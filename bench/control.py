"""The control of the benchmark's comparison: the plain reference in
bfloat16 put in the program's place, judged as a run is; it has to come
out not correct.  One process, several seeds (the benchmark's runs never
call this):

    python3 bench/control.py --workload bc-rmat-s17.exact --seeds 1,2,3 --rounds 25
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "bench"))
sys.path.insert(0, str(ROOT / "src"))

from bcbench.harness import control  # noqa: E402

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--rounds", type=int, required=True,
                        help="rounds of each seed's window (as many as a run completes)")
    args = parser.parse_args()
    for row in control(args.workload, [int(s) for s in args.seeds.split(",")], args.rounds):
        print(json.dumps(row), flush=True)
