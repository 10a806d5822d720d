"""The harness on the CPU at small sizes: the result line's schema, the
manifest, the metric arithmetic, the import rule and the refusals."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

from bcbench import harness, reference, roofline, traffic  # noqa: E402
from bcbench.cell import program_schedule  # noqa: E402
from bcbench.trace import Trace, _collective, from_profiler, idle_gaps, union_seconds  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
#: a fixed sample of 32 roots under h0, on a configuration that runs exact
SAMPLED = {"heuristics": "h0", "sampling": {"mode": "fixed", "k": 32, "seed": 3}}
#: what a copy of the benchmark leaves out
COPY_IGNORE = shutil.ignore_patterns(".cache", "__pycache__")


def small(workload: str) -> dict:
    """The configuration's small sizes for the CPU (its ``test_sizes``)."""
    return harness.load_cell(ROOT, workload)[2]["test_sizes"]["cpu"]


WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(workload, trace):
    out = harness.run(workload, 2**31 + 11, 0.3, bool(trace), device="cpu",
                      overrides=small(workload), log=lambda msg: None)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in MANIFEST[kind]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and np.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "levels_per_round" in line["metrics"] and "schedule_s" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"bc_gteps", "peak_gib", "setup_s"}
        assert line["metrics"]["setup_s"]["value"] > 0


def test_same_seed_gives_same_rounds_and_answers():
    a = harness.run("bc-rmat-s17.exact", 5, 0.0, False, device="cpu",
                    overrides=small("bc-rmat-s17.exact"), log=lambda msg: None)
    b = harness.run("bc-rmat-s17.exact", 5, 0.0, False, device="cpu",
                    overrides=small("bc-rmat-s17.exact"), log=lambda msg: None)
    assert a["attempted"] == b["attempted"] >= 1
    assert a["checks"] == b["checks"]


def test_round_order_is_the_pool_from_a_seeded_start():
    spec = {"pool_rounds": 4}
    assert traffic.pool(10, spec) == [0, 2, 5, 7]
    order = traffic.round_order(10, spec, 2**33 + 1, 3)
    assert len(order) == 12 and sorted(order) == sorted([0, 2, 5, 7] * 3)
    start = order.index(0)
    assert order[start:start + 4] == [0, 2, 5, 7]
    assert order[:4] == order[4:8] == order[8:] == traffic.round_order(10, spec, 2**33 + 1)
    assert traffic.round_order(10, spec, -3, 2) == traffic.round_order(10, spec, -3, 2)
    # every seed runs the same rounds, in another order
    firsts = {traffic.round_order(10, spec, seed)[0] for seed in range(40)}
    assert firsts == {0, 2, 5, 7}
    assert all(sorted(traffic.round_order(10, spec, seed)) == [0, 2, 5, 7] for seed in range(40))
    assert traffic.pool(3, spec) == [0, 1, 2]


def test_a_mix_given_to_run_takes_the_traffic_files_place():
    # a pool of one round: every seed runs the schedule's first round
    runs = [harness.run("bc-rmat-s17.exact", seed, 0.0, False, device="cpu",
                        overrides=small("bc-rmat-s17.exact"), mix={"pool_rounds": 1},
                        log=lambda msg: None) for seed in (1, 2**31 + 9)]
    assert [r["attempted"] for r in runs] == [1, 1]
    assert runs[0]["checks"] == runs[1]["checks"] and runs[0]["correct"]


def test_window_passes_come_nearest_to_the_seconds():
    assert harness.window_passes(20.0, 21.2) == 1
    assert harness.window_passes(20.0, 17.0) == 1
    assert harness.window_passes(20.0, 9.5) == 2
    assert harness.window_passes(20.0, 45.0) == 1
    assert harness.window_passes(0.0, 0.4) == 1
    assert harness.window_passes(3.0, 0.0) == 1


def test_level_steps_count_calls_on_an_instance_or_a_class_and_detach():
    from bcbench.cell import LevelSteps

    class Op:
        def forward_level(self, lvl):
            return lvl + 1

        def backward_level(self, lvl):
            return lvl - 1

        def forward_level_checked(self, lvl):
            return lvl

        def backward_level_checked(self, lvl):
            return lvl

    class Sub(Op):
        pass

    op = Op()
    steps = LevelSteps().attach(op)
    assert op.forward_level(2) == 3 and op.backward_level(2) == 1 and steps.count == 2
    steps.detach()
    op.forward_level(1)
    assert steps.count == 2 and "forward_level" not in vars(op)
    steps = LevelSteps().attach(Sub)
    a, b = Sub(), Sub()
    a.forward_level(1), b.backward_level(1), b.forward_level_checked(1)
    assert steps.count == 3 and Op().forward_level(1) == 2 and steps.count == 3
    steps.detach()
    assert "forward_level" not in vars(Sub) and Sub().forward_level(1) == 2


@pytest.mark.parametrize("workload", WORKLOADS)
def test_levels_per_round_counts_the_engines_level_steps(workload):
    # a static bound L: L forward steps and L - 1 backward.  The liveness
    # loop: the sources' depth + 1 forward (the last finds nothing) and
    # D - 1 backward, D the round's depth, which a derived column can take
    # one level past the sources' (L = D + 1 levels): 2D or 2D - 1 steps
    logged = []
    out = harness.run(workload, 2**31 + 3, 0.0, True, device="cpu",
                      overrides=small(workload), mix={"pool_rounds": 1}, log=logged.append)
    assert out["attempted"] == 1
    config = next(w["config"] for w in MANIFEST["workloads"] if w["name"] == workload)
    cfg = json.loads((ROOT / next(c["file"] for c in MANIFEST["configs"]
                                  if c["name"] == config)).read_text())
    levels = int(re.search(r"levels (\d+)-(\d+)", logged[-1]).group(1))
    want = ({2 * cfg["max_levels"] - 1} if cfg["max_levels"] is not None
            else {2 * (levels - 1), 2 * (levels - 1) - 1})
    assert out["metrics"]["levels_per_round"]["value"] in want


@pytest.mark.parametrize("variant", ["as_configured", "h0_exact", "sampled"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_credit_is_what_the_schedules_own_roots_account_for(workload, variant):
    # exact: Σ over the eligible roots of 1 + ω, to the bit (under h0 every
    # ω is 0, so one a root); a sample of k under h0: k
    extra = {"as_configured": {}, "h0_exact": {"heuristics": "h0", "sampling": None},
             "sampled": SAMPLED}[variant]
    cfg = harness.load_cell(ROOT, workload, dict(small(workload), **extra))[2]
    graph = harness._graph(cfg, None)
    (schedule, *_), plan = program_schedule(cfg, graph)
    dec = harness.decompose(cfg, graph)
    roots = harness.schedule_roots(schedule)
    assert harness.plan_check(dec, schedule, roots, harness.want_roots(dec, cfg), []) == 0
    credit = dec.credit(roots)
    assert isinstance(credit, int)
    sampling = cfg.get("sampling")
    if sampling is None:
        assert plan is None
        assert float(credit) == dec.r_total and credit >= int(dec.eligible.sum())
        if cfg["heuristics"] not in harness.REDUCING_HEURISTICS:
            assert credit == int(dec.eligible.sum())
    else:
        assert credit == sampling["k"] < dec.r_total
        assert plan.scale == int(dec.eligible.sum()) / sampling["k"]


def test_the_reference_sample_is_the_programs_plan():
    from repro_torch.serving.sampling import plan_sampling

    eligible = np.flatnonzero(np.random.default_rng(4).random(3000) < 0.7)
    for k, seed in ((1, 0), (32, 3), (512, 2**31 + 5), (eligible.size - 1, 9)):
        want = plan_sampling(eligible, "fixed", sample_k=k, seed=seed).roots
        got = reference.sample_roots(eligible, k, seed)
        assert got.dtype == np.int64 and np.array_equal(got, want)


def test_gteps_is_edges_times_credited_vertices_over_seconds():
    # 2 of 8 rounds of a schedule that accounts for 400 vertices, 10^6
    # edges, 0.5 s: r = 100, 10^8 / 0.5 = 2e8 edges a second
    assert harness.gteps(10**6, 400.0, 2, 8, 0.5) == pytest.approx(0.2)


def test_level_roofline_arithmetic():
    kind = "NVIDIA H100 80GB HBM3"
    # bytes bound: 8·10^6 + 2·4·1000·10 = 8.08e6 B at 3.35e12 B/s
    assert roofline.level_seconds(10**6, 1000, 10, kind) == pytest.approx(8.08e6 / 3.35e12)
    # FLOP bound: 2·10^6·10^4 = 2e10 at 67e12 beats 8e6 + 8e7 bytes
    assert roofline.level_seconds(10**6, 1000, 10**4, kind) == pytest.approx(2e10 / 67e12)
    # a round of depth 3: 3 forward levels of 4 columns, 2 backward of 6
    want = 3 * roofline.level_seconds(100, 50, 4, kind) + 2 * roofline.level_seconds(
        100, 50, 6, kind)
    assert roofline.round_bound_seconds(4, 4, 6, 100, 50, kind) == pytest.approx(want)
    with pytest.raises(KeyError):
        roofline.level_seconds(1, 1, 1, "cpu")


def test_busy_is_the_union_of_overlapping_intervals():
    ivs = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.6), (4.5, 6.0)]
    assert union_seconds(ivs, 0.0, 5.0) == pytest.approx(3.0)  # the sum would be 4.1
    assert idle_gaps(ivs, 0.0, 5.0) == [(1.5, 2.0), (3.0, 4.5)]
    tr = Trace(window_s=5.0,
               device=[("k1", 0.0, 1.0), ("Memcpy DtoD", 0.5, 1.5), ("k2", 2.0, 3.0)],
               host=[("aten::item", 3.5, 4.0), ("bench.round", 3.0, 5.0)],
               collective=[("Memcpy DtoD", 0.5, 1.5)])
    assert tr.busy_s == pytest.approx(2.5)
    assert tr.collective_s == pytest.approx(1.0)
    assert tr.top_gaps(1) == [["aten::item", pytest.approx(2.0)]]
    assert tr.top_gaps(2)[1] == ["host", pytest.approx(0.5)]
    assert tr.top_ops(2)[0][0] in ("k1", "Memcpy DtoD", "k2")


def test_collectives_are_what_the_nccl_host_ops_launched():
    from torch.autograd import DeviceType

    class Event:
        def __init__(self, name, dev, start, end, cid=0, link=0, annotation=False):
            self._v = (name, dev, start, end, cid, link, annotation)

        def name(self):
            return self._v[0]

        def device_type(self):
            return self._v[1]

        def start_ns(self):
            return int(self._v[2] * 1e9)

        def duration_ns(self):
            return int((self._v[3] - self._v[2]) * 1e9)

        def correlation_id(self):
            return self._v[4]

        def linked_correlation_id(self):
            return self._v[5]

        def is_user_annotation(self):
            return self._v[6]

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    # framework ops carry ids 10-13 and link to nothing; the runtime calls
    # link to their op and carry ids of the runtime's own counter, one of
    # which (12, inside the nccl op) equals the index_select's id
    events = [
        Event("bench.window", cpu, 0.0, 3.0, cid=1),
        Event("nccl:_all_gather_base", cpu, 0.9, 1.25, cid=10),
        Event("record_param_comms", cpu, 0.95, 1.1, cid=11),
        Event("cudaMemcpyAsync", cpu, 0.96, 0.97, cid=12, link=11),
        Event("aten::index_select", cpu, 1.26, 1.3, cid=12),
        Event("cudaLaunchKernel", cpu, 1.27, 1.28, cid=13, link=12),
        Event("Memcpy DtoD", cuda, 1.0, 1.2, link=11),
        Event("gather", cuda, 1.3, 1.4, link=12),
        Event("ncclDevKernel_AllGather", cuda, 2.0, 2.5),
        Event("nccl:_all_gather_base", cuda, 0.99, 1.21, annotation=True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    trace = from_profiler(prof)
    assert trace.window_s == pytest.approx(3.0)
    assert [name for name, _, _ in trace.collective] == ["Memcpy DtoD",
                                                        "ncclDevKernel_AllGather"]
    assert trace.collective_s == pytest.approx(0.7)
    assert trace.busy_s == pytest.approx(0.8)  # the annotation repeats its kernels' time
    device = [("Memcpy DtoD", 1.0, 1.2), ("gather", 1.3, 1.4)]
    host = [("nccl:_all_gather_base", 0.9, 1.25), ("aten::index_select", 1.26, 1.3)]
    assert [n for n, _, _ in _collective(device, [11, 12], host, [10, 12])] == []
    tr = Trace(window_s=3.0, device=device, host=[("aten::item", 0.0, 0.5)])
    assert tr.host_at(0.7) == "after aten::item"


def _ctx(**kw):
    base = dict(spans={}, trace=None, window_s=1.0, n=10, kind="NVIDIA H100 80GB HBM3",
                arcs=20, level_steps=0, rounds=[])
    base.update(kw)
    return SimpleNamespace(**base)


def test_metric_readers_return_nothing_when_there_is_nothing_to_read():
    for m in MANIFEST["per_layer"]:
        reader = harness._load_module(BENCH / "metrics" / f"{m['name']}.py", f"t_{m['name']}")
        assert reader.read(_ctx()) is None, m["name"]
    cpu_trace = Trace(window_s=1.0, device=[], host=[("aten::mm", 0.0, 1.0)])
    for name in ("level_roofline", "device_idle_pct", "collective_ms_per_round",
                 "level_step_ms"):
        reader = harness._load_module(BENCH / "metrics" / f"{name}.py", f"t2_{name}")
        assert reader.read(_ctx(trace=cpu_trace, rounds=[(5, 2, 3)])) is None, name


def test_device_idle_and_level_metrics_from_a_trace():
    tr = Trace(window_s=2.0, device=[("k", 0.0, 0.5), ("k", 0.25, 1.0)], host=[])
    ctx = _ctx(trace=tr, rounds=[(8, 4, 6), (8, 4, 6)], level_steps=28)
    read = lambda name: harness._load_module(BENCH / "metrics" / f"{name}.py", name).read(ctx)
    assert read("device_idle_pct") == pytest.approx(50.0)
    assert read("levels_per_round") == pytest.approx(14.0)
    assert read("level_step_ms") == pytest.approx(1e3 * 1.0 / 28)
    want = 2 * roofline.round_bound_seconds(8, 4, 6, 20, 10, ctx.kind) / 2.0 * 100
    assert read("level_roofline") == pytest.approx(want)


def _imported_top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        bad = _imported_top_names(path) & set(harness.FORBIDDEN_MODULES)
        assert not bad, f"{path} imports {bad}"
        if path.parent.name != "tests":
            text = path.read_text()
            assert "benchmarks/" not in text and "BENCH_" not in text, path
    # the reference, generator and yardstick import nothing of the program
    for name in ("reference.py", "rmat.py", "roofline.py", "trace.py", "traffic.py"):
        assert "repro_torch" not in _imported_top_names(BENCH / "bcbench" / name), name


def test_forbidden_modules_compare_top_level_names_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "jax", "numpy"]) == ["jax", "repro"]
    assert harness.forbidden_modules(["flax.linen", "jaxlib"]) == ["flax", "jaxlib"]


def test_manifest_keeps_to_its_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"] and 1 <= m["run_seconds"] <= 51
    names = [x["name"] for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    e2e = {e["name"] for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file() and p["moves"] in e2e
        assert set(p.get("workloads", [])) <= {w["name"] for w in m["workloads"]}


def test_main_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where no CUDA card is present")
    rc = harness.main(["--workload", "bc-rmat-s17.exact", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=COPY_IGNORE)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "bc-rmat-s17.exact", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def _changed_files(before: Path, after: Path) -> list[str]:
    """The files of ``before`` that ``after`` lacks or holds otherwise (as
    ``git diff`` of the two trees would list them), caches left out."""
    changed = []
    for path in sorted(before.rglob("*")):
        rel = path.relative_to(before)
        if path.is_dir() or {".cache", "__pycache__"} & set(rel.parts):
            continue
        twin = after / rel
        if not twin.is_file() or twin.read_bytes() != path.read_bytes():
            changed.append(rel.as_posix())
    return changed


def test_a_configuration_joins_the_benchmark_as_data_alone(tmp_path):
    # an h0 configuration, sampled and exact, added to a copy of the
    # benchmark by new files and manifest entries alone runs correct, and
    # every bench test parametrised over the manifest runs it
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "bench", ignore=COPY_IGNORE)
    base = json.loads((BENCH / "configs" / "bc-rmat-s17-fused.json").read_text())
    (copy / "bench" / "traffic" / "sample32.json").write_text(json.dumps({"pool_rounds": 2}))
    manifest = json.loads(json.dumps(MANIFEST))
    added = {"bc-rmat-s17.sampled": ("bc-rmat-s17-sampled", SAMPLED["sampling"], 32),
             "bc-rmat-s17.h0": ("bc-rmat-s17-h0", None, None)}
    for workload, (name, sampling, _) in added.items():
        cfg = dict(base, name=name, scale=8, batch_size=16, heuristics="h0", sampling=sampling)
        (copy / "bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        manifest["configs"].append(dict(manifest["configs"][0], name=name,
                                        file=f"bench/configs/{name}.json"))
        manifest["workloads"].append({"name": workload, "config": name, "traffic": "sample32",
                                      "chips": 1, "why": "h0 on the fused path"})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    assert _changed_files(BENCH, copy / "bench") == []
    assert (copy / "BENCHMARK.json").read_bytes() != (ROOT / "BENCHMARK.json").read_bytes()

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = (
        "import json, re, sys; sys.path.insert(0, 'bench'); from bcbench import harness; "
        "rows = []\n"
        "for w in sys.argv[1:]:\n"
        "    logged = []; out = harness.run(w, 2**31 + 13, 0.2, False, device='cpu', "
        "log=logged.append)\n"
        "    got = re.search(r'credited R (\\d+) \\(eligible [^)]*\\) (\\d+)\\)', logged[-1])\n"
        "    rows.append([out, int(got.group(1)), int(got.group(2))])\n"
        "print(json.dumps(rows))")
    proc = subprocess.run([sys.executable, "-c", script, *added], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = json.loads(proc.stdout.splitlines()[-1])
    for (out, credit, r_total), (name, _, k) in zip(rows, added.values()):
        assert out["correct"] is True and out["failed"] == 0, (name, out["checks"])
        assert out["checks"]["plan_errors"]["value"] == 0
        assert out["attempted"] >= 2 and set(out["metrics"]) == {"bc_gteps", "peak_gib", "setup_s"}
        assert credit == (r_total if k is None else k)

    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "bench/tests", "-k", " or ".join(added)],
        cwd=copy, env=env, capture_output=True, text=True, timeout=900)
    tail = proc.stdout[-4000:]
    assert proc.returncode == 0, tail
    summary = tail.strip().splitlines()[-1]
    assert int(re.search(r"(\d+) passed", summary).group(1)) >= 20, tail
    assert "failed" not in summary and "error" not in summary, tail
