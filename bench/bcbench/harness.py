"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, path or
per-layer metric is a file of its own, found by name:

* ``BENCHMARK.json`` (the checkout's root): cells and metrics;
* ``bench/configs/<config>.json``: the graph, the path, the program's
  settings (``heuristics``; an optional ``sampling``, ``{"mode": "fixed",
  "k": k, "seed": s}``, absent or null for an exact run), the
  comparison's limits and the sizes the bench tests run it at
  (``test_sizes``);
* ``bench/traffic/<traffic>.json``: the mix :mod:`bcbench.traffic` reads;
* ``bench/paths/<path>.py``: ``build(cfg, graph, device, span) -> Cell``;
* ``bench/metrics/<metric>.py``: ``read(ctx) -> float | None``.

The window drives the port's round loop, ``core/driver.py:BCDriver``,
over the path's round function and the mix's rounds, in the whole
passes over the mix's pool that come nearest to ``--seconds`` at the
warm time of the pool's first round (no stop rule: a rule costs the
driver a fetch of its accumulator after every round, which a user's
exact run never pays).  The rounds are then worked out again by
:mod:`bcbench.reference`, after the program's device state is freed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import reference, rmat, traffic
from .cell import program_schedule
from .trace import WINDOW_SPAN, from_profiler

__all__ = ["run", "main", "control", "judge", "gteps", "Outputs", "FORBIDDEN_MODULES",
           "forbidden_modules", "load_cell", "check_config"]

ROOT = Path(__file__).resolve().parents[2]
#: top-level module names that may not be loaded in a run (compared whole:
#: the port's package name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)
#: the heuristics the reference checks, and those of them that apply the
#: 1-degree reduction (its one pass; h1t / h3t run it to a fixed point)
CHECKED_HEURISTICS = ("h0", "h1", "h2", "h3")
REDUCING_HEURISTICS = ("h1", "h3")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded)."""
    loaded = {name.split(".", 1)[0] for name in (list(sys.modules) if names is None else names)}
    return sorted(loaded.intersection(FORBIDDEN_MODULES))


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for key, value in over.items():
        both = isinstance(value, dict) and isinstance(out.get(key), dict)
        out[key] = _merge(out[key], value) if both else value
    return out


def check_config(cfg: dict) -> None:
    """Refuse a configuration the reference cannot hold the program to."""
    heuristics = cfg["heuristics"]
    if heuristics not in CHECKED_HEURISTICS:
        raise ValueError(
            f"heuristics {heuristics!r}: the reference checks {CHECKED_HEURISTICS}; its one-pass "
            "1-degree reduction cannot check the exhaustive one of h1t / h3t")
    sampling = cfg.get("sampling")
    if sampling is None:
        return
    if heuristics != "h0":
        raise ValueError(
            f"sampling under heuristics {heuristics!r}: the program samples roots only under "
            "'h0' (the 1-/2-degree corrections are not per-root additive)")
    if not isinstance(sampling, dict) or sampling.get("mode") != "fixed" or set(sampling) != {
            "mode", "k", "seed"}:
        raise ValueError(
            f"sampling {sampling!r}: the benchmark runs {{'mode': 'fixed', 'k': <int>, "
            "'seed': <int>}} (the window runs no stop rule)")


def load_cell(root: Path, workload: str,
              overrides: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """(manifest, workload entry, configuration, traffic mix) by name, the
    configuration with ``overrides`` merged in and checked."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cfg = _merge(json.loads((root / conf["file"]).read_text()), overrides or {})
    check_config(cfg)
    mix = json.loads((root / "bench" / "traffic" / f"{entry['traffic']}.json").read_text())
    return manifest, entry, cfg, mix


class Spans:
    """The benchmark's host spans around its calls into each layer: total
    seconds by name; under a profiler also a ``record_function`` each."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        ctx = (torch.profiler.record_function(f"bench.{name}") if self.traced
               else contextlib.nullcontext())
        t = time.perf_counter()
        with ctx:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t


class Recorder:
    """The round function as the driver calls it, keeping each call's
    n_s and roots (the program's own outputs) for the check."""

    def __init__(self, fn, span):
        self.fn = fn
        self.span = span
        self.calls: list[tuple] = []

    def __call__(self, sources, derived):
        with self.span("round"):
            out = self.fn(sources, derived)
        self.calls.append((out[1], out[2]))
        return out


@dataclasses.dataclass
class Outputs:
    """What a side (program, reference or control) produced for the
    window's completed rounds."""

    bc: np.ndarray  # f64 [n], summed over the rounds
    ns: list[np.ndarray]  # per round: f64 per live column
    levels: list[int]  # per round
    roots: list[np.ndarray]  # per round: the live columns' roots


def reference_outputs(dec, schedule, completed: list[int], device, dtype) -> Outputs:
    """The reference (float64) or the control (bfloat16) over the rounds
    ``completed`` (schedule indices, repeats allowed), each distinct round
    computed once."""
    import torch

    brandes = reference.Brandes(dec, device, dtype)
    acc = torch.zeros(dec.n, dtype=brandes.acc if dtype == torch.float64 else dtype,
                      device=device)
    done: dict[int, reference.RoundRef] = {}
    for idx in completed:
        if idx not in done:
            rnd = schedule.rounds[idx]
            done[idx] = brandes.round(reference.round_roots(rnd.sources, rnd.derived))
        acc += done[idx].bc.to(acc.dtype)
    roots = [reference.round_roots(schedule.rounds[i].sources, schedule.rounds[i].derived)
             for i in completed]
    return Outputs(bc=acc.double().cpu().numpy(), ns=[done[i].ns for i in completed],
                   levels=[done[i].levels for i in completed], roots=roots)


def judge(prog: Outputs, ref: Outputs, plan_errors: int, limits: dict) -> tuple[dict, int]:
    """The compared numbers, each with its limit, and the rounds that
    failed a per-round check.

    * ``bc_err``: max over vertices of |bc − bc_ref| / max(|bc_ref|, 1),
      of the answer (a sampled configuration's estimator, :func:`rescale`);
    * ``ns_errors``: columns whose component size differs (exact);
    * ``levels_errors``: rounds whose depth differs (exact);
    * ``plan_errors``: schedule faults (:func:`reference.coverage_errors`,
      :func:`reference.check_round`) and rounds whose roots are not the
      ones the plan gave them."""
    bad = set()
    ns_errors = levels_errors = 0
    for i, (ns, ns_r, lv, lv_r, rt, rt_r) in enumerate(zip(
            prog.ns, ref.ns, prog.levels, ref.levels, prog.roots, ref.roots)):
        if not np.array_equal(rt, rt_r):
            plan_errors += 1
            bad.add(i)
            continue
        wrong = int((ns != ns_r).sum()) if ns.shape == ns_r.shape else max(ns.size, ns_r.size)
        ns_errors += wrong
        levels_errors += int(lv != lv_r)
        if wrong or lv != lv_r:
            bad.add(i)
    scale = np.maximum(np.abs(ref.bc), 1.0)
    diff = np.abs(prog.bc - ref.bc)
    bc_err = float(np.max(diff / scale)) if diff.size else 0.0
    if not np.isfinite(bc_err):
        bc_err = 1e300  # a non-finite answer; JSON has no inf
    values = {"bc_err": bc_err, "ns_errors": ns_errors, "levels_errors": levels_errors,
              "plan_errors": plan_errors}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    failed = len(prog.levels) if bc_err > limits["bc_err"] else len(bad)
    return checks, failed


def decompose(cfg: dict, graph) -> reference.Decomposition:
    """The reference's residual graph under the configuration's heuristics."""
    return reference.decompose(graph.n, graph.src, graph.dst,
                               reduce=cfg["heuristics"] in REDUCING_HEURISTICS)


def want_roots(dec, cfg: dict) -> np.ndarray:
    """The roots the configuration's schedule must have, each once: the
    reference's own draw of a sample, or every eligible vertex."""
    eligible = np.flatnonzero(dec.eligible)
    sampling = cfg.get("sampling")
    if sampling is None:
        return eligible
    return reference.sample_roots(eligible, sampling["k"], sampling["seed"])


def schedule_roots(schedule) -> np.ndarray:
    """The root of every live column of every round of the schedule."""
    return np.concatenate(
        [reference.round_roots(r.sources, r.derived) for r in schedule.rounds]
        or [np.zeros(0, np.int64)])


def plan_check(dec, schedule, roots: np.ndarray, want: np.ndarray, completed: list[int]) -> int:
    """Schedule faults: its roots (``roots``, :func:`schedule_roots`) against
    the ones it must have (``want``, :func:`want_roots`) and the plan of
    every distinct round the window ran."""
    errors = reference.coverage_errors(dec, roots, want)
    for idx in sorted(set(completed)):
        rnd = schedule.rounds[idx]
        errors += reference.check_round(dec, rnd.sources, rnd.derived)
    return errors


def rescale(cfg: dict, dec, out: Outputs) -> Outputs:
    """A sampled configuration's estimator from a side's sums, worked out
    by the reference: BC_hat = N / k · Σ, with N the eligible vertices and
    k the roots of the window's rounds, repeats counted (as the program's
    ``apply_sampling_rescale`` divides by the roots it accumulated).  An
    exact configuration's sums are its answer."""
    if cfg.get("sampling") is None:
        return out
    k = sum(r.size for r in out.roots)
    return dataclasses.replace(out, bc=out.bc * (int(dec.eligible.sum()) / k) if k else out.bc)


def gteps(edges: int, r_total: float, rounds: int, n_rounds: int, seconds: float) -> float:
    """``bc_gteps``: paper Eq. 7, m · r / t, with r = rounds · r_total /
    n_rounds the input vertices the window's rounds account for when every
    round of the schedule is credited its share of ``r_total``, what the
    whole schedule's roots account for (:meth:`reference.Decomposition.credit`)."""
    return edges * r_total * rounds / n_rounds / seconds / 1e9


def _graph(cfg: dict, cache: Path | None):
    from repro_torch.graphs.graph import Graph

    n, src, dst = rmat.load_or_make(
        {"scale": cfg["scale"], "edge_factor": cfg["edge_factor"], "seed": cfg["graph_seed"],
         "a": cfg["a"], "b": cfg["b"], "c": cfg["c"]}, cache)
    return Graph(n=n, src=src, dst=dst)


def control(workload: str, seeds, rounds: int, *, device: str = "cuda",
            overrides: dict | None = None) -> list[dict]:
    """The control: the reference in bfloat16 put in the program's place
    over the first ``rounds`` rounds a window of each seed runs, judged by
    the cell's comparison against the float64 reference.  It has to come
    out not correct."""
    import torch

    _, _, cfg, mix = load_cell(ROOT, workload, overrides)
    dev = torch.device(device)
    graph = _graph(cfg, ROOT / "bench" / ".cache" / "graph" if dev.type == "cuda" else None)
    schedule = program_schedule(cfg, graph)[0][0]
    dec = decompose(cfg, graph)
    roots, want = schedule_roots(schedule), want_roots(dec, cfg)
    out = []
    for seed in seeds:
        one_pass = traffic.round_order(len(schedule.rounds), mix, seed)
        completed = [one_pass[i % len(one_pass)] for i in range(rounds)]
        ref = rescale(cfg, dec, reference_outputs(dec, schedule, completed, dev, torch.float64))
        low = rescale(cfg, dec, reference_outputs(dec, schedule, completed, dev, torch.bfloat16))
        checks, _ = judge(low, ref, plan_check(dec, schedule, roots, want, completed),
                          cfg["limits"])
        out.append({"seed": seed, "rounds": rounds,
                    "correct": all(c["value"] <= c["limit"] for c in checks.values()),
                    "checks": checks})
    return out


def _device_kind(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def window_passes(seconds: float, pass_s: float) -> int:
    """The whole passes over the pool, at ``pass_s`` a pass, that come
    nearest to a window of ``seconds`` (at least one)."""
    return max(1, round(seconds / pass_s)) if pass_s > 0 else 1


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        overrides: dict | None = None, mix: dict | None = None, fault=None,
        t_start: float | None = None, log=print) -> dict:
    """One run of ``workload``; returns the result line as a dict.
    ``overrides`` merge into the configuration, ``mix`` takes the traffic
    mix's place and ``fault`` wraps the round function (for tests at small
    sizes on the CPU, and for a run of the whole schedule)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from repro_torch.core.bc import apply_sampling_rescale
    from repro_torch.core.driver import BCDriver

    manifest, entry, cfg, cell_mix = load_cell(ROOT, workload, overrides)
    mix = cell_mix if mix is None else mix
    dev = torch.device(device)
    spans = Spans()
    with spans("graph"):
        graph = _graph(cfg, ROOT / "bench" / ".cache" / "graph" if dev.type == "cuda" else None)
    n = graph.n
    path = _load_module(ROOT / "bench" / "paths" / f"{cfg['path']}.py",
                        f"bench_path_{cfg['path']}")
    cell = path.build(cfg, graph, dev, spans)
    try:
        schedule = cell.schedule
        round_fn = cell.round_fn if fault is None else fault(cell.round_fn)
        # the pool's first round twice: the first builds and warms, the
        # second sets how many passes over the pool fill the window
        pool = traffic.pool(len(schedule.rounds), mix)
        first = schedule.rounds[pool[0]]
        args = (torch.from_numpy(first.sources[None]).to(dev),
                torch.from_numpy(first.derived[None]).to(dev))
        round_s = 0.0
        for _ in range(2):
            with spans("warmup"):
                t = time.perf_counter()
                round_fn(*args)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                round_s = time.perf_counter() - t
        order = traffic.round_order(len(schedule.rounds), mix, seed,
                                    window_passes(seconds, len(pool) * round_s))
        window = dataclasses.replace(schedule, rounds=[schedule.rounds[i] for i in order],
                                     round_depths=None)
        recorder = Recorder(round_fn, spans)
        setup_s = time.perf_counter() - t_start

        driver = BCDriver(recorder, window, n=n, device=dev)
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            spans.traced = True
        try:
            with torch.profiler.record_function(WINDOW_SPAN) if trace else contextlib.nullcontext():
                cell.steps.count = 0
                t0 = time.perf_counter()
                result = driver.run()
                if cell.plan is not None:
                    result = apply_sampling_rescale(result, cell.plan)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                window_s = time.perf_counter() - t0
                level_steps = cell.steps.count
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                spans.traced = False
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        k = result.rounds_run
        completed = order[:k]
        calls = recorder.calls[-k:] if k else []
        prog = Outputs(
            bc=result.bc,
            ns=[ns.reshape(-1).double().cpu().numpy()[rt.reshape(-1).cpu().numpy() >= 0]
                for ns, rt in calls],
            levels=list(result.round_levels),
            roots=[rt.reshape(-1).cpu().numpy()[rt.reshape(-1).cpu().numpy() >= 0].astype(np.int64)
                   for _, rt in calls])
        trace_data = from_profiler(prof) if prof is not None else None
        del driver, recorder, calls, result, round_fn, prof
    finally:
        cell.close()
    del cell
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------ the reference
    t_ref = time.perf_counter()
    dec = decompose(cfg, graph)
    ref = rescale(cfg, dec, reference_outputs(dec, schedule, completed, dev, torch.float64))
    roots = schedule_roots(schedule)
    checks, failed = judge(prog, ref, plan_check(dec, schedule, roots, want_roots(dec, cfg),
                                                 completed), cfg["limits"])
    credit = dec.credit(roots)
    t_ref = time.perf_counter() - t_ref
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = _device_kind(dev)
    ctx = SimpleNamespace(
        spans=spans.seconds, trace=trace_data, window_s=window_s, n=n, kind=kind,
        arcs=dec.residual_arcs, level_steps=level_steps,
        rounds=[(lv, int((schedule.rounds[i].sources >= 0).sum()), rt.size)
                for lv, i, rt in zip(prog.levels, completed, prog.roots)])
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    metrics: dict[str, dict] = {}
    if trace:
        for m in manifest["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            reader = _load_module(ROOT / "bench" / "metrics" / f"{m['name']}.py",
                                  f"bench_metric_{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        end_to_end = {
            "bc_gteps": gteps(graph.num_edges, float(credit), k, len(schedule.rounds), window_s),
            "peak_gib": peak / GIB,
            "setup_s": setup_s,
        }
        for m in manifest["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": end_to_end[m["name"]], "unit": units[m["name"]]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": entry["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(completed), "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace_data is not None:
        device_info["busy_s"] = trace_data.busy_s
        device_info["window_s"] = trace_data.window_s
        out["breakdown"] = {"device_ops": trace_data.top_ops(), "idle_gaps": trace_data.top_gaps()}
    steps = ", ".join(f"{name} {sec:.3f}" for name, sec in spans.seconds.items()
                      if name != "round")
    log(f"{workload}: seed {seed}, {len(completed)} rounds in {window_s:.3f} s "
        f"({len(set(completed))} distinct of {len(schedule.rounds)}, levels "
        f"{min(prog.levels, default=0)}-{max(prog.levels, default=0)}; m {graph.num_edges}, "
        f"credited R {credit} (eligible Σ(1 + ω) {dec.r_total:.0f}), residual arcs "
        f"{dec.residual_arcs}; {level_steps} level steps), set-up {setup_s:.3f} s "
        f"({steps}), "
        f"peak {peak / GIB:.3f} GiB, {kind}; the reference {t_ref:.3f} s")
    out["checks"] = checks
    return out


def main(argv=None, t_start: float | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    err = sys.stderr

    import torch

    _, entry, _, _ = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=err)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"the program (src/repro_torch) is not in this checkout ({ROOT})", file=err)
        return 2
    sys.path.insert(0, str(src))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "bench" / ".cache" / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "bench" / ".cache" / "triton"))
    print(f"device: {power_limit()}", file=err)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start,
              log=lambda msg: print(msg, file=err))
    found = forbidden_modules()
    if found:
        print(f"modules this run may not load were loaded: {', '.join(found)}", file=err)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err)
    print(json.dumps(out))
    return 0
