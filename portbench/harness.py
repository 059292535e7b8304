"""The benchmark's runner: one cell, one run, one result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration (``configs/<config>.json`` and its code
``configs/<config>.py``), the traffic (``traffic/<traffic>.json``, which
names its window loop ``entries/<entry>.py``), the limits of the output
check (``limits/<cell>.json``), the plain reference
(``reference/<config>.py``) and one reader per metric
(``metrics/<metric>.py``). Adding a cell, a traffic mix, a configuration
or a metric adds files and entries; no file here changes.

A run: set-up (imports, the kernel library, weights and inputs made on the
card from the seed, warm-up of the cell's own shapes, and for training the
checked first steps), then a closed loop of timed steps for ``--seconds``,
then the output check against the reference once the program's state is
freed. ``--trace 1`` installs the entry's spans, profiles a few steps of
the window and reports the per-layer metrics instead of the end-to-end
ones.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench.traces import Trace

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "nerf_qa_tpu")


def load_module(path: Path):
    """Import a benchmark file by its path (names may hold '-' and '.')."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    key = "portbench_file." + "_".join(path.relative_to(HERE).with_suffix("").parts)
    key = "".join(ch if ch.isalnum() or ch in "._" else "_" for ch in key)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return read_json(REPO / "BENCHMARK.json")


def find(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config_files(name: str) -> tuple[dict, object]:
    return read_json(HERE / "configs" / f"{name}.json"), load_module(HERE / "configs" / f"{name}.py")


def traffic_file(name: str) -> dict:
    return read_json(HERE / "traffic" / f"{name}.json")


def entry_module(name: str):
    return load_module(HERE / "entries" / f"{name}.py")


def metric_module(name: str):
    return load_module(HERE / "metrics" / f"{name}.py")


def reference_module(config: str):
    return load_module(HERE / "reference" / f"{config}.py")


def limits_file(cell: str) -> dict:
    return read_json(HERE / "limits" / f"{cell}.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    that list it, and those that list no cells."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``nerf_qa_torch`` is not ``nerf_qa_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in BANNED})


@dataclass
class Run:
    """What the window saw, for the metric readers."""

    cell: str
    seconds: float
    entry: object
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    frames: int = 0
    step_s: list[float] = field(default_factory=list)
    trace: Trace | None = None


def _profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(run: Run, t0: float, trace: bool, device) -> None:
    """The closed loop: one step at a time until ``run.seconds`` have passed
    (and, traced, until the profiled steps are done). The profiler covers
    the entry's ``trace_steps`` steps from the second one."""
    entry = run.entry
    first, count = 1, entry.trace_steps
    prof = None
    _sync(device)
    start = time.perf_counter()
    run.setup_s = start - t0
    i, now = 0, start
    while True:
        if trace and i == first:
            prof = _profile()
            prof.__enter__()
        a = time.perf_counter()
        with torch.profiler.record_function("pb.step") if prof else contextlib.nullcontext():
            entry.step(i)
        now = time.perf_counter()
        run.step_s.append(now - a)
        i += 1
        if prof is not None and i == first + count:
            prof.__exit__(None, None, None)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                run.trace = Trace.from_file(path)
            prof = None
        if now - start >= run.seconds and not (trace and run.trace is None):
            break
    run.window_s = now - start
    run.steps = i
    run.frames = i * entry.frames_per_step


def make_entry(cell: str, seed: int, device="cuda", overrides: dict | None = None,
               bench: dict | None = None):
    """Build the cell's window loop (its set-up: weights, inputs, warm-up).
    ``overrides`` replaces traffic parameters (the CPU tests' small sizes)."""
    bench = bench or load_benchmark()
    wl = find(bench["workloads"], cell, "workload")
    spec, cfg_mod = config_files(wl["config"])
    traffic = dict(traffic_file(wl["traffic"]), **(overrides or {}))
    ctx = SimpleNamespace(cell=cell, config=spec, config_code=cfg_mod, traffic=traffic,
                          seed=int(seed), device=torch.device(device),
                          reference=reference_module(wl["config"]),
                          limits=limits_file(cell))
    return entry_module(traffic["entry"]).Entry(ctx)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda", overrides: dict | None = None,
             bench: dict | None = None) -> tuple[dict, list[dict]]:
    """Run one cell once; returns (the result line's object, the checks)."""
    bench = bench or load_benchmark()
    entry = make_entry(cell, seed, device, overrides, bench)
    run = Run(cell=cell, seconds=float(seconds), entry=entry)
    hooks = entry.trace_hooks() if trace else contextlib.nullcontext()
    with hooks:
        window(run, t0, trace, device)
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    checks, failed = entry.check()
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, kind):
        value = metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
    result = {"correct": bool(correct), "attempted": run.steps, "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace:
        win = run.trace.window() if run.trace else None
        device_info["busy_s"] = run.trace.busy_us() / 1e6 if run.trace else 0.0
        device_info["window_s"] = (win[1] - win[0]) / 1e6 if win else 0.0
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result, checks


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    chips = find(bench["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0, "cuda", bench=bench)
    bad = banned_modules()
    if bad:
        print(f"portbench: JAX modules loaded in the benchmark process: {bad}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
