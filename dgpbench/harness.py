"""What every cell shares: finding a cell's files by name, the metrics it
reports, the profiler's trace reduced to a summary, and the import guard.

A cell is found by its name alone: ``BENCHMARK.json`` names its
configuration and traffic, ``workloads/<cell>.json`` holds its limits,
``configs/<config>.json`` its sizes, whose ``family`` names
``reference/families/<family>.py`` (the backbone's weights, forward pass
and convolution plan), ``traffic/<traffic>.json`` its driver and
parameters, ``drivers/<driver>.py`` the code that drives it, and
``metrics/<metric>.py`` the reader of each per-layer metric. A later
cell, traffic mix, metric or backbone family is a new file, and no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

from dgpbench.counts import roofline

BENCH_DIR = Path(__file__).resolve().parent
# top-level module names that no run may load: the JAX package and JAX
# (the program's name begins with the JAX package's, so names are compared
# whole), and the repository's scripts that measured the JAX package or
# drive a proof run
BLOCKED = ("jax", "jaxlib", "flax", "deepgraphpose_tpu", "chip_smoke",
           "bench")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def load_cell(root: Path, cell: str) -> dict:
    """The cell's entry, configuration, traffic and limits."""
    root = Path(root)
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    workload = load_json(root / "dgpbench" / "workloads" / f"{cell}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{cell}.json names {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    config_file = next(c["file"] for c in bench["configs"]
                       if c["name"] == entry["config"])
    return {"name": cell, "entry": entry, "bench": bench,
            "limits": workload["limits"],
            "config": load_json(root / config_file),
            "traffic": load_json(root / "dgpbench" / "traffic"
                                 / f"{entry['traffic']}.json")}


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(root: Path, name: str):
    return _load_file(Path(root) / "dgpbench" / "drivers" / f"{name}.py",
                      f"dgpbench_driver_{name}")


def load_metric(root: Path, name: str):
    """The reader of a per-layer metric: ``read(trace) -> float | None``."""
    return _load_file(Path(root) / "dgpbench" / "metrics" / f"{name}.py",
                      "dgpbench_metric_" + re.sub(r"\W", "_", name))


def end_to_end_metrics(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_metrics(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics of a cell: those that list it, and those
    that list no cells and move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_metrics(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def blocked_modules() -> list[str]:
    """Loaded modules whose top-level name is one of BLOCKED."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in BLOCKED})


# --- the device trace -------------------------------------------------------

def summarize_profile(prof, main_thread: int | None = None) -> dict:
    """A profiler run reduced to what the readers and the breakdown use:
    device kernels and copies as (name, start_us, end_us, range) with the
    profiler range (``record_function`` on the device timeline) that holds
    each, their busy time, and the longest idle gaps labelled with the
    innermost host op running in them (on ``main_thread`` where one is)."""
    from torch.autograd import DeviceType

    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in device
              if getattr(e, "is_user_annotation", False)]
    kernels = []
    for e in device:
        if getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        label = next((n for a, b, n in ranges if a <= start < b), None)
        kernels.append((e.name, start, end, label))
    if not kernels:
        raise RuntimeError("the profiler recorded no device operations")
    host = [(e.time_range.start, e.time_range.end, e.name, e.thread)
            for e in events if e.device_type == DeviceType.CPU]
    spans = sorted((s, t) for _, s, t, _ in kernels)
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged,
                                                             merged[1:])),
                  reverse=True)[:10]

    def doing(t0, t1):
        mid = 0.5 * (t0 + t1)
        live = [h for h in host if h[0] <= mid < h[1]]
        mine = [h for h in live if h[3] == main_thread] or live
        if not mine:
            return "host: no traced op"
        return "host: " + min(mine, key=lambda h: h[1] - h[0])[2]

    return {"kernels": kernels,
            "busy_s": 1e-6 * roofline.busy_us((s, t) for _, s, t, _ in
                                              kernels),
            "idle_gaps": [[doing(a, b), 1e-6 * g] for g, a, b in gaps]}


def breakdown(trace: dict) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each list at most 10 long."""
    by_name: dict[str, float] = {}
    for name, start, end, _ in trace["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + 1e-6 * (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], s] for name, s in top],
            "idle_gaps": trace["idle_gaps"]}


def device_ms(trace: dict, include: str | None = None,
              exclude: str | None = None,
              in_range: str | None = None) -> float:
    """Device ms of the kernels whose names match ``include`` (any name
    if None) and not ``exclude``, and, with ``in_range``, that ran inside
    that profiler range."""
    total = 0.0
    for name, start, end, label in trace["kernels"]:
        if ((include is None or re.search(include, name))
                and not (exclude and re.search(exclude, name))
                and (in_range is None or label == in_range)):
            total += 1e-3 * (end - start)
    return total
