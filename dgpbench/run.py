#!/usr/bin/env python3
"""Run one cell of the benchmark of ``deepgraphpose_tpu_torch``.

    python3 dgpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
The cell's files are found by its name (``harness.py``); its traffic
file names the driver that sets it up from ``--seed``, warms it up (the
set-up, ``setup_s``), measures ``--seconds`` and checks every answer of
the window against the plain reference. The last line on standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit; the same numbers end
standard error. Builds and caches go under ``build/`` in the checkout.

Exit codes: 0 a result was printed; 2 bad arguments; 3 no CUDA card, or
fewer than the cell asks for; 4 a blocked module (JAX, the JAX package)
was loaded. No result is printed unless the code is 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed place inside
    the checkout: the port's nvcc builds, and the caches of PyTorch's
    extensions, Triton and the CUDA driver, should anything use them."""
    build = root / "build"
    os.environ["DGP_COMPILE_CACHE"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def execute(root: Path, cell: dict, device, seed: int, seconds: float,
            trace: bool, t_start: float) -> dict:
    """Run ``cell`` on ``device`` and return its result line (a dict in
    the order it is printed)."""
    import torch

    from dgpbench import harness

    driver = harness.load_driver(root, cell["traffic"]["driver"])
    out = driver.run({"config": cell["config"], "traffic": cell["traffic"],
                      "limits": cell["limits"], "device": device,
                      "seed": seed, "seconds": seconds, "trace": trace,
                      "t_start": t_start})
    bench, name = cell["bench"], cell["name"]
    if trace:
        metrics = {}
        for m in harness.per_layer_metrics(bench, name):
            value = harness.load_metric(root, m["name"]).read(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in harness.end_to_end_metrics(bench, name)}
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": kind, "count": cell["entry"]["chips"],
            "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = out["trace"]["busy_s"]
        info["window_s"] = out["trace"]["wall_s"]
        line["breakdown"] = harness.breakdown(out["trace"])
    line["checks"] = out["checks"]
    line["diagnostics"] = {**out.get("diagnostics", {}),
                           "gap_quantiles_50_99_999_max":
                           out.get("gap_quantiles")}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache_env(ROOT)
    sys.path.insert(0, str(ROOT))
    from dgpbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"dgpbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    line = execute(ROOT, cell, device, args.seed, args.seconds,
                   bool(args.trace), T_START)

    found = harness.blocked_modules()
    if found:
        print(f"dgpbench: blocked modules were loaded: {found}",
              file=sys.stderr)
        return 4
    from deepgraphpose_tpu_torch.ops.kernels import launch_counts

    from dgpbench.counts import roofline

    print(f"dgpbench: {line['device']['kind']}, power limit "
          f"{roofline.power_limit_w()} W (peaks assume "
          f"{roofline.DATASHEET_POWER_W} W); kernel launches "
          f"{launch_counts()}", file=sys.stderr)
    print(f"dgpbench: {json.dumps(line.pop('diagnostics'))}",
          file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
