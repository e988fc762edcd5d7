#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 dgpbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 3]

For each of ``--seeds`` the cell runs as ``run.py`` runs it, with a short
window (every frame of the ring is answered more than once), and its
compared numbers are printed; for each of ``--control-seeds`` the control
(the reference in the precision below the cell's) is put in the
program's place on that seed's frames and weights and judged the same
way. The last line sums up: the largest program reading and the smallest
control reading of each number, and their ratio. A limit lies between
the two (see PERF.md). The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from dgpbench import harness
    from dgpbench.run import cache_env

    cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(ROOT, args.workload)
    driver = harness.load_driver(ROOT, cell["traffic"]["driver"])
    device = torch.device("cuda", 0)

    def ctx(seed):
        return {"config": cell["config"], "traffic": cell["traffic"],
                "limits": cell["limits"], "device": device, "seed": seed,
                "seconds": args.seconds, "trace": False,
                "t_start": time.perf_counter()}

    program, control = [], []
    for seed in args.seeds:
        out = driver.run(ctx(seed))
        got = {k: v["value"] for k, v in out["checks"].items()}
        program.append(got)
        print(json.dumps({"side": "program", "seed": seed, **got,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "gap_quantiles": out["gap_quantiles"],
                          "metrics": out["metrics"]}), flush=True)
    for seed in args.control_seeds:
        got = driver.control_readings(ctx(seed))
        got.pop("failed")
        quantiles = got.pop("quantiles")
        control.append(got)
        print(json.dumps({"side": "control", "seed": seed, **got,
                          "gap_quantiles": quantiles}), flush=True)
    names = list((program or control)[0])
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(device)}
    for name in names:
        lower = max((p[name] for p in program), default=None)
        upper = min((c[name] for c in control), default=None)
        summary[name] = {"lower": lower, "upper": upper,
                         "ratio": (upper / lower if lower and upper
                                   else None)}
    summary["blocked_modules"] = harness.blocked_modules()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
