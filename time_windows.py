#!/usr/bin/env python3
"""Time the two ways a multi-window DGP update can batch its trunk.

Run on a machine with an NVIDIA GPU:

    python3 time_windows.py [--windows 2] [--frames 11] [--reps 8]

A G-window update (``fit_dgp(windows_per_device=G)``) runs its windows
through ResNet-50 at 747x832 either in one call of G x T frames or in G
calls of T frames. Both give the same update (the weight gradient sums
the same terms, in another order). This script times the trunk's forward
and backward both ways on one seeded random model and input, in turns
(one, each, each, one, ...), under cuDNN's defaults and with
``cudnn.benchmark`` on, TF32 as the port leaves it. It prints one JSON
line: the card's name and power limit, then for each cuDNN mode the
median ms an update of each batching, their ratio and the peak memory.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--windows", type=int, default=2)
    parser.add_argument("--frames", type=int, default=11)
    parser.add_argument("--reps", type=int, default=8)
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke      # imports no package at module level
    import torch

    if not torch.cuda.is_available():
        print("time_windows.py: CUDA is not available", file=sys.stderr)
        return 1
    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models.pose_model import init_model

    device = torch.device("cuda")
    cfg = PoseConfig(net_type="resnet_50", num_joints=smoke.NUM_JOINTS)
    model = init_model(cfg, torch.Generator().manual_seed(smoke.SEED),
                       device=device)
    g, t = args.windows, args.frames
    images = torch.randint(0, 256, (g * t, *smoke.HW, 3),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.uint8).to(device)

    def loss_of(heads):
        return sum(v.square().mean() for v in heads.values())

    def one():
        loss_of(model(images)).backward()

    def each():
        sum(loss_of(model(images[w * t:(w + 1) * t]))
            for w in range(g)).backward()

    def timed(fn) -> tuple[float, float]:
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(end),
                torch.cuda.max_memory_allocated() / 1e9)

    modes = {}
    for mode, benchmark in (("defaults", False), ("benchmark", True)):
        with torch.backends.cudnn.flags(enabled=True, benchmark=benchmark,
                                        deterministic=False):
            for fn in (one, each, one, each):   # warm-up, autotuning
                timed(fn)
            ms = {"one_call": [], "per_window": []}
            peak = {}
            for r in range(args.reps):
                order = ("one_call", "per_window") if r % 2 == 0 else (
                    "per_window", "one_call")
                for name in order:
                    m, p = timed(one if name == "one_call" else each)
                    ms[name].append(m)
                    peak[name] = p
        med = {k: statistics.median(v) for k, v in ms.items()}
        modes[mode] = {"ms": med, "ms_all": ms, "peak_gb": peak,
                       "per_window_over_one_call":
                           med["per_window"] / med["one_call"]}
    print(json.dumps({"phase": "time_windows", "card": smoke.card_line(),
                      "windows": g, "frames": t, "hw": list(smoke.HW),
                      "modes": modes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
