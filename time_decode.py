#!/usr/bin/env python3
"""Time a checkout's decode kernel at the main path's two map shapes.

Run on a machine with an NVIDIA GPU:

    python3 time_decode.py [--root DIR]

``deepgraphpose_tpu_torch`` is imported from DIR (default: the directory of
this script), so two trees can be timed in turns on one card, each in a
process of its own. For example, an older commit against this one:

    mkdir -p build/parent && git archive 5c9cb6d | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 time_decode.py --root $r
    done

The kernel is built from DIR's sources into DIR/build/kernels, held against
the plain version at each shape (mu within 1e-4 cells, likelihood within
1e-5), and timed with its default launch by CUDA-graph replay over a ring
of inputs twice the L2 (``chip_smoke.time_ms``). Prints one JSON line: the
card's name and power limit, DIR, and for each shape its ms beside the
bound.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    root = args.root.resolve()
    if not (root / "deepgraphpose_tpu_torch").is_dir():
        print(f"time_decode.py: no deepgraphpose_tpu_torch under {root}",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke      # this checkout's: it imports no package
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_decode.py: CUDA is not available", file=sys.stderr)
        return 1
    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models.pose_model import scoremap_size
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel

    device = torch.device("cuda")
    cfg = PoseConfig(net_type="resnet_50", num_joints=smoke.NUM_JOINTS)
    rng = np.random.default_rng(smoke.SEED)
    shapes = []
    for hw in (smoke.HW, smoke.CROP_HW):
        shape = (smoke.BATCH, *scoremap_size(cfg, hw), smoke.NUM_JOINTS)
        bound = smoke.decode_bound(shape)
        ring = [torch.from_numpy((rng.standard_normal(shape) * 3).astype(
            np.float32)).to(device) for _ in range(
                min(64, max(4, -(-100_000_000 // bound["bytes"]))))]
        e_mu, e_lik = smoke.kernel_errors(ring[0], cfg.gamma, cfg.gauss_len)
        if e_mu > smoke.MU_TOL or e_lik > smoke.LIK_TOL:
            raise AssertionError(f"{root}: kernel disagrees with plain at "
                                 f"{shape}: mu {e_mu}, lik {e_lik}")
        ms = smoke.time_ms(lambda x: softargmax_kernel.softargmax_likelihood(
            x, cfg.gamma, cfg.gauss_len), ring, args.reps)
        shapes.append({"shape": list(shape), "ms": ms,
                       "bound_ms": bound["bound_ms"], "max_abs_err_mu": e_mu,
                       "max_abs_err_lik": e_lik})
        del ring
    print(json.dumps({"phase": "time_decode", "card": smoke.card_line(),
                      "root": str(root), "shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
