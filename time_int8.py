#!/usr/bin/env python3
"""Time a checkout's ResNet-50 int8 full-frame path.

Run on a machine with an NVIDIA GPU:

    python3 time_int8.py [--root DIR] [--runs N]

DIR's ``chip_smoke.py`` and ``deepgraphpose_tpu_torch`` are imported
(default: the directory of this script), so two trees can be timed in
turns on one card, each in a process of its own. For example, an older
commit against this one:

    mkdir -p build/parent && git archive 8bd0ddc | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 time_int8.py --root $r
    done

DIR's kernels are built into DIR/build/kernels; its seeded ResNet-50 is
quantized on ``chip_smoke.py``'s calibration frames, and its int8
full-frame phase (1024 frames of 747x832 at batch 128, the first batch's
convs held against the plain version) runs N times. Prints the card's
name and power limit, then each run's JSON line (``frames_per_s``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    root = args.root.resolve()
    if not (root / "deepgraphpose_tpu_torch").is_dir():
        print(f"time_int8.py: no deepgraphpose_tpu_torch under {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as smoke      # DIR's: its phases fit DIR's package

    if not torch.cuda.is_available():
        print("time_int8.py: CUDA is not available", file=sys.stderr)
        return 1
    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.ops.kernels import build

    print(smoke.card_line(), flush=True)
    build.build_all()
    device = torch.device("cuda")
    cfg = PoseConfig(net_type="resnet_50", num_joints=smoke.NUM_JOINTS,
                     compute_dtype="bfloat16", infer_batch_size=smoke.BATCH)
    model, images4, mu, pred = smoke.phase_f32(
        cfg, device, torch.Generator().manual_seed(smoke.SEED))
    qmodel, _ = smoke.phase_quantize(cfg, model, residual=False)
    for run in range(args.runs):
        smoke.phase_int8_full_frame(cfg, device, qmodel,
                                    f"int8_full_frame_{root.name}_{run}",
                                    images4, pred, mu, mu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
