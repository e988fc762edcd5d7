#!/usr/bin/env python3
"""Whether float32 inference repeats exactly on the card.

Run on a machine with an NVIDIA GPU:

    python3 check_repeat.py

On ``chip_smoke.py``'s synthetic project (120 frames of 747x832, a seeded
random-init ResNet-50 saved as the step-2 snapshot), ``estimate_pose``
runs three times in one process with cuDNN autotuned (the default of
``infer_forward``), three times with its background prefetcher replaced by
a loop on the main thread, and three times under deterministic cuDNN; then
one batch of the video's frames goes through the loaded model's part_pred
head three times. Prints one JSON line: the card's name and power limit
and, for each way, the largest distance between any two of its runs (px
for the trajectories, logits for the head).
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("check_repeat.py: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.infer import predict
    from deepgraphpose_tpu_torch.models.pose_model import init_model

    class OnMainThread:
        """``DevicePrefetcher``'s interface, transferring in the loop."""

        def __init__(self, producer, transfer, depth=2):
            self.items = (transfer(item) for item in producer)

        def __iter__(self):
            return self.items

    def largest(runs) -> float:
        return max(float(np.abs(a - b).max()) for i, a in enumerate(runs)
                   for b in runs[i + 1:])

    with tempfile.TemporaryDirectory(prefix="check_repeat_") as work:
        root = smoke.make_fit_project(Path(work) / "p")
        _, cfg, train_dir = resolve_project(root)
        model = init_model(cfg, torch.Generator().manual_seed(smoke.SEED),
                           device="cpu")
        snap = checkpoint.save_snapshot(train_dir, 2, "final--0", model)
        video = root / "videos_dgp" / "synthvid.avi"

        def trajectories():
            with contextlib.redirect_stdout(sys.stderr):
                p = predict.estimate_pose(root / "config.yaml", snap, video,
                                          root / "out", save_pose=False,
                                          device="cuda")
            return np.stack([p["x"], p["y"]], -1)

        out = {"card": smoke.card_line()}
        out["autotuned_px"] = largest([trajectories() for _ in range(3)])
        prefetcher = predict.DevicePrefetcher
        predict.DevicePrefetcher = OnMainThread
        try:
            out["main_thread_feed_px"] = largest(
                [trajectories() for _ in range(3)])
        finally:
            predict.DevicePrefetcher = prefetcher
        with smoke.deterministic():
            out["deterministic_px"] = largest(
                [trajectories() for _ in range(3)])
        loaded = predict.load_model(cfg, snap, torch.float32,
                                    torch.device("cuda"))
        reader = VideoReader(video)
        frames = np.stack([f for _, f in reader.iter_frames(0, 16)])
        reader.close()
        x = torch.from_numpy(frames).cuda()
        out["autotuned_head_logits"] = largest(
            [predict.forward_heads(loaded, x)["part_pred"].cpu().numpy()
             for _ in range(3)])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
