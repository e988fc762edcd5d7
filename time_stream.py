#!/usr/bin/env python3
"""Time estimate_pose_multichip at one rank and at two ranks on one card.

Run on a machine with an NVIDIA GPU:

    python3 time_stream.py [--frames 960]

Makes the port's synthetic project at 747x832 (MJPEG video of --frames
frames, 5 joints) with a seeded random ResNet-50 snapshot, in a temporary
directory, then measures on one card:

* the video's decode alone on the host, frames/s of the frames read:
  in order; as each of two ranks reads a slice of every super-batch (16
  frames, then a seek past the other rank's 16); as each of two ranks
  reads its half of the video (one seek), as ``estimate_pose_multichip``
  does;
* ``estimate_pose_multichip`` in bfloat16 with 16 frames a rank, raw, as
  it prints its loop's frames/s, each run in fresh processes (this
  script started again with ``--rank``): one rank (NCCL) and two ranks
  (gloo, both on cuda:0), in turns one, two, two, one.

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FPD = 16
TIMEOUT = 600


def make_project(workdir: Path, frames: int) -> list:
    """[config.yaml, snapshot, video] of the timed project."""
    import torch

    import chip_smoke as smoke
    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.models.pose_model import init_model
    from deepgraphpose_tpu_torch.utils.synthetic import make_synthetic_project

    root, _, _ = make_synthetic_project(
        workdir / "project", n_frames=frames, n_labeled=smoke.FIT_LABELED,
        hw=smoke.HW, nj=smoke.NUM_JOINTS, seed=smoke.SEED)
    root = Path(root)
    _, cfg, train_dir = resolve_project(root)
    cfg.net_type = "resnet_50"
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    snap = checkpoint.save_snapshot(train_dir, 2, "time", init_model(
        cfg, torch.Generator().manual_seed(smoke.SEED), device="cpu"))
    return [str(root / "config.yaml"), str(snap),
            str(root / "videos" / "synthvid.avi")]


def decode_rates(video: str) -> dict:
    """Frames/s of the host decode: in order, and in each of two ranks'
    patterns (slices of every super-batch; a span)."""
    from deepgraphpose_tpu_torch.data.video import VideoReader

    out = {}
    for name in ("in_order", "slices_rank0_of_2", "slices_rank1_of_2",
                 "span_rank0_of_2", "span_rank1_of_2"):
        reader = VideoReader(video)
        n = reader.n_frames
        rank = int(name[-6]) if "rank" in name else 0
        if name.startswith("slices"):
            parts = [(lo, min(lo + FPD, n))
                     for lo in range(rank * FPD, n, 2 * FPD)]
        elif name.startswith("span"):
            half = -(-n // 2)
            parts = [(rank * half, min((rank + 1) * half, n))]
        else:
            parts = [(0, n)]
        t0 = time.perf_counter()
        read = sum(1 for lo, hi in parts for _ in reader.iter_frames(lo, hi))
        out[name] = read / (time.perf_counter() - t0)
        reader.close()
    return out


def stream_rate(project: list, group) -> float:
    """estimate_pose_multichip's printed frames/s in ``group`` (rank 0
    prints; None on the others)."""
    from deepgraphpose_tpu_torch.parallel.streaming import \
        estimate_pose_multichip

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        estimate_pose_multichip(*project, Path(project[0]).parent / "pred",
                                mesh=group, frames_per_device=FPD,
                                save_pose=False, compute_dtype="bfloat16")
    rate = re.search(r"= ([\d.]+) frames/s", printed.getvalue())
    return float(rate.group(1)) if rate else None


def rank_main(args) -> int:
    import torch.distributed as dist

    from deepgraphpose_tpu_torch.parallel import distributed, mesh

    device = distributed.initialize(f"127.0.0.1:{args.port}", args.world,
                                    args.rank)
    group = mesh.make_mesh(device=device)
    project = json.loads(Path(args.workdir, "project.json").read_text())
    rate = stream_rate(project, group)
    print(json.dumps({"rank": args.rank, "backend": dist.get_backend(),
                      "frames_per_s": rate}), flush=True)
    dist.destroy_process_group()
    return 0


def ranks_rate(workdir: Path, world: int) -> dict:
    """Rank 0's printed frames/s of a run over ``world`` fresh processes,
    and its backend."""
    import chip_smoke as smoke

    port = smoke.free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "--world", str(world), "--port", str(port), "--workdir",
         str(workdir)], cwd=str(HERE), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(o[-3000:]
                                                          for o in outs))
    lines = [json.loads(ln) for ln in outs[0].splitlines()
             if ln.startswith('{"rank"')]
    if not lines:
        raise RuntimeError(f"rank 0 said: {outs[0][-3000:]}")
    return {"ranks": world, "backend": lines[-1]["backend"],
            "frames_per_s": lines[-1]["frames_per_s"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=960)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--workdir", default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("time_stream.py: CUDA is not available", file=sys.stderr)
        return 1
    if args.rank is not None:
        return rank_main(args)
    import chip_smoke as smoke

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        t0 = time.perf_counter()
        project = make_project(workdir, args.frames)
        made_s = time.perf_counter() - t0
        (workdir / "project.json").write_text(json.dumps(project))
        decode = decode_rates(project[2])
        runs = [ranks_rate(workdir, world) for world in (1, 2, 2, 1)]
    print(json.dumps({"phase": "time_stream", "card": smoke.card_line(),
                      "frames": args.frames, "hw": list(smoke.HW),
                      "frames_per_device": FPD, "dtype": "bfloat16",
                      "project_s": made_s, "decode_frames_per_s": decode,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
