"""DeepGraphPose demo pipeline on the port.

The port's twin of ``demo/run_dgp_demo.py`` (ref: demo/run_dgp_demo.py:
114-310): steps 0 (DLC warm-start) -> 1 (DGP labeled-only) -> 2 (full DGP)
-> 3 (predict every video in videos_dgp/ with ``plot_dgp``: the DLC
CSV/H5 export and the labeled MP4 in videos_pred/), with ``--test``
truncating iterations (2/2/5) and videos (10 s).

Usage (on the card; ``--device cpu`` runs on the CPU):
  python -m deepgraphpose_tpu_torch.demo --dlcpath <project> [--shuffle 1]
      [--dlcsnapshot <name>] [--batch_size 10] [--test]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dlcpath", type=str, required=True,
                        help="path to the DLC project folder")
    parser.add_argument("--dlcsnapshot", type=str, default=None,
                        help="use a prefit DLC snapshot and skip step 0")
    parser.add_argument("--shuffle", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--test", action="store_true",
                        help="tiny iteration counts + clipped videos")
    parser.add_argument("--maxiters", type=int, default=None)
    parser.add_argument("--wt", type=float, default=0.0,
                        help="temporal clique weight")
    parser.add_argument("--gm2", type=int, default=0)
    parser.add_argument("--gm3", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from deepgraphpose_tpu_torch.core import paths as paths_lib
    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.infer.video_writer import plot_dgp
    from deepgraphpose_tpu_torch.train.fit import (fit_dgp,
                                                   fit_dgp_labeledonly,
                                                   fit_dlc, resolve_project)

    dlcpath = Path(args.dlcpath)
    _, _, train_dir = resolve_project(dlcpath, args.shuffle)
    if args.test:
        it0, it1, it2 = 2, 2, 5
        display = 1
    else:
        it0 = it1 = args.maxiters or 200000
        it1 = min(it1, 50000)
        it2 = args.maxiters or 200000
        display = 100

    if args.dlcsnapshot is None:
        print("\n=== step 0: fit_dlc ===", flush=True)
        fit_dlc(dlcpath=dlcpath, shuffle=args.shuffle, maxiters=it0,
                displayiters=display, saveiters=max(it0 // 2, 1),
                device=args.device)
        snapshot0 = "snapshot-step0-final--0"
    else:
        snapshot0 = args.dlcsnapshot

    print("\n=== step 1: fit_dgp_labeledonly ===", flush=True)
    fit_dgp_labeledonly(snapshot=snapshot0, dlcpath=dlcpath,
                        shuffle=args.shuffle, maxiters=it1,
                        displayiters=display, saveiters=max(it1 // 2, 1),
                        nepoch=1 if args.test else 100, device=args.device)

    print("\n=== step 2: fit_dgp ===", flush=True)
    fit_dgp(snapshot="snapshot-step1-final--0", dlcpath=dlcpath,
            batch_size=args.batch_size, shuffle=args.shuffle,
            maxiters=it2, displayiters=display,
            saveiters=max(it2 // 2, 1), wt=args.wt, gm2=args.gm2,
            gm3=args.gm3, nepoch=1 if args.test else 100,
            device=args.device)
    snapshot_path = train_dir / "snapshot-step2-final--0.ckpt"

    print("\n=== step 3: predict videos ===", flush=True)
    out_dir = paths_lib.videos_pred_dir(dlcpath)
    for video in paths_lib.list_videos(paths_lib.videos_dgp_dir(dlcpath)):
        max_frames = None
        if args.test:
            reader = VideoReader(video)
            max_frames = int(min(reader.n_frames, reader.fps * 10))
            reader.close()
        print(f"predicting {video}", flush=True)
        plot_dgp(video, out_dir, dlcpath / "config.yaml", snapshot_path,
                 shuffle=args.shuffle, max_frames=max_frames,
                 device=args.device)
    print("\ndemo complete", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
