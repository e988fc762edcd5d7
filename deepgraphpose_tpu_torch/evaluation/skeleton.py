"""Skeleton ("bone") analysis over analyzed trajectories.

Counterpart of ``deepgraphpose_tpu/evaluation/skeleton.py`` (ref:
deeplabcut/post_processing/analyze_skeleton.py:21-149: length, orientation
and likelihood (the smaller of the two joints') per skeleton edge and
frame; 151-216: analyzeskeleton, writing ``<vname><scorer>_skeleton.h5``
and .csv). Host numpy.
"""


from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core.config import ProjectConfig


def bone_statistics(labels: dict, bodyparts: list,
                    skeleton: list) -> dict:
    """Per-frame length/orientation/likelihood per skeleton edge.

    Returns {"<a>_<b>": {"length": (T,), "orientation_deg": (T,),
    "likelihood": (T,)}} — orientation in degrees, measured like the
    reference via arctan2(dy, dx) of the joint-1 -> joint-2 vector
    (ref: analyze_skeleton.py:96-117).
    """
    x = np.asarray(labels["x"], np.float64)
    y = np.asarray(labels["y"], np.float64)
    lik = np.asarray(labels["likelihoods"], np.float64)
    idx = {bp: i for i, bp in enumerate(bodyparts)}
    out = {}
    for a, b in skeleton:
        if a not in idx or b not in idx:
            continue
        ia, ib = idx[a], idx[b]
        dx = x[:, ib] - x[:, ia]
        dy = y[:, ib] - y[:, ia]
        out[f"{a}_{b}"] = {
            "length": np.hypot(dx, dy),
            "orientation_deg": np.degrees(np.arctan2(dy, dx)),
            "likelihood": np.minimum(lik[:, ia], lik[:, ib]),
        }
    return out


def analyzeskeleton(config: str | Path, videos: list, shuffle: int = 1,
                    save_as_csv: bool = True,
                    destfolder: str | Path | None = None,
                    scorer: str | None = None) -> list[Path]:
    """Compute bone stats for each analyzed video; writes
    ``<vname><scorer>_skeleton.h5`` (+ .csv)."""
    import h5py

    from deepgraphpose_tpu_torch.infer.export import read_pose_table

    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    skeleton = proj.skeleton or []
    if not skeleton:
        print("config has no skeleton; nothing to analyze")
        return []
    written = []
    for video in videos:
        video = Path(video)
        folder = Path(destfolder) if destfolder else video.parent
        if scorer is not None:
            cands = [folder / f"{video.stem}{scorer}.h5"]
        else:
            cands = [c for c in sorted(folder.glob(f"{video.stem}DLC_*.h5"))
                     if not (c.stem.endswith("filtered")
                             or c.stem.endswith("_skeleton"))]
        if not cands or not cands[-1].exists():
            print(f"no analysis for {video.stem}; run analyze_videos first")
            continue
        sc, bps, labels, _ = read_pose_table(cands[-1])
        bones = bone_statistics(labels, bps, skeleton)
        dst = folder / (cands[-1].stem + "_skeleton.h5")
        with h5py.File(dst, "w") as f:
            for name, stats in bones.items():
                g = f.create_group(name)
                for k, v in stats.items():
                    g.create_dataset(k, data=v)
        if save_as_csv:
            with open(dst.with_suffix(".csv"), "w") as f:
                cols = [f"{n}_{k}" for n in bones
                        for k in ("length", "orientation_deg", "likelihood")]
                f.write("frame," + ",".join(cols) + "\n")
                T = len(next(iter(bones.values()))["length"])
                for t in range(T):
                    row = [f"{bones[n][k][t]:.6g}" for n in bones
                           for k in ("length", "orientation_deg",
                                     "likelihood")]
                    f.write(f"{t}," + ",".join(row) + "\n")
        written.append(dst)
        print(f"skeleton stats for {video.stem} -> {dst.name} "
              f"({len(bones)} bones)")
    return written
