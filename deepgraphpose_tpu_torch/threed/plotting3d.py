"""3-D trajectory visualization.

The port's own copy of ``deepgraphpose_tpu/threed/plotting3d.py``: host code
(numpy, OpenCV), no model and no device.

ref: deeplabcut/pose_estimation_3d/plotting3D.py:26-155
(create_labeled_video_3d): per-frame 3-D scatter + skeleton edges rendered
with matplotlib, stitched into a video. Headless (Agg) here; frames are
rasterized via the figure canvas and written with OpenCV.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def plot_trajectories_3d(xyz: np.ndarray, bodyparts: list,
                         out_file: str | Path,
                         skeleton: list | None = None,
                         view: tuple = (-113, -270)) -> Path:
    """Static 3-D trajectory figure (one line per bodypart)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    cmap = plt.get_cmap("jet")
    nj = xyz.shape[1]
    for j, bp in enumerate(bodyparts):
        ax.plot(xyz[:, j, 0], xyz[:, j, 1], xyz[:, j, 2],
                color=cmap(j / max(nj - 1, 1)), lw=1, label=bp)
    ax.view_init(*view)
    ax.legend(fontsize=7)
    fig.savefig(out_file, dpi=120)
    plt.close(fig)
    return Path(out_file)


def create_labeled_video_3d(config3d: str | Path, xyz: np.ndarray,
                            bodyparts: list, out_file: str | Path,
                            fps: float = 20.0, trailpoints: int = 0,
                            draw_skeleton: bool = True,
                            view: tuple = (-113, -270),
                            start: int = 0, end: int | None = None) -> Path:
    """Render the 3-D pose per frame into a video
    (ref: plotting3D.py:26-155)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import yaml

    with open(config3d) as f:
        cfg = yaml.safe_load(f)
    skeleton = cfg.get("skeleton") or []
    idx = {bp: j for j, bp in enumerate(bodyparts)}

    end = end if end is not None else xyz.shape[0]
    finite = xyz[np.isfinite(xyz).all(axis=-1)]
    if finite.size == 0:
        raise ValueError("no finite 3-D points to plot")
    lo, hi = finite.min(axis=0), finite.max(axis=0)
    pad = 0.05 * (hi - lo + 1e-9)

    from deepgraphpose_tpu_torch.data.video import write_video

    cmap = plt.get_cmap("jet")
    nj = xyz.shape[1]
    out_file = Path(out_file)

    def render(t):
        fig = plt.figure(figsize=(6, 5))
        ax = fig.add_subplot(projection="3d")
        if trailpoints > 0:
            t0 = max(start, t - trailpoints)
            for j in range(nj):
                ax.plot(xyz[t0:t + 1, j, 0], xyz[t0:t + 1, j, 1],
                        xyz[t0:t + 1, j, 2],
                        color=cmap(j / max(nj - 1, 1)), lw=0.8, alpha=0.5)
        for j in range(nj):
            if np.isfinite(xyz[t, j]).all():
                ax.scatter(*xyz[t, j], color=cmap(j / max(nj - 1, 1)), s=25)
        if draw_skeleton:
            for a, b in skeleton:
                if a in idx and b in idx:
                    pa, pb = xyz[t, idx[a]], xyz[t, idx[b]]
                    if np.isfinite(pa).all() and np.isfinite(pb).all():
                        ax.plot(*np.stack([pa, pb]).T,
                                color=cfg.get("skeleton_color", "black"),
                                lw=1)
        ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
        ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
        ax.set_zlim(lo[2] - pad[2], hi[2] + pad[2])
        ax.view_init(*view)
        fig.canvas.draw()
        # copy: the canvas buffer is reused after plt.close
        frame = np.array(fig.canvas.buffer_rgba())[..., :3]
        plt.close(fig)
        return frame

    first = render(start)
    write_video(out_file,
                (first if t == start else render(t)
                 for t in range(start, end)),
                fps, (first.shape[1], first.shape[0]))
    return out_file
