"""Trajectory plots, labeled evaluation frames and label checking.

The port's own copy of ``deepgraphpose_tpu/infer/plotting.py`` (ref:
deeplabcut/utils/plotting.py plot_trajectories,
generate_training_dataset/trainingsetmanipulation.py:262-343 check_labels,
deeplabcut/utils/visualization.py PlottingandSaveLabeledFrame). Host code:
matplotlib with the Agg backend (headless), imported where a figure is
drawn, so the module imports on a host without it and a call there raises
``ImportError``, as the JAX package's does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _colors(n: int, cmap_name: str = "jet"):
    cmap = _pyplot().get_cmap(cmap_name)
    return [cmap(i / max(n - 1, 1)) for i in range(n)]


def plot_trajectories(config: str | Path, videos: list, shuffle: int = 1,
                      filtered: bool = False, pcutoff: float | None = None,
                      destfolder: str | Path | None = None,
                      scorer: str | None = None) -> list[Path]:
    """Per-video 4-panel figure: trajectory map, x/y vs time, likelihood.

    Reads the analyze_videos H5 next to each video (or in ``destfolder``);
    writes ``<vname>_trajectories.png`` into ``plot-poses/<vname>/`` under
    the project (reference layout).
    """
    plt = _pyplot()

    from deepgraphpose_tpu_torch.core.config import ProjectConfig
    from deepgraphpose_tpu_torch.infer.export import read_pose_table

    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    project_path = Path(proj.project_path or config.parent)
    if pcutoff is None:
        pcutoff = proj.pcutoff
    written = []
    for video in videos:
        video = Path(video)
        folder = Path(destfolder) if destfolder else video.parent
        suffix = "filtered" if filtered else ""
        if scorer is not None:
            cands = [folder / f"{video.stem}{scorer}{suffix}.h5"]
        else:
            cands = [c for c in sorted(folder.glob(
                f"{video.stem}DLC_*{suffix}.h5"))
                if c.stem.endswith("filtered") == filtered]
        if not cands or not cands[-1].exists():
            print(f"no analysis for {video.stem}; run analyze_videos first")
            continue
        sc, bps, labels, _ = read_pose_table(cands[-1])
        colors = _colors(len(bps), proj.colormap)

        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        for j, bp in enumerate(bps):
            x = labels["x"][:, j]
            y = labels["y"][:, j]
            p = labels["likelihoods"][:, j]
            m = p >= pcutoff
            axes[0, 0].plot(np.where(m, x, np.nan),
                            np.where(m, y, np.nan),
                            color=colors[j], label=bp, lw=1)
            axes[0, 1].plot(np.where(m, x, np.nan), color=colors[j], lw=1)
            axes[1, 0].plot(np.where(m, y, np.nan), color=colors[j], lw=1)
            axes[1, 1].plot(p, color=colors[j], lw=1)
        axes[0, 0].set_title("trajectory (x, y)")
        axes[0, 0].invert_yaxis()
        axes[0, 1].set_title("x over time")
        axes[1, 0].set_title("y over time")
        axes[1, 1].set_title("likelihood")
        axes[0, 0].legend(fontsize=7)
        fig.suptitle(f"{video.stem} — {sc}")
        outdir = project_path / "plot-poses" / video.stem
        outdir.mkdir(parents=True, exist_ok=True)
        out = outdir / f"{video.stem}_trajectories.png"
        fig.savefig(out, dpi=120)
        plt.close(fig)
        written.append(out)
        print(f"wrote {out}")
    return written


def plot_evaluation_frames(image_paths, true_xy, pred_xy, likelihood,
                           is_train, out_folder: str | Path,
                           pcutoff: float = 0.4, dotsize: float = 8,
                           alpha: float = 0.7, colormap: str = "jet",
                           bodyparts: list | None = None) -> list[Path]:
    """Per-frame labeled evaluation images with train/test file prefixes
    (ref: deeplabcut/pose_estimation_tensorflow/evaluate.py:34-39 Plotting,
    deeplabcut/utils/visualization.py:69-87): ground truth as '+',
    predictions as '.' when likelihood >= pcutoff and 'x' below it, one
    color per bodypart, files named ``Training-<folder>-<image>`` /
    ``Test-<folder>-<image>``.
    """
    import cv2

    plt = _pyplot()
    out_folder = Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)
    nj = np.asarray(true_xy).shape[1]
    colors = _colors(nj, colormap)
    written = []
    for i, p in enumerate(image_paths):
        p = Path(p)
        img = cv2.imread(str(p))
        if img is None:
            continue
        h, w = img.shape[:2]
        fig, ax = plt.subplots(figsize=(w / 100, h / 100))
        ax.imshow(img[..., ::-1])
        for j in range(nj):
            tx, ty = true_xy[i, j]
            if np.isfinite(tx) and np.isfinite(ty):
                ax.plot(tx, ty, "+", color=colors[j], ms=dotsize,
                        mew=2, alpha=alpha)
            px, py = pred_xy[i, j]
            if np.isfinite(px) and np.isfinite(py):
                marker = "." if likelihood[i, j] >= pcutoff else "x"
                ax.plot(px, py, marker, color=colors[j], ms=dotsize,
                        alpha=alpha)
        ax.set_xlim(0, w)
        ax.set_ylim(h, 0)
        ax.axis("off")
        prefix = "Training" if is_train[i] else "Test"
        out = out_folder / f"{prefix}-{p.parts[-2]}-{p.name}"
        fig.savefig(out, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(out)
    return written


def check_labels(config: str | Path, scale: float = 1.0) -> list[Path]:
    """Draw the human labels onto each labeled frame
    (ref: trainingsetmanipulation.py:262-343): writes
    ``labeled-data/<video>_labeled/`` PNGs for visual inspection."""
    import cv2

    from deepgraphpose_tpu_torch.core.config import ProjectConfig
    from deepgraphpose_tpu_torch.data import project as project_io

    plt = _pyplot()
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    project_path = Path(proj.project_path or config.parent)
    colors = _colors(len(proj.bodyparts), proj.colormap)
    written = []
    for vdir in sorted((project_path / "labeled-data").glob("*")):
        if not vdir.is_dir() or vdir.name.endswith("_labeled"):
            continue
        try:
            labels = project_io.read_labels(vdir, proj.scorer)
        except FileNotFoundError:
            continue
        outdir = vdir.parent / f"{vdir.name}_labeled"
        outdir.mkdir(exist_ok=True)
        for p, c in zip(labels.image_paths, labels.coords_xy):
            img = cv2.imread(str(project_path / p))
            if img is None:
                continue
            fig, ax = plt.subplots(figsize=(img.shape[1] / 100 * scale,
                                            img.shape[0] / 100 * scale))
            ax.imshow(img[..., ::-1])
            for j, (x, y) in enumerate(np.atleast_2d(c)):
                if np.isfinite(x) and np.isfinite(y):
                    ax.plot(x, y, "+", color=colors[j],
                            ms=proj.dotsize, mew=2)
            ax.axis("off")
            out = outdir / Path(p).name
            fig.savefig(out, dpi=100, bbox_inches="tight")
            plt.close(fig)
            written.append(out)
        print(f"checked labels for {vdir.name}: {outdir}")
    return written
