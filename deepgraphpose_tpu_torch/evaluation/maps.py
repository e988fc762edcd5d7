"""Scoremap and training-target visualization for labeled frames.

The port's own copy of ``deepgraphpose_tpu/evaluation/maps.py``
(ref: deeplabcut/pose_estimation_tensorflow/visualizemaps.py
extract_save_all_maps, vis_dataset.py display_dataset).

:func:`labeled_scoremaps` runs the network over the labeled frames on the
card: the model's part_pred head, its sigmoid, and the soft-argmax through
the decode kernel (``ops/kernels/softargmax_kernel.py``; the plain version
on the CPU). :func:`extract_save_all_maps` draws its output, and
:func:`display_dataset` the rasterized training targets, with matplotlib
(Agg backend), which they import before any work: without it they raise
``ImportError``, as the JAX package's do.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.infer.plotting import _pyplot


def _labeled_entries(dlcpath: Path, proj, indices) -> list:
    """[(image path, (nj, 2) label coords)] of the project's labeled
    frames, optionally the ``indices`` subset."""
    from deepgraphpose_tpu_torch.data import project as project_io

    entries = []
    for vdir in sorted((dlcpath / "labeled-data").glob("*")):
        if not vdir.is_dir() or vdir.name.endswith("_labeled"):
            continue
        try:
            labels = project_io.read_labels(vdir, proj.scorer)
        except FileNotFoundError:
            continue
        entries.extend((dlcpath / p, c)
                       for p, c in zip(labels.image_paths, labels.coords_xy))
    if indices is not None:
        entries = [entries[i] for i in indices if i < len(entries)]
    if not entries:
        raise FileNotFoundError(f"no labeled images under {dlcpath}")
    return entries


def _panel_grid(plt, nj: int):
    ncol = min(nj + 1, 4)
    nrow = -(-(nj + 1) // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 2.6 * nrow))
    return fig, np.atleast_1d(axes).reshape(-1)


def labeled_scoremaps(config: str | Path, shuffle: int = 1,
                      indices: list | None = None,
                      snapshot: str | None = None, device=None):
    """Yield (image path, RGB image, sigmoid scoremaps (h, w, nj), mu
    (nj, 2) (row, col) in scoremap cells) for (a subset of) the labeled
    frames, from ``snapshot`` (default: the newest) in float32 on
    ``device`` (default: the card)."""
    import cv2
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
    from deepgraphpose_tpu_torch.core.device import resolve_device
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.infer.predict import (forward_heads,
                                                       load_model)
    from deepgraphpose_tpu_torch.ops.kernels.softargmax_kernel import \
        softargmax_likelihood

    device = resolve_device(device)
    config = Path(config)
    dlcpath = config.parent
    proj, cfg, train_dir = resolve_project(dlcpath, shuffle)
    if snapshot:
        snap = Path(train_dir) / f"{snapshot}{ckpt_lib.CKPT_SUFFIX}"
    else:
        snap = ckpt_lib.latest_snapshot(train_dir)
    if snap is None or not Path(snap).exists():
        raise FileNotFoundError(f"no snapshot under {train_dir}")
    entries = _labeled_entries(dlcpath, proj, indices)
    model = load_model(cfg, snap, torch.float32, device)
    for ip, _ in entries:
        img = cv2.imread(str(ip))
        if img is None:
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        images = torch.from_numpy(img[None]).to(device)
        pred = forward_heads(model, images)["part_pred"]
        mu, _ = softargmax_likelihood(pred, cfg.gamma, cfg.gauss_len)
        yield (ip, img, torch.sigmoid(pred)[0].cpu().numpy(),
               mu[0].cpu().numpy())


def extract_save_all_maps(config: str | Path, shuffle: int = 1,
                          indices: list | None = None,
                          dest_folder: str | Path | None = None,
                          snapshot: str | None = None,
                          device=None) -> list[Path]:
    """Save scoremap grids for (a subset of) the labeled frames: the image,
    then each bodypart's sigmoid scoremap with its soft-argmax marked.

    Writes ``<project>/maps/<image-stem>_scmap.png`` (or into
    ``dest_folder``); returns the paths.
    """
    from deepgraphpose_tpu_torch.core.paths import resolve_project

    plt = _pyplot()
    config = Path(config)
    _, cfg, _ = resolve_project(config.parent, shuffle)
    out_dir = Path(dest_folder) if dest_folder else config.parent / "maps"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = cfg.all_joints_names or [f"bp{i}"
                                     for i in range(cfg.num_joints)]
    written = []
    for ip, img, scmap, mu in labeled_scoremaps(config, shuffle, indices,
                                                snapshot, device):
        nj = scmap.shape[-1]
        fig, axes = _panel_grid(plt, nj)
        axes[0].imshow(img)
        axes[0].set_title("image", fontsize=8)
        for j in range(nj):
            ax = axes[j + 1]
            ax.imshow(scmap[:, :, j], vmin=0, vmax=1, cmap="viridis")
            ax.plot(mu[j, 1], mu[j, 0], "r+", ms=8)
            ax.set_title(names[j], fontsize=8)
        for ax in axes:
            ax.axis("off")
        out = out_dir / f"{ip.stem}_scmap.png"
        fig.tight_layout()
        fig.savefig(out, dpi=100)
        plt.close(fig)
        written.append(out)
    print(f"wrote {len(written)} scoremap grids to {out_dir}")
    return written


def display_dataset(config: str | Path, shuffle: int = 1,
                    indices: list | None = None,
                    dest_folder: str | Path | None = None) -> list[Path]:
    """Visualize the raw training-dataset TARGET scoremaps (no network):
    per labeled image, a panel grid overlaying each joint's rasterized disk
    target on the image (ref: pose_estimation_tensorflow/vis_dataset.py
    display_dataset; headless PNG files here). The targets come from the
    rasterizer the trainer trains against (``ops/targets.py``), on the CPU.

    Writes ``<project>/maps/<image-stem>_targets.png``; returns the paths.
    """
    import cv2
    import torch

    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.ops.targets import dlc_scoremap_targets

    plt = _pyplot()
    config = Path(config)
    dlcpath = config.parent
    proj, cfg, _ = resolve_project(dlcpath, shuffle)
    names = cfg.all_joints_names or [f"bp{i}"
                                     for i in range(cfg.num_joints)]
    s = cfg.global_scale
    stride = cfg.stride
    entries = _labeled_entries(dlcpath, proj, indices)
    out_dir = Path(dest_folder) if dest_folder else dlcpath / "maps"
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for ip, coords in entries:
        img = cv2.imread(str(ip))
        if img is None:
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if s != 1.0:
            img = cv2.resize(img, None, fx=s, fy=s)
        h, w = img.shape[:2]
        sh, sw = -(-h // int(stride)), -(-w // int(stride))
        coords = np.asarray(coords)
        present = ~np.isnan(coords[:, 0])
        scmap, _, _ = dlc_scoremap_targets(
            torch.from_numpy((coords[None] * s).astype(np.float32)),
            torch.from_numpy(present[None]), sh, sw, stride,
            cfg.pos_dist_thresh, cfg.locref_stdev, scale=s)
        scmap = scmap[0].numpy()

        nj = scmap.shape[-1]
        fig, axes = _panel_grid(plt, nj)
        axes[0].imshow(img)
        axes[0].set_title("image", fontsize=8)
        for j in range(nj):
            ax = axes[j + 1]
            ax.imshow(img, extent=(0, w, h, 0))
            up = cv2.resize(scmap[:, :, j], (w, h),
                            interpolation=cv2.INTER_NEAREST)
            ax.imshow(up, alpha=0.5, vmin=0, vmax=1, cmap="viridis",
                      extent=(0, w, h, 0))
            ax.set_title(names[j], fontsize=8)
        for ax in axes:
            ax.axis("off")
        out = out_dir / f"{ip.stem}_targets.png"
        fig.tight_layout()
        fig.savefig(out, dpi=100)
        plt.close(fig)
        written.append(out)
    print(f"wrote {len(written)} target grids to {out_dir}")
    return written
