"""Evaluation: per-keypoint pixel RMSE on the train/test labeled frames.

Counterpart of ``deepgraphpose_tpu/evaluation/metrics.py`` (ref:
src/deepgraphpose/models/eval.py:656-813 evaluate_dgp;
deeplabcut/pose_estimation_tensorflow/evaluate.py:22-32 pairwisedistances
with pcutoff masking, 182-405 evaluate_network). ``evaluate_dgp`` runs on
``device`` (default: the card; without one this raises): the DGP decode
through ``infer.predict.infer_forward`` (the soft-argmax kernel on a CUDA
tensor), the DLC decode through ``ops.decode.argmax_pose_decode``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def pairwise_distances(pred_xy: np.ndarray, true_xy: np.ndarray,
                       likelihood: np.ndarray | None = None,
                       pcutoff: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Per (frame, joint) euclidean pixel error; optionally masked by pcutoff.

    Returns (rmse_all, rmse_pcutoff), each (n_frames, nj) with NaN where the
    ground truth is missing (or below the likelihood cutoff for the second).
    """
    d = np.sqrt(np.sum((pred_xy - true_xy) ** 2, axis=-1))
    rmse_all = d.copy()
    rmse_cut = d.copy()
    if likelihood is not None:
        rmse_cut[likelihood < pcutoff] = np.nan
    return rmse_all, rmse_cut


def load_evaluation_entries(dlcpath: Path, proj, cfg) -> list:
    """Full labeled set + train/test split: list of (image_path, xy, is_train).

    The reference evaluates over the FULL labeled table
    (training-datasets/.../CollectedData_<scorer>) and splits it by the
    Documentation pickle's train/test indices, which index that full table;
    the .mat itself holds train items only (ref: eval.py:723-736,
    auxiliaryfunctions.LoadMetadata). Falls back to .mat order (all-train)
    and then to the labeled-data CSVs when the trainingset files are absent.
    """
    from deepgraphpose_tpu_torch.data import project as project_io

    mat_path = dlcpath / cfg.dataset if cfg.dataset else None
    entries: list[tuple[Path, np.ndarray, bool]] = []
    full_table = None
    if mat_path and mat_path.exists():
        try:
            full_table = project_io.read_labels(mat_path.parent, proj.scorer)
        except FileNotFoundError:
            full_table = None
    if full_table is not None and cfg.metadataset and (
            dlcpath / cfg.metadataset).exists():
        _, train_idx, _, _ = project_io.read_documentation_pickle(
            dlcpath / cfg.metadataset)
        train_set = set(int(i) for i in np.asarray(train_idx).ravel())
        for i, (p, c) in enumerate(zip(full_table.image_paths,
                                       full_table.coords_xy)):
            entries.append((dlcpath / p, c, i in train_set))
    elif mat_path and mat_path.exists():
        ts = project_io.read_training_set(
            mat_path, dlcpath / cfg.metadataset if cfg.metadataset else None)
        coords = ts.coords_for(cfg.num_joints)
        train_set = set(int(i) for i in ts.train_indices)
        # the .mat holds train items only when the doc indices cover more
        for i, (p, c) in enumerate(zip(ts.image_paths, coords)):
            entries.append((dlcpath / p, c, i in train_set or
                            len(train_set) >= len(ts.image_paths)))
    else:
        for vdir in sorted((dlcpath / "labeled-data").glob("*")):
            try:
                labels = project_io.read_labels(vdir, proj.scorer)
            except FileNotFoundError:
                continue
            for p, c in zip(labels.image_paths, labels.coords_xy):
                ip = dlcpath / p
                if ip.exists():
                    entries.append((ip, c, True))
    if not entries:
        raise FileNotFoundError(f"no labeled data under {dlcpath}")
    return entries


def intersect_bodyparts(proj, comparisonbodyparts) -> list[int]:
    """Column indices of the requested bodyparts, in project order
    (ref: auxiliaryfunctions.IntersectionofBodyPartsandOnesGivenbyUser:
    'all' keeps every bodypart; a list is intersected with the project's,
    unknown names rejected)."""
    names = list(proj.bodyparts)
    if (comparisonbodyparts is None or comparisonbodyparts == "all"
            or comparisonbodyparts == ["all"]):
        return list(range(len(names)))
    wanted = ([comparisonbodyparts] if isinstance(comparisonbodyparts, str)
              else list(comparisonbodyparts))
    unknown = [b for b in wanted if b not in names]
    if unknown:
        raise ValueError(f"unknown bodyparts {unknown}; project has {names}")
    return [i for i, n in enumerate(names) if n in wanted]


def _read_images(entries, scale: float) -> tuple:
    """RGB images of the entries that decode, resized by ``scale``, with
    their coords, split flags, paths, per-image (x, y) factors from scaled
    to label pixels, and the image indices grouped by size."""
    import cv2

    by_size: dict[tuple[int, int], list[int]] = {}
    images, coords, is_train, image_paths, up = [], [], [], [], []
    for p, c, tr in entries:
        img = cv2.imread(str(p))
        if img is None:
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if scale != 1.0:
            h0, w0 = img.shape[:2]
            h1 = max(int(round(h0 * scale)), 1)
            w1 = max(int(round(w0 * scale)), 1)
            img = cv2.resize(img, (w1, h1))
            up.append((w0 / w1, h0 / h1))
        else:
            up.append((1.0, 1.0))
        by_size.setdefault(img.shape[:2], []).append(len(images))
        images.append(img)
        coords.append(c)
        is_train.append(tr)
        image_paths.append(p)
    return (images, np.asarray(coords), np.asarray(is_train), image_paths,
            np.asarray(up), by_size)


def evaluate_dgp(proj_cfg_file: str | Path, dgp_model_file: str | Path,
                 shuffle: int = 1, pcutoff: float | None = None,
                 compute_dtype=None, decode: str = "dgp",
                 quantize: bool | str = False, trainingsetindex: int = 0,
                 scale: float = 1.0, comparisonbodyparts="all",
                 device=None) -> dict:
    """RMSE against the human labels over the train/test split.

    Runs the model on every labeled image, batched per image size with the
    tail padded by its last image, and reports mean train/test pixel
    error. ``decode`` selects the reference's two modes (ref:
    eval.py:716-760): 'dgp' is the soft-argmax, 'dlc' the hard argmax +
    locref offset. ``compute_dtype`` (a torch dtype or its name; default
    pose_cfg's) is the model's. ``quantize=True`` evaluates the int8 model
    (``models/quant.py``) calibrated on the first 16 images of each size,
    ``"residual"`` with the int8 residual carry. ``scale`` runs inference
    on images resized by it and maps the predictions back, so the RMSE
    stays in ORIGINAL label pixels (ref: predict_videos.py:132-139, the
    cfg global_scale lever). Returns a dict with per-frame tables and
    summary scalars.
    """
    from deepgraphpose_tpu_torch.core.device import (resolve_device,
                                                     resolve_dtype)
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.prefetch import host_to_device
    from deepgraphpose_tpu_torch.infer.predict import (dlc_heads,
                                                       forward_heads,
                                                       load_model,
                                                       make_infer_fn)
    from deepgraphpose_tpu_torch.ops.decode import argmax_pose_decode

    device = resolve_device(device)
    dlcpath = Path(proj_cfg_file).parent
    proj, cfg, _ = resolve_project(dlcpath, shuffle, trainingsetindex)
    if pcutoff is None:
        pcutoff = proj.pcutoff
    # validate the bodypart subset before the inference loop; the indices
    # are reused for the summary below
    cols = intersect_bodyparts(proj, comparisonbodyparts)
    entries = load_evaluation_entries(dlcpath, proj, cfg)
    images, coords, is_train, image_paths, up, by_size = _read_images(
        entries, scale)

    dtype = resolve_dtype(compute_dtype if compute_dtype is not None
                          else cfg.compute_dtype)
    # the int8 model quantizes float32 weights, as the JAX package does
    float_model = load_model(cfg, dgp_model_file,
                             torch.float32 if quantize else dtype, device)

    pred_xy = np.full_like(coords, np.nan)
    lik = np.zeros(coords.shape[:2])
    for idxs in by_size.values():
        model = float_model
        if quantize:
            from deepgraphpose_tpu_torch.models.quant import quantize_model

            calib = np.stack([images[i] for i in idxs[:16]])
            model = quantize_model(cfg, float_model, calib, dtype=dtype,
                                   residual_int8=(quantize == "residual"))
        infer = make_infer_fn(model, cfg)
        heads = dlc_heads(model)
        bs = min(cfg.infer_batch_size, len(idxs))
        for s in range(0, len(idxs), bs):
            group = idxs[s:s + bs]
            arr = np.stack([images[i] for i in group])
            pad = bs - len(group)
            if pad:
                arr = np.concatenate([arr, arr[-1:].repeat(pad, 0)])
            arr = host_to_device(arr, device)
            if decode == "dlc":
                out = forward_heads(model, arr, heads=heads)
                xyl = argmax_pose_decode(
                    out["part_pred"], out.get("locref"), stride=cfg.stride,
                    locref_stdev=cfg.locref_stdev).cpu().numpy()
                for k, i in enumerate(group):
                    pred_xy[i] = xyl[k, :, :2] * up[i]
                    lik[i] = xyl[k, :, 2]
                continue
            mu, lk = infer(arr)
            mu = mu.cpu().numpy()
            lk = lk.cpu().numpy()
            for k, i in enumerate(group):
                pred_xy[i, :, 0] = (mu[k, :, 1] * cfg.stride
                                    + cfg.stride / 2) * up[i, 0]
                pred_xy[i, :, 1] = (mu[k, :, 0] * cfg.stride
                                    + cfg.stride / 2) * up[i, 1]
                lik[i] = lk[k]

    rmse_all, rmse_cut = pairwise_distances(pred_xy, coords, lik, pcutoff)
    # summary errors over the requested bodypart subset only (ref:
    # evaluate.py:158,367); the per-frame tables stay full-width
    rmse_sub = rmse_all[:, cols]
    rmse_cut_sub = rmse_cut[:, cols]
    out = {
        "pred_xy": pred_xy, "true_xy": coords, "likelihood": lik,
        "is_train": is_train, "image_paths": image_paths,
        "rmse": rmse_all, "rmse_pcutoff": rmse_cut,
        "bodypart_columns": cols,
        "train_error": float(np.nanmean(rmse_sub[is_train])),
        "test_error": (float(np.nanmean(rmse_sub[~is_train]))
                       if (~is_train).any() else float("nan")),
        "train_error_pcutoff": float(np.nanmean(rmse_cut_sub[is_train]))
        if np.isfinite(rmse_cut_sub[is_train]).any() else float("nan"),
    }
    print(f"[evaluate_dgp] train RMSE {out['train_error']:.2f} px, "
          f"test RMSE {out['test_error']:.2f} px")
    return out


def evaluate_network(config: str | Path, shuffle: int = 1,
                     trainingsetindex: int = 0,
                     snapshots: str | list | None = None,
                     pcutoff: float | None = None,
                     plotting: bool = False,
                     quantize: bool | str = False,
                     comparisonbodyparts="all",
                     rescale: bool = False,
                     device=None) -> list[dict]:
    """Evaluate one or all snapshots; appends to a combined results CSV.

    ref: deeplabcut/pose_estimation_tensorflow/evaluate.py:182-405
    (evaluate_network): iterates the chosen snapshots (config
    ``snapshotindex`` or 'all'), reports train/test pixel error with and
    without the pcutoff mask, and appends every row to
    ``evaluation-results/iteration-<i>/CombinedEvaluation-results.csv``.
    ``comparisonbodyparts`` restricts the reported errors to a bodypart
    subset (ref: evaluate.py:265). ``rescale=True`` evaluates at the
    pose_cfg ``global_scale`` resolution through ``evaluate_dgp(scale=)``
    (ref: evaluate.py:315-320); the errors stay in ORIGINAL label pixels,
    as the JAX package reports them. With ``plotting=True`` it also
    writes per-frame labeled evaluation images (ground truth '+',
    predictions '.'/'x' by pcutoff, train/test file prefixes) into
    ``LabeledImages_<snapshot>/`` next to the CSV (ref:
    evaluate.py:382-392); that needs matplotlib, whose absence raises
    ``ImportError`` before any evaluation.
    """
    import csv

    from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
    from deepgraphpose_tpu_torch.core.device import resolve_device
    from deepgraphpose_tpu_torch.core.paths import resolve_project

    if plotting:
        import matplotlib  # noqa: F401  (raises here where it is absent)

        from deepgraphpose_tpu_torch.infer.plotting import \
            plot_evaluation_frames
    device = resolve_device(device)
    config = Path(config)
    dlcpath = config.parent
    proj, pose_cfg, train_dir = resolve_project(dlcpath, shuffle,
                                                trainingsetindex)
    train_dir = Path(train_dir)
    scale = float(pose_cfg.global_scale) if rescale else 1.0
    if rescale:
        print(f"[evaluate_network] rescale=True: evaluating at "
              f"global_scale={scale} (errors stay in original pixels)")

    if snapshots is None:
        idx = proj.snapshotindex
        all_snaps = sorted(train_dir.glob(f"snapshot-*{ckpt_lib.CKPT_SUFFIX}"),
                           key=ckpt_lib._snapshot_iter)
        if not all_snaps:
            raise FileNotFoundError(f"no snapshots under {train_dir}")
        snaps = all_snaps if idx == "all" else [all_snaps[int(idx)]]
    elif isinstance(snapshots, str):
        snaps = [train_dir / f"{snapshots}{ckpt_lib.CKPT_SUFFIX}"]
    else:
        snaps = [train_dir / f"{s}{ckpt_lib.CKPT_SUFFIX}" for s in snapshots]

    results = []
    out_dir = dlcpath / "evaluation-results" / f"iteration-{proj.iteration}"
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / "CombinedEvaluation-results.csv"
    new = not csv_path.exists()
    with open(csv_path, "a", newline="") as f:
        wr = csv.writer(f)
        if new:
            wr.writerow(["snapshot", "shuffle", "train_fraction",
                         "train_error_px", "test_error_px",
                         "train_error_pcutoff_px", "pcutoff"])
        for snap in snaps:
            res = evaluate_dgp(config, snap, shuffle=shuffle,
                               pcutoff=pcutoff, quantize=quantize,
                               trainingsetindex=trainingsetindex,
                               scale=scale,
                               comparisonbodyparts=comparisonbodyparts,
                               device=device)
            res["snapshot"] = snap.stem
            results.append(res)
            if plotting:
                folder = out_dir / f"LabeledImages_{snap.stem}"
                written = plot_evaluation_frames(
                    res["image_paths"], res["true_xy"], res["pred_xy"],
                    res["likelihood"], res["is_train"], folder,
                    pcutoff=pcutoff if pcutoff is not None else proj.pcutoff,
                    dotsize=proj.dotsize, alpha=proj.alphavalue,
                    colormap=proj.colormap, bodyparts=proj.bodyparts)
                print(f"wrote {len(written)} labeled evaluation images "
                      f"to {folder}")
            wr.writerow([snap.stem, shuffle,
                         proj.TrainingFraction[trainingsetindex],
                         f"{res['train_error']:.3f}",
                         f"{res['test_error']:.3f}",
                         f"{res['train_error_pcutoff']:.3f}",
                         pcutoff if pcutoff is not None else proj.pcutoff])
    print(f"evaluation results appended to {csv_path}")
    return results


def write_evaluation_csv(out: dict, path: str | Path,
                         joints_names: list | None = None) -> None:
    """Persist the per-frame RMSE table (ref: evaluate.py results CSV)."""
    import csv

    rmse = out["rmse"]
    nj = rmse.shape[1]
    names = joints_names or [f"bp{i}" for i in range(nj)]
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["frame", "split"] + names)
        for i in range(rmse.shape[0]):
            wr.writerow([i, "train" if out["is_train"][i] else "test"]
                        + [f"{v:.3f}" if np.isfinite(v) else ""
                           for v in rmse[i]])
