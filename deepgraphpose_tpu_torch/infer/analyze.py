"""DLC-style ``analyze_videos``: scorer-named trajectory export.

Counterpart of ``deepgraphpose_tpu/infer/analyze.py`` (ref:
deeplabcut/pose_estimation_tensorflow/predict_videos.py:35-526
analyze_videos / AnalyzeVideo, utils/auxiliaryfunctions.py:349-378
GetScorerName). Inference runs on the port's batched streaming entry
points: ``infer.predict.estimate_pose`` (full frame, crop, scale, int8),
``infer.dynamic.estimate_pose_dynamic_video`` (the tracked crop) and
``infer.predict.make_multi_infer_fn`` (the top-k decode). Each entry point
takes ``device`` (default: the card; without one this raises).

Output contract per video (destfolder defaults to the video's directory):
  <vname><DLCscorer>.h5               the h5py table of ``infer/export.py``
  <vname><DLCscorer>.csv              if save_as_csv
  <vname><DLCscorer>includingmetadata.pickle
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
from deepgraphpose_tpu_torch.core import paths as paths_lib
from deepgraphpose_tpu_torch.core.config import PoseConfig, ProjectConfig
from deepgraphpose_tpu_torch.core.device import resolve_device, resolve_dtype


def get_scorer_name(proj: ProjectConfig, pose_cfg: PoseConfig, shuffle: int,
                    trainingsiterations="unknown") -> tuple[str, str]:
    """(DLC scorer, legacy scorer) (ref: auxiliaryfunctions.py:349-378)."""
    if "resnet" in pose_cfg.net_type:
        netname = pose_cfg.net_type.replace("_", "")
    else:
        netname = "mobnet_" + str(
            int(float(pose_cfg.net_type.split("_")[-1]) * 100))
    tail = f"{proj.Task}{proj.date}shuffle{shuffle}_{trainingsiterations}"
    return f"DLC_{netname}_{tail}", f"DeepCut_{netname}_{tail}"


def _resolve_snapshot(train_dir: Path, proj: ProjectConfig,
                      snapshot: str | None) -> tuple[Path, str]:
    """(snapshot path, trainingsiterations string).

    ``proj.snapshotindex`` indexes the step-2 (DGP) snapshots first, then
    steps 1 and 0, then any (ref: predict_videos.py:142-158 sorts
    snapshots by iteration and indexes with cfg['snapshotindex'])."""
    if snapshot is not None:
        p = train_dir / f"{snapshot}{ckpt_lib.CKPT_SUFFIX}"
        if not p.exists():
            raise FileNotFoundError(p)
        return p, p.stem.split("-")[-1]
    for step in (2, 1, 0, None):
        prefix = f"snapshot-step{step}-" if step is not None else "snapshot-"
        pattern = f"{prefix}*{ckpt_lib.CKPT_SUFFIX}"
        snaps = sorted(train_dir.glob(pattern))
        if snaps:
            snaps = sorted(snaps, key=ckpt_lib._snapshot_iter)
            idx = proj.snapshotindex if proj.snapshotindex != "all" else -1
            p = snaps[int(idx)]
            return p, p.stem.split("-")[-1]
    raise FileNotFoundError(
        f"no snapshots under {train_dir}; train the network first")


def _video_files(videos: list, videotype: str) -> list[Path]:
    """Files as given; directories expanded to their videos, filtered by
    ``videotype`` (ref: predict_videos.py:528-555 GetVideoList)."""
    files: list[Path] = []
    vt = videotype.lower().lstrip(".")
    for v in videos:
        p = Path(v)
        if p.is_dir():
            files.extend(
                Path(f) for f in paths_lib.list_videos(p)
                if not vt or Path(f).suffix.lower().lstrip(".") == vt)
        elif p.exists():
            files.append(p)
        else:
            print(f"warning: video {p} not found; skipping")
    return files


def analyze_videos(config: str | Path, videos: list, videotype: str = "",
                   shuffle: int = 1,
                   trainingsetindex: int = 0, save_as_csv: bool = True,
                   destfolder: str | Path | None = None,
                   batchsize: int | None = None,
                   snapshot: str | None = None,
                   cropping: tuple | None = None,
                   num_outputs: int = 1,
                   max_frames: int | None = None,
                   quantize: bool | str | None = None,
                   scale: float | None = None,
                   preset: str | None = None,
                   dynamic: tuple = (False, 0.5, 10),
                   device=None) -> str:
    """Analyze every video; returns the DLC scorer string.

    ``videos`` may hold files or directories (every video inside, filtered
    by ``videotype``). A video whose ``<vname><scorer>.h5`` (or the legacy
    ``DeepCut`` name) exists in the destination is skipped.
    ``cropping=(x1, x2, y1, y2)`` crops every frame before inference;
    coordinates come back in full-frame pixels.
    ``dynamic=(state, detectiontreshold, margin)`` is the reference's
    dynamic-cropping switch (ref: predict_videos.py:37,90-101
    GetPoseDynamic); here it runs the batched fixed-size tracker
    (``infer/dynamic.py``). ``num_outputs > 1`` writes the top
    ``num_outputs`` peaks of each joint (suffixed columns).
    ``quantize=True`` runs the int8 model (``models/quant.py``, its dense
    convs on the GEMM kernel), ``quantize="residual"`` also carries the
    residual stream in int8. ``scale`` resizes frames before inference
    (coordinates stay in original-video pixels). ``preset="fast"`` is
    scale 0.75 + the residual int8 carry (plain int8 where the backbone
    has no residual carry, ``supports_residual_int8``); explicit
    ``scale=`` / ``quantize=`` arguments override its choices. PERF.md has
    its H100 frames/s.
    """
    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.infer.export import export_pose_like_dlc
    from deepgraphpose_tpu_torch.infer.predict import estimate_pose

    device = resolve_device(device)
    preset_quantize = False
    if preset is not None:
        if preset != "fast":
            raise ValueError(f"unknown preset {preset!r}; only 'fast'")
        if scale is None:
            scale = 0.75
        if quantize is None:  # an explicit quantize=False wins
            quantize = "residual"
            preset_quantize = True
    if quantize is None:
        quantize = False

    config = Path(config)
    proj, pose_cfg, train_dir = paths_lib.resolve_project(
        config.parent, shuffle, trainingsetindex)
    if preset_quantize:
        from deepgraphpose_tpu_torch.models.quant import \
            supports_residual_int8

        if not supports_residual_int8(pose_cfg.net_type):
            quantize = True
    frac = proj.TrainingFraction[trainingsetindex]
    snap_path, iters = _resolve_snapshot(Path(train_dir), proj, snapshot)
    scorer, scorer_legacy = get_scorer_name(proj, pose_cfg, shuffle, iters)
    print(f"Using snapshot {snap_path.name} -> scorer {scorer}")

    video_files = _video_files(videos, videotype)
    if cropping is not None and scale is not None and scale != 1.0:
        raise ValueError(
            "cropping= and scale= don't compose here: analyze_videos' crop "
            "box is in original pixels while scaled inference crops in "
            "resized pixels. Use estimate_pose(scale=, crop=) directly, "
            "whose crop box is documented as resized-pixel coordinates")
    crop = None
    if cropping is not None:
        x1, x2, y1, y2 = cropping
        crop = (x1, y1, x2, y2)  # estimate_pose order: (x0, y0, x1, y1)

    names = pose_cfg.all_joints_names or [
        f"bp{i}" for i in range(pose_cfg.num_joints)]
    batch_size = batchsize or pose_cfg.infer_batch_size

    for video in video_files:
        dest = Path(destfolder) if destfolder else video.parent
        dest.mkdir(parents=True, exist_ok=True)
        dataname = dest / f"{video.stem}{scorer}.h5"
        stem = str(dest / f"{video.stem}{scorer}")
        if dataname.exists() or (
                dest / f"{video.stem}{scorer_legacy}.h5").exists():
            print(f"{video.stem} already analyzed ({dataname.name})")
            continue

        t0 = time.time()
        if scale is not None and scale != 1.0 and (
                num_outputs > 1 or (dynamic and dynamic[0])):
            print("warning: scale is only applied in the full-frame "
                  "single-output path (dynamic cropping already reduces "
                  "compute; num_outputs > 1 decodes full-frame)")
        if num_outputs > 1:
            if crop is not None:
                print("warning: cropping is not applied in the "
                      "num_outputs > 1 path")
            if dynamic and dynamic[0]:
                print("warning: dynamic cropping is not applied in the "
                      "num_outputs > 1 path (full-frame decode)")
            n = _analyze_multi(snap_path, video, stem, pose_cfg, scorer,
                               names, num_outputs, batch_size, max_frames,
                               device)
        else:
            if dynamic and dynamic[0]:
                from deepgraphpose_tpu_torch.infer.dynamic import \
                    estimate_pose_dynamic_video

                if crop is not None:
                    print("warning: static cropping is ignored with "
                          "dynamic=(True, ...): the tracker crops around "
                          "the detected animal on the full frame "
                          "(coordinates are full-frame); pass cropping "
                          "without dynamic to crop statically")
                labels = estimate_pose_dynamic_video(
                    config, snap_path, video, dest, shuffle=shuffle,
                    detection_threshold=float(dynamic[1]),
                    margin=int(dynamic[2]), batch_size=batch_size,
                    max_frames=max_frames, save_pose=False,
                    quantize=quantize, device=device)
            else:
                labels = estimate_pose(
                    proj_cfg_file=config, dgp_model_file=snap_path,
                    video_file=video, output_dir=dest, shuffle=shuffle,
                    save_pose=False, crop=crop, batch_size=batch_size,
                    max_frames=max_frames, pose_cfg=pose_cfg,
                    quantize=quantize, scale=scale, device=device)
            n = labels["x"].shape[0]
            export_pose_like_dlc(labels, scorer, names, stem)
        if not save_as_csv:
            Path(stem + ".csv").unlink(missing_ok=True)
        t1 = time.time()

        reader = VideoReader(video)
        nx, ny = reader.width, reader.height
        reader.close()
        meta = {"data": {
            "start": t0, "stop": t1, "run_duration": t1 - t0,
            "Scorer": scorer,
            "DLC-model-config file": pose_cfg.to_dict(),
            "fps": None, "batch_size": batch_size,
            "frame_dimensions": (ny, nx), "nframes": n,
            "iteration (active-learning)": proj.iteration,
            "training set fraction": frac,
            "cropping": cropping is not None,
            "cropping_parameters": list(cropping) if cropping
            else [0, nx, 0, ny],
        }}
        with open(stem + "includingmetadata.pickle", "wb") as f:
            pickle.dump(meta, f)
        print(f"analyzed {video.name}: {n} frames in {t1 - t0:.1f}s")
    return scorer


def _analyze_multi(snap_path, video, stem: str, pose_cfg, scorer, names,
                   num_outputs: int, batch_size: int, max_frames,
                   device) -> int:
    """num_outputs > 1: the top-k decode per joint, suffixed-column export
    (ref: predict_videos.py:188-196 + multi_pose_predict). Returns the
    frames written."""
    from deepgraphpose_tpu_torch.data.prefetch import host_to_device
    from deepgraphpose_tpu_torch.data.video import (VideoReader,
                                                    iter_frame_batches)
    from deepgraphpose_tpu_torch.infer.export import \
        export_multi_pose_like_dlc
    from deepgraphpose_tpu_torch.infer.predict import (load_model,
                                                       make_multi_infer_fn)

    reader = VideoReader(video)
    n = (min(reader.n_frames, max_frames) if max_frames
         else reader.n_frames)
    model = load_model(pose_cfg, snap_path,
                       resolve_dtype(pose_cfg.compute_dtype), device)
    infer = make_multi_infer_fn(model, pose_cfg, num_outputs)

    pose_all = np.zeros((n, pose_cfg.num_joints, num_outputs, 3))
    n_read = 0
    for start, block in iter_frame_batches(reader, batch_size, n):
        pad = batch_size - block.shape[0]
        arr = (np.concatenate([block, block[-1:].repeat(pad, 0)]) if pad
               else block)
        pose = infer(host_to_device(arr, device)).cpu().numpy()
        pose_all[start:start + block.shape[0]] = pose[:block.shape[0]]
        n_read = start + block.shape[0]
    reader.close()
    if n_read < n:
        print(f"warning: decoder yielded {n_read}/{n} frames; truncating")
        pose_all = pose_all[:n_read]
        n = n_read
    export_multi_pose_like_dlc(pose_all, scorer, names, stem)
    return n


def analyze_time_lapse_frames(config: str | Path, directory: str | Path,
                              frametype: str = ".png", shuffle: int = 1,
                              trainingsetindex: int = 0,
                              save_as_csv: bool = True,
                              snapshot: str | None = None,
                              batchsize: int | None = None,
                              device=None) -> str:
    """Batched inference over a directory of same-sized images.

    ref: predict_videos.py:610-724 (analyze_time_lapse_frames /
    GetPosesofFrames). Writes ``<dirname><scorer>.h5`` (+ .csv) inside the
    directory; returns the scorer.
    """
    import cv2

    from deepgraphpose_tpu_torch.data.prefetch import host_to_device
    from deepgraphpose_tpu_torch.infer.export import export_pose_like_dlc
    from deepgraphpose_tpu_torch.infer.predict import (load_model,
                                                       make_infer_fn)

    device = resolve_device(device)
    config = Path(config)
    directory = Path(directory)
    proj, pose_cfg, train_dir = paths_lib.resolve_project(
        config.parent, shuffle, trainingsetindex)
    snap_path, iters = _resolve_snapshot(Path(train_dir), proj, snapshot)
    scorer, _ = get_scorer_name(proj, pose_cfg, shuffle, iters)

    frames = sorted(p for p in directory.iterdir()
                    if p.suffix.lower() == frametype.lower())
    if not frames:
        raise FileNotFoundError(f"no {frametype} frames in {directory}")
    imgs = []
    for p in frames:
        img = cv2.imread(str(p))
        if img is None:
            raise FileNotFoundError(f"unreadable image {p}")
        imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    hw = imgs[0].shape[:2]
    if any(i.shape[:2] != hw for i in imgs):
        raise ValueError("all frames must share one size "
                         "(ref: GetPosesofFrames assumes constant dims)")

    model = load_model(pose_cfg, snap_path,
                       resolve_dtype(pose_cfg.compute_dtype), device)
    infer = make_infer_fn(model, pose_cfg)

    bs = batchsize or pose_cfg.infer_batch_size
    nj = pose_cfg.num_joints
    mu_all = np.zeros((len(imgs), nj, 2))
    lik_all = np.zeros((len(imgs), nj))
    for s in range(0, len(imgs), bs):
        chunk = imgs[s:s + bs]
        arr = np.stack(chunk + [chunk[-1]] * (bs - len(chunk)))
        mu, lik = infer(host_to_device(arr, device))
        mu_all[s:s + len(chunk)] = mu.cpu().numpy()[:len(chunk)]
        lik_all[s:s + len(chunk)] = lik.cpu().numpy()[:len(chunk)]

    stride = pose_cfg.stride
    labels = {"x": mu_all[:, :, 1] * stride + stride / 2,
              "y": mu_all[:, :, 0] * stride + stride / 2,
              "likelihoods": lik_all}
    names = pose_cfg.all_joints_names or [f"bp{i}" for i in range(nj)]
    out_stem = directory / f"{directory.name}{scorer}"
    export_pose_like_dlc(labels, scorer, names, str(out_stem))
    if not save_as_csv:
        # the writer appends '.csv' to the stem; with_suffix would mangle
        # directory names holding dots
        Path(str(out_stem) + ".csv").unlink(missing_ok=True)
    print(f"analyzed {len(imgs)} frames in {directory} -> {out_stem}.h5")
    return scorer
