"""Batched streaming full-video inference on the card.

Counterpart of ``deepgraphpose_tpu/infer/predict.py``. The host decodes
frames into fixed-size uint8 batches on a background thread and copies
them to the card from pinned memory while the previous batch computes; one
forward + decode per batch. uint8 travels over PCIe (4x less than float32)
and is normalized on the device.

Decode semantics match the reference (ref: eval.py:306-356):
* mu from softmax -> gaussian smooth -> expectation (``argmax_2d_from_cm``),
* pixel coords = mu * stride + stride/2, flipped to (x, y) and rescaled by
  any resize factors,
* likelihood = max sigmoid(scoremap logit) over the 2x2 cells around mu.

On a CUDA tensor the decode is the hand-written kernel
(``ops/kernels/softargmax_kernel.py``); on the CPU, its plain version.
PyTorch modules carry their weights, so where the JAX functions take
``(variables, images)`` these take ``images`` and the model holds the
weights.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path

import numpy as np
import torch

from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib  # noqa: F401
from deepgraphpose_tpu_torch.core.checkpoint import (load_snapshot,
                                                     state_dict_from_flax)
from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.core.device import resolve_device, resolve_dtype
from deepgraphpose_tpu_torch.data.prefetch import (DevicePrefetcher,
                                                   host_to_device)
from deepgraphpose_tpu_torch.data.video import VideoReader
from deepgraphpose_tpu_torch.infer.export import (export_pose_like_dlc,
                                                  load_pose_from_dlc)
from deepgraphpose_tpu_torch.models.pose_model import (  # noqa: F401
    PoseModel, init_model)
from deepgraphpose_tpu_torch.models.quant import QuantizedPoseModel
from deepgraphpose_tpu_torch.ops.softargmax import softargmax_2d  # noqa: F401
from deepgraphpose_tpu_torch.ops.kernels.softargmax_kernel import \
    softargmax_likelihood
from deepgraphpose_tpu_torch.utils import profiling


def inference_cudnn():
    """cuDNN as inference runs it: it autotunes each shape and never uses
    TF32, so a float32 model computes in full float32 as the JAX reference
    does. Where the caller asked cuDNN to be deterministic it does not
    autotune either: its heuristics pick the same algorithms in every
    process."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=True, benchmark=not cudnn.deterministic,
                       deterministic=cudnn.deterministic, allow_tf32=False)


@torch.inference_mode()
def forward_heads(model: PoseModel, images_u8: torch.Tensor,
                  heads=("part_pred",)) -> dict:
    """The model's float32 ``heads`` of uint8 images (B, H, W, 3), under
    :func:`inference_cudnn`."""
    with inference_cudnn():
        return model(images_u8, heads=heads)


@torch.inference_mode()
def infer_forward(model: PoseModel, cfg: PoseConfig, images_u8: torch.Tensor):
    """uint8 images (B, H, W, 3) -> (mu_rc (B, nj, 2), likelihood (B, nj)).
    Only the part_pred head runs."""
    pred = forward_heads(model, images_u8)["part_pred"]
    return softargmax_likelihood(pred, cfg.gamma, cfg.gauss_len)


def make_infer_fn(model: PoseModel, cfg: PoseConfig):
    """(uint8 images on the model's device) -> (mu_rc, likelihood)."""
    from deepgraphpose_tpu_torch.utils.compile_cache import \
        ensure_compile_cache

    ensure_compile_cache()
    return functools.partial(infer_forward, model, cfg)


def dlc_heads(model: PoseModel) -> list:
    """The heads the DLC decodes read: part_pred, and locref where the
    model has it."""
    return [k for k in ("part_pred", "locref") if k in model.head_keys]


def make_multi_infer_fn(model: PoseModel, cfg: PoseConfig, num_outputs: int):
    """Top-k decode for num_outputs > 1 (ref: predict_videos.py num_outputs
    path + predict.py:79-116 multi_pose_predict): (uint8 images on the
    model's device) -> (B, nj, num_outputs, 3) [x, y, likelihood] in
    pixels. It runs both heads and ``ops.decode.multi_pose_decode``, not
    the soft-argmax kernel."""
    from deepgraphpose_tpu_torch.ops.decode import multi_pose_decode

    heads = dlc_heads(model)

    @torch.inference_mode()
    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        out = forward_heads(model, images_u8, heads=heads)
        return multi_pose_decode(out["part_pred"], out.get("locref"),
                                 num_outputs, stride=cfg.stride,
                                 locref_stdev=cfg.locref_stdev)

    return fn


def _batch_producer(reader: VideoReader, batch_size: int,
                    new_size=None, crop=None, max_frames=None):
    """Yield (start_index, n_valid, uint8 batch); the last batch is padded
    with repeats of its last frame. Each batch's ``np.stack`` is the span
    ``dgp.feed.assemble``."""
    import cv2

    buf, start = [], 0
    for i, frame in reader.iter_frames():
        if max_frames is not None and i >= max_frames:
            break
        if new_size is not None:
            frame = cv2.resize(frame, (new_size[1], new_size[0]))
        if crop is not None:
            x0, y0, x1, y1 = crop
            frame = frame[y0:y1, x0:x1]
        buf.append(frame)
        if len(buf) == batch_size:
            with profiling.span("dgp.feed.assemble"):
                batch = np.stack(buf)
            yield start, batch_size, batch
            start += batch_size
            buf = []
    if buf:
        pad = batch_size - len(buf)
        with profiling.span("dgp.feed.assemble"):
            batch = np.stack(buf + [buf[-1]] * pad)
        yield start, len(buf), batch


def load_model(pose_cfg: PoseConfig, dgp_model_file, dtype,
               device) -> PoseModel:
    """A PoseModel holding the weights of a JAX-package snapshot."""
    model = PoseModel(pose_cfg, dtype=dtype)
    variables, _ = load_snapshot(dgp_model_file)
    model.load_state_dict(state_dict_from_flax(variables))
    return model.to(device, memory_format=torch.channels_last).eval()


def estimate_pose(proj_cfg_file: str | Path | None,
                  dgp_model_file: str | Path,
                  video_file: str | Path,
                  output_dir: str | Path,
                  shuffle: int = 1,
                  save_pose: bool = True,
                  save_str: str = "",
                  new_size: tuple | None = None,
                  scale: float | None = None,
                  crop: tuple | None = None,
                  batch_size: int | None = None,
                  max_frames: int | None = None,
                  pose_cfg: PoseConfig | None = None,
                  variables=None, model=None,
                  compute_dtype=None,
                  quantize: bool | str = False,
                  calib_frames: int = 16,
                  device=None) -> dict:
    """Full-video inference; returns {'x','y','likelihoods'} (T, nj) arrays.

    API mirrors the reference's estimate_pose (ref: eval.py:217-372),
    including skip-if-CSV-exists and DLC-format CSV/H5 export.

    Weights: ``model`` (a PoseModel), else ``variables`` (its state_dict),
    else the JAX-package snapshot ``dgp_model_file``. The model is moved to
    ``device`` (default: the card; without one this raises).

    ``scale`` is a relative resize (new_size = max(1, round(scale * dims))),
    exclusive with ``new_size``. ``crop`` (x0, y0, x1, y1) applies after any
    resize, so its box is in resized pixels; returned coordinates are
    original-video pixels in every combination.

    ``quantize=True`` runs the int8 model (``models/quant.py``), calibrated
    on the video's first ``calib_frames`` frames after any resize and crop;
    ``quantize="residual"`` also carries the residual stream in int8. The
    float weights are then read in float32. A ``QuantizedPoseModel`` passed
    as ``model`` runs as it is and needs its state, in it or as
    ``variables``.
    """
    device = resolve_device(device)
    video_file = Path(video_file)
    output_dir = Path(output_dir)
    save_file = output_dir / (video_file.stem + save_str)
    if save_pose and (save_file.with_suffix(".csv")).exists():
        print(f"{save_file}.csv exists; skipping inference")
        return load_pose_from_dlc(str(save_file) + ".csv")

    if pose_cfg is None:
        from deepgraphpose_tpu_torch.core.paths import resolve_project

        _, pose_cfg, _ = resolve_project(Path(proj_cfg_file).parent, shuffle)

    reader = VideoReader(video_file)
    if scale is not None:
        if new_size is not None:
            raise ValueError("pass scale= or new_size=, not both")
        if not 0 < scale:
            raise ValueError(f"scale must be positive, got {scale}")
        if scale != 1.0:
            new_size = (max(1, round(reader.height * scale)),
                        max(1, round(reader.width * scale)))
    scale_x = reader.width / new_size[1] if new_size is not None else 1.0
    scale_y = reader.height / new_size[0] if new_size is not None else 1.0

    if batch_size is None:
        batch_size = pose_cfg.infer_batch_size
    dtype = resolve_dtype(compute_dtype if compute_dtype is not None
                          else pose_cfg.compute_dtype)
    # the int8 model quantizes float32 weights, as the JAX package does
    float_dtype = torch.float32 if quantize else dtype
    if model is None and variables is None:
        model = load_model(pose_cfg, dgp_model_file, float_dtype, device)
    else:
        if model is None:
            model = PoseModel(pose_cfg, dtype=float_dtype)
        if variables is not None:
            model.load_state_dict(variables)
        elif isinstance(model, QuantizedPoseModel) and not model.has_state:
            raise ValueError(
                "estimate_pose(model=<quantized>) needs the model's "
                "quantized state, in it or passed as variables= (or pass "
                "quantize= and let estimate_pose quantize the snapshot)")
        model = model.to(device, memory_format=torch.channels_last).eval()
    if quantize and not isinstance(model, QuantizedPoseModel):
        from deepgraphpose_tpu_torch.models.quant import (
            calib_frames_from_video, quantize_model)

        calib = calib_frames_from_video(video_file, calib_frames,
                                        new_size=new_size, crop=crop)
        model = quantize_model(pose_cfg, model, calib, dtype=dtype,
                               residual_int8=(quantize == "residual"))
    infer = make_infer_fn(model, pose_cfg)

    n_total = (min(reader.n_frames, max_frames) if max_frames
               else reader.n_frames)
    nj = pose_cfg.num_joints
    mu_all = np.zeros((n_total, nj, 2), np.float64)
    lik_all = np.zeros((n_total, nj), np.float64)

    producer = _batch_producer(reader, batch_size, new_size, crop, max_frames)
    pf = DevicePrefetcher(
        producer,
        lambda item: (item[0], item[1], host_to_device(item[2], device)),
        depth=3)
    t0 = time.time()
    feed_start = profiling.mark()
    done = 0
    try:
        for start, n_valid, images in pf:
            mu, lik = infer(images)
            mu = mu[:n_valid].cpu().numpy()
            lik = lik[:n_valid].cpu().numpy()
            end = min(start + n_valid, n_total)
            mu_all[start:end] = mu[:end - start]
            lik_all[start:end] = lik[:end - start]
            done = end
    finally:
        pf.close()
    dt = time.time() - t0
    reader.close()
    fps = done / dt if dt > 0 else float("inf")
    feed = profiling.since(feed_start)
    wait = feed["spans"]["dgp.feed.wait"]
    print(f"[estimate_pose] {done} frames in {dt:.2f}s = {fps:.1f} frames/s; "
          f"{feed['counters'].get('dgp.feed.starved', 0)} of "
          f"{wait['count']} gets found the queue empty, "
          f"{wait['mean_ms']:.2f} ms wait a get")

    stride = pose_cfg.stride
    xr = mu_all[:, :, 1] * stride + 0.5 * stride
    yr = mu_all[:, :, 0] * stride + 0.5 * stride
    if crop is not None:
        # offset in the (possibly resized) frame, BEFORE mapping back to
        # original pixels, so crop and scale/new_size compose
        xr = xr + crop[0]
        yr = yr + crop[1]
    labels = {"x": xr * scale_x, "y": yr * scale_y, "likelihoods": lik_all}

    if save_pose:
        output_dir.mkdir(parents=True, exist_ok=True)
        export_pose_like_dlc(labels, Path(dgp_model_file).stem,
                             pose_cfg.all_joints_names or
                             [f"bp{i}" for i in range(nj)], str(save_file))
    return labels
