"""Dynamic-cropping inference: track the animal, run the net on a crop.

ref: deeplabcut/pose_estimation_tensorflow/predict_videos.py:396-457
(GetPoseDynamic). Counterpart of ``deepgraphpose_tpu/infer/dynamic.py``,
with the same batched, fixed-shape design:

* the crop window is a fixed (ch, cw) size, clamped into the frame;
* frames go in chunks of ``chunk``; all crops of a chunk share the center
  tracked from an earlier chunk, so a chunk is one batched forward;
* every device call is padded to ``chunk`` frames, so cuDNN autotunes one
  shape per path;
* frames whose best likelihood falls below ``detection_threshold`` re-run
  full-frame in one padded batch, and the center re-seeds from them.

The crop origin is computed on the host from the center (as float32, then
truncated to int, then clipped), so the crop needs no device sync; a
dispatched chunk is fetched only in ``_finalize``. The model carries its
weights, so the JAX ``variables`` arguments are gone.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from deepgraphpose_tpu_torch.core.device import resolve_device
from deepgraphpose_tpu_torch.data.prefetch import host_to_device


def _round_up(v: int, m: int) -> int:
    return -(-int(v) // m) * m


def crop_origin(center, frame_hw: tuple[int, int],
                crop_hw: tuple[int, int]) -> tuple[int, int]:
    """Top-left (r0, c0) of the crop window for a (row, col) pixel center:
    ``clip(int32(f32(center) - crop // 2), 0, frame - crop)``
    (ref: deepgraphpose_tpu infer/dynamic.py:57-58)."""
    cen = np.asarray(center, np.float32)
    out = []
    for k in range(2):
        v = (cen[k] - np.float32(crop_hw[k] // 2)).astype(np.int32)
        out.append(int(np.clip(v, 0, frame_hw[k] - crop_hw[k])))
    return out[0], out[1]


def make_crop_infer_fn(model, cfg, crop_hw: tuple[int, int]):
    """(frames_u8 (B, H, W, 3) on the device, center_rc (2,) on the host)
    -> (mu_global_rc, likelihood): one fixed-size crop shared by the chunk,
    a batched forward + decode, coords mapped back to full-frame scoremap
    space (mu_global = mu + offset / stride)."""
    from deepgraphpose_tpu_torch.infer.predict import infer_forward

    ch, cw = crop_hw
    stride = np.float32(cfg.stride)

    @torch.inference_mode()
    def fn(frames, center):
        h, w = frames.shape[1:3]
        r0, c0 = crop_origin(center, (h, w), crop_hw)
        mu, lik = infer_forward(model, cfg,
                                frames[:, r0:r0 + ch, c0:c0 + cw])
        mu[..., 0] += float(np.float32(r0) / stride)
        mu[..., 1] += float(np.float32(c0) / stride)
        return mu, lik

    return fn


def estimate_pose_dynamic(model, cfg, frames: np.ndarray,
                          crop_hw: tuple[int, int] | None = None,
                          detection_threshold: float = 0.5,
                          margin: int = 32,
                          chunk: int = 16, device=None) -> dict:
    """Track-and-crop inference over an in-memory frame array (T, H, W, 3).

    Returns {'mu': (T, nj, 2) scoremap coords, 'likelihoods': (T, nj),
    'cropped': (T,) bool}. ``crop_hw`` defaults to roughly half the frame,
    rounded up to the model stride. The model moves to ``device`` (default:
    the card).
    """
    tracker = DynamicTracker(model, cfg, frames.shape[1:3], crop_hw=crop_hw,
                             detection_threshold=detection_threshold,
                             margin=margin, chunk=chunk, device=device)
    T = frames.shape[0]
    chunks = ((s, frames[s:s + chunk]) for s in range(0, T, chunk))
    out, _ = _run_tracker(tracker, chunks, T, cfg.num_joints)
    return out


def _run_tracker(tracker, chunks, n: int, nj: int):
    """Stream (start, block) chunks through ``tracker.feed``/``flush``;
    returns (outputs sized for ``n`` frames, frames actually stored)."""
    out = {"mu": np.zeros((n, nj, 2)), "likelihoods": np.zeros((n, nj)),
           "cropped": np.zeros(n, bool)}
    n_done = 0

    def store(start, res):
        nonlocal n_done
        mu, lik, was_cropped = res
        end = start + mu.shape[0]
        out["mu"][start:end] = mu
        out["likelihoods"][start:end] = lik
        out["cropped"][start:end] = was_cropped
        n_done = max(n_done, end)

    # pipelined: feed(chunk k) returns chunk k-1's results while k computes
    prev_start = None
    for start, block in chunks:
        res = tracker.feed(block)
        if res is not None:
            store(prev_start, res)
        prev_start = start
    last = tracker.flush()
    if last is not None:
        store(prev_start, last)
    return out, n_done


class DynamicTracker:
    """Persistent track-and-crop state over streamed chunks.

    :meth:`process_chunk` runs one chunk synchronously. The pipelined pair
    :meth:`feed` / :meth:`flush` dispatches the new chunk to the card
    *before* fetching the previous chunk's results, so the fetch that
    updates the center overlaps the next chunk's compute (the center then
    lags two chunks; the crop margin absorbs it).
    """

    def __init__(self, model, cfg, frame_hw: tuple[int, int],
                 crop_hw: tuple[int, int] | None = None,
                 detection_threshold: float = 0.5, margin: int = 32,
                 chunk: int = 16, device=None):
        from deepgraphpose_tpu_torch.infer.predict import make_infer_fn

        H, W = frame_hw
        s = int(cfg.stride)
        if crop_hw is None:
            crop_hw = (min(_round_up(H // 2 + margin, s), _round_up(H, s)),
                       min(_round_up(W // 2 + margin, s), _round_up(W, s)))
        self.device = resolve_device(device)
        model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.crop_hw = (min(crop_hw[0], H), min(crop_hw[1], W))
        self.stride = s
        self.threshold = detection_threshold
        self.chunk = chunk
        self.crop_fn = make_crop_infer_fn(model, cfg, self.crop_hw)
        self.full_fn = make_infer_fn(model, cfg)
        self.center = np.array([H / 2, W / 2])
        self.have_track = False
        self._pending = None  # (mu_dev, lik_dev, n, cropped_flag, block)

    def _padded(self, block: np.ndarray) -> torch.Tensor:
        pad = self.chunk - block.shape[0]
        arr = (np.concatenate([block, block[-1:].repeat(pad, 0)])
               if pad > 0 else block)
        return host_to_device(arr, self.device)

    def _dispatch(self, block: np.ndarray):
        """Enqueue one chunk on the card using the current center; returns
        the un-fetched device tensors."""
        if self.have_track:
            mu, lik = self.crop_fn(self._padded(block),
                                   np.asarray(self.center, np.float32))
        else:
            mu, lik = self.full_fn(self._padded(block))
        return mu, lik, block.shape[0], self.have_track, block

    def _finalize(self, pending):
        """Fetch a dispatched chunk, run the lost-frame fallback, update
        the tracking center; returns (mu, lik, cropped)."""
        mu_dev, lik_dev, n, was_cropped, block = pending
        mu = mu_dev.cpu().numpy()[:n].copy()
        lik = lik_dev.cpu().numpy()[:n].copy()
        cropped = np.full(n, was_cropped)

        detected = (lik > self.threshold).any(axis=1)
        lost = np.flatnonzero(cropped & ~detected)
        if lost.size:
            mu2, lik2 = self.full_fn(self._padded(block[lost]))
            mu[lost] = mu2.cpu().numpy()[:lost.size]
            lik[lost] = lik2.cpu().numpy()[:lost.size]
            cropped[lost] = False
            detected = (lik > self.threshold).any(axis=1)

        if detected.any():
            last = np.flatnonzero(detected)[-1]
            good = lik[last] > self.threshold
            self.center = (mu[last][good].mean(axis=0) * self.stride
                           + self.stride / 2)
            self.have_track = True
        else:
            self.have_track = False
        return mu, lik, cropped

    def process_chunk(self, block: np.ndarray):
        """Synchronous: (mu (n,nj,2), likelihood (n,nj), cropped (n,))."""
        if self._pending is not None:
            raise RuntimeError("process_chunk called with a fed chunk "
                               "pending; flush() first")
        return self._finalize(self._dispatch(block))

    def feed(self, block: np.ndarray):
        """Dispatch ``block`` now and return the PREVIOUS chunk's finalized
        results (None on the first call). Call :meth:`flush` at the end."""
        prev = self._pending
        self._pending = self._dispatch(block)
        return None if prev is None else self._finalize(prev)

    def flush(self):
        """Finalize the last fed chunk (or None if nothing is pending)."""
        prev, self._pending = self._pending, None
        return self._finalize(prev) if prev is not None else None


def estimate_pose_dynamic_video(proj_cfg_file, dgp_model_file, video_file,
                                output_dir, shuffle: int = 1,
                                detection_threshold: float = 0.5,
                                margin: int = 32,
                                crop_hw: tuple[int, int] | None = None,
                                batch_size: int = 16,
                                max_frames: int | None = None,
                                save_pose: bool = True,
                                save_str: str = "",
                                quantize: bool | str = False,
                                device=None) -> dict:
    """GetPoseDynamic-equivalent over a video file, with DLC export.

    ``quantize=True`` (or ``"residual"``) runs the int8 model, calibrated
    on the video's first 8 frames (``models/quant.py``)."""
    from deepgraphpose_tpu_torch.core.device import resolve_dtype
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.video import (VideoReader,
                                                    iter_frame_batches)
    from deepgraphpose_tpu_torch.infer.export import export_pose_like_dlc
    from deepgraphpose_tpu_torch.infer.predict import load_model

    device = resolve_device(device)
    _, cfg, _ = resolve_project(Path(proj_cfg_file).parent, shuffle)
    dtype = resolve_dtype(cfg.compute_dtype)
    model = load_model(cfg, dgp_model_file,
                       torch.float32 if quantize else dtype, device)
    if quantize:
        from deepgraphpose_tpu_torch.models.quant import (
            calib_frames_from_video, quantize_model)

        model = quantize_model(cfg, model,
                               calib_frames_from_video(video_file),
                               dtype=dtype,
                               residual_int8=(quantize == "residual"))
    reader = VideoReader(video_file)
    n = min(reader.n_frames, max_frames) if max_frames else reader.n_frames

    # stream chunk by chunk with persistent tracking state: an hour-long
    # video does not fit host RAM
    tracker = DynamicTracker(model, cfg, (reader.height, reader.width),
                             crop_hw=crop_hw,
                             detection_threshold=detection_threshold,
                             margin=margin, chunk=batch_size, device=device)
    out, n_read = _run_tracker(tracker,
                               iter_frame_batches(reader, batch_size, n), n,
                               cfg.num_joints)
    reader.close()
    if n_read < n:
        print(f"warning: decoder yielded {n_read}/{n} frames; truncating")
        out = {k: v[:n_read] for k, v in out.items()}
    s = cfg.stride
    labels = {"x": out["mu"][:, :, 1] * s + s / 2,
              "y": out["mu"][:, :, 0] * s + s / 2,
              "likelihoods": out["likelihoods"]}
    if save_pose:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        names = cfg.all_joints_names or [f"bp{i}"
                                         for i in range(cfg.num_joints)]
        export_pose_like_dlc(labels, Path(dgp_model_file).stem, names,
                             str(output_dir /
                                 (Path(video_file).stem + save_str)))
    labels["cropped"] = out["cropped"]
    return labels
