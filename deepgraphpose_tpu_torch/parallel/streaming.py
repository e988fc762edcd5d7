"""Time-sharded streaming video inference with halo exchange, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/parallel/streaming.py``. For
hour-long videos (BASELINE.json config 5) the time axis is split over a
data group's ranks, each rank reads, decodes and infers its frames, and
the temporally coupled quantities stay exact across the split:

* the frame-to-frame displacement (the inference-time analog of the
  temporal clique) needs a one-frame halo: each rank's last mu becomes
  the next rank's predecessor;
* the confidence-gated EWMA smoother is a linear recurrence, so carries
  compose as affine maps: each rank scans its frames from a zero carry,
  and the true carry entering rank k is composed from the ranks before
  it, in rank order with the arithmetic of the JAX package's ring of
  ``ppermute`` hops, then applied as a closed-form correction.

The JAX package's halo and ring are ``ppermute``s. gloo has neither
send/recv nor ``all_gather`` on CUDA tensors, so both exchanges are an
all_gather made from one ``all_reduce`` (``DataGroup.all_gather``: each
rank writes its row into its own slot of a zeroed buffer; adding zeros is
exact). ``make_time_sharded_infer_fn`` and ``make_time_sharded_smoother``
take the global (T, ...) arrays that every rank holds, as the JAX
package's do. ``estimate_pose_multichip`` gives each rank one contiguous
span of the video instead of a slice of every super-batch: a process a
rank decodes on its own host threads, and the video's decoder seeks only
once a rank (OpenCV's seek decodes up to 16 frames before its target).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from deepgraphpose_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, DataGroup)

ALPHA, PCUTOFF = 0.5, 0.4      # the smoother's weight and confidence gate


def make_time_sharded_infer_fn(model, cfg, group: DataGroup):
    """``fn(frames (T, H, W, 3) uint8)`` -> (mu (T, nj, 2), likelihood
    (T, nj), displacement (T, nj)) on every rank, T divisible by the
    world. Each rank decodes its contiguous T / world frames;
    ``displacement`` is ``|mu_t - mu_{t-1}|`` in scoremap units, exact
    across the ranks' boundaries through the one-frame halo; frame 0 (no
    predecessor) gets 0."""
    from deepgraphpose_tpu_torch.infer.predict import infer_forward

    def fn(frames):
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        mu, lik = infer_forward(model, cfg,
                                frames[group.shard(frames.shape[0])]
                                .to(group.device))
        with torch.inference_mode():
            # halo: every rank's last mu; mine follows rank - 1's
            lasts = group.all_gather(mu[-1:])
            prev_last = lasts[(group.rank - 1) % group.world][None]
            mu_prev = torch.cat([prev_last, mu[:-1]])
            disp = torch.linalg.vector_norm(mu - mu_prev, dim=-1)
            if group.rank == 0:          # the global first frame
                disp[0] = 0.0
            both = group.all_gather(torch.cat([mu, lik[..., None],
                                               disp[..., None]], -1))
        return both[..., :2], both[..., 2], both[..., 3]

    return fn


def ewma_reference(mu, lik, alpha: float = ALPHA, pcutoff: float = PCUTOFF):
    """Sequential confidence-gated EWMA (numpy, float64; for tests).

    s_0 = x_0; s_t = alpha * s_{t-1} + (1-alpha) * x_t when lik_t >= pcutoff,
    else s_t = s_{t-1} (low-confidence frames coast on the estimate).
    """
    mu = np.asarray(mu, np.float64)
    ok = np.asarray(lik) >= pcutoff
    out = np.empty_like(mu)
    out[0] = mu[0]
    for t in range(1, mu.shape[0]):
        upd = alpha * out[t - 1] + (1 - alpha) * mu[t]
        out[t] = np.where(ok[t][..., None], upd, out[t - 1])
    return out


def affine_scan(x, ok, alpha: float, seed_first: bool, state=None):
    """The gated EWMA over frames ``x`` (T, nj, 2) float64, ``ok`` (T, nj)
    the frames confident enough to update, continued from ``state`` =
    (exit state, total decay) of the frames before (default: a zero carry
    and no decay). Frame t is the affine map s_t = a_t s_{t-1} + b_t x_t,
    (a_t, b_t) = (alpha, 1 - alpha) where ok, else (1, 0); ``seed_first``
    makes frame 0 seed s_0 = x_0. Returns (s (T, nj, 2) from the carry
    given, cumulative decay (T, nj, 2), the state after the last frame):
    the true track is s_t + decay_t * (the carry entering frame 0)."""
    ok = ok[..., None].expand_as(x)
    a = torch.where(ok, x.new_full((), alpha), x.new_full((), 1.0))
    b = torch.where(ok, x.new_full((), 1.0 - alpha), x.new_full((), 0.0))
    if seed_first:
        a[0], b[0] = 0.0, 1.0
    s, decay = ((torch.zeros_like(x[0]), torch.ones_like(x[0]))
                if state is None else state)
    local = []
    for t in range(x.shape[0]):
        s = a[t] * s + b[t] * x[t]
        local.append(s)
    cum = decay * torch.cumprod(a, 0)
    return torch.stack(local), cum, (s, cum[-1])


def carry_into_rank(group: DataGroup, state, carry=None):
    """The carry entering this rank's frames: every rank's ``state`` (exit
    state from a zero carry, total decay) gathered in one exchange and
    composed in rank order from ``carry`` (default zero) entering rank 0,
    as the JAX package's ring hops do."""
    s, decay = state
    ends = group.all_gather(torch.stack([decay, s])[None])
    carry_in = torch.zeros_like(s) if carry is None else carry
    for k in range(group.rank):
        carry_in = ends[k, 0] * carry_in + ends[k, 1]
    return carry_in


def make_time_sharded_smoother(group: DataGroup, alpha: float = ALPHA,
                               pcutoff: float = PCUTOFF):
    """Exact confidence-gated EWMA over a time-sharded (T, nj, 2) track.

    The recurrence is :func:`affine_scan`'s, an affine map a frame. Each
    rank scans its frames from a zero carry and keeps its total decay;
    the carry entering rank k is rank k-1's exit state composed with the
    carry entering it (the ring's hop), from every rank's (decay, state)
    gathered in one exchange (:func:`carry_into_rank`); then s_t +=
    decay_t * carry_in recreates the sequential result.

    The returned ``smooth(mu, lik, carry=None, has_carry=None)`` takes the
    global track (every rank holds it) and returns the smoothed global
    track on every rank, in float64. ``carry`` is the smoothed state
    entering frame 0 (from an earlier super-batch of a streamed video),
    ``has_carry`` a {0., 1.} scalar; without one, frame 0 seeds s_0 = x_0.
    The exit carry for the next super-batch is the last valid smoothed row
    (the scan is causal)."""

    def smooth(mu, lik, carry=None, has_carry=None):
        mu = torch.as_tensor(mu).to(group.device, torch.float64)
        lik = torch.as_tensor(lik).to(group.device)
        sl = group.shard(mu.shape[0])
        seeded = 0.0 if has_carry is None else float(
            torch.as_tensor(has_carry).reshape(-1)[0])
        local, cum, state = affine_scan(
            mu[sl], lik[sl] >= pcutoff, alpha,
            group.rank == 0 and seeded == 0.0)
        carry_in = carry_into_rank(
            group, state,
            None if carry is None else torch.as_tensor(carry).to(mu) * seeded)
        return group.all_gather(local + cum * carry_in[None])

    return smooth


def estimate_pose_multichip(proj_cfg_file, dgp_model_file, video_file,
                            output_dir, mesh: DataGroup | None = None,
                            shuffle: int = 1, frames_per_device: int = 16,
                            max_frames: int | None = None,
                            save_pose: bool = True, save_str: str = "",
                            smooth: bool = False, compute_dtype=None,
                            quantize: bool | str = False,
                            device=None) -> dict:
    """Full-video inference with the time axis split over a data group.

    The hour-long-video configuration (BASELINE.json config 5): rank r
    takes the r-th of ``world`` contiguous spans of the video, each a
    whole number of batches of ``frames_per_device`` (the video's last
    batch padded with its last frame, as at one rank), reads it in order
    from one seek and infers it batch by batch. Across its batches a rank
    threads the displacement's previous frame and, with ``smooth``, the
    EWMA's state and decay (:func:`affine_scan`); across the spans one
    exchange at the end gives each rank its predecessor's last raw mu (the
    halo, from raw coordinates) and the smoother's carry
    (:func:`carry_into_rank`). ``mesh`` is the data group (default:
    ``mesh.make_mesh()`` on ``device``, the card unless named).
    ``quantize=True`` (or ``"residual"``) runs the int8 model, calibrated
    on the video's first 8 frames, as the JAX package does. Returns
    {'x', 'y', 'likelihoods', 'displacement'} (T, nj) arrays on every
    rank; rank 0 writes the DLC-format CSV/H5 as ``estimate_pose`` does.
    Where the decoder yields fewer frames than the container reports, the
    outputs end at the first rank that came short.
    """
    from deepgraphpose_tpu_torch.core.device import resolve_dtype
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.infer.export import export_pose_like_dlc
    from deepgraphpose_tpu_torch.infer.predict import infer_forward, load_model
    from deepgraphpose_tpu_torch.parallel.mesh import make_mesh

    group = make_mesh(device=device) if mesh is None else mesh
    dev = group.device
    _, cfg, _ = resolve_project(Path(proj_cfg_file).parent, shuffle)
    reader = VideoReader(video_file)
    n_total = (min(reader.n_frames, max_frames) if max_frames
               else reader.n_frames)
    dtype = resolve_dtype(compute_dtype if compute_dtype is not None
                          else cfg.compute_dtype)
    model = load_model(cfg, dgp_model_file,
                       torch.float32 if quantize else dtype, dev)
    if quantize:
        # the int8 model splits over time as the float one does: every
        # rank quantizes the same snapshot on the same frames
        from deepgraphpose_tpu_torch.models.quant import (
            calib_frames_from_video, quantize_model)

        model = quantize_model(cfg, model, calib_frames_from_video(video_file),
                               dtype=dtype,
                               residual_int8=(quantize == "residual"))

    nj = cfg.num_joints
    # spans of whole batches: the video is batched as at one rank, so a
    # frame's result does not depend on the world
    span = -(-n_total // (group.world * frames_per_device)) * frames_per_device
    lo = min(group.rank * span, n_total)
    hi = min(lo + span, n_total)
    rows, prev, state = [], None, None
    t0 = time.time()
    with torch.inference_mode():
        for start in range(lo, hi, frames_per_device):
            want = min(frames_per_device, hi - start)
            frames = [f for _, f in reader.iter_frames(start, start + want)]
            if not frames:
                break
            n = len(frames)
            frames += [frames[-1]] * (frames_per_device - n)
            mu, lik = infer_forward(model, cfg,
                                    torch.from_numpy(np.stack(frames)).to(dev))
            mu, lik = mu[:n].double(), lik[:n].double()
            mu_prev = torch.cat([mu[:1] if prev is None else prev, mu[:-1]])
            disp = torch.linalg.vector_norm(mu - mu_prev, dim=-1)
            prev = mu[-1:]
            row = [mu, lik[..., None], disp[..., None]]
            if smooth:
                local, cum, state = affine_scan(
                    mu, lik >= PCUTOFF, ALPHA,
                    group.rank == 0 and start == 0, state)
                row += [local, cum]
            rows.append(torch.cat(row, -1))
            if n < want:
                break                   # the decoder stopped early
        reader.close()
        width = 7 if smooth else 4
        mine = (torch.cat(rows) if rows else
                torch.zeros((0, nj, width), dtype=torch.float64, device=dev))
        n_mine = mine.shape[0]
        # the one exchange: frame counts, the halo, the smoother's carry
        last = mine[-1, :, :2].clone() if n_mine else torch.zeros(
            (nj, 2), dtype=torch.float64, device=dev)
        counts = group.all_gather(torch.tensor(
            [float(n_mine)], dtype=torch.float64, device=dev))
        lasts = group.all_gather(last[None])
        if n_mine and group.rank > 0:
            mine[0, :, 3] = torch.linalg.vector_norm(
                mine[0, :, :2] - lasts[group.rank - 1], dim=-1)
        if smooth:
            carry_in = carry_into_rank(
                group, state if state is not None else
                (torch.zeros((nj, 2), dtype=torch.float64, device=dev),
                 torch.ones((nj, 2), dtype=torch.float64, device=dev)))
            mine[..., :2] = mine[..., 4:6] + mine[..., 6:] * carry_in
        padded = torch.zeros((span, nj, 4), dtype=torch.float64, device=dev)
        padded[:n_mine] = mine[..., :4]
        every = group.all_gather(padded[None])
    parts, n_read = [], 0
    for r, c in enumerate(counts.tolist()):
        c = int(c)
        parts.append(every[r, :c])
        n_read += c
        if c < min(span, max(n_total - r * span, 0)):
            break                       # frames after a short rank drop
    out = torch.cat(parts).cpu().numpy()
    dt = time.time() - t0
    if n_read < n_total:
        print(f"warning: decoder yielded {n_read}/{n_total} frames "
              "(container metadata over-reported); truncating outputs")
    if group.is_root:
        print(f"[estimate_pose_multichip] {n_read} frames over "
              f"{group.world} rank(s) in {dt:.2f}s = "
              f"{n_read / dt if dt > 0 else float('inf'):.1f} frames/s")

    s = cfg.stride
    labels = {"x": out[:, :, 1] * s + s / 2, "y": out[:, :, 0] * s + s / 2,
              "likelihoods": out[:, :, 2], "displacement": out[:, :, 3]}
    if save_pose and group.is_root:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        names = cfg.all_joints_names or [f"bp{i}" for i in range(nj)]
        export_pose_like_dlc(
            {k: labels[k] for k in ("x", "y", "likelihoods")},
            Path(dgp_model_file).stem, names,
            str(output_dir / (Path(video_file).stem + save_str)))
    return labels
