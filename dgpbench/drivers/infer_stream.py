"""Closed-loop full-video inference: the loop of ``estimate_pose`` without
the video decode.

The program's own pipeline runs as ``infer/predict.py::estimate_pose``
runs it: ``_batch_producer`` stacks frames into uint8 batches, a
``DevicePrefetcher`` of the traffic's depth copies each to the card with
``host_to_device`` from pinned memory, ``make_infer_fn`` runs the model
and the decode kernel, and each batch's poses come back with ``.cpu()``.
The reader cycles a ring of seeded frames in memory, so the host's work is
that of a decoded video and nothing waits on a decoder.

Traffic parameters (``traffic/<name>.json``): ``precision`` (``bfloat16``,
or ``int8`` for ``quantize_model`` calibrated on the ring's first
``calib_frames``), ``batch``, ``ring_frames``, ``prefetch_depth``,
``warmup_batches`` (set-up: the first batches, which autotune cuDNN and
fill the queue), ``trace_skip`` and ``trace_batches`` (the traced
sub-window of a ``--trace 1`` run, in batches of the window: late enough
that the queue, full after the warm-up, has drained where the host's
producer is the slower stage) and ``check_block`` (frames a reference
call).

Two rates come out of one window. ``infer_frames_per_s`` is what a lab
sees: the window's frames over its wall time, paced by the slower of the
host's producer and the card. ``card_ms_per_frame`` is what a frame costs
the card: two CUDA events on the loop's stream around each batch's call
into the model and the decode, summed over the window's batches and
divided by its frames. The copy to the card runs before the first event
in stream order and the poses' copy back after the second, so the
host's pace does not enter it.

Correctness: every answer of the window (mu and likelihood of every
joint of every frame whose poses reached the host) is held against the
plain reference on the same frame and weights: the distance of mu from
the reference's, in map cells, and the gap of the likelihood from the one
the reference's maps give at the program's own mu.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time

import numpy as np
import torch

from dgpbench import data
from dgpbench.reference import arch, decode, models, quant


class RingReader:
    """A video reader over frames in memory: frame i is ring[i % len]."""

    def __init__(self, ring: np.ndarray):
        self.ring = ring

    def iter_frames(self):
        for i in itertools.count():
            yield i, self.ring[i % len(self.ring)]


def pose_config(cfg: dict, traffic: dict):
    from deepgraphpose_tpu_torch.core.config import PoseConfig

    return PoseConfig(
        net_type=cfg["net_type"], num_joints=cfg["num_joints"],
        output_stride=cfg["output_stride"],
        deconvolutionstride=cfg["deconvolution_stride"],
        location_refinement=cfg["location_refinement"],
        stride=cfg["stride"], gamma=cfg["gamma"], gauss_len=cfg["gauss_len"],
        mean_pixel=tuple(cfg["mean_pixel"]),
        compute_dtype="bfloat16", infer_batch_size=traffic["batch"])


def program_model(cfg: dict, traffic: dict, weights: dict, ring, device):
    """The program's model holding ``weights``: bf16, or int8 as
    ``estimate_pose(quantize=True)`` builds it."""
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel

    pc = pose_config(cfg, traffic)
    int8 = traffic["precision"] == "int8"
    with torch.device(device):
        model = PoseModel(pc, dtype=torch.float32 if int8 else torch.bfloat16)
    model.load_state_dict(weights)
    model = model.to(device, memory_format=torch.channels_last).eval()
    if int8:
        from deepgraphpose_tpu_torch.models.quant import quantize_model

        model = quantize_model(pc, model, ring[:traffic["calib_frames"]],
                               dtype=torch.bfloat16)
    return pc, model


def reference_fn(cfg: dict, traffic: dict, weights: dict, ring, device,
                 control: bool = False):
    """frames (uint8 on the device) -> the reference's logits. The int8
    cell's reference quantizes again from the calibration frames. With
    ``control``, the reference in the precision below the cell's: int4
    for int8 (the same scheme with 4-bit integers), and for bfloat16 fp8
    (every convolution's input and weight rounded to float8 e4m3 with a
    scale a tensor)."""
    if traffic["precision"] == "int8":
        qmax = 7 if control else 127
        calib = torch.from_numpy(ring[:traffic["calib_frames"]]).to(device)
        state = quant.calibrate(cfg, weights, calib, qmax)
        return lambda x: quant.forward(cfg, weights, state, x, qmax)
    convs = ((fp8_conv, fp8_conv_transpose) if control
             else (models.plain_conv, torch.nn.functional.conv_transpose2d))

    def fn(x):
        with models.exact_float32():
            return models.forward(cfg, weights, x, *convs)
    return fn


@torch.no_grad()
def judge_answers(cfg: dict, ref, ring, idx, mu, lik, device,
                  block: int) -> dict:
    """Every answer (ring index, mu, lik) against the reference ``ref``
    over the frames it covers, ``block`` frames a call."""
    idx_t = torch.from_numpy(idx).to(device)
    mu_t = torch.from_numpy(mu).to(device)
    lik_t = torch.from_numpy(lik).to(device)
    errs = {k: torch.zeros(len(idx), device=device)
            for k in ("mu_err", "lik_err")}
    frames = np.unique(idx)
    pos = torch.full((len(ring),), -1, dtype=torch.int64, device=device)
    for i in range(0, len(frames), block):
        blk = frames[i:i + block]
        logits = ref(torch.from_numpy(ring[blk]).to(device))
        ref_mu = decode.soft_argmax(logits, cfg["gamma"], cfg["gauss_len"])
        pos.fill_(-1)
        pos[torch.from_numpy(blk).to(device)] = torch.arange(
            len(blk), device=device)
        which = pos[idx_t]
        sel = which >= 0
        for k, v in decode.judge(logits, ref_mu, which[sel], mu_t[sel],
                                 lik_t[sel]).items():
            errs[k][sel] = v
    return {k: v.cpu().numpy() for k, v in errs.items()}


def readings(errs: dict, limits: dict) -> dict:
    """The numbers compared and the answers that failed, with the gaps'
    quantiles beside them.

    * ``mu_err_cells_p50``: the median over the answers of the mu gap in
      map cells. Its largest value and its 99th percentile swing from
      seed to seed with the answers whose maps are near a tie, in the
      program and the control alike, and do not tell the two apart by
      three times on ResNet-50 in bf16; the median does.
    * ``lik_err``: the largest likelihood gap of any answer. Every answer
      is held by it: one whose mu or likelihood is altered reads the
      reference's maps elsewhere than its likelihood says.

    ``failed`` counts the answers past the likelihood limit and, where the
    median is past its limit, those past it."""
    mu_err, lik_err = errs["mu_err"], errs["lik_err"]
    out = {"mu_err_cells_p50": float(np.median(mu_err)),
           "lik_err": float(lik_err.max())}
    bad = lik_err > limits["lik_err"]
    if out["mu_err_cells_p50"] > limits["mu_err_cells_p50"]:
        bad |= mu_err > limits["mu_err_cells_p50"]
    out["failed"] = int(np.count_nonzero(bad))
    out["quantiles"] = {name: [float(np.quantile(v, q)) for q in
                               (0.5, 0.99, 0.999, 1.0)]
                        for name, v in errs.items()}
    return out


def run(ctx: dict) -> dict:
    """One run: set-up, the measured window, then the check."""
    from deepgraphpose_tpu_torch.data.prefetch import (DevicePrefetcher,
                                                       host_to_device)
    from deepgraphpose_tpu_torch.infer.predict import (_batch_producer,
                                                       make_infer_fn)

    cfg, traffic, device = ctx["config"], ctx["traffic"], ctx["device"]
    seed, seconds, trace = ctx["seed"], ctx["seconds"], ctx["trace"]
    batch = traffic["batch"]
    marks = [("start", time.perf_counter())]
    ring = data.make_frames(seed, traffic["ring_frames"], cfg["frame_hw"],
                            device)
    marks.append(("frames", time.perf_counter()))
    weights = data.make_weights(cfg, seed, device)
    pc, model = program_model(cfg, traffic, weights, ring, device)
    del weights
    infer = make_infer_fn(model, pc)
    marks.append(("model", time.perf_counter()))

    h2d_s: list[float] = []

    def transfer(item):
        start, n_valid, frames = item
        handed = time.perf_counter()
        images = host_to_device(frames, device)
        h2d_s.append(time.perf_counter() - handed)
        return start, n_valid, images, handed

    warmup = traffic["warmup_batches"]
    trace_from = warmup + traffic["trace_skip"]
    trace_to = trace_from + traffic["trace_batches"]
    prof = prof_t0 = prof_wall = None
    idx, mus, liks, latency, card = [], [], [], [], []
    t0 = t_last = None
    pf = DevicePrefetcher(_batch_producer(RingReader(ring), batch),
                          transfer, depth=traffic["prefetch_depth"])
    try:
        for k, (start, n_valid, images, handed) in enumerate(pf):
            began = _mark(device)
            mu, lik = infer(images)
            ended = _mark(device)
            mu = mu[:n_valid].cpu().numpy()
            lik = lik[:n_valid].cpu().numpy()
            done = time.perf_counter()
            del images
            if k == 0:
                marks.append(("first_batch", done))
            if k < warmup:
                if k == warmup - 1:
                    t0 = done
                    setup_s = done - ctx["t_start"]
                continue
            idx.append((start + np.arange(n_valid)) % len(ring))
            mus.append(mu)
            liks.append(lik)
            latency.append(done - handed)
            card.append((began, ended))
            t_last = done
            if trace and k + 1 == trace_from:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
                prof_t0 = time.perf_counter()
            elif prof is not None and k + 1 == trace_to:
                _sync(device)
                prof_wall = time.perf_counter() - prof_t0
                prof.stop()
            if done - t0 >= seconds and (not trace or prof_wall is not None):
                break
    finally:
        pf.close()
    _sync(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    window_s = t_last - t0
    n_frames = sum(len(i) for i in idx)
    card_ms = sum(_elapsed_ms(a, b) for a, b in card)
    h2d = h2d_s[warmup:warmup + len(latency)]   # one a batch, in order
    out = {"metrics": {
        "infer_frames_per_s": n_frames / window_s,
        "card_ms_per_frame": card_ms / n_frames,
        "infer_batch_ms_p95": 1e3 * float(np.percentile(latency, 95)),
        "setup_s": setup_s},
        "batches": len(latency), "window_s": window_s,
        "diagnostics": {
            "latency_ms_q05_50_95_max": [1e3 * float(np.quantile(latency, q))
                                         for q in (0.05, 0.5, 0.95, 1.0)],
            "host_to_device_ms_q50_95_max": [
                1e3 * float(np.quantile(h2d, q)) for q in (0.5, 0.95, 1.0)],
            "batches": len(latency),
            "setup_s_by_stage": {
                name: b - a for (_, a), (name, b) in zip(marks, marks[1:])}
            | {"imports_and_init": marks[0][1] - ctx["t_start"],
               "rest_of_warmup": t0 - marks[-1][1]}},
        "memory_peak_bytes": memory_peak, "attempted": n_frames}
    if prof is not None:
        from dgpbench import harness

        summary = harness.summarize_profile(prof, threading.get_native_id())
        mh, mw = arch.map_hw(cfg, cfg["frame_hw"])
        summary.update({
            "batches": traffic["trace_batches"],
            "frames": traffic["trace_batches"] * batch,
            "wall_s": prof_wall, "batch": batch,
            "map_shape": (batch, mh, mw, cfg["num_joints"]),
            "frame_hw": tuple(cfg["frame_hw"]),
            "frames_per_s": out["metrics"]["infer_frames_per_s"],
            "card_ms_per_frame": out["metrics"]["card_ms_per_frame"],
            "batch_ms_p95": out["metrics"]["infer_batch_ms_p95"],
            "host_spans": {"host_to_device": h2d},
            "config": cfg, "traffic": traffic})
        out["trace"] = summary
        del prof

    del infer, model, pf
    gc.collect()
    torch.cuda.empty_cache()
    weights = data.make_weights(cfg, seed, device)
    ref = reference_fn(cfg, traffic, weights, ring, device)
    errs = judge_answers(cfg, ref, ring, np.concatenate(idx),
                         np.concatenate(mus), np.concatenate(liks), device,
                         traffic["check_block"])
    got = readings(errs, ctx["limits"])
    out["failed"] = got.pop("failed")
    out["gap_quantiles"] = got.pop("quantiles")
    out["checks"] = {name: {"value": value,
                            "limit": ctx["limits"][name]}
                     for name, value in got.items()}
    out["correct"] = out["failed"] == 0 and n_frames > 0
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device):
    """A point on the device's timeline: a CUDA event recorded on the
    current stream, or on the CPU, which runs each call to its end, the
    host's clock."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _elapsed_ms(began, ended) -> float:
    if isinstance(began, float):
        return 1e3 * (ended - began)
    return began.elapsed_time(ended)


def control_readings(ctx: dict) -> dict:
    """The control (``reference_fn(control=True)``) in the program's
    place on every frame of the ring of ``ctx["seed"]``, judged by the
    reference as the program's answers are."""
    cfg, traffic, device = ctx["config"], ctx["traffic"], ctx["device"]
    ring = data.make_frames(ctx["seed"], traffic["ring_frames"],
                            cfg["frame_hw"], device)
    weights = data.make_weights(cfg, ctx["seed"], device)
    low = reference_fn(cfg, traffic, weights, ring, device, control=True)
    block = traffic["check_block"]
    mus, liks = [], []
    with torch.no_grad():
        for i in range(0, len(ring), block):
            logits = low(torch.from_numpy(ring[i:i + block]).to(device))
            mu = decode.soft_argmax(logits, cfg["gamma"], cfg["gauss_len"])
            mus.append(mu.cpu().numpy())
            liks.append(decode.likelihood_at(logits, mu).cpu().numpy())
    del low
    ref = reference_fn(cfg, traffic, weights, ring, device)
    errs = judge_answers(cfg, ref, ring, np.arange(len(ring)),
                         np.concatenate(mus), np.concatenate(liks), device,
                         block)
    return readings(errs, ctx["limits"])


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_conv(x, weight, stride=1, padding=0, dilation=1, groups=1):
    return models.plain_conv(_fp8(x), _fp8(weight), stride, padding,
                             dilation, groups)


def fp8_conv_transpose(x, weight, bias, stride):
    return torch.nn.functional.conv_transpose2d(_fp8(x), _fp8(weight), bias,
                                                stride)
