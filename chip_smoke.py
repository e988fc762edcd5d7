#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero and the
last line is then never printed:

1. device: the card's name and power limit (nvidia-smi), then nvcc builds
   every kernel under deepgraphpose_tpu_torch/csrc for sm_90a;
2. kernel: the CUDA decode kernel against its plain PyTorch version on the
   card (mu within 1e-4 cells, likelihood within 1e-5) at the maps of both
   main-path phases (full frame and tracked crop) and at odd shapes (an
   unaligned frame, also as a view one float into its storage, C = 1,
   C = 33, C = 2000), and its time at each main-path shape beside its
   memory bound and the plain version's time, for each candidate layout
   (cluster size, threads, ring stages, chunk steps); and at batches 1,
   16 and 64 of the full-frame maps, one to eight CTAs a frame;
3. f32: the full ResNet-50 model in float32 (TF32 off) on 4 frames at
   747x832, ``infer_forward`` (kernel decode) against the same heads
   through the plain decode, and the card's part_pred logits of one frame
   against the port's own forward on the CPU (the CPU path is the one
   tests/test_torch_*.py hold to the JAX package);
4. full-frame: bfloat16, batch 128 at 747x832 through ``make_infer_fn``
   over a device-resident ring of 4 seeded uint8 batches, 1024 frames;
5. tracked crop: ``estimate_pose_dynamic`` at 747x832 with a (408, 448)
   window and chunk 128 over 1024 frames of a seeded moving blob;
6. mm: the int8 GEMM kernel's ``mm_tiled`` (the port of ``pallas_mm``)
   against its plain version at the probe's 4096^3, int8 -> int32 and
   bf16 -> f32 exactly on the probe's small-integer operands, and bf16
   within 1e-5 of the largest |value| on normal ones; timed by CUDA-graph
   replay on a B transposed once to the (N, K) layout the kernel reads
   (the transposition timed on a line of its own, ``mm_transpose``),
   beside its bound, the plain version and the library product
   (``torch._int_mm``; ``torch.matmul`` for bf16, which writes bf16),
   with the kernel's ring depth;
7. quantize: ``quantize_model`` of the f32 model on 16 seeded frames;
8. int8 full-frame and int8 residual full-frame: the int8 model at batch
   128 over 1024 frames; logits on the f32 phase's 4 frames against the
   f32 model (relative error < 0.25 and correlation > 0.99, the bounds of
   tests/test_quant.py) and px against the f32 and bf16 models;
9. int8_conv: each distinct conv of one int8 full-frame batch timed at
   its shape (on the site's kept (N, K) weight) beside its bound, its
   launches per batch, the plain version's time, and ``torch._int_mm``
   for the 1x1 stride-1 sites, with the kernel's ring depth;
10. int8 tracked crop: ``estimate_pose_dynamic`` with the int8 model.
   Each int8 path's first batch (full-frame chunks and crops for the
   tracker), before its counted run, holds every conv it launches against
   the plain version on that conv's own input: int32 exact, the call's
   own output within 1 bf16 ulp or +-1 on at most 1e-4 of the int8
   values;
11. profile: where the device time goes, from torch.profiler over 3
    full-frame batches, 3 tracked-crop steps and 3 int8 full-frame
    batches (device ms per batch by kernel class, device busy share);
12. the ``{"kernels": [...]}`` line;
13. ``{"ok": true, "device": {...}}``.

Every kernel wrapper counts its launches; the counts are set to 0 just
before each main-path run (phases 4, 5, 8 and 10) and read just after,
and every kernel that the path runs must show launches > 0. The weights
are random, from a seeded torch.Generator; nothing is read from disk but
the repository's own sources.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HW = (747, 832)
CROP_HW = (408, 448)
NUM_JOINTS = 5
BATCH = 128
FRAMES = 1024
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12      # H100 SXM, int8 tensor cores, dense
BF16_OPS_PER_S = 989e12       # H100 SXM, bf16 tensor cores, dense
CALIB_FRAMES = 16
CHECK_FRAMES = 32             # frames per plain slice of a checked conv
MM_SIZE = 4096                # the probe's M = N = K
# int8 model against the f32 one (tests/test_quant.py:69-74)
INT8_REL_ERR, INT8_CORR = 0.25, 0.99
MU_TOL, LIK_TOL = 1e-4, 1e-5
SMALL_BATCHES = (1, 16, 64)   # decode batches below the SM count
# card vs CPU float32 logits, relative to the largest logit: both sum the
# convolutions in float32, in different orders and algorithms
LOGIT_RTOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip()


def kernel_errors(x, gamma, gauss_len, layout=None):
    """(mu err in cells, lik err) of the kernel against the plain version.

    The likelihood is held against the plain 2x2 read at the kernel's own
    cell: where mu lies within 1e-4 of an integer the two versions may
    floor to neighbouring cells, and both reads are then right.
    """
    import torch

    from deepgraphpose_tpu_torch.ops import softargmax as plain
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel

    mu_k, lik_k = softargmax_kernel.softargmax_likelihood(
        x, gamma, gauss_len, layout=layout)
    torch.cuda.synchronize()
    mu_p, _ = plain.softargmax_2d(x, gamma=gamma, gauss_len=gauss_len)
    lik_p = plain.max_sigmoid_2x2(x, mu_k)
    torch.cuda.synchronize()
    return ((mu_k - mu_p).abs().max().item(),
            (lik_k - lik_p).abs().max().item())


def time_ms(fn, inputs, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls cycling through
    ``inputs`` (a ring larger than the 50 MB L2, so each call reads from
    memory). The calls are captured once in a CUDA graph and replayed, so
    the time is the card's and not the host's launch rate."""
    import torch

    for x in inputs:
        fn(x)                                   # build, weight cache, autotune
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def decode_bound(shape) -> dict:
    """Least time of the decode at ``shape``: each logit read once, the
    weight vectors read once, mu and lik written once; 10 float32
    operations a logit (scale, max, exp, three weighted sums)."""
    b, h, w, c = shape
    n_bytes = 4 * (b * h * w * c + 3 * b * c + 2 * (h + w))
    n_ops = 10 * b * h * w * c
    bound = {"bytes": 1e3 * n_bytes / HBM_BYTES_PER_S,
             "operations": 1e3 * n_ops / F32_OPS_PER_S}
    bound_by = max(bound, key=bound.get)
    return {"bound_ms": bound[bound_by], "bound_by": bound_by,
            "bytes": n_bytes}


def candidate_layouts(shape, sms: int):
    """Launch layouts the kernel phase times: the wrapper's choice first,
    then clusters of 1, 2, 4 and 8 CTAs a frame, rings of 2 and 4 slots,
    chunks of 4, 8 and 16 thread rows, each with the column threads (whole map
    rows, where C * W fits a CTA) and with about 256 threads of whole
    pixels; those whose shared memory fits a CTA."""
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel as sk

    batch, h, w, joints = shape
    first = sk.launch_shape(batch, h, w, joints, sms)
    per = sk.joint_group(joints)
    threads = {per * max(1, 256 // per)}
    if per == joints and per * w <= sk.MAX_THREADS:
        threads.add(per * w)
    found = [first] + [
        sk.Layout(cluster, t, stages, steps)
        for cluster in (1, 2, 4, 8) for t in sorted(threads)
        for stages in (2, 4) for steps in (4, 8, 16)]
    return [lay for lay in dict.fromkeys(found)
            if sk.smem_bytes(h, w, joints, lay) <= 232448]


def offset_view(x):
    """``x`` as a contiguous view that starts one float into its storage."""
    import torch

    store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    store[1:].copy_(x.reshape(-1))
    return store[1:].view(x.shape)


def kernel_registers() -> dict:
    """Registers a thread of each decode kernel instantiation, from ptxas's
    report in this run's build (empty if the library was built before)."""
    import re

    from deepgraphpose_tpu_torch.ops.kernels import build

    regs, name = {}, None
    for line in build.build_logs.get("softargmax", "").splitlines():
        found = re.search(r"entry function '(\w+)'", line)
        if found:
            name = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            inst = re.search(r"kernelILi(\d+)ELb(\d)E", name)
            key = (f"steps{inst.group(1)}_column{inst.group(2)}" if inst
                   else name)
            regs[key] = int(found.group(1))
            name = None
    return regs


def phase_kernel(cfg, device):
    """The decode kernel against its plain version at the main path's two
    map shapes (full frame and tracked crop) and at odd ones (an unaligned
    frame, a view at a storage offset of one float, C = 1, C = 33, and
    C = 2000 in joint groups), then
    its time at each main-path shape, for each candidate layout."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.models.pose_model import scoremap_size
    from deepgraphpose_tpu_torch.ops import softargmax as plain
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel

    full = (BATCH, *scoremap_size(cfg, HW), NUM_JOINTS)
    crop = (BATCH, *scoremap_size(cfg, CROP_HW), NUM_JOINTS)
    odd = [(3, 23, 31, 4), (2, 23, 31, 7), (8, *full[1:3], 1),
           (4, *crop[1:3], 33), (2, 8, 8, 2000)]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(SEED)
    worst_mu = worst_lik = 0.0
    checked = []

    def check(x, gamma, gauss_len, layout=None):
        nonlocal worst_mu, worst_lik
        e_mu, e_lik = kernel_errors(x, gamma, gauss_len, layout)
        worst_mu, worst_lik = max(worst_mu, e_mu), max(worst_lik, e_lik)
        if e_mu > MU_TOL or e_lik > LIK_TOL:
            raise AssertionError(
                f"kernel disagrees with plain at {tuple(x.shape)}, gauss_len "
                f"{gauss_len}, gamma {gamma}, layout {layout}: mu {e_mu}, "
                f"lik {e_lik}")

    def maps(shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 3).astype(np.float32)).to(device)

    g, s = cfg.gamma, cfg.gauss_len
    shapes = []
    for shape in (full, crop, *odd):
        x = maps(shape)
        views = [x, offset_view(x)] if shape == odd[1] else [x]
        for view in views:
            for gauss_len in (0.0, 1.0, 2.0):
                for gamma in (1.0, 2.5):
                    check(view, gamma, gauss_len)
        checked.append({"shape": list(shape), "storage_offsets": [
            v.storage_offset() for v in views]})
        if shape in odd:
            continue
        layouts = candidate_layouts(shape, sms)    # the wrapper's one first
        for layout in layouts:
            check(x, g, s, layout)
        # a ring of inputs twice the L2, so each launch reads from memory
        bound = decode_bound(shape)
        ring = [x] + [maps(shape) for _ in range(
            min(64, max(4, -(-100_000_000 // bound["bytes"]))) - 1)]
        by_layout = [{**lay._asdict(), "ms": time_ms(
            lambda x, lay=lay: softargmax_kernel.softargmax_likelihood(
                x, g, s, layout=lay), ring, 200)} for lay in layouts]
        shapes.append({
            "shape": list(shape), "ms": by_layout[0]["ms"],
            "layout": by_layout[0],
            "fastest": min(by_layout, key=lambda d: d["ms"]),
            "plain_ms": time_ms(lambda x: plain.softargmax_likelihood(
                x, g, s), ring, 20),
            **bound, "by_layout": by_layout})
    # batches below the SM count, where a cluster splits each frame: the
    # wrapper's layout, then 1 to 8 CTAs a frame (inputs of these sizes
    # stay in the L2, as the heads' output does)
    small = []
    for batch in SMALL_BATCHES:
        shape = (batch, *full[1:])
        x = maps(shape)
        chosen = softargmax_kernel.launch_shape(*shape, sms)
        layouts = [chosen] + [chosen._replace(cluster=k, stages=2, steps=8)
                              for k in (1, 2, 4, 8)]
        for layout in layouts:
            check(x, g, s, layout)
        ring = [x] + [maps(shape) for _ in range(3)]
        small.append({"shape": list(shape), "layout": chosen._asdict(),
                      "by_cluster": [{**lay._asdict(), "ms": time_ms(
                          lambda x, lay=lay:
                          softargmax_kernel.softargmax_likelihood(
                              x, g, s, layout=lay), ring, 200)}
                          for lay in layouts]})
    out = {"phase": "kernel", "max_abs_err_mu": worst_mu,
           "max_abs_err_lik": worst_lik, "checked": checked,
           "registers": kernel_registers(), "shapes": shapes,
           "small_batches": small}
    emit(out)
    return out


def phase_f32(cfg, device, generator):
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.infer.predict import infer_forward
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel, init_model
    from deepgraphpose_tpu_torch.ops import softargmax as plain

    model = init_model(cfg, generator, torch.float32, device)
    rng = np.random.default_rng(SEED + 1)
    images = torch.from_numpy(
        rng.integers(0, 256, (4, *HW, 3), dtype=np.uint8)).to(device)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                     allow_tf32=False):
        mu_k, lik_k = infer_forward(model, cfg, images)
        with torch.inference_mode():
            pred = model(images, heads=("part_pred",))["part_pred"]
            mu_p, _ = plain.softargmax_2d(pred, gamma=cfg.gamma,
                                          gauss_len=cfg.gauss_len)
            lik_p = plain.max_sigmoid_2x2(pred, mu_k)
    torch.cuda.synchronize()
    px = ((mu_k - mu_p).abs().max() * cfg.stride).item()
    e_lik = (lik_k - lik_p).abs().max().item()

    ref = PoseModel(cfg, dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    ref = ref.to(memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        pred_cpu = ref(images[:1].cpu(), heads=("part_pred",))["part_pred"]
        mu_cpu, _ = plain.softargmax_2d(pred_cpu, gamma=cfg.gamma,
                                        gauss_len=cfg.gauss_len)
    scale = pred_cpu.abs().max().item()
    logit_rel = (pred[:1].cpu() - pred_cpu).abs().max().item() / scale
    out = {"phase": "f32", "frames": 4, "hw": list(HW),
           "scoremap": list(pred.shape[1:3]), "max_px_diff": px,
           "max_lik_diff": e_lik, "cpu_ref_logit_rel": logit_rel,
           "logit_absmax": scale,
           "cpu_ref_px_diff": (mu_k[:1].cpu() - mu_cpu).abs().max().item()
           * cfg.stride}
    emit(out)
    if not (np.isfinite(px) and px <= MU_TOL * cfg.stride and e_lik <= LIK_TOL
            and np.isfinite(logit_rel) and logit_rel <= LOGIT_RTOL):
        raise AssertionError(f"f32 forward: kernel decode vs plain, or card "
                             f"vs CPU logits, out of tolerance: {out}")
    return model, images, mu_k, pred


def phase_full_frame(cfg, device, model_f32, images4, mu_f32, pred_f32):
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.infer.predict import (infer_forward,
                                                       make_infer_fn)
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel

    model = PoseModel(cfg, dtype=torch.bfloat16)
    model.load_state_dict(model_f32.state_dict())
    model = model.to(device, memory_format=torch.channels_last).eval()
    mu_bf16, _ = infer_forward(model, cfg, images4)
    err = ((mu_bf16 - mu_f32).abs() * cfg.stride)
    bf16_px = {"max": err.max().item(), "mean": err.mean().item()}
    with torch.inference_mode():
        pred = model(images4, heads=("part_pred",))["part_pred"]
    bf16_logit_rel = ((pred - pred_f32).abs().max()
                      / pred_f32.abs().max()).item()

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ring = [torch.randint(0, 256, (BATCH, *HW, 3), generator=gen,
                          dtype=torch.uint8, device=device) for _ in range(4)]
    infer = make_infer_fn(model, cfg)
    infer(ring[0])                              # cuDNN autotunes this shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    softargmax_kernel.launches = 0
    t0 = time.perf_counter()
    outs = [infer(ring[i % len(ring)]) for i in range(FRAMES // BATCH)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = softargmax_kernel.launches
    mu, lik = outs[-1]
    ok = (tuple(mu.shape) == (BATCH, NUM_JOINTS, 2)
          and bool(torch.isfinite(mu).all()) and bool(torch.isfinite(lik).all())
          and bool(((lik >= 0) & (lik <= 1)).all()))
    out = {"phase": "full_frame", "dtype": "bfloat16", "batch": BATCH,
           "hw": list(HW), "frames": FRAMES, "seconds": dt,
           "frames_per_s": FRAMES / dt, "launches": launches,
           "bf16_vs_f32_px": bf16_px,
           "bf16_vs_f32_logit_rel": bf16_logit_rel,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    if (launches <= 0 or not ok or not np.isfinite(bf16_px["max"])
            or not np.isfinite(bf16_logit_rel)):
        raise AssertionError(f"full-frame path failed: {out}")
    return model, launches, mu_bf16


def moving_blob_frames(n: int):
    """(n, 747, 832, 3) uint8: fixed seeded noise plus a bright disc that
    circles the frame."""
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    base = rng.integers(0, 40, (*HW, 3), dtype=np.uint8)
    frames = np.broadcast_to(base, (n, *HW, 3)).copy()
    t = np.arange(n)
    rows = (HW[0] / 2 + HW[0] / 4 * np.sin(2 * np.pi * t / 400)).astype(int)
    cols = (HW[1] / 2 + HW[1] / 4 * np.cos(2 * np.pi * t / 400)).astype(int)
    for k in range(n):
        frames[k, rows[k] - 12:rows[k] + 12, cols[k] - 12:cols[k] + 12] = 255
    return frames


def phase_tracked_crop(cfg, device, model):
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.infer.dynamic import estimate_pose_dynamic
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel

    frames = moving_blob_frames(FRAMES)
    kw = dict(crop_hw=CROP_HW, chunk=BATCH, device=device)
    estimate_pose_dynamic(model, cfg, frames[:4 * BATCH], **kw)  # autotune
    torch.cuda.synchronize()
    softargmax_kernel.launches = 0
    t0 = time.perf_counter()
    res = estimate_pose_dynamic(model, cfg, frames, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = softargmax_kernel.launches
    ok = (res["mu"].shape == (FRAMES, NUM_JOINTS, 2)
          and np.isfinite(res["mu"]).all()
          and np.isfinite(res["likelihoods"]).all())
    out = {"phase": "tracked_crop", "dtype": "bfloat16", "chunk": BATCH,
           "hw": list(HW), "crop_hw": list(CROP_HW), "frames": FRAMES,
           "seconds": dt, "frames_per_s": FRAMES / dt,
           "cropped_share": float(res["cropped"].mean()),
           "launches": launches}
    emit(out)
    if launches <= 0 or not ok:
        raise AssertionError(f"tracked-crop path failed: {out}")
    return launches


def reset_launches() -> None:
    from deepgraphpose_tpu_torch.ops.kernels import (int8_gemm_kernel,
                                                     softargmax_kernel)

    softargmax_kernel.launches = 0
    for name in int8_gemm_kernel.launches:
        int8_gemm_kernel.launches[name] = 0


def read_launches() -> dict:
    from deepgraphpose_tpu_torch.ops.kernels import (int8_gemm_kernel,
                                                     softargmax_kernel)

    return {"softargmax_likelihood": softargmax_kernel.launches,
            **int8_gemm_kernel.launches}


def op_bound(ops: float, n_bytes: float, ops_per_s: float) -> dict:
    """Least time for ``ops`` tensor-core operations at the dense peak and
    ``n_bytes`` moved (each input read once, each output written once)."""
    bound = {"bytes": 1e3 * n_bytes / HBM_BYTES_PER_S,
             "operations": 1e3 * ops / ops_per_s}
    bound_by = max(bound, key=bound.get)
    return {"bound_ms": bound[bound_by], "bound_by": bound_by}


def eager_ms(fn, x) -> float:
    """Device ms of one call after a warm-up call (for the plain versions,
    whose float64 convolutions allocate too much to capture many times)."""
    import torch

    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(x)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def library_ms(fn, inputs, reps: int):
    """Time of a PyTorch yardstick, or its error if it refuses the shape."""
    try:
        return time_ms(fn, inputs, reps), None
    except RuntimeError as err:
        return None, str(err).splitlines()[0][:200]


def phase_mm(device) -> dict:
    """mm_tiled at the probe's 4096^3 against its plain version, timed
    beside its bound, the plain version and the library product."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.ops import int8_gemm as plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    n = MM_SIZE
    rng = np.random.default_rng(SEED + 6)

    def ints():   # the probe's operands (scripts/int8_conv_probe.py:125)
        return torch.from_numpy(rng.integers(-8, 8, (n, n), dtype=np.int8)
                                ).to(device)

    a8 = [ints(), ints()]
    b8 = ints()
    abf, bbf = [a.to(torch.bfloat16) for a in a8], b8.to(torch.bfloat16)
    errors = {}
    for name, a, b in (("int8", a8[0], b8), ("bf16", abf[0], bbf)):
        got, want = gk.mm(a, b), plain.mm(a, b)
        torch.cuda.synchronize()
        errors[name] = (got.double() - want.double()).abs().max().item()
    # bf16 on normal values: the kernel sums in float32, plain in float64
    an = torch.from_numpy(rng.standard_normal((n, n), np.float32)).to(
        device, torch.bfloat16)
    bn = torch.from_numpy(rng.standard_normal((n, n), np.float32)).to(
        device, torch.bfloat16)
    got, want = gk.mm(an, bn), plain.mm(an, bn)
    torch.cuda.synchronize()
    bf16_normal_rel = ((got - want).abs().max() / want.abs().max()).item()
    del got, want, an, bn

    int8_lib, int8_lib_err = library_ms(
        lambda a: torch._int_mm(a, b8), a8, 20)
    bf16_lib, _ = library_ms(lambda a: torch.matmul(a, bbf), abf, 20)
    # the kernel reads B as (N, K): timed on a B transposed once, as a
    # QuantConv keeps its weight; the transposition is timed on its own
    b8t, bbft = b8.t().contiguous(), bbf.t().contiguous()
    emit({"phase": "mm_transpose", "shape": [n, n],
          "int8_ms": time_ms(lambda b: b.t().contiguous(), [b8, *a8], 20),
          "bf16_ms": time_ms(lambda b: b.t().contiguous(), [bbf, *abf], 20)})
    out = {
        "phase": "mm", "shape": [n, n, n], "ring_stages": gk.ring_stages(),
        "max_abs_err_int8": errors["int8"], "max_abs_err_bf16": errors["bf16"],
        "bf16_normal_rel_err": bf16_normal_rel,
        "int8": {"ms": time_ms(lambda a: gk.mm(a, b8, b_nk=b8t), a8, 20),
                 "plain_ms": eager_ms(lambda a: plain.mm(a, b8), a8[0]),
                 "library_ms": int8_lib, "library": "torch._int_mm",
                 "library_error": int8_lib_err,
                 **op_bound(2.0 * n ** 3, 6 * n * n, INT8_OPS_PER_S)},
        "bf16": {"ms": time_ms(lambda a: gk.mm(a, bbf, b_nk=bbft), abf, 20),
                 "plain_ms": eager_ms(lambda a: plain.mm(a, bbf), abf[0]),
                 "library_ms": bf16_lib,
                 "library": "torch.matmul (writes bf16)",
                 **op_bound(2.0 * n ** 3, 8 * n * n, BF16_OPS_PER_S)},
    }
    for key in ("int8", "bf16"):
        out[key]["tops"] = 2.0 * n ** 3 / out[key]["ms"] / 1e9
    emit(out)
    if errors["int8"] != 0 or errors["bf16"] != 0 or bf16_normal_rel > 1e-5:
        raise AssertionError(f"mm_tiled disagrees with plain: {out}")
    return out


def calib_frames(n: int):
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    return rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8)


def phase_quantize(cfg, model_f32, residual: bool):
    """quantize_model of the f32 model on CALIB_FRAMES seeded frames."""
    import torch

    from deepgraphpose_tpu_torch.models.quant import quantize_model

    t0 = time.perf_counter()
    qmodel = quantize_model(cfg, model_f32, calib_frames(CALIB_FRAMES),
                            dtype=torch.bfloat16, residual_int8=residual)
    torch.cuda.synchronize()
    return qmodel, time.perf_counter() - t0


SIGNATURE = ("route", "k", "cin", "cout", "stride", "rate", "in_hw", "in",
             "out", "relu")


@contextlib.contextmanager
def checked_convs(qmodel, path: str, calls: list):
    """Within the block, each int8 conv of ``qmodel`` launches as its path
    launches it; the first call of each (site, input shape and type,
    output) is then held on that same input against the plain version:
    the int32 accumulator exactly (the kernel once more, with an int32
    store), and the call's own output within one bf16 ulp (a float store)
    or +-1 on at most 1e-4 of the values (an int8 store: ties of the
    requantization). The plain version runs CHECK_FRAMES frames at a time.
    Each checked call is appended to ``calls``; a disagreement raises. The
    checking launches happen inside the block only, so a run that counts
    launches keeps them out."""
    import torch

    from deepgraphpose_tpu_torch.ops import int8_gemm as plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    site_of = {q.qw.data_ptr(): name for name, q in qmodel.sites.items()}
    kernel = gk.conv_int8
    seen = set()

    def conv(x, w, k, stride, rate, pad, oscale, bias, relu, out,
             in_scale=None, w_nk=None):
        y = kernel(x, w, k, stride, rate, pad, oscale, bias, relu, out,
                   in_scale, w_nk=w_nk)
        site = site_of[w.data_ptr()]
        kind = "int8" if isinstance(out, tuple) else str(out).split(".")[-1]
        key = (site, tuple(x.shape), x.dtype, kind)
        if key in seen:
            return y
        seen.add(key)
        args = (w, k, stride, rate, pad, oscale, bias, relu)
        acc = kernel(x, *args, torch.int32, in_scale, w_nk=w_nk)
        acc_err, step, differing, within = 0.0, 0.0, 0, True
        for i in range(0, x.shape[0], CHECK_FRAMES):
            part = slice(i, i + CHECK_FRAMES)
            want_acc = plain.conv_int8(x[part], *args, torch.int32, in_scale)
            if not torch.equal(acc[part], want_acc):
                acc_err = max(acc_err, (acc[part].double() - want_acc.double()
                                        ).abs().max().item())
            want = plain.epilogue(want_acc, oscale, bias, relu, out).float()
            diff = (y[part].float() - want).abs()
            step = max(step, diff.max().item())
            within = within and bool((diff <= want.abs() * 2.0 ** -7).all())
            differing += int((diff != 0).sum().item())
            del want_acc, want, diff
        del acc
        share = differing / y.numel()
        entry = {
            "path": path, "site": site,
            "route": ("mm_tiled" if k == 1 and stride == 1 and pad == 0
                      else "conv_int8"),
            "k": k, "cin": x.shape[-1], "cout": w.shape[1], "stride": stride,
            "rate": rate, "batch": x.shape[0], "in_hw": list(x.shape[1:3]),
            "out_hw": list(y.shape[1:3]), "in": str(x.dtype).split(".")[-1],
            "out": kind, "relu": bool(relu), "acc_err": acc_err,
            "differing_share": share,
            "replay": (k, stride, rate, pad, relu, out, in_scale)}
        calls.append(entry)
        ok = (step <= 1 and share <= 1e-4) if kind == "int8" else within
        if acc_err != 0 or not ok:
            raise AssertionError(
                f"{path} {site} {tuple(x.shape)} {entry['in']} -> {kind}: "
                f"kernel vs plain: int32 error {acc_err}, largest output "
                f"difference {step}, differing share {share}")
        return y

    gk.conv_int8 = conv
    try:
        yield
    finally:
        gk.conv_int8 = kernel


def check_summary(calls) -> dict:
    return {"convs_checked": len(calls),
            "by_route": {r: sum(c["route"] == r for c in calls)
                         for r in ("mm_tiled", "conv_int8")},
            "max_abs_err_int32": max(c["acc_err"] for c in calls),
            "max_epilogue_differing_share": max(c["differing_share"]
                                                for c in calls)}


def phase_int8_conv(device, qmodel, calls) -> dict:
    """Each distinct conv of one int8 full-frame batch (the calls that
    ``checked_convs`` recorded) timed at its shape on seeded inputs of its
    type, with its launches per batch, its bound, the plain version's
    time, and ``torch._int_mm`` for the 1x1 stride-1 sites."""
    import torch

    from deepgraphpose_tpu_torch.ops import int8_gemm as plain
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    distinct: dict = {}
    for c in calls:
        distinct.setdefault(tuple(str(c[f]) for f in SIGNATURE),
                            [c, 0])[1] += 1
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    sites = []
    for c, count in distinct.values():
        q = qmodel.sites[c["site"]]
        k, stride, rate, pad, relu, out, in_scale = c["replay"]
        b, (h, w), cin, cout = c["batch"], c["in_hw"], c["cin"], c["cout"]
        (oh, ow), wide = c["out_hw"], c["in"] != "int8"

        def run(x, fn=gk.conv_int8, **kw):
            return fn(x, q.qw, k, stride, rate, pad, q.oscale, q.bias, relu,
                      out, in_scale, **kw)

        def ints():
            if wide:    # about the calibrated range, some clipped
                return (torch.randn((b, h, w, cin), generator=gen,
                                    device=device) * (40 * in_scale)
                        ).to(getattr(torch, c["in"]))
            return torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                                 dtype=torch.int8, device=device)

        ring = [ints(), ints()]
        m = b * oh * ow
        entry = {key: c[key] for key in ("site", "route", "k", "cin", "cout",
                                         "stride", "rate", "in_hw", "out_hw",
                                         "in", "out")}
        entry["launches_per_batch"] = count
        entry["ms"] = time_ms(lambda x: run(x, w_nk=q.qw_nk), ring, 5)
        # input, weight, scale and bias read once; output written once
        entry.update(op_bound(
            2.0 * m * cout * k * k * cin,
            b * h * w * cin * ring[0].element_size() + k * k * cin * cout
            + 8 * cout + m * cout * (1 if c["out"] == "int8" else 2),
            INT8_OPS_PER_S))
        entry["tops"] = 2.0 * m * cout * k * k * cin / entry["ms"] / 1e9
        torch.cuda.empty_cache()
        entry["plain_ms"] = eager_ms(lambda x: run(x, fn=plain.conv_int8),
                                     ring[0])
        torch.cuda.empty_cache()
        if c["route"] == "mm_tiled":     # on int8 input, as _int_mm takes it
            ring8 = [torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                                   dtype=torch.int8, device=device)
                     for _ in ring]
            entry["library_ms"], entry["library_error"] = library_ms(
                lambda x: torch._int_mm(x.view(-1, cin), q.qw), ring8, 5)
            del ring8
        else:
            entry["library_ms"] = None
        sites.append(entry)
        del ring
        torch.cuda.empty_cache()

    def per_batch(route):
        mine = [s for s in sites if s["route"] == route]
        out = {}
        for key in ("ms", "bound_ms", "plain_ms", "library_ms"):
            vals = [s[key] for s in mine]
            out[key] = None if None in vals else sum(
                v * s["launches_per_batch"] for v, s in zip(vals, mine))
        by = {}
        for s in mine:
            by[s["bound_by"]] = (by.get(s["bound_by"], 0.0)
                                 + s["bound_ms"] * s["launches_per_batch"])
        out["bound_by"] = max(by, key=by.get)
        out["launches_per_batch"] = sum(s["launches_per_batch"] for s in mine)
        return out

    out = {"phase": "int8_conv", "batch": BATCH, "hw": list(HW),
           "ring_stages": gk.ring_stages(),
           "per_batch": {route: per_batch(route)
                         for route in ("mm_tiled", "conv_int8")},
           "sites": sites}
    emit(out)
    return out


def phase_int8_full_frame(cfg, device, qmodel, name, images4, pred_f32,
                          mu_f32, mu_bf16):
    """The int8 model at batch 128 over 1024 frames, with its logits and
    px against the f32 (and px against the bf16) model. Its first batch,
    before the counted run, holds every conv against the plain version
    (``checked_convs``). Returns (the phase's line, the checked calls)."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.infer.predict import (infer_forward,
                                                       make_infer_fn)

    with torch.inference_mode():
        pred = qmodel(images4, heads=("part_pred",))["part_pred"]
    mu_q, _ = infer_forward(qmodel, cfg, images4)
    f, q = pred_f32.double(), pred.double()
    rel = ((q - f).abs().max() / f.abs().max()).item()
    corr = float(np.corrcoef(f.cpu().numpy().ravel(),
                             q.cpu().numpy().ravel())[0, 1])
    px = {}
    for ref_name, ref in (("f32", mu_f32), ("bf16", mu_bf16)):
        err = (mu_q - ref).abs() * cfg.stride
        px[ref_name] = {"max": err.max().item(), "mean": err.mean().item()}

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ring = [torch.randint(0, 256, (BATCH, *HW, 3), generator=gen,
                          dtype=torch.uint8, device=device) for _ in range(4)]
    infer = make_infer_fn(qmodel, cfg)
    calls: list = []
    with checked_convs(qmodel, name, calls):
        infer(ring[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    outs = [infer(ring[i % len(ring)]) for i in range(FRAMES // BATCH)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    mu, lik = outs[-1]
    ok = (tuple(mu.shape) == (BATCH, NUM_JOINTS, 2)
          and bool(torch.isfinite(mu).all()) and bool(torch.isfinite(lik).all())
          and bool(((lik >= 0) & (lik <= 1)).all()))
    out = {"phase": name, "dtype": "int8 backbone, bfloat16 heads",
           "residual_int8": qmodel.residual_int8, "batch": BATCH,
           "hw": list(HW), "frames": FRAMES, "seconds": dt,
           "frames_per_s": FRAMES / dt, "launches": launches,
           "logits_vs_f32": {"rel_err": rel, "corr": corr},
           "px_vs": px, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "checked": check_summary(calls)}
    emit(out)
    if (not ok or min(launches.values()) <= 0 or not rel < INT8_REL_ERR
            or not corr > INT8_CORR):
        raise AssertionError(f"{name} failed: {out}")
    return out, calls


def phase_int8_tracked_crop(cfg, device, qmodel):
    """``estimate_pose_dynamic`` with the int8 model. The warm-up run, on
    the first 4 chunks (full-frame chunks, then crops), holds every conv
    against the plain version (``checked_convs``), the crop's shapes
    included. Returns (the phase's line, the checked calls)."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.infer.dynamic import estimate_pose_dynamic

    frames = moving_blob_frames(FRAMES)
    kw = dict(crop_hw=CROP_HW, chunk=BATCH, device=device)
    calls: list = []
    with checked_convs(qmodel, "int8_tracked_crop", calls):
        estimate_pose_dynamic(qmodel, cfg, frames[:4 * BATCH], **kw)
    torch.cuda.synchronize()
    stem_hw = sorted({tuple(c["in_hw"]) for c in calls
                      if c["site"] == "conv1"})
    reset_launches()
    t0 = time.perf_counter()
    res = estimate_pose_dynamic(qmodel, cfg, frames, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    ok = (res["mu"].shape == (FRAMES, NUM_JOINTS, 2)
          and np.isfinite(res["mu"]).all()
          and np.isfinite(res["likelihoods"]).all())
    out = {"phase": "int8_tracked_crop", "chunk": BATCH, "hw": list(HW),
           "crop_hw": list(CROP_HW), "frames": FRAMES, "seconds": dt,
           "frames_per_s": FRAMES / dt,
           "cropped_share": float(res["cropped"].mean()),
           "launches": launches, "checked": check_summary(calls),
           "checked_stem_in_hw": stem_hw}
    emit(out)
    if min(launches.values()) <= 0 or not ok or CROP_HW not in stem_hw:
        raise AssertionError(f"int8 tracked-crop path failed: {out}")
    return out, calls


def kernel_class(name: str) -> str:
    """Sort a device kernel's name into decode, int8_gemm (the port's int8
    GEMM, matched before the library GEMMs), convolution, elementwise,
    copy or other."""
    import re

    for label, pattern in (
            ("decode", r"softargmax_likelihood"),
            ("int8_gemm", r"gemm_kernel<|gemm_kernelI"),
            ("convolution",
             r"(?i)conv|cudnn|xmma|implicit|gemm|wgrad|dgrad|fprop|sm90"),
            ("copy", r"(?i)copy|memcpy|memset|cat|pad"),
            ("elementwise", r"(?i)elementwise|vectorized|reduce|pool|max")):
        if re.search(pattern, name):
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def profile_path(name: str, step, batches: int) -> dict:
    """Trace ``batches`` calls of ``step`` with torch.profiler: wall ms per
    batch, the device's busy share of that wall time (union of kernel
    intervals), and device ms per batch by kernel class."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()                                      # autotune outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_class: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_class[kernel_class(e.name)] = by_class.get(
            kernel_class(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "phase": "profile", "path": name, "batches": batches,
        "wall_ms_per_batch": wall_us / batches / 1e3,
        "device_busy_share": busy / wall_us,
        "kernels_per_batch": len(kernels) / batches,
        "device_ms_per_batch": {k: v / batches / 1e3 for k, v in
                                sorted(by_class.items(),
                                       key=lambda kv: -kv[1])},
        "top_kernels_ms_per_batch": [[n[:90], v / batches / 1e3]
                                     for n, v in top],
    }


def phase_profile(cfg, device, model, qmodel, batches: int = 3) -> None:
    """Where the device time goes: full-frame batches and tracked-crop
    steps (the crop step alone, at a fixed center) of the bf16 model, and
    full-frame batches of the int8 model."""
    import torch

    from deepgraphpose_tpu_torch.infer.dynamic import make_crop_infer_fn
    from deepgraphpose_tpu_torch.infer.predict import make_infer_fn

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    frames = torch.randint(0, 256, (BATCH, *HW, 3), generator=gen,
                           dtype=torch.uint8, device=device)
    full = make_infer_fn(model, cfg)
    crop = make_crop_infer_fn(model, cfg, CROP_HW)
    center = (HW[0] / 2, HW[1] / 2)
    full_int8 = make_infer_fn(qmodel, cfg)
    for name, step in (("full_frame", lambda: full(frames)),
                       ("tracked_crop", lambda: crop(frames, center)),
                       ("int8_full_frame", lambda: full_int8(frames))):
        emit(profile_path(name, step, batches))


def main() -> int:
    if not (ROOT / "deepgraphpose_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(deepgraphpose_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this check runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.ops.kernels import build

    device = torch.device("cuda")
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": build.sources(), "nvcc": " ".join(build.NVCC_FLAGS),
          "ptxas": {k: v.strip() for k, v in build.build_logs.items()}})
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    cfg = PoseConfig(net_type="resnet_50", num_joints=NUM_JOINTS,
                     compute_dtype="bfloat16", infer_batch_size=BATCH)
    generator = torch.Generator().manual_seed(SEED)
    kern = phase_kernel(cfg, device)
    model_f32, images4, mu_f32, pred_f32 = phase_f32(cfg, device, generator)
    model, full_launches, mu_bf16 = phase_full_frame(
        cfg, device, model_f32, images4, mu_f32, pred_f32)
    crop_launches = phase_tracked_crop(cfg, device, model)
    mm = phase_mm(device)

    qmodel, seconds = phase_quantize(cfg, model_f32, residual=False)
    emit({"phase": "quantize", "calib_frames": CALIB_FRAMES, "hw": list(HW),
          "seconds": seconds, "sites": len(qmodel.sites)})
    int8_paths, checks = {}, []
    path, calls = phase_int8_full_frame(
        cfg, device, qmodel, "int8_full_frame", images4, pred_f32, mu_f32,
        mu_bf16)
    int8_paths["int8_full_frame"] = path
    checks += calls
    conv = phase_int8_conv(device, qmodel, calls)
    path, calls = phase_int8_tracked_crop(cfg, device, qmodel)
    int8_paths["int8_tracked_crop"] = path
    checks += calls
    rmodel, _ = phase_quantize(cfg, model_f32, residual=True)
    path, calls = phase_int8_full_frame(
        cfg, device, rmodel, "int8_residual_full_frame", images4, pred_f32,
        mu_f32, mu_bf16)
    int8_paths["int8_residual_full_frame"] = path
    checks += calls
    del rmodel, model_f32, pred_f32
    phase_profile(cfg, device, model, qmodel)

    by_path = {name: path["launches"] for name, path in int8_paths.items()}
    decode_by_path = {"full_frame": full_launches,
                      "tracked_crop": crop_launches,
                      **{name: counts["softargmax_likelihood"]
                         for name, counts in by_path.items()}}
    main_shape = kern["shapes"][0]          # the full-frame maps
    conv_int8 = conv["per_batch"]["conv_int8"]
    acc_err = {r: max(c["acc_err"] for c in checks if c["route"] == r)
               for r in ("mm_tiled", "conv_int8")}
    emit({"kernels": [{
        "name": "softargmax_likelihood", "route": "cuda",
        "source": "deepgraphpose_tpu_torch/csrc/softargmax.cu",
        "replaces": "deepgraphpose_tpu/ops/pallas/softargmax_kernel.py:89",
        "launches": sum(decode_by_path.values()),
        "launches_by_path": decode_by_path,
        "max_abs_err": max(kern["max_abs_err_mu"], kern["max_abs_err_lik"]),
        "max_abs_err_mu": kern["max_abs_err_mu"],
        "max_abs_err_lik": kern["max_abs_err_lik"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "cluster": main_shape["layout"]["cluster"],
        "registers": kern["registers"],
        "shapes": [{k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "layout")}
                   for d in kern["shapes"]],
    }, {
        "name": "mm_tiled", "route": "cuda",
        "source": "deepgraphpose_tpu_torch/csrc/int8_gemm.cu",
        "replaces": "scripts/int8_conv_probe.py:179",
        "launches": sum(c["mm_tiled"] for c in by_path.values()),
        "launches_by_path": {n: c["mm_tiled"] for n, c in by_path.items()},
        "max_abs_err": max(mm["max_abs_err_int8"], mm["max_abs_err_bf16"],
                           acc_err["mm_tiled"]),
        "shape": mm["shape"], "ring_stages": mm["ring_stages"],
        **{k: mm["int8"][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
        "bf16": {k: mm["bf16"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
        "conv_sites_per_batch": conv["per_batch"]["mm_tiled"],
    }, {
        "name": "conv_int8", "route": "cuda",
        "source": "deepgraphpose_tpu_torch/csrc/int8_gemm.cu",
        "replaces": "scripts/int8_conv_probe.py:179",
        "launches": sum(c["conv_int8"] for c in by_path.values()),
        "launches_by_path": {n: c["conv_int8"] for n, c in by_path.items()},
        "max_abs_err": acc_err["conv_int8"],
        "unit": "per 128-frame batch: the sum over its sites' launches",
        **{k: conv_int8[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
