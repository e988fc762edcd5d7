#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero and the
last line is then never printed:

1. device: the card's name and power limit (nvidia-smi), then nvcc builds
   every kernel under deepgraphpose_tpu_torch/csrc for sm_90a;
2. kernel: the CUDA decode kernel against its plain PyTorch version on the
   card (mu within 1e-4 cells of the plain version in float64, likelihood
   within 1e-5) at the maps of both main-path phases (full frame and
   tracked crop) and at odd shapes (an unaligned frame, also as a view one
   float into its storage, C = 1, C = 33, C = 2000, 300 joints on the
   full-frame maps and 40 on output stride 8's, and the training steps'
   11 and 2 frames), and its time at each main-path shape beside its
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
5b. bn_tail: the frozen-BN tail kernel (``frozen_bn_act``) at the sites
   of ResNet-50 and MobileNetV2 at batch 128 and 747x832 in bfloat16 (the
   root BN + ReLU, the projection, identity and subsample unit tails, a
   bottleneck's BN + ReLU, MobileNetV2's largest relu6 expand, a project
   BN with the residual) and two of them in float32: bit for bit the
   plain chain (``bn_act_kernel.plain``), its time beside the bound of the
   bytes it reads and writes once and the plain chain's time, by CUDA
   events. Every float inference path (4, 5 and the float paths after)
   launches it, the int8 and training paths never;
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
10b. mobilenet: mobilenet_v2_1.0 at full width and depth, as phases 3,
   4 and 7-9 for ResNet-50: ``mobilenet_f32`` (4 frames, card logits
   against the CPU, TF32 off), ``mobilenet_full_frame`` (bf16, b=128,
   1024 frames: frames/s, decode launches), ``mobilenet_quantize``,
   ``mobilenet_int8_full_frame`` (every conv checked as above: the stem
   on ``conv_int8`` with ReLU6 and TF SAME's split pads, the 1x1s on
   ``mm_tiled`` with ReLU6, the first expand's 1.91e9 outputs; frames/s,
   logits against f32), ``mobilenet_int8_checks`` and
   ``mobilenet_int8_conv`` (each distinct int8 conv timed);
11. train_parity: one DGP step-2 update of ResNet-50 (3 frames of
    128x160, a limb clique, wt > 0, seeded flow) from one init and batch,
    frozen and trainable batch-norm, TF32 off: on the card in float32, on
    the CPU in float32 and in float64. Card and CPU float32 loss terms
    within 1e-5 relative; against the float64 step the card's parameters
    (1e-5) and momentum traces (1e-4 of a tensor's largest value) within
    those bounds or no farther than twice the CPU's float32 step; and
    the gradient of mu through the kernel path against the plain path's
    on step 2's (11, 94, 104, 5) maps;
12. train_step0, train_step1, train_step2: the DGP chain at 747x832,
    ResNet-50 in float32 with trainable batch-norm, one model through the
    three steps: the DLC step at batch 1, step 1 at pad_to 2, step 2 at
    pad_to 11 (limb clique, wt > 0, flow from OpenCV's Farneback where
    cv2 imports, else a seeded field), batches from ``assemble_batch``
    over in-memory moving-blob frames; 2 warm-up and 10 timed steps each,
    host-fed (the batch copied to the card every step): steps/s, frames/s,
    peak memory, first and last loss (finite and falling), the decode
    launches (one per DGP step, none in the DLC step) and layout;
13. fit: the training entry points with their defaults on the port's
    synthetic project (utils/synthetic.py) at 747x832, 120 frames, 10
    labeled, 5 joints, written into a temporary directory that is then
    deleted; ResNet-50 float32 from a seeded random init: fit_dlc (labeled
    pool, scale jitter on the card, trainable BN), fit_dgp_labeledonly
    and fit_dgp(batch_size=10) (frame pools, the reference augmentation
    on the card), each 22 updates, a host-fed fit_dgp(wt=1) with
    Farneback flow, 6 updates, fit_dgp(wt=1, device_flow=True) from the
    frame pool with the Lucas-Kanade flow made on the card, fit_dgp over a
    pool budget patched down in this script so that the frames rotate
    through the card in at least 3 segments (segment count, host assembly
    seconds and one segment's copy time), and fit_dlc and fit_dgp with
    scan_iters=11 (on the card: CUDA graph replays) beside their eager
    twins under deterministic cuDNN (final parameters within 1e-5 of each
    tensor's largest value); fit_dgp(compute_dtype="bfloat16") beside the
    float32 fit_dgp (``fit_bf16_vs_f32``: steps/s, peak memory, losses);
    mobilenet_v2_1.0's fit_dlc -> fit_dgp_labeledonly -> fit_dgp on a
    copy of the project (from the seeded init, trainable batch-norm in
    step 0); per run steps/s and frames/s between the loss
    reads at iteration 2 and the last (with the superstep: between its
    first and last dispatch ends; snapshot writes taken out), peak memory,
    the feed, losses (finite, falling), the snapshots written and left
    after pruning, and every kernel's launches (the decode once an update
    of the DGP runs, graph replays counted, never in fit_dlc, no GEMM
    kernel); then on the card: one pooled against one host-fed update
    without augmentation on the same window and weights (loss terms and
    parameters within 1e-6 relative), the augmentation on the card
    against the CPU on the same draws at (11, 747, 832) (images within
    1e-3, keypoints within 1e-4 px), the flow of one window on the card
    against the CPU (within twice the CPU float32 run's distance from the
    CPU float64 run, or 1e-5 of the largest value), skip-if-final, and
    ``estimate_pose`` from the step-2 final snapshot;
13b. analysis: what users run after training, on the fit project and
    its step-2 final snapshot, each path's launches counted from 0:
    ``analyze_videos`` full frame (timed; its trajectories, read back from
    the CSV, reported against the fit phase's ``estimate_pose``), again
    beside ``estimate_pose`` under deterministic cuDNN (within 1e-4 px:
    autotuned float32 convolutions differ from call to call), with
    dynamic=(True, 0.5, 10), with num_outputs=3 (the DLC top-k decode: no
    decode kernel; its first peak is the argmax decode of the same heads,
    and the card's top-k locations equal, its values within 1e-5 of, the
    same decode of the same heads on the CPU) and with preset="fast"
    (scale 0.75 + residual int8: ``mm_tiled`` and ``conv_int8``);
    ``analyze_time_lapse_frames`` over the labeled frames;
    ``evaluate_network``, ``evaluate_dgp(decode="dlc")`` (no decode
    kernel), ``evaluate_dgp(quantize=True)`` (both GEMM routes), and
    ``evaluate_dgp`` in float32 (TF32 off) against the same call on the
    CPU, within 1e-2 px; the wall seconds and frames/s of the full-frame
    and the fast analysis (video decode and CSV writes included). Where
    h5py is absent the H5 writers become recorders for the phase (the
    package raises without h5py, as the JAX package does);
13c. parallel: data parallelism and the multi-window group updates
    (``parallel/``), on the fit project: fit_dgp(batch_size=10) one
    window an update beside windows_per_device=2 eager and with
    scan_iters=11 (updates/s, windows/s, frames/s, peak memory; the
    superstep's final parameters against its eager twin's, reported),
    then the two-window pair again under deterministic cuDNN (the same
    code, the windows through the trunk in one call; the superstep's final
    parameters within 1e-5 of each tensor's largest of its eager twin's);
    two ranks on the one card
    (this script started twice with ``--parallel-worker``, gloo, each on
    cuda:0) against world 1 in this process: the float64 DP steps
    (``make_dp_pooled_dgp_train_step`` with trainable batch-norm and the
    device flow, ``make_dp_pooled_dlc_train_step`` with global-batch
    batch-norm and the reference augmentation; ResNet-50 at 128x160, loss
    terms 1e-5 relative, parameters and buffers 1e-5 of each tensor's
    largest), fit_dgp(data_parallel=2) against
    fit_dgp(windows_per_device=2) from the same seed at 747x832 (TF32
    off, deterministic cuDNN; ``rtol=1e-4, atol=1e-5``) and
    ``estimate_pose_multichip`` on a small video (displacement and
    smoothed track within 1e-6 of world 1) and, each rank decoding only
    its frames, over the fit project's 747x832 video in bfloat16 (x and y
    within 1e-4 px of world 1, frames/s of both); whether NCCL takes two ranks
    on one card (``--nccl-probe``, reported); then
    ``estimate_pose_multichip`` at world 1 under an NCCL group over the
    fit project's video in bf16 and int8: raw within 1e-4 px of
    ``estimate_pose`` on the same snapshot and batches, smoothed within
    1e-5 of ``ewma_reference``, frames/s;
13d. serving: ``infer/serving.py`` on the step-2 final snapshot at
    747x832: ``export_from_snapshot`` in float32 at batch 16, loaded in
    this process, (mu, likelihood) within 1e-5 of ``infer_forward`` on the
    same weights and batches (TF32 off) and frames/s beside
    ``make_infer_fn``; in bfloat16 at batch 128 beside the live bf16 model;
    int8 (``quantize=True``, calibrated on the video's first 8 frames
    resized to 747x832) against the live int8 model of the same recipe on
    the next 16 frames (within 1e-2 px; its logits within the int8 bounds
    of phase 8 there), with ``mm_tiled``
    and ``conv_int8`` launched by the loaded program; the float32 artifact
    in a fresh process (this script with ``--serve-worker``) that imports
    only ``deepgraphpose_tpu_torch.infer.serving`` with JAX blocked (the
    decode launched there, the result within 1e-5 of this process's); each
    artifact's size, export and load seconds;
13e. headonly: ``fit_dlc_heads`` from the fit phase's step-0 final
    snapshot, 210 updates: steps/s beside the fit phase's fit_dlc, the
    feature cache's bytes and forward seconds; the loss falls, the
    backbone is bit-identical to the step-0 snapshot, the heads moved, the
    frozen-BN tail kernel launched in the feature cache and no kernel
    elsewhere, and ``estimate_pose`` runs from the snapshot written;
13f. render: ``plot_dgp`` from the step-2 snapshot on the fit project's
    video under deterministic cuDNN (the MP4 holds all 120 frames, its
    trajectories within 1e-4 px of ``estimate_pose``'s; wall frames/s, with
    ``estimate_pose`` and the draw/encode seconds apart), then with
    ``quantize=True``; the labeled frames' scoremaps
    (``extract_save_all_maps``, or, where matplotlib is absent, its maps
    without the drawing), ``evaluate_network(plotting=True)`` and
    ``display_dataset`` (where matplotlib is absent, their ImportError is
    reported on a ``render_not_run`` line), ``utils/profiling.trace``
    around one served batch (the trace holds the decode kernel), and
    ``device_memory_stats``;
13g. workflow: the DLC project workflow through the port's CLI
    (``python -m deepgraphpose_tpu_torch.cli``, called in this process as
    ``cli.main(argv)``, one call a command, each counted from 0 on a line
    of its own with its wall seconds) on the fit phase's 747x832 video
    with ResNet-50: create-project, extract-frames (uniform), the labels
    written from the video's ground truth, check-labels,
    create-training-dataset, train --step 0, 1 and 2 (22 updates each),
    evaluate and evaluate --int8, analyze-videos (under deterministic
    cuDNN: its trajectories within 1e-4 px of ``estimate_pose`` from the
    same step-2 snapshot) and analyze-videos --int8, filter-predictions,
    extract-outlier-frames, analyze-skeleton, create-labeled-video,
    export-model (batch 16, float32), create-project-3d, calibrate-cameras
    on checkerboard views rendered for two seeded camera poses (the
    relative pose recovered: RMS below 1 px, fresh points triangulated
    within 0.5), triangulate. The decode launched by every command that
    runs the model but the DLC step, ``mm_tiled`` and ``conv_int8`` by the
    int8 ones (their first batch's convs checked as in phase 10), no GEMM
    kernel elsewhere, every model on the card. Where h5py is absent the
    pose tables are kept as numpy archives under their .h5 names, and the
    commands that need matplotlib or h5py themselves (check-labels,
    analyze-skeleton, triangulate) are reported with their ImportError on
    a ``workflow_not_run`` line;
13h. native_decode: the native batch JPEG decoder (``native/``, built
    with g++ at first use; its build status is printed after the device
    line: available, the library's path, or why not): ``FrameCache.
    get_batch`` through the native decode against the cache's OpenCV
    path, in turns, on 24 seeded 11-frame windows of the fit project's
    746x832 video (wall ms a window; the two within 3 per channel value,
    tests/test_native.py's bound); then the host-fed fit_dgp(wt=1) of the
    fit phase (6 updates, Farneback flow) with the native decode and with
    OpenCV's, each with its host assembly (``assemble_s``) split into the
    decode and the flow, the decode launched once an update, every
    window decoded by the route named. Where the library does not build
    the phase times the OpenCV path alone and says why;
13i. trained (ROADMAP item 12b): ResNet-50 in float32, ResNet-50 with
    ``compute_dtype="bfloat16"`` and mobilenet_v2_1.0 in float32, each
    trained by ``fit_dlc`` from the seeded init (trainable batch-norm) on
    a twin of the fit project, on the labeled pool with the reference
    augmentation on the card and scale jitter 0.5-1.25 (the no-ImageNet
    recipe), positives within 17 px (pose_cfg's default; the project's
    9 px leave a joint one or two positive cells), a constant rate
    (0.02 for ResNet-50, 0.1 for MobileNetV2), 3960 updates (5940 for
    MobileNetV2) as supersteps of 11 under deterministic cuDNN (a run
    repeats exactly): updates, seconds and losses (finite, falling).
    Over the 120-frame video, for each
    float32-trained model: ``estimate_pose`` in float32 (TF32 off,
    deterministic cuDNN) from the trained and from the untrained
    snapshot, the labeled frames' RMSE to the labels (trained below
    untrained), and bfloat16, int8 and (ResNet-50) residual int8 against
    float32 (px median, p99 and max, also a joint at a time; likelihood
    differences), the labeled frames' RMSE with batch-norm on each
    frame's own statistics (a diagnostic of the moving ones), each int8
    path's first batch checked conv by conv as in phase 10; the
    bf16-trained ResNet-50 against the float32-trained one, both in
    float32; the decode on every path, the GEMM kernels on the int8
    paths only; then the trained ResNet-50 snapshot through
    ``export_tf_arrays`` and ``import_tf_arrays`` (exact) and, where
    tensorstore imports, an Orbax snapshot written and read back (exact),
    else an ``orbax_not_run`` line with the reason;
14. profile: where the device time goes, from torch.profiler over 3
    full-frame batches, 3 MobileNetV2 full-frame batches (its depthwise
    convs a class of their own), 3 tracked-crop steps, 3 int8 full-frame
    batches,
    3 host-fed step-2 train steps, 3 pooled, augmented step-2 steps, 3
    superstep dispatches of 11 such updates (graph replays), and 3 pooled
    step-2 steps with the flow made on the card (device ms per update by
    kernel class, the flow's own, device busy share, kernels and host
    launch calls per update);
15. the ``{"kernels": [...]}`` line;
16. ``{"ok": true, "device": {...}}``.

Every kernel wrapper counts its launches (a superstep adds each graph
replay's captured launches); the counts are set to 0 just before each
main-path run (phases 4, 5, 8, 10, 10b, 12, each fit run, each
analysis path, each parallel path, a rank's in its own process, each
served, head-only and render path, each workflow command, each host-fed
native_decode run and each trained run and path) and read just after,
and every kernel that the path runs must show launches > 0; phases 4,
5, 8, 10, 10b, 12, the fit runs and head-only also hold every other
kernel at 0. The weights
are random, from a seeded torch.Generator, or trained here from such an
init (phases 13 and 13i); nothing is read from disk but the repository's
own sources and the files the phases write.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import tempfile
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
TRAIN_BATCH = 10              # the demo's --batch_size; step 2 pads to + 1
TRAIN_FRAMES = 32             # moving-blob frames the training phases read
TRAIN_LABELED = (3, 6, 9, 14, 20)   # of them, labeled
TRAIN_WINDOW = 4              # step 2's window: frames 4..13, 2 labeled
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_LR = 0.005              # fit_dgp's rate (fit.py::_dgp_cfg_overrides)
TRAIN_PARITY_HW = (128, 160)  # card against CPU: ResNet-50 on 3 frames
TRAIN_PARITY_FRAMES = 3
# card vs CPU float32 logits, relative to the largest logit: both sum the
# convolutions in float32, in different orders and algorithms
LOGIT_RTOL = 1e-3
MOBILE_NET = "mobilenet_v2_1.0"   # the second backbone family, full width
# the kernels by the names their wrappers count them under
DECODE, BN_TAIL = "softargmax_likelihood", "frozen_bn_act"
GEMMS = ("mm_tiled", "conv_int8")


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

    mu is held against the plain version evaluated in float64 on the same
    logits: in float32 it rounds gamma * x itself, up to 9e-5 cells from
    float64 on large maps of noise. The likelihood is held against the
    plain 2x2 read at the kernel's own cell: where mu lies within 1e-4 of
    an integer the two versions may floor to neighbouring cells, and both
    reads are then right.
    """
    import torch

    from deepgraphpose_tpu_torch.ops import softargmax as plain
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel

    mu_k, lik_k = softargmax_kernel.softargmax_likelihood(
        x, gamma, gauss_len, layout=layout)
    torch.cuda.synchronize()
    mu_p, _ = plain.softargmax_2d(x.double(), gamma=gamma,
                                  gauss_len=gauss_len)
    lik_p = plain.max_sigmoid_2x2(x, mu_k)
    torch.cuda.synchronize()
    return ((mu_k.double() - mu_p).abs().max().item(),
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
    per = sk.joint_group(joints, h * w)
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
    stride8 = scoremap_size(cfg.replace(output_stride=8), HW)
    odd = [(3, 23, 31, 4), (2, 23, 31, 7), (8, *full[1:3], 1),
           (4, *crop[1:3], 33), (2, 8, 8, 2000),
           # many joints on large maps: the consumer-sum cap
           (BATCH, *full[1:3], 300), (BATCH, *stride8, 40),
           # the DGP training steps' maps: step 2's batch + 1, step 1's 2
           (TRAIN_BATCH + 1, *full[1:]), (2, *full[1:])]
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
        return e_mu, e_lik

    gen = torch.Generator(device=device).manual_seed(SEED)

    def maps(shape):
        if np.prod(shape) > 50_000_000:     # drawn on the card
            return torch.randn(shape, generator=gen, device=device) * 3
        return torch.from_numpy(
            (rng.standard_normal(shape) * 3).astype(np.float32)).to(device)

    g, s = cfg.gamma, cfg.gauss_len
    shapes = []
    for shape in (full, crop, *odd):
        x = maps(shape)
        views = [x, offset_view(x)] if shape == odd[1] else [x]
        errs = [check(view, gamma, gauss_len) for view in views
                for gauss_len in (0.0, 1.0, 2.0) for gamma in (1.0, 2.5)]
        checked.append({
            "shape": list(shape),
            "storage_offsets": [v.storage_offset() for v in views],
            "layout": softargmax_kernel.launch_shape(*shape, sms)._asdict(),
            "max_abs_err_mu": max(e[0] for e in errs),
            "max_abs_err_lik": max(e[1] for e in errs)})
        if shape in odd:
            del x, views
            torch.cuda.empty_cache()
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


def phase_f32(cfg, device, generator, name: str = "f32"):
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
    out = {"phase": name, "net_type": cfg.net_type, "frames": 4,
           "hw": list(HW),
           "scoremap": list(pred.shape[1:3]), "max_px_diff": px,
           "max_lik_diff": e_lik, "cpu_ref_logit_rel": logit_rel,
           "logit_absmax": scale,
           "cpu_ref_px_diff": (mu_k[:1].cpu() - mu_cpu).abs().max().item()
           * cfg.stride}
    emit(out)
    if not (np.isfinite(px) and px <= MU_TOL * cfg.stride and e_lik <= LIK_TOL
            and np.isfinite(logit_rel) and logit_rel <= LOGIT_RTOL):
        raise AssertionError(f"{name} forward: kernel decode vs plain, or "
                             f"card vs CPU logits, out of tolerance: {out}")
    return model, images, mu_k, pred


def phase_full_frame(cfg, device, model_f32, images4, mu_f32, pred_f32,
                     name: str = "full_frame"):
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.infer.predict import (infer_forward,
                                                       make_infer_fn)
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel

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
    out = {"phase": name, "net_type": cfg.net_type, "dtype": "bfloat16",
           "batch": BATCH,
           "hw": list(HW), "frames": FRAMES, "seconds": dt,
           "frames_per_s": FRAMES / dt, "launches": launches,
           "bf16_vs_f32_px": bf16_px,
           "bf16_vs_f32_logit_rel": bf16_logit_rel,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    if (not launched(launches, (DECODE, BN_TAIL)) or not ok
            or not np.isfinite(bf16_px["max"])
            or not np.isfinite(bf16_logit_rel)):
        raise AssertionError(f"{name} path failed: {out}")
    return model, launches, mu_bf16


def blob_centers(n: int):
    """(rows, cols) int pixel centers of the moving blob in frames 0..n-1."""
    import numpy as np

    t = np.arange(n)
    rows = (HW[0] / 2 + HW[0] / 4 * np.sin(2 * np.pi * t / 400)).astype(int)
    cols = (HW[1] / 2 + HW[1] / 4 * np.cos(2 * np.pi * t / 400)).astype(int)
    return rows, cols


def moving_blob_frames(n: int):
    """(n, 747, 832, 3) uint8: fixed seeded noise plus a bright disc that
    circles the frame."""
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    base = rng.integers(0, 40, (*HW, 3), dtype=np.uint8)
    frames = np.broadcast_to(base, (n, *HW, 3)).copy()
    rows, cols = blob_centers(n)
    for k in range(n):
        frames[k, rows[k] - 12:rows[k] + 12, cols[k] - 12:cols[k] + 12] = 255
    return frames


def phase_tracked_crop(cfg, device, model):
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.infer.dynamic import estimate_pose_dynamic

    frames = moving_blob_frames(FRAMES)
    kw = dict(crop_hw=CROP_HW, chunk=BATCH, device=device)
    estimate_pose_dynamic(model, cfg, frames[:4 * BATCH], **kw)  # autotune
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = estimate_pose_dynamic(model, cfg, frames, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    ok = (res["mu"].shape == (FRAMES, NUM_JOINTS, 2)
          and np.isfinite(res["mu"]).all()
          and np.isfinite(res["likelihoods"]).all())
    out = {"phase": "tracked_crop", "dtype": "bfloat16", "chunk": BATCH,
           "hw": list(HW), "crop_hw": list(CROP_HW), "frames": FRAMES,
           "seconds": dt, "frames_per_s": FRAMES / dt,
           "cropped_share": float(res["cropped"].mean()),
           "launches": launches}
    emit(out)
    if not launched(launches, (DECODE, BN_TAIL)) or not ok:
        raise AssertionError(f"tracked-crop path failed: {out}")
    return launches


def reset_launches() -> None:
    from deepgraphpose_tpu_torch.ops.kernels import add_launches

    add_launches(read_launches(), -1)


def read_launches() -> dict:
    from deepgraphpose_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def launched(counts: dict, kernels) -> bool:
    """Whether each of ``kernels`` launched and no other kernel did."""
    return all((n > 0) == (name in kernels) for name, n in counts.items())


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


# (site, (n, c, h, w), residual, act); the first is the kernels line's
BN_SITES = (
    ("block1_unit1_tail_projection", (BATCH, 256, 186, 207), "projection",
     "relu"),
    ("root_bn1_relu", (BATCH, 64, 374, 416), None, "relu"),
    ("block1_unit2_tail_identity", (BATCH, 256, 186, 207), "identity",
     "relu"),
    ("block1_unit3_tail_subsample", (BATCH, 256, 93, 104), "subsample",
     "relu"),
    ("block1_bn2_relu", (BATCH, 64, 186, 207), None, "relu"),
    ("block3_tail_identity", (BATCH, 1024, 47, 52), "identity", "relu"),
    ("block4_tail_identity", (BATCH, 2048, 47, 52), "identity", "relu"),
    ("mobilenet_expand_relu6", (BATCH, 96, 374, 416), None, "relu6"),
    ("mobilenet_project_residual", (BATCH, 24, 187, 208), "identity",
     "none"),
)
BN_F32_SITES = ("block1_unit1_tail_projection", "mobilenet_project_residual")
BN_F32_BATCH = 16


def bn_tail_inputs(shape, residual, dtype, device, generator):
    """(x, inv, shift, r, inv_r, shift_r) of a site: channels_last seeded
    values, factors away from 1 and 0 so that every op rounds; the
    subsample residual is slim's x[:, :, ::2, ::2] view of a tensor twice
    the size."""
    import torch

    n, c, h, w = shape

    def randn(*size):
        return torch.randn(size, generator=generator, device=device).to(
            dtype).contiguous(memory_format=torch.channels_last)

    x = randn(n, c, h, w)
    inv = (0.5 + torch.rand(c, generator=generator, device=device)).to(dtype)
    shift = torch.randn(c, generator=generator, device=device).to(dtype)
    r = inv_r = shift_r = None
    if residual in ("identity", "projection"):
        r = randn(n, c, h, w)
    elif residual == "subsample":
        r = randn(n, c, 2 * h, 2 * w)[:, :, ::2, ::2]
    if residual == "projection":
        inv_r = (0.5 + torch.rand(c, generator=generator,
                                  device=device)).to(dtype)
        shift_r = torch.randn(c, generator=generator, device=device).to(dtype)
    return x, inv, shift, r, inv_r, shift_r


def events_ms(fn, reps: int) -> float:
    """Mean device ms of ``reps`` eager calls after a warm-up call, by CUDA
    events (each call's output is fresh memory; a graph would keep them
    all)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_bn_tail(device) -> dict:
    """The frozen-BN tail kernel at each of BN_SITES in bfloat16, and at
    BN_F32_SITES in float32 at batch BN_F32_BATCH: bit for bit the plain
    chain, the kernel's and the chain's device ms, the bound of its bytes
    (x and the residual read once, the output written once) at
    HBM_BYTES_PER_S. Returns {"sites": [...]} for the kernels line."""
    import torch

    from deepgraphpose_tpu_torch.ops.kernels import bn_act_kernel as bk

    generator = torch.Generator(device=device).manual_seed(SEED + 11)
    rows = []
    cases = [(name, shape, res, act, torch.bfloat16)
             for name, shape, res, act in BN_SITES]
    cases += [(name, (BN_F32_BATCH, *shape[1:]), res, act, torch.float32)
              for name, shape, res, act in BN_SITES if name in BN_F32_SITES]
    for name, shape, res, act, dtype in cases:
        args = bn_tail_inputs(shape, res, dtype, device, generator)
        assert bk.takes(args[0], args[3]), name
        before = bk.launches
        got = bk.frozen_bn_act(*args, act=act)
        want = bk.plain(*args, act=act)
        torch.cuda.synchronize()
        bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        bitwise = (got.shape == want.shape and got.stride() == want.stride()
                   and torch.equal(got.view(bits[dtype]),
                                   want.view(bits[dtype])))
        max_abs_err = (got.float() - want.float()).abs().max().item()
        del got, want
        launches = bk.launches - before
        x, r = args[0], args[3]
        n_bytes = x.element_size() * x.numel() * (3 if r is not None else 2)
        ms = events_ms(lambda: bk.frozen_bn_act(*args, act=act), 10)
        plain_ms = events_ms(lambda: bk.plain(*args, act=act), 3)
        row = {"site": name, "shape": list(shape), "dtype": str(dtype),
               "residual": res, "act": act, "bitwise": bool(bitwise),
               "max_abs_err": max_abs_err, "launches": launches,
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
               "bound_by": "bytes", "bytes": n_bytes,
               "gb_per_s": n_bytes / ms / 1e6}
        row["share_of_bound"] = row["bound_ms"] / ms
        rows.append(row)
        del args, x, r
        torch.cuda.empty_cache()
    out = {"phase": "bn_tail", "hbm_bytes_per_s": HBM_BYTES_PER_S,
           "sites": rows}
    emit(out)
    if not all(r["bitwise"] and r["launches"] == 1 for r in rows):
        raise AssertionError(f"bn_tail: the kernel is not the chain: {out}")
    return out


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
        dense = k == 1 and stride == 1 and not any(
            sum(plain.side_pads(pad), ()))
        entry = {
            "path": path, "site": site,
            "route": "mm_tiled" if dense else "conv_int8",
            "k": k, "cin": x.shape[-1], "cout": w.shape[1], "stride": stride,
            "rate": rate, "batch": x.shape[0], "in_hw": list(x.shape[1:3]),
            "out_hw": list(y.shape[1:3]), "in": str(x.dtype).split(".")[-1],
            "out": kind, "relu": int(relu),
            "pad": [list(p) for p in plain.side_pads(pad)],
            "acc_err": acc_err,
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


def phase_int8_conv(device, qmodel, calls, name: str = "int8_conv") -> dict:
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

    out = {"phase": name, "net_type": qmodel.cfg.net_type, "batch": BATCH,
           "hw": list(HW),
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
    out = {"phase": name, "net_type": cfg.net_type,
           "dtype": "int8 backbone, bfloat16 heads",
           "residual_int8": qmodel.residual_int8, "batch": BATCH,
           "hw": list(HW), "frames": FRAMES, "seconds": dt,
           "frames_per_s": FRAMES / dt, "launches": launches,
           "logits_vs_f32": {"rel_err": rel, "corr": corr},
           "px_vs": px, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "checked": check_summary(calls)}
    emit(out)
    if (not ok or not launched(launches, (DECODE, *GEMMS))
            or not rel < INT8_REL_ERR or not corr > INT8_CORR):
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
    if (not launched(launches, (DECODE, *GEMMS)) or not ok
            or CROP_HW not in stem_hw):
        raise AssertionError(f"int8 tracked-crop path failed: {out}")
    return out, calls


def phase_mobilenet(device) -> dict:
    """MOBILE_NET's inference paths, as ResNet-50's: f32 (card against
    CPU, TF32 off), bf16 full frame, quantize_model, the int8 full frame
    with every conv checked (the stem on ``conv_int8`` with ReLU6 and TF
    SAME's split pads, the 1x1s on ``mm_tiled`` with ReLU6, MobileNetV2's
    first expand writing 1.9e9 outputs at batch 128), and each distinct
    int8 conv timed."""
    import torch

    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models.mobilenet import same_pads
    from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel as gk

    cfg = PoseConfig(net_type=MOBILE_NET, num_joints=NUM_JOINTS,
                     compute_dtype="bfloat16", infer_batch_size=BATCH)
    generator = torch.Generator().manual_seed(SEED + 8)
    model_f32, images4, mu_f32, pred_f32 = phase_f32(
        cfg, device, generator, "mobilenet_f32")
    model, full_launches, mu_bf16 = phase_full_frame(
        cfg, device, model_f32, images4, mu_f32, pred_f32,
        "mobilenet_full_frame")
    qmodel, seconds = phase_quantize(cfg, model_f32, residual=False)
    emit({"phase": "mobilenet_quantize", "calib_frames": CALIB_FRAMES,
          "hw": list(HW), "seconds": seconds, "sites": len(qmodel.sites),
          "depthwise_sites": len(qmodel.dw)})
    path, calls = phase_int8_full_frame(
        cfg, device, qmodel, "mobilenet_int8_full_frame", images4, pred_f32,
        mu_f32, mu_bf16)
    stem_pad = [list(same_pads(3, 2, 1, n)) for n in HW]
    stem = [c for c in calls if c["site"] == "conv_stem"]
    relu6 = {r: sum(c["route"] == r and c["relu"] == gk.RELU6 for c in calls)
             for r in ("mm_tiled", "conv_int8")}
    def outputs(c):
        return c["batch"] * c["out_hw"][0] * c["out_hw"][1] * c["cout"]

    largest = max(calls, key=outputs)
    out = {"phase": "mobilenet_int8_checks", "relu6_calls": relu6,
           "stem": {k: stem[0][k] for k in ("route", "relu", "pad", "k",
                                            "cin", "in_hw", "out_hw")}
           if stem else None,
           "largest_site": {"site": largest["site"],
                            "outputs": outputs(largest)},
           "sites_checked": len({c["site"] for c in calls}),
           "sites": len(qmodel.sites)}
    emit(out)
    if (not stem or stem[0]["route"] != "conv_int8"
            or stem[0]["relu"] != gk.RELU6 or stem[0]["pad"] != stem_pad
            or min(relu6.values()) <= 0
            or out["sites_checked"] != len(qmodel.sites)):
        raise AssertionError(f"MobileNetV2 int8 convs not all checked: {out}")
    conv = phase_int8_conv(device, qmodel, calls, "mobilenet_int8_conv")
    del model_f32, pred_f32
    torch.cuda.empty_cache()
    return {"cfg": cfg, "model": model, "full_launches": full_launches,
            "int8_path": path, "calls": calls, "conv": conv}


class BlobVideo:
    """The part of ``data/batcher.py::VideoDataset`` that ``assemble_batch``
    reads (``get_frames``, ``labels_rc_for_frames``, ``nj``, ``cfg``), in
    memory: TRAIN_FRAMES moving-blob frames at 747x832, the joints at fixed
    offsets around the blob, labeled on TRAIN_LABELED."""

    def __init__(self, cfg):
        import numpy as np

        from deepgraphpose_tpu_torch.data.batcher import xy_to_scoremap

        self.cfg, self.nj = cfg, cfg.num_joints
        self.frames = moving_blob_frames(TRAIN_FRAMES)
        rows, cols = blob_centers(TRAIN_FRAMES)
        offsets = np.array([[0, 0], [-20, 0], [20, 0], [0, -20], [0, 20]],
                           np.float64)[:self.nj]            # (x, y) pixels
        self.coords_xy = np.stack([cols, rows], -1)[:, None, :] + offsets
        self.visible_frames = np.asarray(TRAIN_LABELED, np.int64)
        self.labels_rc = xy_to_scoremap(self.coords_xy[self.visible_frames],
                                        cfg.stride)

    def get_frames(self, indices):
        import numpy as np

        return self.frames[np.asarray(indices)]

    def labels_rc_for_frames(self, frames):
        """(coords_rc, is_visible), NaN where a frame carries no labels."""
        import numpy as np

        from deepgraphpose_tpu_torch.data.batcher import xy_to_scoremap

        frames = np.asarray(frames)
        rc = np.full((len(frames), self.nj, 2), np.nan, np.float32)
        vis = np.isin(frames, self.visible_frames)
        rc[vis] = xy_to_scoremap(self.coords_xy[frames[vis]], self.cfg.stride)
        return rc, vis


# step 2's hyperparameters (fit.py::_dgp_cfg_overrides) with a temporal
# clique; step 1 turns the cliques and the hidden markers off
STEP2 = dict(ws=1000.0, ws_max=1.2, wt=1.0, wt_max=0.0, wn_visible=5.0,
             wn_hidden=3.0, gamma=1.0, gauss_len=1.0, lengthscale=1.0,
             gm2=0, gm3=0)
STEP1 = dict(STEP2, ws=0.0, wt=0.0, wn_visible=1.0, wn_hidden=0.0)
LIMBS = ((0, 1), (0, 2), (0, 3), (0, 4))      # a star skeleton of 5 joints


def incidence(nj: int):
    import numpy as np

    S0 = np.zeros((len(LIMBS), nj), np.float32)
    for k, (a, b) in enumerate(LIMBS):
        S0[k, a], S0[k, b] = 1.0, -1.0
    return S0


def conditioned_init(cfg, seed: int) -> dict:
    """The parity steps' init: init_model's LeCun kernels with the root
    conv divided by 100 (0-255 pixels give O(1) activations), batch-norm
    scale and var uniform in [0.5, 1.5], its bias and mean N(0, 0.1), as
    the JAX comparison tests draw their variables
    (tests/test_torch_train.py::random_variables). With frozen batch-norm
    it brings a float32 step's momentum traces within 1e-3 of the float64
    step's (PERF.md); init_model's identity batch-norm on 0-255 inputs
    leaves them several times farther."""
    import torch

    from deepgraphpose_tpu_torch.models.pose_model import init_model

    gen = torch.Generator().manual_seed(seed)
    state = init_model(cfg, gen, device="cpu").state_dict()
    for key, value in state.items():
        name = key.rsplit(".", 1)[1]
        if key == "backbone.conv1.weight":
            value /= 100.0
        elif name in ("scale", "var"):
            value.copy_(torch.rand(value.shape, generator=gen) + 0.5)
        elif name in ("bias", "mean") and "bn" in key:
            value.copy_(torch.randn(value.shape, generator=gen) * 0.1)
    return state


def one_step(model, params, images, batch, bn_train: bool, lr: float):
    """One step-2 update of ``model`` in its own dtype and device: (loss
    terms, parameters and buffers, momentum traces), as float64 on the
    CPU, and the decode launches it made."""
    import torch

    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel
    from deepgraphpose_tpu_torch.train import steps

    dtype = next(model.parameters()).dtype
    opt = steps.make_optimizer(model.parameters(), lr, clip_norm=10.0)
    step = steps.make_dgp_train_step(model, params, opt, bn_train=bn_train)
    before = softargmax_kernel.launches
    loss = step(images, {k: v.to(dtype) for k, v in batch.items()})
    if images.is_cuda or next(model.parameters()).is_cuda:
        torch.cuda.synchronize()
    launches = softargmax_kernel.launches - before

    def cpu64(t):
        return t.detach().to("cpu", torch.float64)

    return ({k: v.item() for k, v in loss.items()},
            {k: cpu64(v) for k, v in model.state_dict().items()},
            {k: cpu64(opt.state[p]["momentum_buffer"])
             for k, p in model.named_parameters()}, launches)


def step_errors(run, ref) -> dict:
    """A step's distance from the reference step: the largest loss-term
    error relative to the term, the largest parameter or buffer error, and
    the largest trace error relative to its tensor's largest value."""
    loss, state, trace, _ = run
    return {"loss_rel": max(abs(loss[k] - v) / abs(v)
                            for k, v in ref[0].items() if v),
            "param_abs": max((state[k] - v).abs().max().item()
                             for k, v in ref[1].items()),
            "trace_rel": max((trace[k] - v).abs().max().item()
                             / v.abs().max().item()
                             for k, v in ref[2].items())}


@contextlib.contextmanager
def deterministic(allow_tf32: bool = False):
    """Deterministic cuDNN without autotuning, TF32 off unless allowed:
    every process picks the same algorithms for one shape."""
    import torch

    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=allow_tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


# one DGP step on the card against the CPU from one init and batch. In
# float64 on both (the objective in float32, as the heads emit it) every
# parameter and buffer within F64_PARAM_ABS and every momentum trace within
# F64_TRACE_REL of its tensor's largest value; in float32 the loss terms
# within F32_LOSS_REL and, with frozen batch-norm, the card's step against
# the CPU's float64 step within F32_PARAM_ABS and F32_TRACE_REL. With
# trainable batch-norm a float32 gradient of a random ResNet-50 is chaotic:
# the CPU's own float32 step strays from its float64 step by a tenth or
# more of a tensor's largest trace (train_parity's f32_cpu_vs_f64; the
# readings are in PERF.md), so that mode's float32 step is held by its
# loss terms, and its gradients by the float64 step.
F64_PARAM_ABS, F64_TRACE_REL = 1e-5, 1e-4
F32_LOSS_REL, F32_PARAM_ABS, F32_TRACE_REL = 1e-5, 1e-5, 2e-3


def step_parity(make_model, params, images, batch, bn_train: bool,
                lr: float, device) -> tuple[dict, bool]:
    """One step of ``make_model(dtype, device)`` on the CPU and on
    ``device`` in float64 and float32, TF32 off: (the distances above,
    whether they hold and the card's objective launched the decode kernel
    once a step and the CPU's never)."""
    import numpy as np
    import torch

    with deterministic():
        runs = [one_step(make_model(dtype, dev), params, images, batch,
                         bn_train, lr)
                for dtype in (torch.float64, torch.float32)
                for dev in ("cpu", device)]
    cpu64, card64, cpu32, card32 = runs
    errors = {"f64_card_vs_cpu": step_errors(card64, cpu64),
              "f32_card_vs_cpu_loss_rel": step_errors(card32, cpu32)[
                  "loss_rel"],
              "f32_card_vs_f64": step_errors(card32, cpu64),
              "f32_cpu_vs_f64": step_errors(cpu32, cpu64),
              "decode_launches": [run[3] for run in runs],
              "losses": card32[0]}
    f32 = errors["f32_card_vs_f64"]
    ok = (errors["f64_card_vs_cpu"]["param_abs"] <= F64_PARAM_ABS
          and errors["f64_card_vs_cpu"]["trace_rel"] <= F64_TRACE_REL
          and errors["f32_card_vs_cpu_loss_rel"] <= F32_LOSS_REL
          and (bn_train or (f32["param_abs"] <= F32_PARAM_ABS
                            and f32["trace_rel"] <= F32_TRACE_REL))
          and errors["decode_launches"] == [0, 1, 0, 1]
          and all(np.isfinite(v) for run in runs for v in run[0].values()))
    return errors, ok


def phase_train_parity(device) -> dict:
    """One step-2 update of ResNet-50 (3 frames of 128x160, a limb clique,
    wt > 0, seeded flow) from one ``conditioned_init`` and batch, frozen
    and trainable batch-norm, held by ``step_parity``: the card against
    the CPU in float64 and in float32, the decode kernel in the card's
    objective. Then the gradient of mu through ``softargmax_2d_cuda``
    against the plain version's on step 2's (11, 94, 104, 5) maps."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models.pose_model import (PoseModel,
                                                           scoremap_size)
    from deepgraphpose_tpu_torch.ops import softargmax as plain
    from deepgraphpose_tpu_torch.ops.dgp_objective import loss_params
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel

    cfg = PoseConfig(net_type="resnet_50", num_joints=NUM_JOINTS, **STEP2)
    h, w = scoremap_size(cfg, TRAIN_PARITY_HW)
    t = TRAIN_PARITY_FRAMES
    rng = np.random.default_rng(SEED + 8)
    images = torch.from_numpy(rng.integers(0, 256, (t, *TRAIN_PARITY_HW, 3),
                                           dtype=np.uint8))
    vis = np.zeros((t, NUM_JOINTS), np.float32)
    vis[0] = 1.0
    targets = rng.uniform(2, min(h, w) - 3, (t, NUM_JOINTS, 2))
    batch = {
        "targets": torch.from_numpy((targets * vis[..., None]).astype(
            np.float32)),
        "visible_mask": torch.from_numpy(vis.ravel()),
        "hidden_mask": torch.from_numpy(1.0 - vis.ravel()),
        "frame_mask": torch.ones(t), "wt_batch": torch.full((t - 1,), 1.0),
        "pair_mask": torch.ones(t - 1),
        "flow": torch.from_numpy(rng.uniform(0.1, 3.0, (
            t - 1, *TRAIN_PARITY_HW)).astype(np.float32))}
    params = loss_params(cfg, incidence(NUM_JOINTS),
                         [targets[:1].astype(np.float32)], 4, 20)
    init = conditioned_init(cfg, SEED + 9)

    def model(dtype, dev):
        m = PoseModel(cfg, dtype=dtype).to(dtype)
        m.load_state_dict(init)
        return m.to(dev, memory_format=torch.channels_last)

    out = {"phase": "train_parity", "model": "resnet_50",
           "hw": list(TRAIN_PARITY_HW), "frames": t, "scoremap": [h, w],
           "tf32": False, "lr": TRAIN_LR, "modes": []}
    ok = True
    for bn_train in (False, True):
        errors, good = step_parity(model, params, images, batch, bn_train,
                                   TRAIN_LR, device)
        out["modes"].append({"bn_train": bn_train, **errors})
        ok = ok and good
    # the decode's gradient at step 2's maps: kernel forward, plain backward
    full = (TRAIN_BATCH + 1, *scoremap_size(cfg, HW), NUM_JOINTS)
    x = torch.randn(full, generator=torch.Generator(device=device).manual_seed(
        SEED + 10), device=device) * 3
    wts = torch.randn(full[0], NUM_JOINTS, 2, device=device)
    s1 = x.clone().requires_grad_(True)
    (softargmax_kernel.softargmax_2d_cuda(s1, cfg.gamma, cfg.gauss_len)
     * wts).sum().backward()
    s2 = x.clone().requires_grad_(True)
    (plain.softargmax_2d(s2, gamma=cfg.gamma, gauss_len=cfg.gauss_len)[0]
     * wts).sum().backward()
    grad_rel = ((s1.grad - s2.grad).abs().max()
                / s2.grad.abs().max()).item()
    out["decode_grad"] = {"shape": list(full), "rel_err": grad_rel}
    emit(out)
    if not ok or grad_rel > 1e-6:
        raise AssertionError(f"train step: card against CPU out of "
                             f"tolerance: {out}")
    return out


def timed_steps(step, inputs, n_frames: int, decode_launches: int) -> dict:
    """TRAIN_WARMUP then TRAIN_STEPS calls of ``step(*inputs())``, one
    repeated host batch copied to the card each step: steps/s, frames/s,
    peak memory, every loss dict, and every kernel's launches in the timed
    steps, counted from 0 just before them. Fails unless the decode kernel
    launched ``decode_launches`` times a step and no GEMM kernel did."""
    import torch

    losses = [step(*inputs()) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses += [step(*inputs()) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    want = {name: 0 for name in launches}
    want["softargmax_likelihood"] = decode_launches * TRAIN_STEPS
    if launches != want:
        raise AssertionError(f"{launches} kernel launches in {TRAIN_STEPS} "
                             f"steps, expected {want}")
    return {"steps_per_s": TRAIN_STEPS / dt,
            "frames_per_s": TRAIN_STEPS * n_frames / dt,
            "ms_per_step": 1e3 * dt / TRAIN_STEPS,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
            "losses": [{k: v.item() for k, v in d.items()} for d in losses]}


def phase_train(device):
    """Steps 0, 1 and 2 of the DGP chain on the card, host-fed, at the full
    747x832 frame: ResNet-50 in float32 with trainable batch-norm (the
    from-scratch mode fit_dlc and fit_dgp take without a warm start), one
    model through the three steps, batches from ``assemble_batch`` over
    ``BlobVideo``. Returns (the three lines, the step-2 step and inputs)."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.data.batcher import assemble_batch
    from deepgraphpose_tpu_torch.data.prefetch import host_to_device
    from deepgraphpose_tpu_torch.models.pose_model import (init_model,
                                                           scoremap_size)
    from deepgraphpose_tpu_torch.ops.dgp_objective import loss_params
    from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel
    from deepgraphpose_tpu_torch.train import steps

    base = PoseConfig(net_type="resnet_50", num_joints=NUM_JOINTS,
                      compute_dtype="float32")
    video = BlobVideo(base)
    model = init_model(base, torch.Generator().manual_seed(SEED + 11),
                       torch.float32, device)
    tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}
    lines = []

    def report(name, timing, key, extra):
        first, last = timing["losses"][0][key], timing["losses"][-1][key]
        line = {"phase": name, "model": "resnet_50", "hw": list(HW),
                "dtype": "float32", "tf32": tf32, "bn_train": True,
                "loss_key": key, "first_loss": first, "last_loss": last,
                **{k: v for k, v in timing.items() if k != "losses"},
                **extra}
        emit(line)
        finite = all(np.isfinite(v) for d in timing["losses"]
                     for v in d.values())
        if not (finite and last < first):
            raise AssertionError(f"{name}: losses not finite and falling: "
                                 f"{timing['losses']}")
        lines.append(line)

    # step 0: supervised DLC, batch 1
    frame = [int(TRAIN_LABELED[0])]
    opt = steps.make_optimizer(model.parameters(),
                               steps.piecewise_lr(base.multi_step))
    step0 = steps.make_dlc_train_step(model, base, opt, bn_train=True)
    coords = torch.from_numpy(video.coords_xy[frame].astype(np.float32))
    present = torch.ones(1, NUM_JOINTS, dtype=torch.bool)
    timing = timed_steps(step0, lambda: (
        host_to_device(video.get_frames(frame), device), coords, present), 1,
        decode_launches=0)
    report("train_step0", timing, "total_loss", {"batch": 1})

    # steps 1 and 2: DGP
    S0 = incidence(NUM_JOINTS)
    n_vis = len(TRAIN_LABELED)
    step2_lines = None
    for name, over, pad_to, frames in (
            ("train_step1", STEP1, 2, [int(TRAIN_LABELED[1])]),
            ("train_step2", STEP2, TRAIN_BATCH + 1,
             list(range(TRAIN_WINDOW, TRAIN_WINDOW + TRAIN_BATCH)))):
        cfg = base.replace(**over)
        vis = [f for f in frames if f in TRAIN_LABELED]
        hid = [f for f in frames if f not in TRAIN_LABELED]
        flow_from = "none (wt = 0)"
        if cfg.wt > 0:
            try:
                import cv2  # noqa: F401

                flow_from = "flow_magnitude_sequence (OpenCV Farneback)"
            except ImportError:
                flow_from = "seeded numpy field (no OpenCV on this host)"
        t0 = time.perf_counter()
        batch = assemble_batch(video, vis, hid, pad_to=pad_to, wt=cfg.wt,
                               compute_flow=flow_from.startswith("flow_"))
        if flow_from.startswith("seeded"):
            batch.flow = np.random.default_rng(SEED + 12).uniform(
                0.0, 3.0, batch.flow.shape).astype(np.float32)
        assemble_s = time.perf_counter() - t0
        params = loss_params(cfg, S0, [video.labels_rc], n_vis,
                             TRAIN_FRAMES - n_vis)
        opt = steps.make_optimizer(model.parameters(), TRAIN_LR,
                                   clip_norm=10.0)
        visible_only = name == "train_step1"
        step = steps.make_dgp_train_step(model, params, opt,
                                         visible_only=visible_only,
                                         bn_train=True)
        zeros = (None if cfg.wt > 0 else
                 torch.zeros(batch.flow.shape, device=device))

        def inputs(batch=batch, zeros=zeros):
            return (host_to_device(batch.images, device),
                    batch.as_torch(flow=zeros, device=device))

        timing = timed_steps(step, inputs, len(frames), decode_launches=1)
        layout = softargmax_kernel.launch_shape(
            pad_to, *scoremap_size(base, HW), NUM_JOINTS)
        report(name, timing,
               "total_loss_visible" if visible_only else "total_loss",
               {"pad_to": pad_to, "frames": len(frames),
                "visible_frames": len(vis), "limbs": params.n_limbs,
                "wt": cfg.wt, "flow": flow_from, "assemble_s": assemble_s,
                "decode_layout": layout._asdict()})
        if name == "train_step2":
            step2_lines = (step, inputs)
    return lines, step2_lines


# the fit phase: the training entry points on a synthetic project at the
# full frame (utils/synthetic.py), ResNet-50 float32 from a seeded random
# init (so bn_train resolves to on in fit_dlc)
FIT_FRAMES, FIT_LABELED = 120, 10
FIT_ITERS = 22                # updates a run; steps/s over iterations 3-20
FIT_DISPLAY = 2               # a loss read (a sync) every 2 updates
FIT_SAVE = 8                  # snapshots at 8 and 16, then the run's last
FIT_KEEP = 2                  # the project's max_to_keep, so pruning shows
FIT_WT_ITERS = 6              # the host-fed wt > 0 run (Farneback flow)
FEED_REL = 1e-6               # pooled against host-fed update, card
AUG_IMAGE_ATOL, AUG_KEYPOINT_ATOL = 1e-3, 1e-4     # card against CPU
SCAN_K = 11                   # updates a superstep dispatch
SCAN_REL = 1e-5               # superstep run against its eager twin, card
SPILL_SEGMENT_FRAMES = 30     # frames a segment holds besides the labeled
SPILL_MIN_SEGMENTS = 3


def make_fit_project(root, net_type: str = "resnet_50") -> Path:
    """The port's synthetic project at HW, FIT_FRAMES frames, FIT_LABELED
    labeled, NUM_JOINTS joints, its pose_cfg on ``net_type`` with
    max_to_keep FIT_KEEP. Returns its root."""
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.utils.synthetic import make_synthetic_project

    root, _, _ = make_synthetic_project(root, n_frames=FIT_FRAMES,
                                        n_labeled=FIT_LABELED, hw=HW,
                                        nj=NUM_JOINTS, seed=SEED)
    _, cfg, train_dir = resolve_project(root)
    cfg.net_type, cfg.max_to_keep = net_type, FIT_KEEP
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    return Path(root)


@contextlib.contextmanager
def observed_fit():
    """Record, while a fit entry point runs, each display sync (iteration,
    host clock, loss), each superstep dispatch's end (its last iteration
    and the host clock once the card has run it) and each snapshot write
    (name, seconds), by wrapping ``StepTimer.interval``,
    ``fit._log_chunk`` and ``checkpoint.save_snapshot``."""
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.train import fit
    from deepgraphpose_tpu_torch.utils import profiling

    seen = {"syncs": [], "saves": [], "chunks": []}
    interval, save = profiling.StepTimer.interval, checkpoint.save_snapshot
    log_chunk = fit._log_chunk

    def timed_chunk(log, iterations, *args):
        torch.cuda.synchronize()
        seen["chunks"].append((iterations[-1], time.perf_counter()))
        return log_chunk(log, iterations, *args)

    def timed_interval(self, iteration, n_steps, **metrics):
        seen["syncs"].append((iteration, time.perf_counter(),
                              metrics["loss"]))
        return interval(self, iteration, n_steps, **metrics)

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        path = save(*args, **kwargs)
        seen["saves"].append((path.name, t0, time.perf_counter() - t0))
        return path

    profiling.StepTimer.interval = timed_interval
    checkpoint.save_snapshot = timed_save
    fit._log_chunk = timed_chunk
    try:
        yield seen
    finally:
        profiling.StepTimer.interval = interval
        checkpoint.save_snapshot = save
        fit._log_chunk = log_chunk


def fit_run(name: str, fn, kwargs: dict, frames_per_update: int,
            decode_per_update: int) -> dict:
    """One call of a fit entry point on the card: its printout to stderr;
    updates, wall seconds, steps/s and frames/s between the syncs at
    iteration 2 and the run's last sync (with the superstep: between the
    ends of its first and last dispatches; snapshot writes in between taken
    out), peak memory, the feed (a resident pool and its MB, rotating
    segments and their count, or the host), the superstep's K and
    dispatches, whether the flow was made on the card, the losses, the
    snapshots written and left after pruning, and every kernel's launches
    (graph replays included), counted from 0 just before the call. Fails
    unless the losses are finite and fall (the mean of the last three reads
    below the first three), the decode launched ``decode_per_update`` times
    an update and no GEMM kernel launched."""
    import io

    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    printed = io.StringIO()
    with observed_fit() as seen, contextlib.redirect_stdout(printed):
        t0 = time.perf_counter()
        final = fn(**kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    print(printed.getvalue(), file=sys.stderr, end="")
    _, pose_cfg, train_dir = resolve_project(kwargs["dlcpath"])
    step = int(re.search(r"snapshot-step(\d+)", final.name).group(1))
    debug = kwargs.get("debug", "")
    _, last_it = checkpoint.latest_intermediate_snapshot(train_dir, step,
                                                         debug)
    updates = last_it + 1
    syncs = seen["syncs"]
    marks = seen["chunks"] or [(it, t) for it, t, _ in syncs if it >= 2]
    (it_a, t_a), (it_b, t_b) = marks[0], marks[-1]
    saving = sum(s for _, t, s in seen["saves"] if t_a <= t < t_b)
    seconds = t_b - t_a - saving
    losses = [loss for _, _, loss in syncs]
    text = printed.getvalue()
    pool = re.search(r"\((\d+) MB in device memory\)", text)
    spill = re.search(r"over (\d+) segments, <= 2 x (\d+) MB resident", text)
    scan = re.search(r"scan superstep K=(\d+)", text)
    out = {"phase": "fit", "run": name, "model": pose_cfg.net_type,
           "hw": list(HW), "dtype": kwargs.get("compute_dtype", "float32"),
           "updates": updates, "wall_s": wall,
           "timed_iterations": [it_a + 1, it_b], "timed_s": seconds,
           "snapshot_s_excluded": saving,
           "steps_per_s": (it_b - it_a) / seconds,
           "frames_per_s": (it_b - it_a) * frames_per_update / seconds,
           "frames_per_update": frames_per_update,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "pool_mb": int(pool.group(1)) if pool else None,
           "feed": ("device pool" if pool else "segments" if spill
                    else "host"),
           "segments": int(spill.group(1)) if spill else None,
           "segment_mb": int(spill.group(2)) if spill else None,
           "lk_flow": "on-device LK flow" in text,
           "scan_k": int(scan.group(1)) if scan else 0,
           "dispatches": len(seen["chunks"]),
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses,
           "snapshots_written": [n for n, _, _ in seen["saves"]],
           "snapshots_left": sorted(p.name for p in train_dir.glob(
               f"snapshot-step{step}{debug}-*.ckpt")),
           "launches": launches, "final": final.name}
    emit(out)
    want = {k: 0 for k in launches}
    want["softargmax_likelihood"] = decode_per_update * updates
    falling = np.mean(losses[-3:]) < np.mean(losses[:3])
    if not (np.isfinite(losses).all() and falling) or launches != want:
        raise AssertionError(f"fit run {name}: losses finite and falling, "
                             f"launches {want} expected: {out}")
    return out


def fit_window(root, device, snapshot: str, wt: float = 0.0,
               dtype=None) -> dict:
    """One step-2 window of the fit project (batch TRAIN_BATCH, with a
    labeled frame, ``wt`` for the temporal clique): its ``DGPBatch`` as
    the host feed makes it (``batch``, frames and flow included) and as
    the pooled fit loop makes it (``pool_batch``: labels and masks only),
    its FramePool rows on the card, the pool, the objective's parameters,
    and a function that makes a model loaded from ``snapshot`` (in the
    project's train dir; float32 weights computing in ``dtype``, float32
    by default) and its optimizer."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.data.batcher import (MultiDataset,
                                                      assemble_batch,
                                                      generate_batch_schedule)
    from deepgraphpose_tpu_torch.data.prefetch import host_to_device
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel
    from deepgraphpose_tpu_torch.ops.dgp_objective import loss_params
    from deepgraphpose_tpu_torch.train import device_data, fit, steps

    proj, cfg, train_dir = fit.resolve_project(root)
    cfg = fit._dgp_cfg_overrides(cfg, 2, TRAIN_BATCH, wt, 0, 0, 1, False)
    mds = MultiDataset(proj, cfg, fit.dgp_video_sets(proj, root),
                       cache_dir=Path(root) / "motion_energy_cache")
    d = mds.datasets[0]
    params = loss_params(cfg, proj.skeleton_incidence(), [d.labels_rc],
                         mds.n_visible_frames_total, mds.n_hidden_frames_total)
    schedule = generate_batch_schedule([d.visible_frames], [d.hidden_frames],
                                       [d.chunk], TRAIN_BATCH, 1, 50, seed=0)
    frames = next(f for _, f in schedule
                  if np.isin(f, d.visible_frames).any())
    vis = frames[np.isin(frames, d.visible_frames)]
    hid = frames[~np.isin(frames, d.visible_frames)]
    pool = device_data.FramePool(d, device)
    snap = train_dir / f"{snapshot}.ckpt"

    def model_and_optimizer():
        model = PoseModel(cfg, dtype=dtype or torch.float32,
                          param_dtype=torch.float32)
        checkpoint.restore_backbone_and_heads(model, snap)
        model = model.to(device, memory_format=torch.channels_last)
        return model, steps.make_optimizer(model.parameters(), cfg.lr,
                                           clip_norm=10.0)

    b = assemble_batch(d, vis, hid, pad_to=TRAIN_BATCH + 1, wt=wt)
    return {"batch": b, "rows": host_to_device(pool.rows(b.frames), device),
            "pool_batch": assemble_batch(d, vis, hid, pad_to=TRAIN_BATCH + 1,
                                         wt=wt, with_images=False),
            "pool": pool, "params": params, "frames": [int(f) for f in frames],
            "model_and_optimizer": model_and_optimizer}


def dgp_window(root, device, snapshot: str, aug_cfg=None, wt: float = 0.0,
               device_flow: bool = False):
    """A pooled DGP step on :func:`fit_window`'s window: (step, inputs), a
    model of its own, loaded from the snapshot, behind the step. Also
    returns a host-fed step on another copy of the model and its inputs,
    and the FramePool."""
    import torch

    from deepgraphpose_tpu_torch.data.prefetch import host_to_device
    from deepgraphpose_tpu_torch.train import device_data, steps

    win = fit_window(root, device, snapshot, wt)
    b, pool, rows = win["batch"], win["pool"], win["rows"]
    pb = win["pool_batch"]
    pooled_model, opt = win["model_and_optimizer"]()
    pooled = device_data.make_pooled_dgp_train_step(
        pooled_model, win["params"], opt, aug_cfg, device_flow=device_flow)
    host_model, opt = win["model_and_optimizer"]()
    host = steps.make_dgp_train_step(host_model, win["params"], opt)
    gen = torch.Generator(device).manual_seed(SEED + 2)
    return {"pooled": (pooled, lambda: (pool.images, rows,
                                        pb.as_torch(device=device), gen)),
            "host": (host, lambda: (host_to_device(b.images, device),
                                    b.as_torch(device=device))),
            "models": (pooled_model, host_model), "pool": pool,
            "rows": rows, "frames": win["frames"]}


def stacked(win: dict, device, k: int) -> tuple:
    """The window's pool rows and batch tensors repeated k times, on the
    card: a superstep's staged inputs."""
    batch = win["pool_batch"].as_torch(device=device)
    return (win["rows"].expand(k, -1).contiguous(),
            {n: v.expand(k, *v.shape).contiguous() for n, v in batch.items()})


def scan_window(root, device, snapshot: str, aug_cfg=None, k: int = SCAN_K):
    """The pooled step-2 superstep on a model loaded from ``snapshot``, and
    its inputs: :func:`fit_window`'s window k times (step, inputs)."""
    import torch

    from deepgraphpose_tpu_torch.train import device_data

    win = fit_window(root, device, snapshot)
    model, opt = win["model_and_optimizer"]()
    step = device_data.make_pooled_dgp_scan_step(model, win["params"], opt,
                                                 aug_cfg)
    rows, batch = stacked(win, device, k)
    gen = torch.Generator(device).manual_seed(SEED + 2)
    return step, lambda: (win["pool"].images, rows, batch, gen)


def superstep_vs_eager(root, device, snapshot: str, k: int = 3,
                       aug_cfg=None, bn_train: bool = False,
                       dtype=None) -> dict:
    """k pooled step-2 updates on :func:`fit_window`'s window from one
    snapshot and generator seed, cuDNN deterministic: eagerly, and as one
    superstep dispatch (on the card: a warm-up update, then replays of a
    CUDA graph). The largest loss-term deviation relative to the term, the
    largest parameter or buffer deviation relative to its tensor's largest
    value, and each way's decode launches. ``dtype``: the models' compute
    dtype (float32 weights)."""
    import torch

    from deepgraphpose_tpu_torch.train import device_data

    win = fit_window(root, device, snapshot, dtype=dtype)
    pool = win["pool"]
    got = {}
    for way in ("eager", "superstep"):
        model, opt = win["model_and_optimizer"]()
        gen = torch.Generator(device).manual_seed(SEED + 2)
        reset_launches()
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True):
            if way == "eager":
                step = device_data.make_pooled_dgp_train_step(
                    model, win["params"], opt, aug_cfg, bn_train=bn_train)
                batch = win["pool_batch"].as_torch(device=device)
                outs = [step(pool.images, win["rows"], batch, gen)
                        for _ in range(k)]
                terms = {n: torch.stack([o[n] for o in outs])
                         for n in outs[0]}
            else:
                step = device_data.make_pooled_dgp_scan_step(
                    model, win["params"], opt, aug_cfg, bn_train=bn_train)
                terms = step(pool.images, *stacked(win, device, k), gen)
        torch.cuda.synchronize()
        got[way] = (terms, model.state_dict(),
                    read_launches()["softargmax_likelihood"])
    (want, ref, n_eager), (terms, state, n_scan) = got["eager"], \
        got["superstep"]
    return {"k": k, "aug": aug_cfg is not None, "bn_train": bn_train,
            "loss_rel": max(((terms[n] - v).abs() / v.abs().clamp_min(
                1e-30)).max().item() for n, v in want.items()),
            "param_rel": max(((state[n] - v).abs().max()
                              / v.abs().max().clamp_min(1e-30)).item()
                             for n, v in ref.items()),
            "decode_launches": [n_eager, n_scan]}


def flow_card_vs_cpu(frames) -> dict:
    """``flow_magnitude_device`` of (T, H, W, 3) uint8 ``frames`` (a card
    tensor) on the card and on the CPU in float32, against the CPU in
    float64: each one's largest deviation, the flow's largest value, and
    whether the card is within twice the CPU float32 run's deviation or
    1e-5 of the largest value."""
    from deepgraphpose_tpu_torch.ops.flow_device import flow_magnitude_device

    card = flow_magnitude_device(frames).cpu()
    cpu = flow_magnitude_device(frames.cpu())
    ref = flow_magnitude_device(frames.cpu().double())
    out = {"shape": list(frames.shape),
           "card_abs": (card.double() - ref).abs().max().item(),
           "cpu_abs": (cpu.double() - ref).abs().max().item(),
           "flow_max": ref.abs().max().item()}
    out["ok"] = bool(card.shape == ref.shape and card.dtype == cpu.dtype
                     and out["card_abs"] <= max(2.0 * out["cpu_abs"],
                                                1e-5 * out["flow_max"]))
    return out


def pooled_vs_host(root, device, snapshot: str) -> tuple[dict, bool]:
    """One update through the pool and one host-fed, no augmentation, on the
    same window and weights, cuDNN deterministic: the largest loss-term
    error relative to the term, and the largest parameter or buffer error
    relative to its tensor's largest value; whether both are within
    FEED_REL."""
    import torch

    win = dgp_window(root, device, snapshot)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        outs = [step(*inputs()) for step, inputs in (win["pooled"],
                                                     win["host"])]
    got, want = outs
    loss_rel = max(abs(got[k].item() - v.item()) / abs(v.item())
                   for k, v in want.items() if v.item())
    pooled, host = (m.state_dict() for m in win["models"])
    param_rel = max(((pooled[k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30)).item()
                    for k, v in host.items())
    errors = {"frames": win["frames"], "loss_rel": loss_rel,
              "param_rel": param_rel}
    return errors, loss_rel <= FEED_REL and param_rel <= FEED_REL


def augment_card_vs_cpu(device, shape,
                        seed: int = SEED + 13) -> tuple[dict, bool]:
    """``apply_augment`` of the reference config on the card and on the CPU
    with the same draws (``draw_augment`` on the card, from ``seed``):
    images (0-255) within AUG_IMAGE_ATOL, keypoints within
    AUG_KEYPOINT_ATOL px, present equal; half the frames gated off."""
    import torch

    from deepgraphpose_tpu_torch.ops import augment_device as aug

    b, h, w = shape
    cfg = aug.DeviceAugmentConfig.reference(scale_jitter=(0.75, 1.25))
    gen = torch.Generator(device).manual_seed(seed)
    images = torch.randint(0, 256, (b, h, w, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    coords = torch.rand(b, NUM_JOINTS, 2, generator=gen, device=device)
    coords = coords * torch.tensor([w - 1.0, h - 1.0], device=device)
    present = torch.ones(b, NUM_JOINTS, device=device)
    gate = (torch.arange(b, device=device) % 2 == 0).float()
    draws = aug.draw_augment(gen, cfg, b, (h, w))
    card = aug.apply_augment(images, coords, present, cfg, draws, gate=gate)
    cpu = aug.apply_augment(images.cpu(), coords.cpu(), present.cpu(), cfg,
                            {k: v.cpu() for k, v in draws.items()},
                            gate=gate.cpu())
    errors = {"shape": list(shape),
              "image_abs": (card[0].cpu() - cpu[0]).abs().max().item(),
              "keypoint_abs": (card[1].cpu() - cpu[1]).abs().max().item(),
              "present_equal": bool(torch.equal(card[2].cpu(), cpu[2]))}
    return errors, (errors["image_abs"] <= AUG_IMAGE_ATOL
                    and errors["keypoint_abs"] <= AUG_KEYPOINT_ATOL
                    and errors["present_equal"])


def spill_run(root, common: dict, device) -> dict:
    """fit_dgp over a pool budget patched down (in this script only) to
    the labeled frames and SPILL_SEGMENT_FRAMES more a segment, so that the
    project's frames rotate through the card in segments. Adds to the run's
    line the host seconds of each segment's assembly and the card's time
    for one segment's copy from pinned memory (CUDA events)."""
    import torch

    from deepgraphpose_tpu_torch.train import device_data, fit

    frame_bytes = HW[0] * HW[1] * 3
    budget = 2 * (FIT_LABELED + SPILL_SEGMENT_FRAMES) * frame_bytes
    host_segment = device_data.SegmentedFramePool.host_segment
    assembled = []

    def timed_host_segment(self, k):
        t0 = time.perf_counter()
        out = host_segment(self, k)
        assembled.append((time.perf_counter() - t0, out))
        return out

    saved = device_data.DEFAULT_POOL_BUDGET_BYTES
    device_data.DEFAULT_POOL_BUDGET_BYTES = budget
    device_data.SegmentedFramePool.host_segment = timed_host_segment
    try:
        run = fit_run("fit_dgp_spill", fit.fit_dgp,
                      dict(common, batch_size=TRAIN_BATCH, debug="_spill",
                           saveiters=FIT_SAVE * TRAIN_BATCH), TRAIN_BATCH, 1)
    finally:
        device_data.DEFAULT_POOL_BUDGET_BYTES = saved
        device_data.SegmentedFramePool.host_segment = host_segment
    host = torch.from_numpy(assembled[-1][1])
    host = host.pin_memory() if device.type == "cuda" else host
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(2):                          # the second copy is timed
        start.record()
        host.to(device, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
    run.update({"budget_bytes": budget,
                "segment_host_s": [t for t, _ in assembled],
                "segment_upload_ms": start.elapsed_time(end),
                "segment_upload_bytes": host.numel()})
    emit({"phase": "fit_spill", **{k: run[k] for k in (
        "segments", "segment_mb", "budget_bytes", "segment_host_s",
        "segment_upload_ms", "segment_upload_bytes")}})
    return run


def scan_pair(name: str, fn, kwargs: dict, twins: tuple,
              frames_per_update: int, decode_per_update: int,
              root) -> list:
    """The fit run ``name`` with scan_iters=0 and with SCAN_K, cuDNN
    deterministic, each writing its own snapshots (``twins``: the two
    runs' extra arguments); fails unless the superstep's final parameters
    and buffers are within SCAN_REL of each tensor's largest value of the
    eager twin's."""
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project

    runs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        for label, scan, extra in (("eager", 0, twins[0]),
                                   ("scan", SCAN_K, twins[1])):
            runs.append(fit_run(f"{name}_{label}" if scan == 0 else name, fn,
                                dict(kwargs, scan_iters=scan, **extra),
                                frames_per_update, decode_per_update))
            torch.cuda.empty_cache()
    _, _, train_dir = resolve_project(root)
    eager, scan = (checkpoint.state_dict_from_flax(checkpoint.load_snapshot(
        train_dir / run["final"])[0]) for run in runs)
    rel = max(((scan[n] - v).abs().max() / v.abs().max().clamp_min(1e-30)
               ).item() for n, v in eager.items())
    out = {"phase": "fit_scan_vs_eager", "run": name, "k": SCAN_K,
           "param_rel": rel, "steps_per_s": [r["steps_per_s"] for r in runs],
           "dispatches": runs[1]["dispatches"]}
    emit(out)
    if not (rel <= SCAN_REL and runs[1]["scan_k"] == SCAN_K
            and runs[1]["dispatches"] > 1 and runs[0]["scan_k"] == 0):
        raise AssertionError(f"superstep run against its eager twin: {out}")
    return runs


def retarget_project(root, dest, net_type: str) -> Path:
    """A copy of the fit project (before any run) whose pose_cfg names
    ``net_type``."""
    import shutil

    from deepgraphpose_tpu_torch.core.paths import resolve_project

    shutil.copytree(root, dest)
    _, cfg, train_dir = resolve_project(dest)
    cfg.net_type = net_type
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    return Path(dest)


def mobilenet_fit_runs(common: dict, step2: dict, root) -> list:
    """The chain fit_dlc -> fit_dgp_labeledonly -> fit_dgp(batch_size=10)
    of MOBILE_NET on the fit project's copy: fit_dlc from the seeded init
    (no pretrained file: trainable batch-norm), each later step from the
    one before, frame pools and on-card augmentation as for ResNet-50."""
    from deepgraphpose_tpu_torch.train import fit

    kw, kw2 = dict(common, dlcpath=root), dict(step2, dlcpath=root)
    return [fit_run("mobilenet_fit_dlc", fit.fit_dlc, kw, 1, 0),
            fit_run("mobilenet_fit_dgp_labeledonly", fit.fit_dgp_labeledonly,
                    kw, 1, 1),
            fit_run("mobilenet_fit_dgp", fit.fit_dgp, kw2, TRAIN_BATCH, 1)]


def phase_fit(device, workdir) -> tuple[list, tuple, dict]:
    """The training entry points with their defaults on the fit project at
    747x832: fit_dlc (labeled pool, scale jitter on the card),
    fit_dgp_labeledonly and fit_dgp(batch_size=10) (frame pools, the
    reference augmentation on the card), fit_dgp(wt=1, debug="_wt")
    (host-fed, Farneback flow), fit_dgp(wt=1, device_flow=True) (the frame
    pool, the flow made on the card), fit_dgp over a patched budget
    (rotating segments), and fit_dlc and fit_dgp with scan_iters=SCAN_K
    beside their eager twins; then estimate_pose from the step-2 final
    snapshot on the project's video; the card checks (pooled against
    host-fed update, augmentation card against CPU, the flow card against
    CPU, skip-if-final). Returns (the run lines, (the estimate_pose result,
    the step-2 final snapshot it read), the steps the profile traces:
    name -> (step, inputs, updates a call))."""
    import numpy as np

    from deepgraphpose_tpu_torch.infer.predict import estimate_pose
    from deepgraphpose_tpu_torch.ops.augment_device import DeviceAugmentConfig
    from deepgraphpose_tpu_torch.train import fit

    t0 = time.perf_counter()
    root = make_fit_project(Path(workdir) / "fit_project")
    mobile_root = retarget_project(root, Path(workdir) / "fit_mobilenet",
                                   MOBILE_NET)
    emit({"phase": "fit_project", "hw": list(HW), "frames": FIT_FRAMES,
          "labeled": FIT_LABELED, "joints": NUM_JOINTS,
          "seconds": time.perf_counter() - t0})
    common = dict(dlcpath=root, maxiters=FIT_ITERS, displayiters=FIT_DISPLAY,
                  saveiters=FIT_SAVE, device=device)
    step2 = dict(common, batch_size=TRAIN_BATCH,
                 saveiters=FIT_SAVE * TRAIN_BATCH)
    runs = [fit_run("fit_dlc", fit.fit_dlc, common, 1, 0),
            fit_run("fit_dgp_labeledonly", fit.fit_dgp_labeledonly, common,
                    1, 1),
            fit_run("fit_dgp", fit.fit_dgp, step2, TRAIN_BATCH, 1),
            fit_run("fit_dgp_wt", fit.fit_dgp,
                    dict(step2, wt=1.0, debug="_wt", maxiters=FIT_WT_ITERS,
                         displayiters=1), TRAIN_BATCH, 1),
            fit_run("fit_dgp_flow", fit.fit_dgp,
                    dict(step2, wt=1.0, device_flow=True, debug="_flow"),
                    TRAIN_BATCH, 1),
            spill_run(root, common, device),
            fit_run("fit_dgp_bf16", fit.fit_dgp,
                    dict(step2, compute_dtype="bfloat16", debug="_bf16"),
                    TRAIN_BATCH, 1)]
    runs += mobilenet_fit_runs(common, step2, mobile_root)
    runs += scan_pair("fit_dlc_scan", fit.fit_dlc, common,
                      (dict(step=10), dict(step=11)), 1, 0, root)
    runs += scan_pair("fit_dgp_scan", fit.fit_dgp, step2,
                      (dict(debug="_scan0"), dict(debug="_scan")),
                      TRAIN_BATCH, 1, root)
    feeds = {"fit_dlc": "device pool", "fit_dgp_labeledonly": "device pool",
             "fit_dgp": "device pool", "fit_dgp_wt": "host",
             "fit_dgp_flow": "device pool", "fit_dgp_spill": "segments"}
    by_run = {r["run"]: r for r in runs}
    if any(r["feed"] != feeds.get(r["run"], "device pool") for r in runs) \
            or not by_run["fit_dgp_flow"]["lk_flow"] \
            or by_run["fit_dgp_spill"]["segments"] < SPILL_MIN_SEGMENTS:
        raise AssertionError(f"fit runs took the wrong feeds: {runs}")
    f32, bf16 = by_run["fit_dgp"], by_run["fit_dgp_bf16"]
    emit({"phase": "fit_bf16_vs_f32", "run": "fit_dgp",
          "steps_per_s": {"float32": f32["steps_per_s"],
                          "bfloat16": bf16["steps_per_s"]},
          "speedup": bf16["steps_per_s"] / f32["steps_per_s"],
          "peak_mem_gb": {"float32": f32["peak_mem_gb"],
                          "bfloat16": bf16["peak_mem_gb"]},
          "losses_first_last": {"float32": [f32["first_loss"],
                                            f32["last_loss"]],
                                "bfloat16": [bf16["first_loss"],
                                             bf16["last_loss"]]}})

    feed_errors, feed_ok = pooled_vs_host(root, device,
                                          "snapshot-step1-final--0")
    aug_errors, aug_ok = augment_card_vs_cpu(
        device, (TRAIN_BATCH + 1, *HW))
    flow_win = dgp_window(root, device, "snapshot-step1-final--0", wt=1.0,
                          device_flow=True)
    flow_errors = flow_card_vs_cpu(
        flow_win["pool"].images.index_select(0, flow_win["rows"]))
    _, _, train_dir = fit.resolve_project(root)
    final = train_dir / "snapshot-step2-final--0.ckpt"
    printed = contextlib.redirect_stdout(sys.stderr)
    with printed:
        again = fit.fit_dgp(dlcpath=root, batch_size=TRAIN_BATCH,
                            maxiters=FIT_ITERS, device=device)
        t0 = time.perf_counter()
        pose = estimate_pose(root / "config.yaml", final,
                             root / "videos_dgp" / "synthvid.avi",
                             root / "videos_pred", save_pose=False,
                             device=device)
        pose_s = time.perf_counter() - t0
    xy = np.stack([pose["x"], pose["y"]], -1)
    out = {"phase": "fit_checks", "pooled_vs_host": feed_errors,
           "augment_card_vs_cpu": aug_errors,
           "flow_card_vs_cpu": flow_errors,
           "skip_if_final": again == final,
           "estimate_pose": {"frames": int(xy.shape[0]), "seconds": pose_s,
                             "finite": bool(np.isfinite(xy).all()
                                            and np.isfinite(
                                                pose["likelihoods"]).all())}}
    emit(out)
    if not (feed_ok and aug_ok and flow_errors["ok"] and out["skip_if_final"]
            and out["estimate_pose"]["finite"]
            and xy.shape == (FIT_FRAMES, NUM_JOINTS, 2)):
        raise AssertionError(f"fit checks failed: {out}")
    reference = DeviceAugmentConfig.reference()
    pooled = dgp_window(root, device, "snapshot-step1-final--0", reference)
    return runs, (pose, final), {
        "fit_dgp_pooled_step2": (*pooled["pooled"], 1),
        "fit_dgp_scan_step2": (*scan_window(root, device,
                                            "snapshot-step1-final--0",
                                            reference), SCAN_K),
        "fit_dgp_flow_step2": (*flow_win["pooled"], 1)}


ANALYSIS_EQUAL_PX = 1e-4       # analyze_videos against estimate_pose
TOPK_VALUE_TOL = 1e-5          # top-k values, card against the CPU
EVAL_CARD_CPU_PX = 1e-2        # evaluate_dgp float32, card against the CPU


@contextlib.contextmanager
def h5_writes(tables: bool = False):
    """Where h5py is absent (the card host), the H5 writers become
    recorders for the block: ``infer/export.py``'s two, the CollectedData
    twin of ``data/project.py`` and the 4-level one of
    ``project/multi_individual.py``. The package itself raises without
    h5py, as the JAX package does, and the phases read the trajectories
    back from the CSVs either way. With ``tables``, a pose table is kept
    instead as a numpy archive under its ``.h5`` name and
    ``read_pose_table`` reads it back, so that the commands that read an
    analysis (filtering, outliers) run on the card. Yields the note the
    phase line prints and the paths the recorders took."""
    import importlib.util

    import numpy as np

    from deepgraphpose_tpu_torch.data import project as project_io
    from deepgraphpose_tpu_torch.infer import export
    from deepgraphpose_tpu_torch.project import multi_individual

    if importlib.util.find_spec("h5py") is not None:
        yield "written", []
        return
    recorded = []

    def record(path, *a, **k):
        recorded.append(str(path))

    def keep_table(path, scorer, joints_names, labels, index=None):
        recorded.append(str(path))
        with open(path, "wb") as f:
            np.savez(f, scorer=scorer, bodyparts=np.array(joints_names),
                     index=np.array(index if index is not None else []),
                     **{k: labels[k] for k in ("x", "y", "likelihoods")})

    def read_table(path):
        with np.load(path) as z:
            index = [str(i) for i in z["index"]]
            return (str(z["scorer"]), [str(b) for b in z["bodyparts"]],
                    {k: z[k] for k in ("x", "y", "likelihoods")},
                    index or list(range(z["x"].shape[0])))

    saved = (export.write_pose_h5, export.write_multi_pose_h5,
             export.read_pose_table, project_io.write_collected_data_h5,
             multi_individual.write_multi_individual_h5)
    export.write_pose_h5 = keep_table if tables else record
    export.write_multi_pose_h5 = record
    if tables:
        export.read_pose_table = read_table
    project_io.write_collected_data_h5 = record
    multi_individual.write_multi_individual_h5 = record
    try:
        yield ("stand-in: h5py absent on this host; pose tables kept as "
               "numpy archives under their .h5 names" if tables else
               "not written: h5py absent on this host"), recorded
    finally:
        (export.write_pose_h5, export.write_multi_pose_h5,
         export.read_pose_table, project_io.write_collected_data_h5,
         multi_individual.write_multi_individual_h5) = saved


def counted(fn, *args, **kwargs) -> tuple:
    """(result, wall seconds, every kernel's launches) of one call, the
    counts set to 0 just before it and read just after a sync."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def top_k_card_vs_cpu(root, snapshot: Path, video: Path, k: int,
                      device) -> dict:
    """The part_pred and locref heads of every frame of ``video`` from
    ``snapshot``, batched and padded as ``analyze_videos`` batches them;
    on the card the argmax decode, the top-k locations and the top-k
    decode, and the same plain decode of the same heads copied to the
    CPU. Returns the argmax decode (T, nj, 3) and the largest differences
    (locations counted, values in px / likelihood)."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core.device import resolve_dtype
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.prefetch import host_to_device
    from deepgraphpose_tpu_torch.data.video import (VideoReader,
                                                    iter_frame_batches)
    from deepgraphpose_tpu_torch.infer.predict import (dlc_heads,
                                                       forward_heads,
                                                       load_model)
    from deepgraphpose_tpu_torch.ops import decode

    _, cfg, _ = resolve_project(root)
    model = load_model(cfg, snapshot, resolve_dtype(cfg.compute_dtype),
                       device)
    bs = cfg.infer_batch_size
    reader = VideoReader(video)
    argmax, moved, worst = [], 0, 0.0
    for _, block in iter_frame_batches(reader, bs):
        n = block.shape[0]
        arr = np.concatenate([block, block[-1:].repeat(bs - n, 0)])
        heads = forward_heads(model, host_to_device(arr, device),
                              heads=dlc_heads(model))
        part, loc = heads["part_pred"], heads.get("locref")
        scmap, _ = decode.extract_cnn_output(part, loc, cfg.locref_stdev)
        card = (decode.get_top_values(scmap, k),
                decode.multi_pose_decode(part, loc, k, cfg.stride,
                                         cfg.locref_stdev))
        argmax.append(decode.argmax_pose_decode(
            part, loc, cfg.stride, cfg.locref_stdev)[:n].cpu().numpy())
        part, loc = part.cpu(), loc.cpu() if loc is not None else None
        scmap, _ = decode.extract_cnn_output(part, loc, cfg.locref_stdev)
        plain = (decode.get_top_values(scmap, k),
                 decode.multi_pose_decode(part, loc, k, cfg.stride,
                                          cfg.locref_stdev))
        for got, want in zip(card[0], plain[0]):
            moved += int((got.cpu() != want).sum())
        worst = max(worst, (card[1].cpu() - plain[1]).abs().max().item())
    reader.close()
    return {"argmax": np.concatenate(argmax), "locations_moved": moved,
            "max_abs_err": worst}


def phase_analysis(device, root, pose: dict, final: Path) -> dict:
    """What users run after training, on the fit project and its step-2
    final snapshot ``final``, which analyze_videos must resolve itself
    (``pose``: the estimate_pose of ``fit_checks``): analyze_videos
    full frame (trajectories equal to ``pose``), dynamic=(True, 0.5, 10),
    num_outputs=3 (the DLC top-k decode: no decode kernel; the first peak
    equal to the argmax decode of the same heads, the card's top-k against
    the plain decode on the CPU), preset="fast" (scale 0.75 + residual
    int8: both GEMM routes), analyze_time_lapse_frames over the labeled
    frames, evaluate_network, evaluate_dgp with decode="dlc" and with
    quantize=True, and evaluate_dgp in float32 (TF32 off) on the card
    against the CPU. Every path counts its launches from 0. Returns
    {path: launches}."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.evaluation import metrics
    from deepgraphpose_tpu_torch.infer import analyze
    from deepgraphpose_tpu_torch.infer.export import load_pose_from_dlc
    from deepgraphpose_tpu_torch.infer.predict import estimate_pose

    t_phase = time.perf_counter()
    config = root / "config.yaml"
    video = root / "videos_dgp" / "synthvid.avi"
    out = root / "analysis"
    proj, _, train_dir = resolve_project(root)
    snapshot = analyze._resolve_snapshot(train_dir, proj, None)[0]
    reader = VideoReader(video)
    frames, video_hw = reader.n_frames, [reader.height, reader.width]
    reader.close()
    launches, seconds, line = {}, {}, {"phase": "analysis"}

    def run(path, fn, *args, **kwargs):
        result, seconds[path], launches[path] = counted(fn, *args, **kwargs)
        return result

    def trajectories(folder, stem):
        """(T, columns, 3) x, y, likelihood from a DLC-format CSV."""
        table = load_pose_from_dlc(str(folder / f"{stem}.csv"))
        return np.stack([table[k] for k in ("x", "y", "likelihoods")], -1)

    with h5_writes() as (h5_note, h5_recorded), \
            contextlib.redirect_stdout(sys.stderr):
        scorer = run("analyze_videos", analyze.analyze_videos, config,
                     [video], destfolder=out / "full", device=device)
        stem = f"{video.stem}{scorer}"
        full = trajectories(out / "full", stem)
        autotuned = np.stack([pose["x"], pose["y"], pose["likelihoods"]],
                             -1)
        # the same path against estimate_pose under deterministic cuDNN:
        # autotuned float32 convolutions differ from call to call
        # (check_repeat.py: 1.5e-5 in the logits of one batch repeated,
        # 3.1e-4 px after the decode), so two autotuned runs of one path
        # need not match to 1e-4 px
        with deterministic():
            want = estimate_pose(config, final, video, out / "ref",
                                 save_pose=False, device=device)
            run("analyze_videos_deterministic", analyze.analyze_videos,
                config, [video], destfolder=out / "det", device=device)
        want = np.stack([want["x"], want["y"], want["likelihoods"]], -1)
        det = trajectories(out / "det", stem)
        run("analyze_videos_dynamic", analyze.analyze_videos, config,
            [video], destfolder=out / "dynamic", dynamic=(True, 0.5, 10),
            device=device)
        dynamic = trajectories(out / "dynamic", stem)
        run("analyze_videos_top3", analyze.analyze_videos, config, [video],
            destfolder=out / "top3", num_outputs=3, device=device)
        top3 = trajectories(out / "top3", stem)
        topk = top_k_card_vs_cpu(root, snapshot, video, 3, device)
        run("analyze_videos_fast", analyze.analyze_videos, config, [video],
            destfolder=out / "fast", preset="fast", device=device)
        fast = trajectories(out / "fast", stem)
        labeled = root / "labeled-data" / "synthvid"
        run("analyze_time_lapse_frames", analyze.analyze_time_lapse_frames,
            config, labeled, frametype=".png", device=device)
        lapse = trajectories(labeled, f"{labeled.name}{scorer}")
        network = run("evaluate_network", metrics.evaluate_network, config,
                      device=device)[0]
        csv_rows = (root / "evaluation-results" / "iteration-0"
                    / "CombinedEvaluation-results.csv").read_text(
                        ).strip().splitlines()
        dlc = run("evaluate_dgp_dlc", metrics.evaluate_dgp, config,
                  snapshot, decode="dlc", device=device)
        int8 = run("evaluate_dgp_int8", metrics.evaluate_dgp, config,
                   snapshot, quantize=True, device=device)
        f32 = run("evaluate_dgp_f32", metrics.evaluate_dgp, config,
                  snapshot, compute_dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        f32_cpu = metrics.evaluate_dgp(config, snapshot,
                                       compute_dtype=torch.float32,
                                       device="cpu")
        cpu_s = time.perf_counter() - t0

    first_peak = top3.reshape(frames, -1, 3, 3)[:, :, 0]   # (T, nj, k, 3)
    decode = {p: c["softargmax_likelihood"] for p, c in launches.items()}
    errors = [r[key] for r in (network, dlc, int8, f32)
              for key in ("train_error",)]
    line.update({
        "video": {"frames": frames, "hw": video_hw},
        "snapshot": snapshot.name, "scorer": scorer,
        "evaluate_network_snapshot": network["snapshot"],
        "h5": h5_note, "h5_recorded": len(h5_recorded),
        "first_number_no_limit": {
            path: {"seconds": seconds[path],
                   "frames_per_s": frames / seconds[path]}
            for path in ("analyze_videos", "analyze_videos_fast")},
        "seconds": seconds, "cpu_evaluate_s": cpu_s,
        "full_vs_estimate_pose_px": float(
            np.abs(det[..., :2] - want[..., :2]).max()),
        "full_vs_estimate_pose_lik": float(
            np.abs(det[..., 2] - want[..., 2]).max()),
        "autotuned_full_vs_estimate_pose_px": float(
            np.abs(full[..., :2] - autotuned[..., :2]).max()),
        "dynamic_shape": list(dynamic.shape),
        "top3_first_peak_vs_argmax": float(
            np.abs(first_peak - topk["argmax"]).max()),
        "top3_card_vs_cpu": {"locations_moved": topk["locations_moved"],
                             "max_abs_err": topk["max_abs_err"]},
        "fast_shape": list(fast.shape), "time_lapse_rows": len(lapse),
        "train_error_px": {"evaluate_network": network["train_error"],
                           "dlc": dlc["train_error"],
                           "int8": int8["train_error"],
                           "f32": f32["train_error"]},
        "combined_csv_rows": len(csv_rows) - 1,
        "f32_card_vs_cpu_px": float(np.nanmax(
            np.abs(f32["pred_xy"] - f32_cpu["pred_xy"]))),
        "launches": launches, "phase_s": time.perf_counter() - t_phase})
    emit(line)
    failed = [name for name, ok in {
        "the step-2 final snapshot": snapshot == final,
        "full frame equals estimate_pose": (
            det.shape == want.shape == full.shape
            and line["full_vs_estimate_pose_px"] <= ANALYSIS_EQUAL_PX
            and line["full_vs_estimate_pose_lik"] <= ANALYSIS_EQUAL_PX),
        "dynamic finite": (dynamic.shape[0] == frames
                           and np.isfinite(dynamic).all()),
        "top3 first peak is the argmax": (
            line["top3_first_peak_vs_argmax"] <= TOPK_VALUE_TOL),
        "top3 card against CPU": (
            topk["locations_moved"] == 0
            and topk["max_abs_err"] <= TOPK_VALUE_TOL),
        "fast finite": fast.shape[0] == frames and np.isfinite(fast).all(),
        "time lapse": (len(lapse) == FIT_LABELED
                       and np.isfinite(lapse).all()),
        "errors finite": bool(np.isfinite(errors).all()),
        "combined csv": (len(csv_rows) >= 2 and csv_rows[-1].startswith(
            network["snapshot"] + ",")),
        "f32 card against CPU": (
            line["f32_card_vs_cpu_px"] <= EVAL_CARD_CPU_PX),
        "decode on its paths": all(decode[p] > 0 for p in (
            "analyze_videos", "analyze_videos_deterministic",
            "analyze_videos_dynamic",
            "analyze_videos_fast", "analyze_time_lapse_frames",
            "evaluate_network", "evaluate_dgp_int8", "evaluate_dgp_f32")),
        "no decode on the DLC decodes": (
            decode["analyze_videos_top3"] == 0
            and decode["evaluate_dgp_dlc"] == 0),
        "GEMM routes on the int8 paths": all(
            launches[p][r] > 0 for p in ("analyze_videos_fast",
                                         "evaluate_dgp_int8")
            for r in ("mm_tiled", "conv_int8")),
        "no GEMM on the float paths": all(
            launches[p][r] == 0 for p in launches
            if p not in ("analyze_videos_fast", "evaluate_dgp_int8")
            for r in ("mm_tiled", "conv_int8")),
    }.items() if not ok]
    if failed:
        raise AssertionError(f"analysis checks failed: {failed}")
    return launches


# the parallel phase: the multi-window group updates on one card, two ranks
# sharing the card over gloo (NCCL refuses two ranks on one device; gloo's
# all_reduce and broadcast take CUDA tensors), and time-sharded inference
PAR_G = 2                      # windows an update
PAR_FIT_ITERS = 6              # schedule windows of the two-rank fit runs
PAR_STEP_REL = 1e-5            # float64 steps, two ranks against world 1
PAR_FIT_RTOL, PAR_FIT_ATOL = 1e-4, 1e-5      # the reference's fit bound
PAR_RAW_PX = 1e-4              # multichip raw mu against estimate_pose
PAR_SMOOTH_TOL = 1e-5          # the smoothed track against ewma_reference
PAR_STREAM_TOL = 1e-6          # two ranks' halo and smoothing, world 1
PAR_STREAM_HW = (96, 112)      # the two-rank streaming video
PAR_STREAM_FRAMES, PAR_STREAM_FPD = 40, 4
PAR_FPD = 16                   # frames a device, full-width multichip runs
PAR_TIMEOUT = 600              # seconds the two ranks may take
PAR_NCCL_TIMEOUT = 90


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parallel_case(workdir, final) -> dict:
    """The two-rank checks' inputs, saved for the ranks to load: ResNet-50
    in float64 from ``conditioned_init`` at TRAIN_PARITY_HW; PAR_G DGP
    windows of 3 frames over a frame pool (a limb clique, wt > 0); a step-0
    global batch of 4 canvases; a small synthetic project with a seeded
    snapshot for the streaming check; and the fit project's config, step-2
    ``final`` snapshot and 747x832 video for the full-width streaming
    run."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.models.pose_model import (init_model,
                                                           scoremap_size)
    from deepgraphpose_tpu_torch.ops.dgp_objective import loss_params
    from deepgraphpose_tpu_torch.utils.synthetic import make_synthetic_project

    root = Path(workdir) / "fit_project"
    cfg_kw = dict(net_type="resnet_50", num_joints=NUM_JOINTS, **STEP2)
    cfg = PoseConfig(**cfg_kw)
    h, w = scoremap_size(cfg, TRAIN_PARITY_HW)
    t, g = TRAIN_PARITY_FRAMES, PAR_G
    rng = np.random.default_rng(SEED + 20)
    vis = np.zeros((g, t, NUM_JOINTS), np.float32)
    vis[:, 0] = 1.0
    targets = rng.uniform(2, min(h, w) - 3, (g, t, NUM_JOINTS, 2))
    batch = {
        "targets": (targets * vis[..., None]).astype(np.float32),
        "visible_mask": vis.reshape(g, -1),
        "hidden_mask": 1.0 - vis.reshape(g, -1),
        "frame_mask": np.ones((g, t), np.float32),
        "wt_batch": np.ones((g, t - 1), np.float32),
        "pair_mask": np.ones((g, t - 1), np.float32),
        "flow": np.zeros((g, t - 1, *TRAIN_PARITY_HW), np.float32)}
    n = 8
    coords = rng.uniform(8, min(TRAIN_PARITY_HW) - 8, (n, NUM_JOINTS, 2))
    stream = Path(make_synthetic_project(
        Path(workdir) / "stream_project", n_frames=PAR_STREAM_FRAMES,
        n_labeled=4, hw=PAR_STREAM_HW, nj=NUM_JOINTS, seed=SEED)[0])
    _, scfg, train_dir = resolve_project(stream)
    scfg.net_type = "resnet_50"
    scfg.to_yaml(train_dir / "pose_cfg.yaml")
    snap = checkpoint.save_snapshot(
        train_dir, 2, "stream", init_model(
            scfg, torch.Generator().manual_seed(SEED + 21), device="cpu"))
    case = {
        "cfg": cfg_kw, "lr": TRAIN_LR,
        "state": {k: v.double() if v.is_floating_point() else v
                  for k, v in conditioned_init(cfg, SEED + 22).items()},
        "params": loss_params(cfg, incidence(NUM_JOINTS),
                              [targets[0, :1].astype(np.float32)], 4, 20),
        "pool": torch.from_numpy(rng.integers(
            0, 256, (n, *TRAIN_PARITY_HW, 3), dtype=np.uint8)),
        "rows": torch.from_numpy(rng.integers(0, n, (g, t))),
        "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
        "dlc": {"images": torch.from_numpy(rng.integers(
                    0, 256, (n, *TRAIN_PARITY_HW, 3), dtype=np.uint8)),
                "coords": torch.from_numpy(coords.astype(np.float32)),
                "present": torch.ones(n, NUM_JOINTS),
                "content_wh": torch.tensor(
                    [[TRAIN_PARITY_HW[1], TRAIN_PARITY_HW[0]]] * n,
                    dtype=torch.float32)},
        "idxs": torch.from_numpy(rng.integers(0, n, (4,))),
        "stream": [str(stream / "config.yaml"), str(snap),
                   str(stream / "videos" / "synthvid.avi")],
        "wide_stream": [str(root / "config.yaml"), str(final),
                        str(root / "videos_dgp" / "synthvid.avi")]}
    torch.save(case, Path(workdir) / "parallel_case.pt")
    return case


def dp_steps(case: dict, group) -> dict:
    """The float64 DP steps of ``case`` in ``group`` (each rank its slice):
    the DGP pooled step with trainable batch-norm and the device flow, and
    the step-0 pooled step with trainable batch-norm and the reference
    augmentation; at world 1 the step-0 step is the single-device one on
    the global batch. Each: loss terms, parameters and buffers (float64 on
    the CPU), launches."""
    import types

    import torch

    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel
    from deepgraphpose_tpu_torch.ops.augment_device import DeviceAugmentConfig
    from deepgraphpose_tpu_torch.parallel import train_dp
    from deepgraphpose_tpu_torch.train import device_data as dd
    from deepgraphpose_tpu_torch.train import steps

    dev = group.device
    cfg = PoseConfig(**case["cfg"])

    def model():
        m = PoseModel(cfg, dtype=torch.float64).to(torch.float64)
        m.load_state_dict(case["state"])
        return m.to(dev, memory_format=torch.channels_last)

    def result(out, m, launches):
        return {"loss": {k: v.item() for k, v in out.items()},
                "state": {k: v.detach().to("cpu", torch.float64)
                          for k, v in m.state_dict().items()},
                "launches": launches}

    out = {}
    with deterministic():
        m = model()
        opt = steps.make_optimizer(m.parameters(), case["lr"],
                                   clip_norm=10.0)
        step = train_dp.make_dp_pooled_dgp_train_step(
            m, case["params"], opt, group, None, bn_train=True,
            device_flow=True)
        sl = group.shard(PAR_G)
        res, _, launches = counted(
            step, case["pool"].to(dev), case["rows"][sl].to(dev),
            {k: v[sl].to(dev, torch.float64) for k, v in
             case["batch"].items()}, [None] * (sl.stop - sl.start))
        out["dgp"] = result(res, m, launches)

        m = model()
        opt = steps.make_optimizer(m.parameters(), case["lr"])
        aug = DeviceAugmentConfig.reference()
        step = (train_dp.make_dp_pooled_dlc_train_step(
                    m, cfg, opt, group, aug, bn_train=True)
                if group.world > 1 else
                dd.make_pooled_dlc_train_step(m, cfg, opt, aug,
                                              bn_train=True))
        pool = types.SimpleNamespace(**{k: v.to(dev) for k, v in
                                        case["dlc"].items()})
        res, _, launches = counted(
            step, pool, case["idxs"].to(dev),
            torch.Generator(dev).manual_seed(SEED + 23))
        out["dlc"] = result(res, m, launches)
    return out


def dp_fit(root, device, **kw) -> tuple:
    """fit_dgp on the fit project from its step-1 snapshot for
    PAR_FIT_ITERS windows, deterministic: (final snapshot, seconds,
    launches)."""
    from deepgraphpose_tpu_torch.train import fit

    with deterministic(), contextlib.redirect_stdout(sys.stderr):
        return counted(fit.fit_dgp, dlcpath=root, batch_size=TRAIN_BATCH,
                       maxiters=PAR_FIT_ITERS, displayiters=1,
                       saveiters=1000, device=device, **kw)


def stream_run(case: dict, group) -> tuple:
    """estimate_pose_multichip over the small project's video in
    ``group``, float32, smoothed, deterministic: (labels, seconds,
    launches)."""
    import torch

    from deepgraphpose_tpu_torch.parallel.streaming import \
        estimate_pose_multichip

    with deterministic(), contextlib.redirect_stdout(sys.stderr):
        return counted(estimate_pose_multichip, *case["stream"],
                       Path(case["stream"][0]).parent / "pred", mesh=group,
                       frames_per_device=PAR_STREAM_FPD, smooth=True,
                       compute_dtype=torch.float32, save_pose=False)


def wide_stream_run(case: dict, group) -> tuple:
    """estimate_pose_multichip over the fit project's 747x832 video from
    its step-2 snapshot in ``group``, bfloat16, raw, deterministic, PAR_FPD
    frames a rank: (labels, frames/s of the loop as it prints them (rank 0
    prints), launches)."""
    import io

    from deepgraphpose_tpu_torch.parallel.streaming import \
        estimate_pose_multichip

    printed = io.StringIO()
    with deterministic(), contextlib.redirect_stdout(printed):
        labels, _, launches = counted(
            estimate_pose_multichip, *case["wide_stream"],
            Path(case["wide_stream"][0]).parent / "videos_pred", mesh=group,
            frames_per_device=PAR_FPD, save_pose=False,
            compute_dtype="bfloat16")
    rate = re.search(r"= ([\d.]+) frames/s", printed.getvalue())
    return labels, float(rate.group(1)) if rate else None, launches


def parallel_worker(rank: int, port: int, workdir: str) -> int:
    """One of two ranks on the card over gloo: the DP steps, fit_dgp
    (data_parallel=2) and the time-sharded inference of the case, small
    and at full width; the results go to ``workdir/rank<r>.pt``."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from deepgraphpose_tpu_torch.parallel import distributed, mesh

    device = distributed.initialize(f"127.0.0.1:{port}", 2, rank)
    group = mesh.make_mesh(device=device)
    case = torch.load(Path(workdir) / "parallel_case.pt", weights_only=False)
    out = {"device": str(device), "backend": dist.get_backend(),
           "world": group.world, **dp_steps(case, group)}
    final, seconds, launches = dp_fit(Path(workdir) / "fit_project", device,
                                      data_parallel=2, debug="_dp2")
    out["fit"] = {"final": str(final), "seconds": seconds,
                  "launches": launches}
    labels, seconds, launches = stream_run(case, group)
    out["stream"] = {"labels": labels, "seconds": seconds,
                     "launches": launches}
    labels, fps, launches = wide_stream_run(case, group)
    out["wide_stream"] = {"labels": labels, "frames_per_s": fps,
                          "launches": launches}
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    dist.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)
    return 0


def nccl_probe(rank: int, port: int) -> int:
    """Two ranks on one card over NCCL: an all_reduce, and whether NCCL
    takes it."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from deepgraphpose_tpu_torch.parallel import distributed

    try:
        device = distributed.initialize(f"127.0.0.1:{port}", 2, rank,
                                        backend="nccl")
        x = torch.ones(1, device=device)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print(f"NCCL ACCEPTED {x.item()}", flush=True)
        return 0
    except Exception as e:  # noqa: BLE001 - the probe reports the refusal
        print(f"NCCL REFUSED {type(e).__name__}: "
              f"{str(e).splitlines()[0][:300]}", flush=True)
        return 3


def run_ranks(args: list, timeout: int) -> list:
    """Start this script twice with ``args`` and the rank, wait for both
    within ``timeout`` seconds (killing both past it): (return codes,
    outputs); a return code of None marks a rank killed at the limit."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               *args[:1], str(rank), str(port), *args[1:]],
                              cwd=str(ROOT), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for rank in range(2)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(
                    deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
                p.returncode = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def within_largest(got: dict, want: dict) -> float:
    """The largest error of a tensor over that tensor's largest value."""
    return max(((got[k] - v).abs().max()
                / v.abs().max().clamp_min(1e-30)).item()
               for k, v in want.items())


def group_runs(root, device) -> list:
    """fit_dgp(batch_size=TRAIN_BATCH) one window an update, then PAR_G
    windows an update eager and with the superstep (scan_iters=SCAN_K),
    with cuDNN's defaults: updates/s, windows/s, frames/s and peak memory
    side by side, and the superstep's final parameters against its eager
    twin's (reported: the defaults' algorithms need not be deterministic).
    Then the same eager and superstep twins under deterministic cuDNN;
    fails unless the superstep's final parameters are within SCAN_REL of
    each tensor's largest of its eager twin's."""
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.train import fit

    step2 = dict(dlcpath=root, maxiters=FIT_ITERS, displayiters=FIT_DISPLAY,
                 saveiters=FIT_SAVE * TRAIN_BATCH, batch_size=TRAIN_BATCH,
                 device=device)

    def run(name, g, scan):
        out = fit_run(name, fit.fit_dgp,
                      dict(step2, windows_per_device=g, scan_iters=scan,
                           debug=f"_{name[8:]}"), TRAIN_BATCH, 1)
        torch.cuda.empty_cache()
        return out

    runs = [run("fit_dgp_g1", 1, 0), run("fit_dgp_w2", PAR_G, 0),
            run("fit_dgp_w2_scan", PAR_G, SCAN_K)]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        twins = [run("fit_dgp_w2_det", PAR_G, 0),
                 run("fit_dgp_w2_scan_det", PAR_G, SCAN_K)]
    _, _, train_dir = resolve_project(root)

    def rel(pair):
        eager, scan = (checkpoint.state_dict_from_flax(
            checkpoint.load_snapshot(train_dir / r["final"])[0])
            for r in pair)
        return within_largest(scan, eager)

    rel_det = rel(twins)
    out = {"phase": "parallel_group", "windows": PAR_G, "k": SCAN_K,
           "scan_vs_eager_param_rel": rel_det,
           "scan_vs_eager_param_rel_defaults": rel(runs[1:]), "runs": [{
               "run": r["run"], "updates_per_s": r["steps_per_s"] / g,
               "windows_per_s": r["steps_per_s"],
               "frames_per_s": r["frames_per_s"],
               "peak_mem_gb": r["peak_mem_gb"], "scan_k": r["scan_k"],
               "dispatches": r["dispatches"]}
               for r, g in zip(runs + twins, (1, PAR_G, PAR_G, PAR_G,
                                              PAR_G))]}
    emit(out)
    if not (rel_det <= SCAN_REL and twins[1]["scan_k"] == SCAN_K
            and twins[1]["dispatches"] > 1 and runs[2]["scan_k"] == SCAN_K):
        raise AssertionError(f"group superstep against its eager twin: "
                             f"{out}")
    return runs + twins


def two_ranks(device, workdir, final) -> dict:
    """Two ranks on the one card (gloo, each on cuda:0) against world 1 in
    this process: the float64 DP steps (loss terms PAR_STEP_REL relative,
    parameters and buffers PAR_STEP_REL of each tensor's largest), fit_dgp
    (data_parallel=2) against fit_dgp(windows_per_device=2) from the same
    seed (``rtol``/``atol`` PAR_FIT_*), the time-sharded inference's
    displacement and smoothed track (PAR_STREAM_TOL), the full-width
    bfloat16 streaming run's x and y (PAR_RAW_PX) and frames/s beside one
    rank's; then whether NCCL
    takes two ranks on one card. Returns each path's launches."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.parallel import mesh

    root = Path(workdir) / "fit_project"
    case = parallel_case(workdir, final)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(["--parallel-worker", str(workdir)], PAR_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    for rc, log in ranks:
        print(log[-4000:], file=sys.stderr)
    if any(rc != 0 for rc, _ in ranks):
        raise AssertionError(f"a rank failed: {[rc for rc, _ in ranks]}")
    got = [torch.load(Path(workdir) / f"rank{r}.pt", weights_only=False)
           for r in range(2)]

    group = mesh.make_mesh(1, device)
    want = dp_steps(case, group)
    ref_final, ref_s, ref_launches = dp_fit(root, device,
                                            windows_per_device=PAR_G,
                                            debug="_dp2ref")
    ref_stream, _, _ = stream_run(case, group)
    ref_wide, ref_wide_fps, ref_wide_launches = wide_stream_run(case, group)

    steps_err = {}
    for name in ("dgp", "dlc"):
        steps_err[name] = {
            "loss_rel": max(abs(r[name]["loss"][k] - v) / abs(v)
                            for r in got for k, v in want[name]["loss"].items()
                            if v),
            "param_rel": max(within_largest(r[name]["state"],
                                            want[name]["state"])
                             for r in got)}
    load = checkpoint.load_snapshot
    dp_state = checkpoint.state_dict_from_flax(load(got[0]["fit"]["final"])[0])
    ref_state = checkpoint.state_dict_from_flax(load(ref_final)[0])
    fit_ok = all(np.allclose(dp_state[k].double().numpy(),
                             v.double().numpy(), rtol=PAR_FIT_RTOL,
                             atol=PAR_FIT_ATOL) for k, v in ref_state.items())
    fit_dev = max(((dp_state[k] - v).abs() - PAR_FIT_RTOL * v.abs()).max()
                  .item() for k, v in ref_state.items())
    stream_err = {key: max(float(np.max(np.abs(r["stream"]["labels"][key]
                                                - ref_stream[key])))
                           for r in got)
                  for key in ("x", "y", "displacement")}
    wide_px = max(float(np.max(np.abs(r["wide_stream"]["labels"][key]
                                      - ref_wide[key])))
                  for r in got for key in ("x", "y"))

    nccl = run_ranks(["--nccl-probe"], PAR_NCCL_TIMEOUT)
    nccl_said = [next((ln for ln in out.splitlines() if "NCCL" in ln),
                      out.strip().splitlines()[-1] if out.strip() else "")
                 for _, out in nccl]
    nccl_outcome = ("accepted" if all(rc == 0 for rc, _ in nccl) else
                    "killed at the limit" if any(rc is None for rc, _ in nccl)
                    else "refused")
    out = {"phase": "parallel_two_ranks", "ranks": 2,
           "backend": got[0]["backend"],
           "devices": [r["device"] for r in got], "seconds": ranks_s,
           "steps": steps_err, "step_rel_bound": PAR_STEP_REL,
           "fit": {"final": Path(got[0]["fit"]["final"]).name,
                   "windows": PAR_FIT_ITERS, "allclose": fit_ok,
                   "worst_over_rtol": fit_dev,
                   "rtol": PAR_FIT_RTOL, "atol": PAR_FIT_ATOL,
                   "ranks_s": [r["fit"]["seconds"] for r in got],
                   "one_rank_s": ref_s},
           "stream": {"hw": list(PAR_STREAM_HW), "frames": PAR_STREAM_FRAMES,
                      "frames_per_device": PAR_STREAM_FPD,
                      "max_abs_err": stream_err,
                      "ranks_s": [r["stream"]["seconds"] for r in got]},
           "wide_stream": {"hw": list(HW), "frames_per_device": PAR_FPD,
                           "dtype": "bfloat16", "frames": int(
                               ref_wide["x"].shape[0]),
                           "two_ranks_frames_per_s": got[0]["wide_stream"][
                               "frames_per_s"],
                           "one_rank_frames_per_s": ref_wide_fps,
                           "max_px_from_one_rank": wide_px},
           "nccl_two_ranks_one_card": {"outcome": nccl_outcome,
                                       "said": nccl_said,
                                       "rcs": [rc for rc, _ in nccl]}}
    emit(out)
    ok = (all(e["loss_rel"] <= PAR_STEP_REL and e["param_rel"] <= PAR_STEP_REL
              for e in steps_err.values())
          and fit_ok and got[0]["fit"]["final"] == got[1]["fit"]["final"]
          and max(stream_err.values()) <= PAR_STREAM_TOL
          and wide_px <= PAR_RAW_PX
          and got[0]["backend"] == "gloo"
          and got[0]["dgp"]["launches"]["softargmax_likelihood"] == 1)
    if not ok:
        raise AssertionError(f"two ranks against one: {out}")
    launches = {"parallel_fit_w2_ref": ref_launches,
                "parallel_wide_stream_ref": ref_wide_launches}
    for r, rank in enumerate(got):
        for name in ("dgp", "dlc"):
            launches[f"parallel_dp_{name}_step_rank{r}"] = rank[name][
                "launches"]
        launches[f"parallel_dp_fit_rank{r}"] = rank["fit"]["launches"]
        launches[f"parallel_stream_rank{r}"] = rank["stream"]["launches"]
        launches[f"parallel_wide_stream_rank{r}"] = rank["wide_stream"][
            "launches"]
    return launches


def multichip_runs(device, root, final) -> dict:
    """estimate_pose_multichip at world 1 under an NCCL process group of
    one, over the fit project's 747x832 ResNet-50 video from the step-2
    snapshot, in bf16 and int8: raw (smooth=False) against estimate_pose
    on the same snapshot, batches and calibration frames (PAR_RAW_PX);
    smoothed against ewma_reference of the raw track (PAR_SMOOTH_TOL);
    frames/s of the loop. Returns each path's launches."""
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.infer.predict import estimate_pose
    from deepgraphpose_tpu_torch.parallel import distributed, mesh
    from deepgraphpose_tpu_torch.parallel.streaming import (
        estimate_pose_multichip, ewma_reference)

    group = mesh.make_mesh(device=distributed.initialize(
        f"127.0.0.1:{free_port()}", 1, 0))
    backend = dist.get_backend()
    video = root / "videos_dgp" / "synthvid.avi"
    stride = resolve_project(root)[1].stride
    lines, launches, ok = [], {}, backend == "nccl"
    try:
        for dtype, quantize in (("bfloat16", False), ("bfloat16", True)):
            name = "multichip_int8" if quantize else "multichip_bf16"
            ref = estimate_pose(root / "config.yaml", final, video,
                                root / "videos_pred", save_pose=False,
                                batch_size=PAR_FPD, compute_dtype=dtype,
                                quantize=quantize, calib_frames=8,
                                device=device)
            runs = {}
            for smooth in (False, True):
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    runs[smooth], seconds, counts = counted(
                        estimate_pose_multichip, root / "config.yaml", final,
                        video, root / "videos_pred", mesh=group,
                        frames_per_device=PAR_FPD, save_pose=False,
                        smooth=smooth, compute_dtype=dtype,
                        quantize=quantize)
                rate = re.search(r"= ([\d.]+) frames/s", printed.getvalue())
                launches[f"{name}{'_smooth' if smooth else ''}"] = counts
                fps = float(rate.group(1)) if rate else None
            raw, sm = runs[False], runs[True]
            raw_px = max(float(np.max(np.abs(raw[k] - ref[k])))
                         for k in ("x", "y"))
            cells = np.stack([(raw["y"] - stride / 2) / stride,
                              (raw["x"] - stride / 2) / stride], -1)
            want = ewma_reference(cells, raw["likelihoods"])
            got = np.stack([(sm["y"] - stride / 2) / stride,
                            (sm["x"] - stride / 2) / stride], -1)
            smooth_ok = np.allclose(got, want, rtol=PAR_SMOOTH_TOL,
                                    atol=PAR_SMOOTH_TOL)
            line = {"phase": "parallel_multichip", "path": name,
                    "world": group.world, "backend": backend,
                    "frames": int(raw["x"].shape[0]),
                    "frames_per_device": PAR_FPD, "dtype": dtype,
                    "quantize": quantize, "frames_per_s": fps,
                    "wall_s": seconds,
                    "raw_vs_estimate_pose_px": raw_px,
                    "smoothed_vs_ewma_cells": float(np.max(np.abs(got
                                                                  - want))),
                    "smoothed_allclose": bool(smooth_ok),
                    "displacement_max": float(raw["displacement"].max()),
                    "launches": counts}
            emit(line)
            lines.append(line)
            ok = (ok and raw_px <= PAR_RAW_PX and smooth_ok
                  and all(np.isfinite(raw[k]).all() for k in raw)
                  and counts["softargmax_likelihood"] > 0
                  and (counts["mm_tiled"] > 0 and counts["conv_int8"] > 0)
                  == quantize)
    finally:
        dist.destroy_process_group()
    if not ok:
        raise AssertionError(f"time-sharded inference failed: {lines}")
    return launches


def phase_parallel(device, workdir, final) -> dict:
    """The parallel phase on the fit project: the group runs, two ranks on
    the card, the time-sharded inference. Returns each path's launches."""
    import torch

    t0 = time.perf_counter()
    root = Path(workdir) / "fit_project"
    runs = group_runs(root, device)
    launches = {r["run"]: r["launches"] for r in runs}
    launches.update(two_ranks(device, workdir, final))
    torch.cuda.empty_cache()
    launches.update(multichip_runs(device, root, final))
    emit({"phase": "parallel", "seconds": time.perf_counter() - t0})
    return launches


# the serving, head-only and render phases: what users run on the card
# after training, on the fit project and its snapshots
SERVE_BATCH = 16               # export_from_snapshot's default batch
SERVE_BATCHES = 8              # timed batches a path
SERVE_TOL = 1e-5               # served float32 against infer_forward
SERVE_INT8_PX = 1e-2           # served int8 against the live int8 model
HEAD_ITERS, HEAD_DISPLAY = 210, 10   # fit_dlc_heads updates, display sync
RENDER_EQUAL_PX = 1e-4         # plot_dgp's trajectories against estimate_pose
BLOCKED = ("jax", "flax", "optax", "deepgraphpose_tpu")


def serve_batches(n: int, batch: int, seed: int):
    """``n`` seeded uint8 batches of (batch, *HW, 3) on the host."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch, *HW, 3), dtype=np.uint8)
            for _ in range(n)]


def frames_per_s(fn, ring, batches: int) -> float:
    """Frames/s of ``batches`` calls of ``fn`` cycling through the device
    ``ring``, after one warm-up call (cuDNN autotunes the shape)."""
    import torch

    fn(ring[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(batches):
        fn(ring[i % len(ring)])
    torch.cuda.synchronize()
    return batches * ring[0].shape[0] / (time.perf_counter() - t0)


def serve_worker(art: str, inputs: str, out: str) -> int:
    """A fresh process that imports only ``infer.serving`` (JAX blocked):
    loads the artifact, runs it on the saved batch with the decode's
    launches counted, and saves mu, lik and what it imported to ``out``."""
    for name in BLOCKED:
        sys.modules[name] = None
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.infer import serving
    from deepgraphpose_tpu_torch.ops.kernels import launch_counts

    t0 = time.perf_counter()
    call, meta = serving.load_infer_artifact(art)
    load_s = time.perf_counter() - t0
    x = np.load(inputs)
    call(x)[0].cpu()
    before = launch_counts()
    mu, lik = (t.cpu() for t in call(x))
    torch.save({"mu": mu, "lik": lik, "load_s": load_s,
                "launches": {k: n - before[k]
                             for k, n in launch_counts().items()},
                "platforms": meta["platforms"],
                "blocked_loaded": sorted(
                    m for m, mod in sys.modules.items()
                    if m.split(".")[0] in BLOCKED and mod is not None),
                "port_modules": sum(m.startswith("deepgraphpose_tpu_torch")
                                    for m in sys.modules)}, out)
    return 0


def phase_serving(device, workdir, final) -> tuple[dict, Path]:
    """export_from_snapshot of the step-2 final snapshot ``final`` at
    747x832: float32 at batch SERVE_BATCH against infer_forward on the same
    weights and batches (TF32 off) and beside make_infer_fn in frames/s;
    bfloat16 at batch BATCH beside the live bf16 model; int8
    (quantize=True, calibrated on the video's frames resized to 747x832)
    against the live int8 model built the same way; the float32 artifact
    again in a fresh process that imports only infer.serving. Each served
    path's launches are counted from 0. Returns ({path: launches}, the
    float32 artifact)."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.infer import serving
    from deepgraphpose_tpu_torch.infer.predict import (infer_forward,
                                                       load_model,
                                                       make_infer_fn)
    from deepgraphpose_tpu_torch.models.quant import (calib_frames_from_video,
                                                      quantize_model)

    t_phase = time.perf_counter()
    workdir = Path(workdir)
    root = workdir / "fit_project"
    config = root / "config.yaml"
    _, cfg, _ = resolve_project(root)
    lines, launches, arts = {}, {}, {}

    def export(name, **kw):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            art = serving.export_from_snapshot(
                config, final.name, workdir / f"serve_{name}.pt2",
                in_hw=HW, device=device, **kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        call, meta = serving.load_infer_artifact(art)
        arts[name] = art
        return call, meta, {"export_s": export_s,
                            "load_s": time.perf_counter() - t0,
                            "mb": art.stat().st_size / 1e6,
                            "platforms": meta["platforms"]}

    def served(name, call, ring):
        """The loaded artifact's outputs on ``ring``, launches counted."""
        outs, _, launches[name] = counted(lambda: [call(x) for x in ring])
        return outs

    host = serve_batches(2, SERVE_BATCH, SEED + 5)
    ring = [torch.from_numpy(x).to(device) for x in host]

    # float32 at batch 16 against infer_forward on the same weights
    call, meta, line = export("f32", batch_size=SERVE_BATCH)
    f32 = load_model(cfg, final, torch.float32, device)
    outs = served("serving_f32", call, ring)
    want = [infer_forward(f32, cfg, x) for x in ring]
    err = max(max(((g - w).abs() / (SERVE_TOL + SERVE_TOL * w.abs())).max()
                  .item() for g, w in zip(got, ref))
              for got, ref in zip(outs, want))
    fps = {"served": [], "make_infer_fn": []}
    live = make_infer_fn(f32, cfg)
    for which in ("served", "make_infer_fn", "make_infer_fn", "served"):
        fps[which].append(frames_per_s(call if which == "served" else live,
                                       ring, SERVE_BATCHES))
    lines["f32"] = dict(line, batch=SERVE_BATCH, meta_keys=sorted(meta),
                        vs_infer_forward_tol_units=err,
                        frames_per_s=fps)

    # the fresh process: the same artifact and first batch
    np.save(workdir / "serve_in.npy", host[0])
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--serve-worker",
         str(arts["f32"]), str(workdir / "serve_in.npy"),
         str(workdir / "serve_out.pt")], cwd=str(ROOT), capture_output=True,
        text=True, timeout=600)
    fresh = (torch.load(workdir / "serve_out.pt") if res.returncode == 0
             else None)
    lines["fresh_process"] = {
        "rc": res.returncode, "seconds": time.perf_counter() - t0,
        "stderr_tail": res.stderr[-400:] if res.returncode else "",
        **({"load_s": fresh["load_s"], "launches": fresh["launches"],
            "platforms": fresh["platforms"],
            "blocked_loaded": fresh["blocked_loaded"],
            "port_modules": fresh["port_modules"],
            "vs_this_process": max(
                (fresh["mu"] - outs[0][0].cpu()).abs().max().item(),
                (fresh["lik"] - outs[0][1].cpu()).abs().max().item())}
           if fresh else {})}
    if fresh:
        launches["serving_fresh_process"] = fresh["launches"]
    del live, call
    torch.cuda.empty_cache()

    # bfloat16 at batch 128 beside the live bf16 model
    call, meta, line = export("bf16", batch_size=BATCH,
                              compute_dtype="bfloat16")
    bf16 = load_model(cfg, final, torch.bfloat16, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    big = [torch.randint(0, 256, (BATCH, *HW, 3), generator=gen,
                         dtype=torch.uint8, device=device) for _ in range(2)]
    outs = served("serving_bf16", call, big[:1])
    mu_live, _ = infer_forward(bf16, cfg, big[0])
    live = make_infer_fn(bf16, cfg)
    fps = {"served": [], "make_infer_fn": []}
    for which in ("served", "make_infer_fn", "make_infer_fn", "served"):
        fps[which].append(frames_per_s(call if which == "served" else live,
                                       big, FRAMES // BATCH))
    lines["bf16"] = dict(line, batch=BATCH, frames_per_s=fps,
                         vs_live_px=((outs[0][0] - mu_live).abs().max()
                                     * cfg.stride).item())
    del live, call, bf16, big
    torch.cuda.empty_cache()

    # int8 against the live int8 model of the same recipe (calibrated on
    # the video's first 8 frames), on the next SERVE_BATCH frames
    call, meta, line = export("int8", batch_size=SERVE_BATCH, quantize=True)
    frames = calib_frames_from_video(root / "videos_dgp" / "synthvid.avi",
                                     8 + SERVE_BATCH, resize_to=HW)
    qmodel = quantize_model(cfg, f32, frames[:8])
    held = torch.from_numpy(frames[8:]).to(device)
    outs = served("serving_int8", call, [held])
    mu_q, _ = infer_forward(qmodel, cfg, held)
    with torch.inference_mode():
        q = qmodel(held, heads=("part_pred",))["part_pred"]
        f = f32(held, heads=("part_pred",))["part_pred"]
    rel = ((q - f).abs().max() / f.abs().max()).item()
    corr = float(np.corrcoef(f.cpu().numpy().ravel(),
                             q.cpu().numpy().ravel())[0, 1])
    fps = frames_per_s(call, ring, SERVE_BATCHES)
    lines["int8"] = dict(line, batch=SERVE_BATCH, frames_per_s=fps,
                         quantized_int8=meta["quantized_int8"],
                         vs_live_int8_px=((outs[0][0] - mu_q).abs().max()
                                          * cfg.stride).item(),
                         live_logits_vs_f32={"rel_err": rel, "corr": corr})
    del call, qmodel, f32
    torch.cuda.empty_cache()

    out = {"phase": "serving", "hw": list(HW), "snapshot": final.name,
           **lines, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    gemm = ("mm_tiled", "conv_int8")
    failed = [name for name, ok in {
        "f32 within 1e-5 of infer_forward": err <= 1.0,
        "decode on every served path": all(
            launches[p]["softargmax_likelihood"] > 0 for p in (
                "serving_f32", "serving_bf16", "serving_int8")),
        "GEMM kernels on the int8 artifact": all(
            launches["serving_int8"][k] > 0 for k in gemm),
        "no GEMM on the float artifacts": all(
            launches[p][k] == 0 for p in ("serving_f32", "serving_bf16")
            for k in gemm),
        "int8 sidecar": lines["int8"]["quantized_int8"] is True,
        "int8 against the live int8 model": (
            lines["int8"]["vs_live_int8_px"] <= SERVE_INT8_PX),
        "live int8 logits within the int8 bounds": (
            rel < INT8_REL_ERR and corr > INT8_CORR),
        "bf16 finite": np.isfinite(lines["bf16"]["vs_live_px"]),
        "fresh process ran, JAX blocked": bool(
            fresh and not fresh["blocked_loaded"]),
        "fresh process launched the decode": bool(
            fresh and fresh["launches"][DECODE] > 0),
        "fresh process matches": bool(
            fresh and lines["fresh_process"]["vs_this_process"]
            <= SERVE_TOL),
        "artifacts on the card": all(
            lines[k]["platforms"] == ["cuda"] for k in ("f32", "bf16",
                                                         "int8")),
    }.items() if not ok]
    if failed:
        raise AssertionError(f"serving checks failed: {failed}")
    return launches, arts["f32"]


class TimedLines:
    """A stdout that keeps what is printed and when each line was written
    (the display lines of a training loop follow its syncs)."""

    def __init__(self):
        self.lines = []

    def write(self, text: str) -> int:
        now = time.perf_counter()
        for line in text.splitlines():
            if line.strip():
                self.lines.append((now, line))
        return len(text)

    def flush(self) -> None:
        pass


def phase_headonly(device, workdir, fit_lines) -> dict:
    """fit_dlc_heads from the fit phase's step-0 final snapshot: steps/s
    between its display syncs at HEAD_DISPLAY and the last, beside the
    fit phase's fit_dlc; the feature cache's bytes, forward seconds and
    launches; the loss falls, the backbone is bit-identical to the step-0
    snapshot, the heads moved; the frozen-BN tail kernel launched only in
    the feature cache (a forward under no_grad) and no other kernel
    launched in the run; the snapshot written runs in estimate_pose.
    Returns {path: launches}."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.infer.predict import estimate_pose
    from deepgraphpose_tpu_torch.train import headonly

    root = Path(workdir) / "fit_project"
    _, _, train_dir = resolve_project(root)
    cache = {}
    precompute = headonly.precompute_features

    def timed_features(*args, **kwargs):
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        feats = precompute(*args, **kwargs)
        torch.cuda.synchronize()
        cache.update(seconds=time.perf_counter() - t0,
                     bytes=feats.numel() * feats.element_size(),
                     shape=list(feats.shape),
                     launches={k: n - before[k]
                               for k, n in read_launches().items()})
        return feats

    printed = TimedLines()
    torch.cuda.reset_peak_memory_stats()
    headonly.precompute_features = timed_features
    try:
        with contextlib.redirect_stdout(printed):
            snap, wall, launches = counted(
                headonly.fit_dlc_heads, dlcpath=root,
                snapshot="snapshot-step0-final--0", maxiters=HEAD_ITERS,
                displayiters=HEAD_DISPLAY, device=device)
    finally:
        headonly.precompute_features = precompute
    for _, line in printed.lines:
        print(line, file=sys.stderr)
    syncs = [(t, int(m.group(1)), float(m.group(2))) for t, line in
             printed.lines for m in [re.match(
                 r"\[fit_dlc_heads\] iter (\d+)/\d+ loss ([\d.]+)", line)]
             if m]
    (t_a, it_a, _), (t_b, it_b, _) = syncs[1], syncs[-1]
    losses = [loss for _, _, loss in syncs]
    before, _ = checkpoint.load_snapshot(
        train_dir / "snapshot-step0-final--0.ckpt")
    after, _ = checkpoint.load_snapshot(snap)

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix, np.asarray(tree)

    backbone_equal, heads_moved = True, []
    for coll in ("params", "batch_stats"):
        for (path, a), (_, b) in zip(leaves(after[coll]),
                                     leaves(before[coll]), strict=True):
            if path[0] in headonly.HEAD_KEYS:
                heads_moved.append(not np.array_equal(a, b))
            else:
                backbone_equal &= bool(np.array_equal(a, b))
    with contextlib.redirect_stdout(sys.stderr):
        pose, pose_s, pose_launches = counted(
            estimate_pose, root / "config.yaml", snap,
            root / "videos_dgp" / "synthvid.avi", root / "videos_pred",
            save_pose=False, max_frames=32, device=device)
    fit_dlc = next(r for r in fit_lines if r["run"] == "fit_dlc")
    out = {"phase": "headonly", "snapshot": snap.name, "wall_s": wall,
           "updates": HEAD_ITERS, "timed_iterations": [it_a + 1, it_b],
           "steps_per_s": (it_b - it_a) / (t_b - t_a),
           "fit_dlc_steps_per_s": fit_dlc["steps_per_s"],
           "feature_cache": cache,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_loss": losses[0], "last_loss": losses[-1],
           "backbone_bit_identical": backbone_equal,
           "heads_moved": all(heads_moved) and bool(heads_moved),
           "estimate_pose": {"frames": int(pose["x"].shape[0]),
                             "seconds": pose_s,
                             "finite": bool(np.isfinite(pose["x"]).all())},
           "launches": launches, "estimate_pose_launches": pose_launches}
    emit(out)
    if not (out["backbone_bit_identical"] and out["heads_moved"]
            and np.mean(losses[-3:]) < np.mean(losses[:3])
            and out["estimate_pose"]["finite"]
            and launched(pose_launches, (DECODE, BN_TAIL))
            and launched(cache["launches"], (BN_TAIL,))
            and launches == cache["launches"]):
        raise AssertionError(f"headonly checks failed: {out}")
    return {"fit_dlc_heads": launches,
            "fit_dlc_heads_estimate_pose": pose_launches}


def phase_render(device, workdir, final, served: Path) -> dict:
    """plot_dgp from the step-2 snapshot on the fit project's video (the MP4
    holds every frame, its trajectories are estimate_pose's, both under
    deterministic cuDNN; wall frames/s with estimate_pose and the
    draw/encode apart), plot_dgp(quantize=True),
    the scoremaps of the labeled frames (extract_save_all_maps where
    matplotlib imports, else the maps without the drawing),
    evaluate_network(plotting=True) and display_dataset where matplotlib
    imports, utils/profiling.trace around a batch of the ``served``
    artifact, and device_memory_stats. Returns {path: launches}."""
    import importlib.util

    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.evaluation import maps, metrics
    from deepgraphpose_tpu_torch.infer import predict, serving, video_writer
    from deepgraphpose_tpu_torch.infer.export import load_pose_from_dlc
    from deepgraphpose_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    root = Path(workdir) / "fit_project"
    config = root / "config.yaml"
    video = root / "videos_dgp" / "synthvid.avi"
    launches, line, not_run = {}, {"phase": "render"}, {}
    parts = {}
    estimate = predict.estimate_pose
    annotate = video_writer.create_annotated_movie

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - t0
            return out
        return wrapped

    predict.estimate_pose = timed("estimate_pose_s", estimate)
    video_writer.create_annotated_movie = timed("draw_encode_s", annotate)
    mp4s = {}
    try:
        with h5_writes() as (h5_note, _), \
                contextlib.redirect_stdout(sys.stderr):
            # plot_dgp's float run and its reference under deterministic
            # cuDNN, so that the trajectories can match (autotuned float32
            # convolutions differ from call to call; see phase_analysis)
            with deterministic():
                ref = estimate(config, final, video, Path(workdir) / "ref",
                               save_pose=False, device=device)
            for name, kw, cudnn in (
                    ("plot_dgp", {}, deterministic),
                    ("plot_dgp_int8", dict(quantize=True, save_str="_int8"),
                     contextlib.nullcontext)):
                out_dir = Path(workdir) / "render" / name
                with cudnn():
                    mp4, wall, launches[name] = counted(
                        video_writer.plot_dgp, video, out_dir, config, final,
                        device=device, **kw)
                reader = VideoReader(mp4)
                n = sum(1 for _ in reader.iter_frames())
                size = [reader.height, reader.width]
                reader.close()
                table = load_pose_from_dlc(
                    str(out_dir / f"{video.stem}{kw.get('save_str', '')}.csv"))
                mp4s[name] = {"frames": n, "hw": size, "wall_s": wall,
                              "frames_per_s": n / wall, **parts,
                              "mb": mp4.stat().st_size / 1e6,
                              "cudnn": ("deterministic" if name == "plot_dgp"
                                        else "autotuned")}
                if name == "plot_dgp":
                    mp4s[name]["vs_estimate_pose_px"] = float(max(
                        np.abs(table[k] - ref[k]).max() for k in ("x", "y")))
    finally:
        predict.estimate_pose = estimate
        video_writer.create_annotated_movie = annotate
    line.update(mp4s, h5=h5_note)

    drawing = importlib.util.find_spec("matplotlib") is not None
    with contextlib.redirect_stdout(sys.stderr):
        if drawing:
            grids, line["maps_s"], launches["extract_save_all_maps"] = counted(
                maps.extract_save_all_maps, config,
                snapshot="snapshot-step2-final--0", device=device)
            line["maps_written"] = len(grids)
            results, _, launches["evaluate_network_plotting"] = counted(
                metrics.evaluate_network, config, plotting=True,
                snapshots="snapshot-step2-final--0", device=device)
            line["labeled_images"] = len(list(
                (root / "evaluation-results" / "iteration-0"
                 / "LabeledImages_snapshot-step2-final--0").glob("*.png")))
            line["targets_written"] = len(maps.display_dataset(config))
        else:
            grids, line["maps_s"], launches["labeled_scoremaps"] = counted(
                lambda: list(maps.labeled_scoremaps(
                    config, snapshot="snapshot-step2-final--0",
                    device=device)))
            line["maps_finite"] = all(np.isfinite(s).all()
                                      and np.isfinite(m).all()
                                      for _, _, s, m in grids)
            for what, fn in (("evaluate_network(plotting=True)", lambda:
                              metrics.evaluate_network(
                                  config, plotting=True, device=device)),
                             ("display_dataset", lambda:
                              maps.display_dataset(config)),
                             ("extract_save_all_maps (the drawing)", lambda:
                              maps.extract_save_all_maps(config,
                                                         device=device))):
                try:
                    fn()
                    not_run[what] = "ran"
                except ImportError as e:
                    not_run[what] = f"ImportError: {e}"
        line["maps"] = len(grids)

    call, _ = serving.load_infer_artifact(served)
    x = torch.from_numpy(serve_batches(1, SERVE_BATCH, SEED + 7)[0]).to(
        device)
    call(x)
    trace_dir = Path(workdir) / "trace"
    with contextlib.redirect_stdout(sys.stderr):
        with profiling.trace(trace_dir):
            call(x)
    traces = list(trace_dir.glob("trace-*.json"))
    events = (json.loads(traces[0].read_text())["traceEvents"]
              if traces else [])
    line["trace"] = {"files": len(traces),
                     "mb": traces[0].stat().st_size / 1e6 if traces else 0,
                     "decode_kernel_events": sum(
                         "softargmax_likelihood_kernel" in e.get("name", "")
                         for e in events),
                     "decode_op_events": sum(
                         "dgp_torch::softargmax_likelihood" in e.get(
                             "name", "") for e in events)}
    line["device_memory_stats"] = profiling.device_memory_stats()
    line.update(launches=launches, seconds=time.perf_counter() - t_phase)
    emit(line)
    if not_run:
        emit({"phase": "render_not_run",
              "why": "matplotlib absent on this host: the figures raise "
                     "ImportError, as the JAX package's do; the maps' "
                     "inference (decode kernel) ran without the drawing",
              "calls": not_run})
    gemm = ("mm_tiled", "conv_int8")
    frames = FIT_FRAMES
    failed = [name for name, ok in {
        "plot_dgp writes every frame": all(
            m["frames"] == frames for m in mp4s.values()),
        "plot_dgp trajectories are estimate_pose's": (
            mp4s["plot_dgp"]["vs_estimate_pose_px"] <= RENDER_EQUAL_PX),
        "decode on every inference path": all(
            c["softargmax_likelihood"] > 0 for c in launches.values()),
        "GEMM kernels on plot_dgp(quantize=True)": all(
            launches["plot_dgp_int8"][k] > 0 for k in gemm),
        "no GEMM on the float paths": all(
            c[k] == 0 for p, c in launches.items() if p != "plot_dgp_int8"
            for k in gemm),
        "maps of every labeled frame": line["maps"] == FIT_LABELED,
        "figures absent only for want of matplotlib": drawing or all(
            v.startswith("ImportError") for v in not_run.values()),
        "trace written with the decode kernel": (
            line["trace"]["files"] == 1
            and line["trace"]["decode_kernel_events"] > 0),
        "device memory stats": (
            line["device_memory_stats"][0]["device"] == "cuda:0"),
    }.items() if not ok]
    if failed:
        raise AssertionError(f"render checks failed: {failed}")
    return launches


# the workflow phase: the port's CLI in this process, one call a command
WORKFLOW_ITERS = 22            # --maxiters of each train step
WORKFLOW_TRAIN_FRACTION = 0.8  # 8 of the 10 extracted frames train
CB_ROWS, CB_COLS, CB_SQUARE = 8, 6, 0.5   # calibrate-cameras' defaults
CB_VIEWS = 12                  # rendered board poses
CB_SIZE = (640, 480)           # calibration image (w, h)
CALIB_RMS_PX = 1.0             # tests/test_threed.py's bounds
CALIB_TRIANGULATED = 0.5


def synthetic_track(n_frames: int, hw, nj: int):
    """(T, nj, 2) x, y of the dots in utils/synthetic.py's video (its
    formula), the ground truth the workflow labels its frames with."""
    import numpy as np

    h, w = hw
    t = np.arange(n_frames)
    cx = w / 2 + (w / 3) * np.sin(2 * np.pi * t[:, None] / 25
                                  + np.arange(nj) * 2)
    cy = h / 2 + (h / 3) * np.cos(2 * np.pi * t[:, None] / 31
                                  + np.arange(nj))
    return np.stack([cx, cy], -1)


def stereo_cameras():
    """tests/test_threed.py's two cameras: intrinsics K1, K2 and camera 2's
    pose (R, T) in camera 1's frame."""
    import cv2
    import numpy as np

    K1 = np.array([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]])
    K2 = np.array([[820.0, 0, 330], [0, 820, 235], [0, 0, 1]])
    R, _ = cv2.Rodrigues(np.array([0.0, 0.35, 0.0]))
    T = np.array([[-3.0], [0.1], [0.4]])
    return K1, K2, R, T


def checkerboard_views(img_dir, cbrow: int = CB_ROWS, cbcol: int = CB_COLS,
                       square: float = CB_SQUARE, views: int = CB_VIEWS,
                       names=("camera-1", "camera-2")) -> dict:
    """Render a (cbrow x cbcol inner corners) checkerboard of ``square``
    units in ``views`` seeded poses through both stereo_cameras into
    ``img_dir/<camera>-<view>.png`` (a homography of a drawn board, with
    OpenCV). Returns the truth: {"K1", "K2", "R", "T"}."""
    import cv2
    import numpy as np

    K1, K2, R, T = stereo_cameras()
    px, margin = 40, 1                 # board pixels a square, white rim
    nx, ny = cbcol + 1 + 2 * margin, cbrow + 1 + 2 * margin
    board = np.full((ny * px, nx * px), 255, np.uint8)
    for j in range(cbrow + 1):
        for i in range(cbcol + 1):
            if (i + j) % 2 == 0:
                y0, x0 = (j + margin) * px, (i + margin) * px
                board[y0:y0 + px, x0:x0 + px] = 0
    # board pixel -> board plane (units), inner corner (0, 0) at the origin
    to_plane = np.array([[square / px, 0, -(1 + margin) * square],
                         [0, square / px, -(1 + margin) * square],
                         [0, 0, 1.0]])
    centre = np.array([(cbcol - 1) / 2 * square, (cbrow - 1) / 2 * square,
                       0.0])
    img_dir = Path(img_dir)
    img_dir.mkdir(parents=True, exist_ok=True)
    for v in range(views):
        Rb, _ = cv2.Rodrigues(np.array([0.25, -0.2, 0.05]) * (v % 5 - 2))
        tb = np.array([-0.6 + 0.1 * v, -0.3 + 0.05 * v, 12.0 + 0.2 * v])
        for name, K, Rc, tc in ((names[0], K1, np.eye(3), np.zeros((3, 1))),
                                (names[1], K2, R, T)):
            Rcb = Rc @ Rb
            tcb = Rc @ (tb - Rb @ centre).reshape(3, 1) + tc
            H = K @ np.hstack([Rcb[:, :2], tcb]) @ to_plane
            img = cv2.warpPerspective(board, H, CB_SIZE,
                                      flags=cv2.INTER_LINEAR,
                                      borderValue=128)
            cv2.imwrite(str(img_dir / f"{name}-{v:02d}.png"), img)
    return {"K1": K1, "K2": K2, "R": R, "T": T}


def calibration_errors(system, truth: dict, rng) -> dict:
    """How well a calibrated CameraSystem recovers the truth of
    checkerboard_views: its stereo RMS, and fresh points in front of the
    cameras, projected through the true cameras and triangulated with the
    recovered projections (tests/test_threed.py's check)."""
    import numpy as np

    from deepgraphpose_tpu_torch.threed.triangulation import \
        triangulate_points

    P1 = truth["K1"] @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = truth["K2"] @ np.hstack([truth["R"], truth["T"]])

    def project(P, X):
        x = (P @ np.hstack([X, np.ones((len(X), 1))]).T).T
        return x[:, :2] / x[:, 2:3]

    X = rng.uniform([-1, -1, 8], [1, 1, 12], (20, 3))
    names = system.camera_names
    got = triangulate_points(system.P[names[0]], system.P[names[1]],
                             project(P1, X), project(P2, X))
    return {"rms_px": float(system.rms),
            "triangulated_max": float(np.abs(got - X).max()),
            "R_max": float(np.abs(system.R - truth["R"]).max()),
            "T_max": float(np.abs(system.T.reshape(3, 1)
                                  - truth["T"]).max())}


@contextlib.contextmanager
def model_devices():
    """Record the device of the first parameter of every PoseModel and
    QuantizedPoseModel forward inside the block: the set of device types
    the commands ran their models on."""
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel
    from deepgraphpose_tpu_torch.models.quant import QuantizedPoseModel

    seen: set = set()
    saved = {cls: cls.forward for cls in (PoseModel, QuantizedPoseModel)}

    def recording(forward):
        def wrapped(self, *args, **kwargs):
            param = next(self.parameters(), None)
            buf = next(self.buffers(), None)
            seen.add((param if param is not None else buf).device.type)
            return forward(self, *args, **kwargs)
        return wrapped

    for cls, forward in saved.items():
        cls.forward = recording(forward)
    try:
        yield seen
    finally:
        for cls, forward in saved.items():
            cls.forward = forward


@contextlib.contextmanager
def checked_first_int8_batch(path: str, calls: list):
    """Within the block, each int8 model that ``quantize_model`` makes runs
    its first forward under ``checked_convs`` (every conv of the first
    batch held against the plain version on its own input); the checks'
    own launches, one on the route of each checked conv, are appended to
    ``calls`` so that the caller takes them out of the command's count."""
    from deepgraphpose_tpu_torch.models import quant

    make = quant.quantize_model

    def quantize_model(*args, **kwargs):
        qmodel = make(*args, **kwargs)
        forward = qmodel.forward

        def first(*a, **k):
            del qmodel.forward          # later batches run unchecked
            with checked_convs(qmodel, path, calls):
                return forward(*a, **k)
        qmodel.forward = first
        return qmodel

    quant.quantize_model = quantize_model
    try:
        yield
    finally:
        quant.quantize_model = make


def phase_workflow(device, workdir) -> dict:
    """The DLC project workflow through the port's CLI
    (``deepgraphpose_tpu_torch/cli.py``), in this process, one
    ``cli.main(argv)`` a command, on the fit phase's 747x832 video with
    ResNet-50 at full width and depth: create-project, extract-frames
    (uniform), the labels written from the video's ground truth,
    check-labels, create-training-dataset, train --step 0, 1 and 2
    (WORKFLOW_ITERS updates each), evaluate and evaluate --int8,
    analyze-videos and analyze-videos --int8, filter-predictions,
    extract-outlier-frames, analyze-skeleton, create-labeled-video,
    export-model (batch 16, float32), create-project-3d, calibrate-cameras
    on rendered checkerboard views and triangulate. Each command's line
    holds its wall seconds and every kernel's launches (counts set to 0
    before it; an int8 command's first-batch conv checks taken out). A
    command that needs a package this host lacks (matplotlib, h5py) is
    reported on the ``workflow_not_run`` line with its ImportError.
    Returns {command: launches}."""
    import glob
    import importlib.util

    import numpy as np
    import torch

    from deepgraphpose_tpu_torch import cli
    from deepgraphpose_tpu_torch.core.config import ProjectConfig
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.project import (
        Labels, write_collected_data_csv)
    from deepgraphpose_tpu_torch.infer import analyze
    from deepgraphpose_tpu_torch.infer.export import load_pose_from_dlc
    from deepgraphpose_tpu_torch.infer.predict import estimate_pose
    from deepgraphpose_tpu_torch.threed.calibration import CameraSystem

    t_phase = time.perf_counter()
    wf = Path(workdir) / "workflow"
    wf.mkdir()
    source = Path(workdir) / "fit_project" / "videos_dgp" / "synthvid.avi"
    dev = str(device)
    launches, not_run, checks = {}, {}, {}
    devices = set()

    def command(name, argv, expect_import_error=None):
        """One CLI command, counted; returns its exit code, or None where
        it raised the expected ImportError (reported, not run)."""
        calls = checks.setdefault(name, [])
        argv = [str(a) for a in argv] + ["--device", dev]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            with checked_first_int8_batch(name, calls), \
                    model_devices() as seen, \
                    contextlib.redirect_stdout(sys.stderr):
                rc = cli.main(argv)
        except ImportError as e:
            if expect_import_error is None or \
                    importlib.util.find_spec(expect_import_error) is not None:
                raise
            not_run[name] = f"ImportError: {e}"
            return None
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        for c in calls:                 # the checks' own launches
            counts[c["route"]] -= 1
        devices.update(seen)
        launches[name] = counts
        line = {"phase": "workflow", "command": name, "argv": argv,
                "rc": rc, "seconds": seconds, "launches": counts,
                "model_devices": sorted(seen)}
        if calls:
            line["checked"] = check_summary(calls)
        emit(line)
        if rc != 0:
            raise AssertionError(f"workflow: {name} exited {rc}")
        return rc

    with h5_writes(tables=True) as (h5_note, h5_recorded):
        command("create-project", ["create-project", "Workflow", "chip",
                                   source, "--wd", wf])
        (config,) = [Path(c) for c in glob.glob(
            str(wf / "Workflow-chip-*" / "config.yaml"))]
        root = config.parent
        # the user's edits of config.yaml: bodyparts, skeleton, frames
        proj = ProjectConfig.from_yaml(config)
        bodyparts = [f"bp{j}" for j in range(NUM_JOINTS)]
        proj.bodyparts, proj.skeleton = bodyparts, [["bp0", "bp1"],
                                                    ["bp0", "bp2"]]
        proj.numframes2pick = FIT_LABELED
        proj.TrainingFraction = [WORKFLOW_TRAIN_FRACTION]
        proj.to_yaml(config)
        command("extract-frames", ["extract-frames", config, "--mode",
                                   "automatic", "--algo", "uniform"])
        vdir = root / "labeled-data" / source.stem
        pngs = sorted(vdir.glob("img*.png"))
        picked = [int(p.stem[3:]) for p in pngs]
        truth = synthetic_track(FIT_FRAMES, HW, NUM_JOINTS)
        write_collected_data_csv(
            vdir / "CollectedData_chip.csv",
            Labels(scorer="chip", bodyparts=bodyparts,
                   image_paths=[f"labeled-data/{source.stem}/{p.name}"
                                for p in pngs],
                   coords_xy=truth[picked]))
        command("check-labels", ["check-labels", config],
                expect_import_error="matplotlib")
        command("create-training-dataset",
                ["create-training-dataset", config])
        for step in (0, 1, 2):
            command(f"train-step{step}",
                    ["train", config, "--step", step,
                     "--maxiters", WORKFLOW_ITERS])
        command("evaluate", ["evaluate", config])
        command("evaluate-int8", ["evaluate", config, "--int8"])
        video = root / "videos" / source.name
        folders = {"float": video.parent, "int8": root / "analysis_int8"}
        # the float analysis (next to the video, where the commands after
        # it look) and its reference under deterministic cuDNN: autotuned
        # float32 convolutions differ from call to call
        with deterministic():
            command("analyze-videos", ["analyze-videos", config, video])
            proj, pose_cfg, train_dir = resolve_project(root)
            snapshot = analyze._resolve_snapshot(train_dir, proj, None)[0]
            with contextlib.redirect_stdout(sys.stderr):
                want = estimate_pose(config, snapshot, video, root / "ref",
                                     save_pose=False, device=device)
        command("analyze-videos-int8", ["analyze-videos", config, video,
                                        "--int8", "--destfolder",
                                        folders["int8"]])
        scorer = analyze.get_scorer_name(
            proj, pose_cfg, 1, snapshot.stem.split("-")[-1])[0]
        tables = {k: load_pose_from_dlc(
            str(folder / f"{video.stem}{scorer}.csv"))
            for k, folder in folders.items()}
        command("filter-predictions", ["filter-predictions", config, video])
        command("extract-outlier-frames", ["extract-outlier-frames", config,
                                           video])
        command("analyze-skeleton", ["analyze-skeleton", config, video],
                expect_import_error="h5py")
        command("create-labeled-video", ["create-labeled-video", config,
                                         video, "--destfolder",
                                         root / "labeled_video"])
        artifact = root / "exported" / "pose.pt2"
        artifact.parent.mkdir()
        command("export-model", ["export-model", config, artifact,
                                 "--batch-size", SERVE_BATCH])
        served = served_batch(artifact, video, device)
        launches["export-model served batch"] = served.pop("launches")
        command("create-project-3d", ["create-project-3d", "Stereo", "chip",
                                      "--wd", wf])
        (config3d,) = [Path(c) for c in glob.glob(
            str(wf / "Stereo-chip-*-3d" / "config.yaml"))]
        truth3d = checkerboard_views(config3d.parent / "calibration_images")
        command("calibrate-cameras", ["calibrate-cameras", config3d,
                                      "--square-size", CB_SQUARE])
        system = CameraSystem.load(config3d.parent / "camera_matrix"
                                   / "stereo_params.pickle")
        calib = calibration_errors(system, truth3d,
                                   np.random.default_rng(SEED))
        tri = triangulate_views(config3d, truth3d, command)
    emit({"phase": "workflow_not_run",
          "why": "packages absent on this host: the commands raise "
                 "ImportError, as the JAX package's do",
          "commands": not_run, "h5": h5_note,
          "h5_recorded": len(h5_recorded)})

    got = np.stack([tables["float"][k] for k in ("x", "y")], -1)
    ref = np.stack([want[k] for k in ("x", "y")], -1)
    train_files = sorted(p.name for p in Path(train_dir).glob("*.ckpt"))
    finals = [f"snapshot-step{s}-final--0.ckpt" for s in (0, 1, 2)]
    model_commands = ("train-step1", "train-step2", "evaluate",
                      "evaluate-int8", "analyze-videos",
                      "analyze-videos-int8", "create-labeled-video",
                      "export-model served batch")
    int8_commands = ("evaluate-int8", "analyze-videos-int8")
    gemm = ("mm_tiled", "conv_int8")
    line = {"phase": "workflow_checks", "project": root.name,
            "frames_labeled": picked, "snapshots": train_files,
            "snapshot_analyzed": snapshot.name, "scorer": scorer,
            "analyze_vs_estimate_pose_px": float(np.abs(got - ref).max()),
            "int8_vs_float_px": float(np.nanmax(np.abs(np.stack(
                [tables["int8"][k] for k in ("x", "y")], -1) - got))),
            "artifact_mb": artifact.stat().st_size / 1e6,
            "served": served,
            "calibration": calib, "triangulate": tri,
            "model_devices": sorted(devices),
            "checked": {k: check_summary(v) for k, v in checks.items()
                        if v},
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    failed = [name for name, ok in {
        "the three steps' final snapshots": all(f in train_files
                                                for f in finals),
        "analyze-videos read the step-2 final": (
            snapshot.name == finals[2]),
        "analyze-videos equals estimate_pose": (
            got.shape == ref.shape == (FIT_FRAMES, NUM_JOINTS, 2)
            and line["analyze_vs_estimate_pose_px"] <= ANALYSIS_EQUAL_PX),
        "the exported artifact serves": served["finite"],
        "int8 trajectories finite": bool(np.isfinite(np.stack(
            [tables["int8"][k] for k in ("x", "y")])).all()),
        "decode on every model command": all(
            launches[c]["softargmax_likelihood"] > 0
            for c in model_commands),
        "no kernel in the DLC step": all(
            v == 0 for v in launches["train-step0"].values()),
        "GEMM kernels on the int8 commands": all(
            launches[c][k] > 0 for c in int8_commands for k in gemm),
        "first int8 batch checked on both routes": all(
            {c["route"] for c in checks[cmd]} == set(gemm)
            for cmd in int8_commands),
        "no GEMM on the float commands": all(
            launches[c][k] == 0 for c in launches if c not in int8_commands
            for k in gemm),
        "models on the card only": devices == {"cuda"},
        "calibration recovers the stereo pose": (
            calib["rms_px"] < CALIB_RMS_PX
            and calib["triangulated_max"] < CALIB_TRIANGULATED),
        "triangulated where h5py imports": (
            "triangulate" in not_run
            or tri["max_err"] < CALIB_TRIANGULATED),
        "absent only for want of a package": set(not_run) <= {
            "check-labels", "analyze-skeleton", "triangulate"},
    }.items() if not ok]
    if failed:
        raise AssertionError(f"workflow checks failed: {failed}")
    return launches


def served_batch(artifact, video, device) -> dict:
    """One batch of the video's first frames through the artifact that
    export-model wrote, loaded as a server loads it, counted: the
    program's graph calls the decode op (``dgp_torch::
    softargmax_likelihood``); the export itself traces it without a
    launch."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.infer import serving

    call, meta = serving.load_infer_artifact(artifact)
    reader = VideoReader(video)
    frames = np.stack([f for _, f in zip(range(meta["input_shape"][0]),
                                         (f for _, f in
                                          reader.iter_frames()))])
    reader.close()
    x = torch.from_numpy(frames).to(device)
    (mu, lik), seconds, launches = counted(call, x)
    out = {"input_shape": meta["input_shape"],
           "platforms": meta["platforms"], "seconds": seconds,
           "finite": bool(torch.isfinite(mu).all() and
                          torch.isfinite(lik).all()),
           "launches": launches}
    emit({"phase": "workflow", "command": "export-model served batch",
          **out})
    return out


def triangulate_views(config3d, truth: dict, command) -> dict:
    """``triangulate`` through the CLI on two pose tables: a seeded 3-D
    trajectory projected through the true cameras (tables written with
    infer/export.py's H5 writer; where h5py is absent the command is not
    run and ``command`` reports it). Called inside ``h5_writes(tables=
    True)``. Returns the largest error against
    the trajectory, or {} where it did not run."""
    import numpy as np

    from deepgraphpose_tpu_torch.infer import export

    root = Path(config3d).parent
    rng = np.random.default_rng(SEED + 3)
    X = rng.uniform([-1, -1, 8], [1, 1, 12], (30, NUM_JOINTS, 3))
    bps = [f"bp{j}" for j in range(NUM_JOINTS)]
    Ps = (truth["K1"] @ np.hstack([np.eye(3), np.zeros((3, 1))]),
          truth["K2"] @ np.hstack([truth["R"], truth["T"]]))
    paths = []
    for cam, P in zip(("cam1", "cam2"), Ps):
        x = (P @ np.hstack([X.reshape(-1, 3),
                            np.ones((X.size // 3, 1))]).T).T
        xy = (x[:, :2] / x[:, 2:3]).reshape(30, NUM_JOINTS, 2)
        path = root / f"stereo_{cam}.h5"
        export.write_pose_h5(path, "chip", bps,
                             {"x": xy[..., 0], "y": xy[..., 1],
                              "likelihoods": np.ones((30, NUM_JOINTS))})
        paths.append(path)
    if command("triangulate", ["triangulate", config3d, *paths],
               expect_import_error="h5py") is None:
        return {}
    import h5py

    with h5py.File(root / "stereo_cam1_DGP_3D_3d.h5") as f:
        xyz = f["df_with_missing_3d"]["xyz"][()]
    return {"max_err": float(np.abs(xyz - X).max())}


# --------------------------------------------------------------------------
# native_decode: the host feed's batch JPEG decode (native/)
# --------------------------------------------------------------------------

NATIVE_WINDOW = TRAIN_BATCH + 1   # frames a host-fed step-2 window
NATIVE_WINDOWS = 24               # windows timed on each path
NATIVE_TOL = 3                    # per channel value (tests/test_native.py)


def native_status_line() -> dict:
    """The native decoder's build status (built, loaded from the build
    directory, or why not), as ``native.status()`` gives it."""
    from deepgraphpose_tpu_torch import native

    line = {"phase": "native_build", **native.status()}
    emit(line)
    return line


def get_batch_windows(video) -> dict:
    """``FrameCache.get_batch`` over NATIVE_WINDOWS seeded windows of
    NATIVE_WINDOW frames of ``video`` (every frame cached): the native
    batch decode against the cache's OpenCV path (``get`` a frame, as
    ``get_batch`` decodes without the library), wall ms a window, in turn
    in one process, and the largest difference between the two."""
    import numpy as np

    from deepgraphpose_tpu_torch import native
    from deepgraphpose_tpu_torch.data.video import FrameCache, VideoReader

    reader = VideoReader(video)
    cache = FrameCache(reader, range(reader.n_frames))
    starts = np.random.default_rng(SEED).integers(
        0, reader.n_frames - NATIVE_WINDOW, NATIVE_WINDOWS)
    windows = [list(range(s, s + NATIVE_WINDOW)) for s in starts]
    h, w = cache.get(0).shape[:2]

    def opencv(idx):
        return np.stack([cache.get(i) for i in idx])

    available = native.load_framecache_lib() is not None
    paths = {"native": cache.get_batch} if available else {}
    paths["opencv"] = opencv
    ms = {name: [] for name in paths}
    worst = 0
    for idx in windows:
        out = {}
        for name, fn in paths.items():
            t0 = time.perf_counter()
            out[name] = fn(idx)
            ms[name].append(1e3 * (time.perf_counter() - t0))
        if available:
            worst = max(worst, int(np.abs(out["native"].astype(np.int16)
                                          - out["opencv"]).max()))
    reader.close()
    return {"frames": [NATIVE_WINDOW, h, w, 3], "windows": NATIVE_WINDOWS,
            "cached_mb": cache.nbytes / 1e6,
            "ms_per_window": {k: {"median": float(np.median(v)),
                                  "mean": float(np.mean(v)),
                                  "first": v[0]} for k, v in ms.items()},
            "speedup": (float(np.median(ms["opencv"])
                              / np.median(ms["native"]))
                        if available else None),
            "max_abs_diff": worst if available else None}


@contextlib.contextmanager
def assemble_split(opencv: bool):
    """Within the block, the wall seconds the host feed spends in
    ``assemble_batch`` (``assemble_s``), in ``FrameCache.get_batch`` (the
    decode) and in ``flow_magnitude_sequence`` (OpenCV's Farneback flow),
    summed over its calls on the fit loop's producer thread, and the
    batches the native library decoded; with ``opencv`` the library
    declines every batch, so ``get_batch`` decodes with OpenCV a frame."""
    from deepgraphpose_tpu_torch import native
    from deepgraphpose_tpu_torch.data import flow, video
    from deepgraphpose_tpu_torch.train import fit

    spent = {"assemble_s": 0.0, "decode_s": 0.0, "flow_s": 0.0,
             "assembled": 0, "decoded": 0, "flows": 0, "native_batches": 0}
    saved = (fit.assemble_batch, video.FrameCache.get_batch,
             flow.flow_magnitude_sequence, native.decode_jpeg_batch)

    def timed(key, count, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
                spent[count] += 1
        return wrapped

    def decode(*args, **kwargs):
        out = None if opencv else saved[3](*args, **kwargs)
        spent["native_batches"] += out is not None
        return out

    fit.assemble_batch = timed("assemble_s", "assembled", saved[0])
    video.FrameCache.get_batch = timed("decode_s", "decoded", saved[1])
    flow.flow_magnitude_sequence = timed("flow_s", "flows", saved[2])
    native.decode_jpeg_batch = decode
    try:
        yield spent
    finally:
        (fit.assemble_batch, video.FrameCache.get_batch,
         flow.flow_magnitude_sequence, native.decode_jpeg_batch) = saved


def phase_native_decode(device, workdir) -> list:
    """The native batch JPEG decoder on the fit project: its build status,
    ``get_batch`` native against OpenCV on 11-frame windows of the
    project's video (within NATIVE_TOL per channel value), and the
    host-fed fit_dgp(wt=1) of the fit phase run again with the native
    decode and with OpenCV's, each with its host assembly split into the
    decode and the Farneback flow. Where the library does not build the
    phase says why, times the OpenCV path alone and runs the fit once."""
    from deepgraphpose_tpu_torch import native
    from deepgraphpose_tpu_torch.train import fit

    status = native.status()
    root = Path(workdir) / "fit_project"
    windows = get_batch_windows(root / "videos_dgp" / "synthvid.avi")
    line = {"phase": "native_decode", "available": status["available"],
            "reason": status["reason"], **windows}
    emit(line)
    if status["available"] and not line["max_abs_diff"] <= NATIVE_TOL:
        raise AssertionError(f"native decode against OpenCV: {line}")
    kw = dict(dlcpath=root, maxiters=FIT_WT_ITERS, displayiters=1,
              saveiters=FIT_SAVE * TRAIN_BATCH, device=device,
              batch_size=TRAIN_BATCH, wt=1.0)
    runs = []
    for feed in (("native", "opencv") if status["available"]
                 else ("opencv",)):
        with assemble_split(opencv=feed == "opencv") as spent:
            run = fit_run(f"fit_dgp_wt_{feed}", fit.fit_dgp,
                          dict(kw, debug=f"_wt_{feed}"), TRAIN_BATCH, 1)
        per = max(spent["decoded"], 1)
        split = {"phase": "native_fit", "run": run["run"], "decode": feed,
                 "steps_per_s": run["steps_per_s"],
                 "updates": run["updates"], "wall_s": run["wall_s"],
                 **spent,
                 "decode_ms_per_window": 1e3 * spent["decode_s"] / per,
                 "flow_ms_per_window": 1e3 * spent["flow_s"] / per,
                 "assemble_ms_per_window": 1e3 * spent["assemble_s"] / per,
                 "launches": run["launches"]}
        emit(split)
        want_native = spent["decoded"] if feed == "native" else 0
        if spent["native_batches"] != want_native or not spent["decoded"]:
            raise AssertionError(f"{run['run']}: the windows took the wrong "
                                 f"decode: {split}")
        runs.append(run)
    return runs


# --------------------------------------------------------------------------
# trained: a model trained on the card, and what bf16 and int8 cost it
# --------------------------------------------------------------------------

# updates a training run, in dispatches of SCAN_K
TRAINED_ITERS = {"resnet_50": 3960, MOBILE_NET: 5940}
TRAINED_DISPLAY = 220         # a loss read every 20 dispatches
TRAINED_JITTER = (0.5, 1.25)  # the no-ImageNet recipe's scale jitter
TRAINED_POS_DIST = 17         # px; pose_cfg's default (the project has 9)
# a constant rate a backbone: the reference schedule's main rate for the
# ResNets (0.005 is its warm-up, tuned for ImageNet weights)
TRAINED_LR = {"resnet_50": 0.02, MOBILE_NET: 0.1}
TRAINED_RUNS = (("resnet_50", "float32"), ("resnet_50", "bfloat16"),
                (MOBILE_NET, "float32"))


def px_error(pose: dict, ref: dict) -> dict:
    """Each (frame, joint)'s distance between two trajectories, in px:
    median, 99th percentile and largest, and a joint at a time; and the
    likelihoods' largest and mean absolute difference."""
    import numpy as np

    d = np.hypot(pose["x"] - ref["x"], pose["y"] - ref["y"])
    dl = np.abs(pose["likelihoods"] - ref["likelihoods"])
    return {"median": float(np.median(d)),
            "p99": float(np.percentile(d, 99)), "max": float(d.max()),
            "median_by_joint": np.median(d, 0).tolist(),
            "max_by_joint": d.max(0).tolist(),
            "lik_max": float(dl.max()), "lik_mean": float(dl.mean())}


def label_rmse(pose: dict, frames, coords_xy) -> dict:
    """RMSE in px between a trajectory's labeled frames and the labels:
    over every joint (``all``) and a joint at a time (``by_joint``)."""
    import numpy as np

    xy = np.stack([pose["x"][frames], pose["y"][frames]], -1)
    sq = np.sum((xy - coords_xy) ** 2, -1)
    return {"all": float(np.sqrt(sq.mean())),
            "by_joint": np.sqrt(sq.mean(0)).tolist()}


def batch_stat_rmse(root: Path, snapshot: Path, device, labels,
                    dtype: str = "float32") -> dict:
    """The labeled frames' RMSE of a model whose batch-norm runs on each
    frame's own statistics, as it trained (batch 1), instead of its
    moving ones: one frame at a time, computing in ``dtype`` over float32
    weights, the plain decode. A diagnostic of the moving statistics, not
    a path users run."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel
    from deepgraphpose_tpu_torch.ops.softargmax import softargmax_2d

    frames, coords = labels
    _, cfg, _ = resolve_project(root)
    model = PoseModel(cfg, dtype=dtype, param_dtype="float32").to(device)
    checkpoint.load_snapshot(snapshot, model)
    reader = VideoReader(root / "videos_dgp" / "synthvid.avi")
    xy = []
    with torch.no_grad(), deterministic():
        for f in frames:
            image = torch.from_numpy(reader.read_frame(int(f))[None])
            maps = model(image.to(device), heads=("part_pred",),
                         train=True)["part_pred"]
            mu, _ = softargmax_2d(maps.float(), gamma=cfg.gamma,
                                  gauss_len=cfg.gauss_len)
            xy.append(mu[0].flip(-1).cpu().numpy() * cfg.stride
                      + 0.5 * cfg.stride)
    reader.close()
    xy = np.stack(xy)
    return label_rmse({"x": xy[..., 0], "y": xy[..., 1]},
                      np.arange(len(frames)), coords)


# one bf16 step-0 update with trainable batch-norm, card against CPU, with
# the CPU's float32 update as the yardstick. A bf16 step of ResNet-50 with
# batch statistics of one frame is mostly rounding noise: its momentum
# traces lie a median 0.36-1.06 of each tensor's largest float32 value
# from float32's (PERF.md), and two bf16 steps that round in a different
# order are two draws of that noise, a tensor at a time. So a tensor's
# card-to-CPU distance against the CPU's bf16-to-float32 distance (floor
# 1e-6 of the tensor's largest float32 value: the CPU tests' bound) is
# reported, not held. Held: the loss terms, within BF16_LOSS_REL of the
# CPU's bf16 ones or as close as the CPU's bf16 term is to its float32
# one; finite traces and moving statistics; and the card's median bf16
# distance from float32 within BF16_NOISE_FACTOR of the CPU's either way:
# the card's bf16 step is as far from float32 as the CPU's (a step that
# ran in float32 would sit at the card's float32 distance from the CPU,
# a median 7e-4).
BF16_LOSS_REL = 1e-2
BF16_NOISE_FACTOR = 1.5


def bf16_step_card_vs_cpu(root: Path, snapshot: Path, device,
                          labels) -> dict:
    """From ``snapshot`` (the bf16-trained ResNet-50), one bf16 update of
    ``make_dlc_train_step(bn_train=True)`` at the recipe's rate on the
    first labeled frame (batch 1, 746x832, its labels) on the card under
    deterministic cuDNN and on the CPU, and the CPU's float32 update: the
    bounds above, and how far bf16 moves each trace from float32 (the
    median and largest over the tensors of the distance over the tensor's
    largest float32 value), on the CPU and on the card."""
    import numpy as np
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel
    from deepgraphpose_tpu_torch.train import steps

    frames, coords = labels
    _, cfg, _ = resolve_project(root)
    reader = VideoReader(root / "videos_dgp" / "synthvid.avi")
    image = torch.from_numpy(reader.read_frame(int(frames[0]))[None])
    reader.close()
    xy = torch.from_numpy(np.asarray(coords[:1], np.float32))
    present = torch.isfinite(xy[..., 0])
    xy = torch.nan_to_num(xy)
    rate = TRAINED_LR[cfg.net_type]

    def update(dtype, dev):
        model = PoseModel(cfg, dtype=dtype, param_dtype=torch.float32)
        checkpoint.load_snapshot(snapshot, model)
        model = model.to(dev, memory_format=torch.channels_last)
        opt = steps.make_optimizer(model.parameters(), rate)
        t0 = time.perf_counter()
        losses = steps.make_dlc_train_step(model, cfg, opt, bn_train=True)(
            image, xy, present)
        losses = {k: v.item() for k, v in losses.items()}
        seconds = time.perf_counter() - t0
        traces = {k: opt.state[p]["momentum_buffer"].cpu()
                  for k, p in model.named_parameters()}
        stats = {k: v.cpu() for k, v in model.state_dict().items()
                 if k.endswith((".mean", ".var"))}
        return losses, traces, stats, seconds

    with deterministic():
        card = update(torch.bfloat16, device)
        card32 = update(torch.float32, device)
    cpu, cpu32 = update(torch.bfloat16, "cpu"), update(torch.float32, "cpu")

    def ratios(got, want, want32) -> dict:
        return {k: (got[k] - want[k]).abs().max().item() / max(
            (want[k] - want32[k]).abs().max().item(),
            1e-6 * want32[k].abs().max().item()) for k in want}

    def spread(a, b) -> dict:
        rel = [(a[k] - b[k]).abs().max().item() / b[k].abs().max().item()
               for k in b]
        return {"median": float(np.median(rel)), "max": float(max(rel))}

    loss_ratio = {k: abs(card[0][k] - cpu[0][k]) / max(
        BF16_LOSS_REL * abs(cpu[0][k]), abs(cpu[0][k] - cpu32[0][k]))
        for k in cpu[0]}
    ratio = {**ratios(card[1], cpu[1], cpu32[1]),
             **ratios(card[2], cpu[2], cpu32[2])}
    noise = {"cpu": spread(cpu[1], cpu32[1]),
             "card": spread(card[1], card32[1])}
    noise_ratio = noise["card"]["median"] / noise["cpu"]["median"]
    finite = all(torch.isfinite(v).all().item()
                 for part in (card[1], card[2]) for v in part.values())
    out = {"phase": "trained_bf16_step_card_vs_cpu", "model": cfg.net_type,
           "hw": list(image.shape[1:3]), "batch": 1, "lr": rate,
           "losses": {"card": card[0], "cpu": cpu[0],
                      "cpu_float32": cpu32[0]},
           "loss_ratio": max(loss_ratio.values()),
           "worst_ratio": max(ratio.values()), "tensors": len(ratio),
           "past_one_distance": sorted(k for k, r in ratio.items()
                                       if r > 1.0),
           "past_two_distances": sorted(k for k, r in ratio.items()
                                        if r > 2.0),
           "finite": finite, "bf16_vs_float32_traces": noise,
           "noise_ratio": noise_ratio,
           "card_vs_cpu_float32_traces": spread(card32[1], cpu32[1]),
           "seconds": {"card": card[3], "cpu": cpu[3],
                       "cpu_float32": cpu32[3]}}
    emit(out)
    if (out["loss_ratio"] > 1.0 or not finite
            or not 1 / BF16_NOISE_FACTOR <= noise_ratio <= BF16_NOISE_FACTOR):
        raise AssertionError(f"bf16 step, card against CPU: {out}")
    return out


def trained_projects(workdir) -> tuple[dict, tuple]:
    """The fit project's twin (the same seed, video and labels), copied
    once for each training run of TRAINED_RUNS with its backbone, the
    recipe's scale jitter, TRAINED_POS_DIST and a constant rate
    TRAINED_LR; and (the labeled frames, their labels in px)."""
    import shutil

    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.utils.synthetic import make_synthetic_project

    base, frames, coords = make_synthetic_project(
        Path(workdir) / "trained_base", n_frames=FIT_FRAMES,
        n_labeled=FIT_LABELED, hw=HW, nj=NUM_JOINTS, seed=SEED)
    roots = {}
    for net_type, dtype in TRAINED_RUNS:
        root = Path(workdir) / f"trained_{net_type}_{dtype}"
        shutil.copytree(base, root)
        _, cfg, train_dir = resolve_project(root)
        cfg.net_type, cfg.max_to_keep = net_type, FIT_KEEP
        cfg.scale_jitter_lo, cfg.scale_jitter_up = TRAINED_JITTER
        cfg.pos_dist_thresh = TRAINED_POS_DIST
        cfg.multi_step = [[TRAINED_LR[net_type], TRAINED_ITERS[net_type]]]
        cfg.to_yaml(train_dir / "pose_cfg.yaml")
        roots[net_type, dtype] = root
    return roots, (frames, coords)


def pose_of(root: Path, snapshot: Path, device, path: str,
            **kw) -> tuple[dict, dict]:
    """``estimate_pose`` of the project's 120-frame video from ``snapshot``
    (no files written), counted from 0: (the trajectories, a line with
    its wall seconds and launches). An int8 run's first batch is checked
    conv by conv, the checks' own launches taken out of its count."""
    from deepgraphpose_tpu_torch.infer.predict import estimate_pose

    checks: list = []
    with checked_first_int8_batch(path, checks), \
            contextlib.redirect_stdout(sys.stderr):
        pose, seconds, launches = counted(
            estimate_pose, root / "config.yaml", snapshot,
            root / "videos_dgp" / "synthvid.avi", root / "videos_pred",
            save_pose=False, device=device, **kw)
    for c in checks:
        launches[c["route"]] -= 1
    line = {"path": path, "seconds": seconds, "launches": launches}
    if checks:
        line["checked"] = check_summary(checks)
    return pose, line


def trained_paths(root: Path, final: Path, untrained: Path, device, labels,
                  name: str) -> tuple[dict, dict]:
    """A float32-trained model's paths over the video: float32 (TF32 off,
    deterministic cuDNN) from the trained and the untrained snapshot,
    bfloat16, int8 and (the ResNets) residual int8 against the float32
    trajectories; the labeled frames' RMSE of both float32 runs and of
    the trained model on batch statistics (``batch_stat_rmse``). Fails
    unless every trajectory is finite, the trained RMSE is below the
    untrained one, the decode launched on every path and the GEMM kernels
    on the int8 paths only."""
    import numpy as np

    from deepgraphpose_tpu_torch.models.quant import supports_residual_int8

    frames, coords = labels
    with deterministic():
        f32, f32_line = pose_of(root, final, device, f"{name} float32",
                                compute_dtype="float32")
        init, init_line = pose_of(root, untrained, device,
                                  f"{name} untrained float32",
                                  compute_dtype="float32")
    runs = {"float32": f32_line, "untrained": init_line}
    errors = {}
    poses = {"float32": f32, "untrained": init}
    paths = [("bfloat16", dict(compute_dtype="bfloat16")),
             ("int8", dict(quantize=True))]
    if supports_residual_int8(name):
        paths.append(("int8_residual", dict(quantize="residual")))
    for path, kw in paths:
        poses[path], runs[path] = pose_of(root, final, device,
                                          f"{name} {path}", **kw)
        errors[path] = px_error(poses[path], f32)
    rmse = {"trained": label_rmse(f32, frames, coords),
            "untrained": label_rmse(init, frames, coords),
            "trained_batch_stats": batch_stat_rmse(root, final, device,
                                                   labels)}
    out = {"phase": "trained_paths", "model": name,
           "frames": int(f32["x"].shape[0]), "rmse_labeled_px": rmse,
           "px_vs_float32": errors, "paths": runs}
    if not supports_residual_int8(name):
        out["int8_residual"] = ("not run: the residual int8 carry is a "
                                "ResNet mode (models/quant.py)")
    emit(out)
    gemm = ("mm_tiled", "conv_int8")
    launches_ok = all(
        line["launches"]["softargmax_likelihood"] > 0
        and all((line["launches"][k] > 0) == path.startswith("int8")
                for k in gemm)
        for path, line in runs.items())
    finite = all(np.isfinite(p[k]).all() for p in poses.values()
                 for k in ("x", "y", "likelihoods"))
    if not (finite and launches_ok
            and rmse["trained"]["all"] < rmse["untrained"]["all"]
            and f32["x"].shape == (FIT_FRAMES, NUM_JOINTS)):
        raise AssertionError(f"trained paths of {name}: {out}")
    return out, f32


def trained_round_trips(final: Path) -> dict:
    """The trained ResNet-50 snapshot on this host: ``export_tf_arrays``
    then ``import_tf_arrays`` (exact), and the Orbax snapshot written and
    read back (exact) where tensorstore imports, else ``orbax_not_run``
    with the reason."""
    import torch

    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models import tf_import
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel

    model = PoseModel(PoseConfig(net_type="resnet_50",
                                 num_joints=NUM_JOINTS))
    checkpoint.load_snapshot(final, model)
    state = model.state_dict()
    arrays = tf_import.export_tf_arrays(state, "resnet_50")
    back, report = tf_import.import_tf_arrays(
        {k: torch.zeros_like(v) for k, v in state.items()}, arrays,
        "resnet_50")
    tf_exact = not report["missing"] and all(
        torch.equal(back[k], v) for k, v in state.items())
    out = {"phase": "trained_round_trips", "tf_arrays": len(arrays),
           "tf_exact": tf_exact}
    try:
        import tensorstore  # noqa: F401
    except ImportError as e:
        emit({"phase": "orbax_not_run", "reason": f"ImportError: {e}"})
        out["orbax_exact"] = None
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_") as d:
            path = checkpoint.save_snapshot_orbax(d, 0, "final--0", model)
            twin = PoseModel(PoseConfig(net_type="resnet_50",
                                        num_joints=NUM_JOINTS))
            checkpoint.load_snapshot_orbax(path, twin)
            out["orbax_exact"] = all(
                torch.equal(a, b) for a, b in zip(
                    state.values(), twin.state_dict().values()))
    emit(out)
    if not tf_exact or out["orbax_exact"] is False:
        raise AssertionError(f"trained snapshot round trips: {out}")
    return out


def phase_trained(device, workdir) -> dict:
    """Item 12b: ResNet-50 in float32 and in bfloat16 and mobilenet_v2_1.0
    in float32 trained by ``fit_dlc`` on the fit project's twin from the
    seeded init (trainable batch-norm), on the labeled pool with the
    reference augmentation on the card (``trained_projects``' recipe),
    TRAINED_ITERS updates as CUDA-graph supersteps of SCAN_K; then each
    float32-trained model's paths (``trained_paths``), the bf16-trained
    ResNet-50 against the float32-trained one (both evaluated in float32,
    TF32 off), the bf16-trained one's labeled-frame RMSE on its moving and
    on batch statistics (in float32, and in bfloat16 as it trained), one
    bf16 update from it on the card against the
    CPU (``bf16_step_card_vs_cpu``), and the round trips of the trained
    ResNet-50 snapshot. Returns every path's launches by name."""
    from deepgraphpose_tpu_torch.core import checkpoint
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.train import fit

    roots, labels = trained_projects(workdir)
    finals, lines, f32 = {}, {}, None
    for (net_type, dtype), root in roots.items():
        name = f"trained_{net_type}_{dtype}"
        _, cfg, train_dir = resolve_project(root)
        if dtype == "float32":
            model = fit._init_model(cfg, 0, None, "cpu")
            untrained = checkpoint.save_snapshot(
                Path(workdir) / f"untrained_{net_type}", 0, "final--0",
                model)
        with deterministic(allow_tf32=True):
            run = fit_run(name, fit.fit_dlc, dict(
                dlcpath=root, maxiters=TRAINED_ITERS[net_type],
                displayiters=TRAINED_DISPLAY,
                saveiters=TRAINED_ITERS[net_type] // 2, scan_iters=SCAN_K,
                aug=True, compute_dtype=dtype, device=device), 1, 0)
        finals[net_type, dtype] = train_dir / run["final"]
        lines[name] = run["launches"]
        if dtype == "float32":
            out, pose = trained_paths(root, finals[net_type, dtype],
                                      untrained, device, labels, net_type)
            lines.update({f"{name} {p}": r["launches"]
                          for p, r in out["paths"].items()})
            if net_type == "resnet_50":
                f32 = pose
    with deterministic():
        bf16, line = pose_of(roots["resnet_50", "float32"],
                             finals["resnet_50", "bfloat16"], device,
                             "resnet_50 bf16-trained",
                             compute_dtype="float32")
    lines["trained_resnet_50_bfloat16 float32"] = line["launches"]
    bf16_root = roots["resnet_50", "bfloat16"]
    rmse = {"float32_trained": label_rmse(f32, *labels),
            "bfloat16_trained": label_rmse(bf16, *labels),
            "bfloat16_trained_batch_stats": batch_stat_rmse(
                bf16_root, finals["resnet_50", "bfloat16"], device, labels),
            "bfloat16_trained_batch_stats_in_bfloat16": batch_stat_rmse(
                bf16_root, finals["resnet_50", "bfloat16"], device, labels,
                "bfloat16")}
    emit({"phase": "trained_bf16_vs_f32", "model": "resnet_50",
          "evaluated_in": "float32", "rmse_labeled_px": rmse,
          "joint2_px": {k: v["by_joint"][2] for k, v in rmse.items()},
          "px": px_error(bf16, f32), "launches": line["launches"]})
    bf16_step_card_vs_cpu(bf16_root, finals["resnet_50", "bfloat16"],
                          device, labels)
    trained_round_trips(finals["resnet_50", "float32"])
    return lines


def kernel_class(name: str) -> str:
    """Sort a device kernel's name into decode, int8_gemm (the port's int8
    GEMM, matched before the library GEMMs), convolution, h2d (copies from
    the host), elementwise, copy (on the device: copies, pads, concats) or
    other."""
    for label, pattern in (
            ("decode", r"softargmax_likelihood"),
            ("h2d", r"Memcpy HtoD"),
            ("int8_gemm", r"gemm_kernel<|gemm_kernelI"),
            ("convolution",
             r"(?i)conv|cudnn|xmma|implicit|gemm|wgrad|dgrad|fprop|sm90"),
            ("copy", r"(?i)copy|memcpy|memset|cat|pad"),
            ("elementwise", r"(?i)elementwise|vectorized|reduce|pool|max")):
        if re.search(pattern, name):
            return label
    return "other"


# profiler ranges whose kernels form a class of their own
SPAN_CLASSES = {"flow_magnitude_device": "flow",
                "depthwise_conv": "depthwise"}


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


def profile_path(name: str, step, batches: int, updates: int = 1) -> dict:
    """Trace ``batches`` calls of ``step`` with torch.profiler: wall ms per
    batch (per update, where a call runs ``updates`` of them), the
    device's busy share of that wall time (union of kernel intervals),
    device ms by kernel class, kernels and host launch calls (kernel and
    graph launches, copies and fills) a batch. Kernels that run inside a
    range of SPAN_CLASSES form that range's class (the device flow, the
    depthwise convs)."""
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

    # device kernels and copies; a user annotation (the optimizer's step
    # range, the flow's range) is a span on the device's timeline, not work
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    spans = [(e.time_range.start, e.time_range.end, SPAN_CLASSES[e.name])
             for e in events if e.device_type == DeviceType.CUDA
             and getattr(e, "is_user_annotation", False)
             and e.name in SPAN_CLASSES]
    launch_calls = [e for e in events if e.device_type == DeviceType.CPU
                    and re.match(r"cu(da)?(LaunchKernel|GraphLaunch|Memcpy"
                                 r"|Memset|LaunchCooperative)", e.name)]
    n = batches * updates
    by_class: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        label = next((c for a, b, c in spans
                      if a <= e.time_range.start < b), kernel_class(e.name))
        by_class[label] = by_class.get(label, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "phase": "profile", "path": name, "batches": batches,
        "updates_per_batch": updates,
        "wall_ms_per_batch": wall_us / batches / 1e3,
        "wall_ms_per_update": wall_us / n / 1e3,
        "device_busy_share": busy / wall_us,
        "kernels_per_update": len(kernels) / n,
        "host_launch_calls_per_update": len(launch_calls) / n,
        "device_ms_per_update": {k: v / n / 1e3 for k, v in
                                 sorted(by_class.items(),
                                        key=lambda kv: -kv[1])},
        "top_kernels_ms_per_update": [[k[:90], v / n / 1e3]
                                      for k, v in top],
    }


def phase_profile(cfg, device, model, qmodel, train_step2, fit_steps: dict,
                  mobile: tuple, batches: int = 3) -> None:
    """Where the device time goes: full-frame batches and tracked-crop
    steps (the crop step alone, at a fixed center) of the bf16 model,
    full-frame batches of the int8 model, and DGP step-2 train steps:
    host-fed (``train_step2``: the step and its inputs), and the fit
    phase's ``fit_steps`` (from the frame pool with the reference
    augmentation on the card, eagerly and as the superstep's graph
    replays; with the flow made on the card); and ``mobile`` (its config
    and bf16 model): MOBILE_NET's full-frame batches, its depthwise convs
    a class of their own."""
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
    train, inputs = train_step2
    mobile_full = make_infer_fn(mobile[1], mobile[0])
    paths = [("full_frame", lambda: full(frames), 1),
             ("mobilenet_full_frame", lambda: mobile_full(frames), 1),
             ("tracked_crop", lambda: crop(frames, center), 1),
             ("int8_full_frame", lambda: full_int8(frames), 1),
             ("train_step2", lambda: train(*inputs()), 1)]
    for name, (step, step_inputs, updates) in fit_steps.items():
        paths.append((name, lambda s=step, i=step_inputs: s(*i()), updates))
    for name, step, updates in paths:
        emit(profile_path(name, step, batches, updates))


def main() -> int:
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4])
    if sys.argv[1:2] == ["--nccl-probe"]:
        return nccl_probe(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--serve-worker"]:
        return serve_worker(*sys.argv[2:5])
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
    native_status_line()

    cfg = PoseConfig(net_type="resnet_50", num_joints=NUM_JOINTS,
                     compute_dtype="bfloat16", infer_batch_size=BATCH)
    generator = torch.Generator().manual_seed(SEED)
    kern = phase_kernel(cfg, device)
    model_f32, images4, mu_f32, pred_f32 = phase_f32(cfg, device, generator)
    model, full_launches, mu_bf16 = phase_full_frame(
        cfg, device, model_f32, images4, mu_f32, pred_f32)
    crop_launches = phase_tracked_crop(cfg, device, model)
    bn_tail = phase_bn_tail(device)
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
    torch.cuda.empty_cache()
    mobile = phase_mobilenet(device)
    int8_paths["mobilenet_int8_full_frame"] = mobile["int8_path"]
    checks += mobile["calls"]
    phase_train_parity(device)
    train_lines, train_step2 = phase_train(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as workdir:
        fit_lines, (pose, final), fit_steps = phase_fit(device, workdir)
        analysis = phase_analysis(device, Path(workdir) / "fit_project",
                                  pose, final)
        parallel = phase_parallel(device, workdir, final)
        serving, served = phase_serving(device, workdir, final)
        headonly = phase_headonly(device, workdir, fit_lines)
        render = phase_render(device, workdir, final, served)
        workflow = phase_workflow(device, workdir)
        native_runs = phase_native_decode(device, workdir)
        trained = phase_trained(device, workdir)
        phase_profile(cfg, device, model, qmodel, train_step2, fit_steps,
                      (mobile["cfg"], mobile["model"]))

    by_path = {"full_frame": full_launches, "tracked_crop": crop_launches,
               "mobilenet_full_frame": mobile["full_launches"]}
    by_path.update({name: path["launches"]
                    for name, path in int8_paths.items()})
    by_path.update({line["phase"]: line["launches"] for line in train_lines})
    by_path.update({line["run"]: line["launches"] for line in fit_lines})
    by_path.update(analysis)
    by_path.update(parallel)
    by_path.update(serving)
    by_path.update(headonly)
    by_path.update(render)
    by_path.update({f"workflow {name}": counts
                    for name, counts in workflow.items()})
    by_path.update({line["run"]: line["launches"] for line in native_runs})
    by_path.update(trained)
    decode_by_path = {name: counts[DECODE] for name, counts in by_path.items()}
    bn_by_path = {name: counts[BN_TAIL] for name, counts in by_path.items()}
    bn_main = bn_tail["sites"][0]           # block1 unit1's projection tail
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
        "mobilenet_conv_sites_per_batch":
            mobile["conv"]["per_batch"]["mm_tiled"],
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
        "mobilenet_per_batch": mobile["conv"]["per_batch"]["conv_int8"],
    }, {
        "name": BN_TAIL, "route": "cuda",
        "source": "deepgraphpose_tpu_torch/csrc/bn_act.cu",
        "replaces": None,   # XLA fused the frozen-BN tail into the conv
        "launches": sum(bn_by_path.values()),
        "launches_by_path": bn_by_path,
        "per_batch": {"resnet_50": full_launches[BN_TAIL] * BATCH // FRAMES,
                      MOBILE_NET: mobile["full_launches"][BN_TAIL] * BATCH
                      // FRAMES},
        "max_abs_err": max(r["max_abs_err"] for r in bn_tail["sites"]),
        "bitwise": all(r["bitwise"] for r in bn_tail["sites"]),
        "site": bn_main["site"], "shape": bn_main["shape"],
        **{k: bn_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "sites": [{k: r[k] for k in ("site", "shape", "dtype", "ms",
                                     "plain_ms", "bound_ms", "gb_per_s")}
                  for r in bn_tail["sites"]],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
