"""Ahead-of-time export of the inference function for serving.

The port's counterpart of ``deepgraphpose_tpu/infer/serving.py``, which
freezes a trained model into a serialized StableHLO artifact. Here the
artifact is a ``torch.export`` program saved with ``torch.export.save``:
the weights are inside it, and a server runs it without this package's
model code on the hot path. Its graph calls the decode as the custom op
``dgp_torch::softargmax_likelihood`` and, for the int8 model, every conv
as ``dgp_torch::mm_tiled`` or ``dgp_torch::conv_int8``
(``ops/kernels/``), so the loaded program launches the hand-written
kernels on the card.

The contract is the JAX package's: uint8 images (B, H, W, 3) -> (mu_rc
(B, nj, 2) scoremap (row, col), likelihood (B, nj)), batch and frame size
static, and a ``<artifact>.json`` sidecar with the decode metadata a
server needs. An artifact runs on the one platform it was exported on
(``"cuda"`` or ``"cpu"``, the model's device): the program binds its
weights, and the tensors its graph makes (the int8 walk's quantization
divisors), to the device it was traced on.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.infer.predict import inference_cudnn
from deepgraphpose_tpu_torch.models.quant import QuantizedPoseModel
# importing the kernel wrappers registers the ops the programs call
from deepgraphpose_tpu_torch.ops.kernels import int8_gemm_kernel  # noqa: F401
from deepgraphpose_tpu_torch.ops.kernels import softargmax_kernel

_META_SUFFIX = ".json"


class ServedPose(nn.Module):
    """What the artifact computes: uint8 images -> the model's part_pred
    head -> the decode op, as ``infer/predict.py::infer_forward``."""

    def __init__(self, model: nn.Module, cfg: PoseConfig):
        super().__init__()
        self.model = model
        self.gamma = float(cfg.gamma)
        self.gauss_len = float(cfg.gauss_len)

    def forward(self, images_u8: torch.Tensor):
        pred = self.model(images_u8, heads=("part_pred",))["part_pred"]
        return softargmax_kernel.OP(pred, self.gamma, self.gauss_len, 1.0)


def export_infer_artifact(model: nn.Module, cfg: PoseConfig,
                          in_hw: tuple[int, int], batch_size: int,
                          out_path: str | Path,
                          platforms: tuple | None = None) -> Path:
    """Export ``model`` (a ``PoseModel`` or ``QuantizedPoseModel``, which
    holds its weights) at (batch_size, *in_hw, 3) to ``out_path``, with
    the sidecar ``<out_path>.json``.

    ``platforms`` defaults to the model's device type; any other value
    raises ``ValueError``, since the program runs only where it was
    exported (move the model there and export again).
    """
    device = model.mean_pixel.device
    if platforms is None:
        platforms = (device.type,)
    if tuple(platforms) != (device.type,):
        raise ValueError(
            f"export_infer_artifact(platforms={tuple(platforms)!r}): a "
            f"torch.export program runs only on the device it was exported "
            f"on, here {device.type!r} (the model's); its weights and the "
            "tensors its graph makes are bound to that device. Export once "
            "per platform, with the model moved there")
    out_path = Path(out_path)
    example = torch.zeros((batch_size, *in_hw, 3), dtype=torch.uint8,
                          device=device)
    with torch.no_grad():
        program = torch.export.export(ServedPose(model.eval(), cfg),
                                      (example,), strict=False)
    program.example_inputs = None   # else saved: a batch of frames
    torch.export.save(program, out_path)
    meta = dict(
        input_shape=[batch_size, *in_hw, 3],
        num_joints=cfg.num_joints,
        all_joints_names=list(cfg.all_joints_names),
        stride=float(cfg.stride),
        net_type=cfg.net_type,
        outputs=["mu_rc (B, nj, 2) scoremap (row, col); pixels = "
                 "coord * stride + stride/2", "likelihood (B, nj)"],
        platforms=list(platforms),
        quantized_int8=isinstance(model, QuantizedPoseModel),
        residual_int8=bool(getattr(model, "residual_int8", False)),
    )
    Path(str(out_path) + _META_SUFFIX).write_text(json.dumps(meta, indent=1))
    return out_path


def export_from_snapshot(config_path: str | Path, snapshot: str | Path,
                         out_path: str | Path, batch_size: int = 16,
                         in_hw: tuple[int, int] | None = None,
                         shuffle: int = 1, platforms: tuple | None = None,
                         quantize: bool | str = False, compute_dtype=None,
                         device=None) -> Path:
    """Export a trained snapshot of a DLC project (either package's
    msgpack snapshot, or a TF1 one) on ``device`` (default: the card).

    ``in_hw`` defaults to the first project video's frame size. A missing
    snapshot raises ``FileNotFoundError``: the export never falls back to
    the init weights. ``compute_dtype`` (default float32, as the JAX
    package exports) is the float model's. ``quantize=True`` exports the
    int8 model (``models/quant.py``, calibrated on the first project
    video's frames resized to ``in_hw``), whose convs run on the GEMM
    kernel; ``quantize="residual"`` also carries the residual stream in
    int8, and the sidecar records it as ``residual_int8``.
    """
    from deepgraphpose_tpu_torch.core.device import (resolve_device,
                                                     resolve_dtype)
    from deepgraphpose_tpu_torch.models.pose_model import init_model
    from deepgraphpose_tpu_torch.train.fit import (_warm_start,
                                                   dgp_video_sets,
                                                   resolve_project)

    device = resolve_device(device)
    proj_dir = Path(config_path).parent
    proj, cfg, train_dir = resolve_project(proj_dir, shuffle)
    vids = dgp_video_sets(proj, proj_dir)
    if in_hw is None:
        from deepgraphpose_tpu_torch.data.video import VideoReader

        reader = VideoReader(vids[0])
        in_hw = (reader.height, reader.width)
        reader.close()
    # the int8 model quantizes float32 weights, as the JAX package does
    dtype = (torch.float32 if quantize or compute_dtype is None
             else resolve_dtype(compute_dtype))
    model = init_model(cfg, dtype=dtype, device=device)
    snap_name = Path(snapshot).name
    if snap_name.endswith(".ckpt"):
        snap_name = snap_name[: -len(".ckpt")]
    model, warmed = _warm_start(model, cfg, Path(train_dir), snap_name,
                                allow_init_weights=False)
    if not warmed:
        raise FileNotFoundError(f"snapshot {snapshot} not found under "
                                f"{train_dir}")
    if quantize:
        from deepgraphpose_tpu_torch.models.quant import (
            calib_frames_from_video, quantize_model)

        calib = calib_frames_from_video(vids[0], resize_to=tuple(in_hw))
        model = quantize_model(cfg, model, calib,
                               residual_int8=(quantize == "residual"))
    return export_infer_artifact(model, cfg, tuple(in_hw), batch_size,
                                 out_path, platforms)


def load_infer_artifact(path: str | Path):
    """Load an exported artifact -> (callable, metadata dict).

    The callable maps uint8 images (B, H, W, 3), a tensor or an array, to
    (mu_rc, likelihood) on the artifact's device, under the cuDNN flags of
    ``infer_forward`` (no TF32). Importing this module registered the ops
    the program calls, so a process needs nothing else of the package.
    """
    path = Path(path)
    program = torch.export.load(path)
    meta = {}
    meta_path = Path(str(path) + _META_SUFFIX)
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    state = [*program.state_dict.values(), *program.constants.values()]
    device = next(t.device for t in state if isinstance(t, torch.Tensor))
    module = program.module()

    def call(images_u8):
        images = torch.as_tensor(images_u8, dtype=torch.uint8).to(device)
        with torch.no_grad(), inference_cudnn():
            return module(images)

    return call, meta
