"""deepgraphpose_tpu_torch — the PyTorch/CUDA port of deepgraphpose_tpu.

Runs DeepGraphPose full-video pose inference on an NVIDIA H100: a
ResNet-v1 trunk with deconvolutional heads in PyTorch (cuDNN convs in
``channels_last``), or its int8 form (``models/quant.py``) whose convs run
on a tensor-core GEMM written for Hopper (``csrc/int8_gemm.cu``), and the
soft-argmax + likelihood decode as a CUDA kernel (``csrc/softargmax.cu``).
It also takes the DGP training steps 0, 1 and 2 on batches assembled on
the host (``data/batcher.py``, ``train/steps.py``), the objective's decode
on the same kernel. The module layout and public names follow
``deepgraphpose_tpu``, which stays the reference; this package imports
nothing of it, nor JAX. Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from deepgraphpose_tpu_torch.core.config import PoseConfig, ProjectConfig  # noqa: F401

_LAZY_API = {
    "estimate_pose": ("deepgraphpose_tpu_torch.infer.predict",
                      "estimate_pose"),
    "estimate_pose_dynamic": ("deepgraphpose_tpu_torch.infer.dynamic",
                              "estimate_pose_dynamic"),
}


def __getattr__(name):
    if name in _LAZY_API:
        import importlib

        module, attr = _LAZY_API[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'deepgraphpose_tpu_torch' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_API))
