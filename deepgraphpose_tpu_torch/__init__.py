"""deepgraphpose_tpu_torch — the PyTorch/CUDA port of deepgraphpose_tpu.

Runs DeepGraphPose full-video pose inference on an NVIDIA H100: a
ResNet-v1 or MobileNetV2 trunk with deconvolutional heads in PyTorch
(cuDNN convs in ``channels_last``), or its int8 form (``models/quant.py``)
whose dense convs run on a tensor-core GEMM written for Hopper
(``csrc/int8_gemm.cu``), and the
soft-argmax + likelihood decode as a CUDA kernel (``csrc/softargmax.cu``).
It also trains: the DGP chain's entry points ``fit_dlc``,
``fit_dgp_labeledonly`` and ``fit_dgp`` (``train/fit.py``) feed their
steps (``train/steps.py``) from frame pools on the card with on-card
augmentation (``train/device_data.py``) or from batches assembled on the
host (``data/batcher.py``), decode the objective's maps on the same
kernel, and write snapshots in the JAX package's format; in float32 or in
bfloat16 mixed precision (float32 weights). After training, what users
run: ``analyze_videos`` (DLC-scorer CSV/H5, the DLC top-k decode for
``num_outputs > 1``), ``evaluate_network`` / ``evaluate_dgp`` (px error
against the labels), ``filterpredictions``, ``extract_outlier_frames`` and
``analyzeskeleton``; the labeled video (``plot_dgp``), trajectory
plots, scoremap grids and labeled evaluation images; head-only training
(``fit_dlc_heads``); and the serving artifact (``infer/serving.py``: a
``torch.export`` program whose graph calls both kernels as custom ops).
Training spreads over the ranks of a
``torch.distributed`` process group (``data_parallel``) and batches
several windows an update (``windows_per_device``), and
``parallel.streaming.estimate_pose_multichip`` splits a video's time axis
over the ranks (``parallel/``). The module
layout and public names follow ``deepgraphpose_tpu``, which stays the
reference; this package imports nothing of it, nor JAX. Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from deepgraphpose_tpu_torch.core.config import PoseConfig, ProjectConfig  # noqa: F401

_LAZY_API = {
    "estimate_pose": ("deepgraphpose_tpu_torch.infer.predict",
                      "estimate_pose"),
    "estimate_pose_dynamic": ("deepgraphpose_tpu_torch.infer.dynamic",
                              "estimate_pose_dynamic"),
    "fit_dlc": ("deepgraphpose_tpu_torch.train.fit", "fit_dlc"),
    "fit_dgp_labeledonly": ("deepgraphpose_tpu_torch.train.fit",
                            "fit_dgp_labeledonly"),
    "fit_dgp": ("deepgraphpose_tpu_torch.train.fit", "fit_dgp"),
    "fit_dlc_heads": ("deepgraphpose_tpu_torch.train.headonly",
                      "fit_dlc_heads"),
    "plot_dgp": ("deepgraphpose_tpu_torch.infer.video_writer", "plot_dgp"),
    "evaluate_dgp": ("deepgraphpose_tpu_torch.evaluation.metrics",
                     "evaluate_dgp"),
    "analyze_videos": ("deepgraphpose_tpu_torch.infer.analyze",
                       "analyze_videos"),
    "analyze_time_lapse_frames": ("deepgraphpose_tpu_torch.infer.analyze",
                                  "analyze_time_lapse_frames"),
    "evaluate_network": ("deepgraphpose_tpu_torch.evaluation.metrics",
                         "evaluate_network"),
    "filterpredictions": ("deepgraphpose_tpu_torch.evaluation.filtering",
                          "filterpredictions"),
    "extract_outlier_frames": ("deepgraphpose_tpu_torch.evaluation.outliers",
                               "extract_outlier_frames"),
    "analyzeskeleton": ("deepgraphpose_tpu_torch.evaluation.skeleton",
                        "analyzeskeleton"),
    "plot_trajectories": ("deepgraphpose_tpu_torch.infer.plotting",
                          "plot_trajectories"),
    "check_labels": ("deepgraphpose_tpu_torch.infer.plotting",
                     "check_labels"),
    "extract_save_all_maps": ("deepgraphpose_tpu_torch.evaluation.maps",
                              "extract_save_all_maps"),
    "display_dataset": ("deepgraphpose_tpu_torch.evaluation.maps",
                        "display_dataset"),
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
