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
over the ranks (``parallel/``). The DLC project workflow runs on it
alone: the project tooling (``project/``: ``create_new_project``,
``extract_frames``, the browser ``LabelServer``,
``create_training_dataset``, hygiene, refinement, conversions),
``threed/`` (stereo calibration, triangulation), DeepLabCut's spellings
(``compat.py``) and the command line, ``python -m
deepgraphpose_tpu_torch.cli``, whose ``--device`` picks the card or the
CPU. The module
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
    # the DLC project workflow (project/, threed/)
    "create_new_project": ("deepgraphpose_tpu_torch.project",
                           "create_new_project"),
    "add_new_videos": ("deepgraphpose_tpu_torch.project", "add_new_videos"),
    "extract_frames": ("deepgraphpose_tpu_torch.project", "extract_frames"),
    "create_training_dataset": ("deepgraphpose_tpu_torch.project",
                                "create_training_dataset"),
    "merge_datasets": ("deepgraphpose_tpu_torch.project.refine",
                       "merge_datasets"),
    "mergeandsplit": ("deepgraphpose_tpu_torch.project.refine",
                      "mergeandsplit"),
    "LabelServer": ("deepgraphpose_tpu_torch.project.label_server",
                    "LabelServer"),
    "compare_video_lists_and_data_folders": (
        "deepgraphpose_tpu_torch.project",
        "compare_video_lists_and_data_folders"),
    "drop_duplicates_in_annotation_files": (
        "deepgraphpose_tpu_torch.project",
        "drop_duplicates_in_annotation_files"),
    "drop_annotations_for_deleted_images": (
        "deepgraphpose_tpu_torch.project",
        "drop_annotations_for_deleted_images"),
    "drop_unannotated_images": ("deepgraphpose_tpu_torch.project",
                                "drop_unannotated_images"),
    "convertcsv2h5": ("deepgraphpose_tpu_torch.project.conversion",
                      "convertcsv2h5"),
    "convertannotationdata_fromwindows2unixstyle": (
        "deepgraphpose_tpu_torch.project.conversion",
        "convertannotationdata_fromwindows2unixstyle"),
    "analyze_videos_converth5_to_csv": (
        "deepgraphpose_tpu_torch.project.conversion",
        "analyze_videos_converth5_to_csv"),
    "merge_windowsannotationdataONlinuxsystem": (
        "deepgraphpose_tpu_torch.project.conversion",
        "merge_windowsannotationdataONlinuxsystem"),
    # the modules whose ``show`` opens the browser UI, under the DLC names
    "select_crop_parameters": ("deepgraphpose_tpu_torch.project",
                               "crop_select"),
    "multiple_individual_labeling_toolbox": (
        "deepgraphpose_tpu_torch.project", "multi_individual"),
    "create_new_project_3d": ("deepgraphpose_tpu_torch.threed",
                              "create_new_project_3d"),
    "calibrate_cameras": ("deepgraphpose_tpu_torch.threed",
                          "calibrate_cameras"),
    "triangulate": ("deepgraphpose_tpu_torch.threed", "triangulate"),
    "create_labeled_video_3d": ("deepgraphpose_tpu_torch.threed.plotting3d",
                                "create_labeled_video_3d"),
}

# DeepLabCut's spellings (compat.py), so that
# ``import deepgraphpose_tpu_torch as deeplabcut`` runs DLC project scripts
for _name in ("label_frames", "refine_labels", "launch_dlc",
              "train_network",
              "return_train_network_path", "return_evaluate_network_data",
              "load_demo_data", "create_pretrained_human_project",
              "create_training_model_comparison",
              "adddatasetstovideolistandviceversa", "check_undistortion",
              "comparevideolistsanddatafolders",
              "dropannotationfileentriesduetodeletedimages",
              "dropimagesduetolackofannotation",
              "dropduplicatesinannotatinfiles",
              "ShortenVideo", "DownSampleVideo", "create_labeled_video"):
    _LAZY_API[_name] = ("deepgraphpose_tpu_torch.compat", _name)
del _name


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
