"""DLC project scaffolding: create projects, extract frames, build
training datasets.

The port's own copy of ``deepgraphpose_tpu/project/__init__.py``: host code
(numpy, OpenCV), no model and no device.

Capability parity with the vendored DeepLabCut project tooling
(ref: deeplabcut/create_project/new.py, generate_training_dataset/
frame_extraction.py, trainingsetmanipulation.py) using this package's own
IO primitives — same on-disk filestructure contract, no wx GUI.
"""

from deepgraphpose_tpu_torch.project import (crop_select,  # noqa: F401
                                             multi_individual)
from deepgraphpose_tpu_torch.project.new import (add_new_videos,
                                                 create_new_project)
from deepgraphpose_tpu_torch.project.extract import extract_frames
from deepgraphpose_tpu_torch.project.hygiene import (
    compare_video_lists_and_data_folders,
    drop_annotations_for_deleted_images, drop_duplicates_in_annotation_files,
    drop_unannotated_images)
from deepgraphpose_tpu_torch.project.training_dataset import (
    create_training_dataset, merge_annotated_datasets, split_trials)

__all__ = [
    "create_new_project", "add_new_videos", "extract_frames",
    "create_training_dataset", "merge_annotated_datasets", "split_trials",
    "compare_video_lists_and_data_folders",
    "drop_duplicates_in_annotation_files",
    "drop_annotations_for_deleted_images", "drop_unannotated_images",
    "crop_select", "multi_individual",
]
