"""Label-file hygiene utilities.

The port's own copy of ``deepgraphpose_tpu/project/hygiene.py``: host code
(numpy, OpenCV), no model and no device.

ref: deeplabcut/generate_training_dataset/trainingsetmanipulation.py:36-219
(comparevideolistsanddatafolders, dropduplicatesinannotatinfiles,
dropannotationfileentriesduetodeletedimages, dropimagesduetolackofannotation)
— housekeeping between labeling rounds so create_training_dataset sees a
consistent project.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core.config import ProjectConfig
from deepgraphpose_tpu_torch.data import project as project_io


def compare_video_lists_and_data_folders(config: str | Path) -> dict:
    """Report videos without labeled-data folders and vice versa
    (ref: trainingsetmanipulation.py:36-65)."""
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    root = Path(proj.project_path or config.parent)
    video_stems = {Path(v).stem for v in proj.video_sets}
    folder_stems = {p.name for p in (root / "labeled-data").glob("*")
                    if p.is_dir() and not p.name.endswith("_labeled")}
    report = {
        "videos_without_folders": sorted(video_stems - folder_stems),
        "folders_without_videos": sorted(folder_stems - video_stems),
    }
    for v in report["videos_without_folders"]:
        print(f"video {v} has no labeled-data folder")
    for f in report["folders_without_videos"]:
        print(f"labeled-data/{f} has no video in config.yaml video_sets")
    return report


def _each_labels(root: Path, scorer: str):
    for vdir in sorted((root / "labeled-data").glob("*")):
        if not vdir.is_dir() or vdir.name.endswith("_labeled"):
            continue
        try:
            yield vdir, project_io.read_labels(vdir, scorer)
        except FileNotFoundError:
            continue


def _rewrite_kept_rows(vdir: Path, scorer: str, labels, keep: list,
                       why: str) -> int:
    """Rewrite CollectedData with only ``keep`` rows; returns rows removed.

    The reference rewrites both the .csv and .h5 (trainingsetmanipulation
    keeps them in sync); both are rewritten here too
    (data/project.py::write_collected_data).
    """
    dropped = len(labels.image_paths) - len(keep)
    if dropped == 0:
        return 0
    project_io.write_collected_data(
        vdir / f"CollectedData_{scorer}.csv",
        project_io.Labels(
            scorer=scorer, bodyparts=list(labels.bodyparts),
            image_paths=[labels.image_paths[i] for i in keep],
            coords_xy=np.asarray(labels.coords_xy)[keep]))
    print(f"{vdir.name}: dropped {dropped} {why}")
    return dropped


def drop_duplicates_in_annotation_files(config: str | Path) -> int:
    """Remove duplicate image rows, keeping the first
    (ref: trainingsetmanipulation.py:124-152). Returns rows removed."""
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    root = Path(proj.project_path or config.parent)
    removed = 0
    for vdir, labels in _each_labels(root, proj.scorer):
        seen: set = set()
        keep = []
        for i, p in enumerate(labels.image_paths):
            if str(p) not in seen:
                seen.add(str(p))
                keep.append(i)
        removed += _rewrite_kept_rows(vdir, proj.scorer, labels, keep,
                                      "duplicate rows")
    return removed


def drop_annotations_for_deleted_images(config: str | Path) -> int:
    """Remove label rows whose image file no longer exists
    (ref: trainingsetmanipulation.py:154-183). Returns rows removed."""
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    root = Path(proj.project_path or config.parent)
    removed = 0
    for vdir, labels in _each_labels(root, proj.scorer):
        keep = [i for i, p in enumerate(labels.image_paths)
                if (root / p).exists()]
        removed += _rewrite_kept_rows(vdir, proj.scorer, labels, keep,
                                      "rows with missing images")
    return removed


def drop_unannotated_images(config: str | Path,
                            delete: bool = False) -> list[Path]:
    """Find (optionally delete) extracted PNGs with no label row
    (ref: trainingsetmanipulation.py:185-219)."""
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    root = Path(proj.project_path or config.parent)
    orphans: list[Path] = []
    for vdir, labels in _each_labels(root, proj.scorer):
        labeled = {Path(p).name for p in labels.image_paths}
        for png in sorted(vdir.glob("img*.png")):
            if png.name not in labeled:
                orphans.append(png)
                if delete:
                    png.unlink()
    action = "deleted" if delete else "found"
    print(f"{action} {len(orphans)} unannotated images")
    return orphans
