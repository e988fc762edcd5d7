"""Annotation/pose-file conversion helpers.

The port's own copy of ``deepgraphpose_tpu/project/conversion.py``: host
code (numpy, OpenCV), no model and no device.

Parity with the reference's project-migration surface
(ref: DeepLabCut/deeplabcut/utils/conversioncode.py, exported at the
package top level, DeepLabCut/deeplabcut/__init__.py:57):

* :func:`convertcsv2h5` — rebuild the CollectedData ``.h5`` from a
  (possibly hand-edited) ``.csv``, optionally renaming the scorer.
* :func:`convertannotationdata_fromwindows2unixstyle` — rewrite
  ``labeled-data\\video\\imgNNN.png`` Windows paths to unix form.
* :func:`analyze_videos_converth5_to_csv` — export pose ``.h5`` tables
  next to videos as ``.csv`` without re-analyzing.
* :func:`merge_windowsannotationdataONlinuxsystem` — collect annotations
  by scanning labeled-data/ when video_sets keys don't resolve.

All IO goes through the h5py-based readers/writers (data/project.py,
infer/export.py) — no pandas/pytables dependency; ``userfeedback``
defaults to False (no interactive prompt on a headless host), pass
True for the reference's per-folder confirmation behavior.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core.config import ProjectConfig
from deepgraphpose_tpu_torch.data import project as project_io


def _labeled_data_folders(config: str | Path) -> tuple[ProjectConfig, list]:
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    root = Path(proj.project_path or config.parent)
    names = [Path(v).stem for v in proj.video_sets]
    return proj, [root / "labeled-data" / n for n in names]


def _ask(folder: Path, what: str, userfeedback: bool) -> bool:
    if not userfeedback:
        return True
    print(f"Do you want to convert the {what} in folder: {folder} ?")
    return input("yes/no").lower() in ("y", "yes", "ja", "ha")


def convertcsv2h5(config: str | Path, userfeedback: bool = False,
                  scorer: str | None = None) -> int:
    """Rebuild CollectedData ``.h5`` files from their ``.csv`` siblings
    (ref: conversioncode.py:49-110) — e.g. after hand-editing the csv.
    ``scorer`` overrides the annotator name in both rewritten files.
    Returns the number of folders converted."""
    proj, folders = _labeled_data_folders(config)
    new_scorer = scorer or proj.scorer
    done = 0
    for folder in folders:
        csv_path = folder / f"CollectedData_{proj.scorer}.csv"
        if not csv_path.exists():
            print(f"Attention: {folder} does not appear to have labeled "
                  "data!")
            continue
        if not _ask(folder, "csv file", userfeedback):
            continue
        labels = project_io.read_collected_data_csv(csv_path)
        labels.scorer = new_scorer
        project_io.write_collected_data_csv(csv_path, labels)
        project_io.write_collected_data_h5(
            folder / f"CollectedData_{proj.scorer}.h5", labels)
        done += 1
    return done


def pathmagic(string: str) -> str:
    """labeled-data\\video\\imgNNN.png -> labeled-data/video/imgNNN.png
    (ref: conversioncode.py:158-165)."""
    parts = string.split("\\")
    if len(parts) == 3:
        return os.path.join(*parts)
    return string


def convertannotationdata_fromwindows2unixstyle(
        config: str | Path, userfeedback: bool = False) -> int:
    """Convert Windows-style image paths in annotation files to unix form
    (ref: conversioncode.py:17-47, 167-184). The original files are kept
    as ``CollectedData_<scorer>windows.{csv,h5}``. Returns folders
    converted."""
    proj, folders = _labeled_data_folders(config)
    done = 0
    for folder in folders:
        base = folder / f"CollectedData_{proj.scorer}"
        if not (base.with_suffix(".csv").exists()
                or base.with_suffix(".h5").exists()):
            continue
        if not _ask(folder, "annotationdata", userfeedback):
            continue
        labels = project_io.read_labels(folder, proj.scorer)
        # back up the original pair under the 'windows' suffix
        project_io.write_collected_data(
            folder / f"CollectedData_{proj.scorer}windows.csv", labels)
        labels.image_paths = [pathmagic(p) for p in labels.image_paths]
        project_io.write_collected_data(base.with_suffix(".csv"), labels)
        done += 1
    return done


def analyze_videos_converth5_to_csv(videopath: str | Path,
                                    videotype: str = ".avi") -> int:
    """Export every pose ``.h5`` table belonging to a video in
    ``videopath`` as ``.csv`` (ref: conversioncode.py:112-156) — for runs
    of analyze_videos without save_as_csv. Returns files converted."""
    from deepgraphpose_tpu_torch.infer.export import read_pose_table

    videopath = Path(videopath)
    videos = [p for p in videopath.iterdir()
              if p.suffix == videotype and "_labeled" not in p.name]
    h5s = [p for p in videopath.iterdir() if p.suffix == ".h5"]
    done = 0
    for video in videos:
        vname = video.stem
        for pfn in h5s:
            if not pfn.stem.startswith(vname) or pfn.stem == vname:
                continue
            try:
                scorer, bodyparts, labels, index = read_pose_table(pfn)
            except Exception:
                continue  # not a pose table (e.g. a CollectedData file)
            print(f"Found output file for scorer: {scorer}; "
                  "converting to csv...")
            x, y, lik = labels["x"], labels["y"], labels["likelihoods"]
            nj = x.shape[1]
            with open(pfn.with_suffix(".csv"), "w", newline="") as f:
                f.write("scorer," + ",".join([scorer] * 3 * nj) + "\n")
                f.write("bodyparts," + ",".join(
                    [bp for bp in bodyparts for _ in range(3)]) + "\n")
                f.write("coords," + ",".join(["x", "y", "likelihood"] * nj)
                        + "\n")
                for i in range(x.shape[0]):
                    row = np.empty(3 * nj)
                    row[0::3], row[1::3], row[2::3] = x[i], y[i], lik[i]
                    f.write(f"{index[i]}," + ",".join(
                        repr(float(v)) for v in row) + "\n")
            done += 1
    print("All pose files were converted.")
    return done


def merge_windowsannotationdataONlinuxsystem(cfg: dict | ProjectConfig):
    """Collect annotations by scanning labeled-data/ directly when the
    video_sets keys don't resolve (project created on Windows, run on
    unix; ref: conversioncode.py:188-208). Returns one merged Labels."""
    if isinstance(cfg, dict):
        project_path = cfg["project_path"]
        scorer = cfg["scorer"]
    else:
        project_path, scorer = cfg.project_path, cfg.scorer
    data_path = Path(project_path) / "labeled-data"
    merged = None
    for folder in sorted(data_path.iterdir()):
        if not folder.is_dir() or folder.name.endswith("_labeled"):
            continue
        try:
            labels = project_io.read_labels(folder, scorer)
        except FileNotFoundError:
            print(f"{folder / f'CollectedData_{scorer}.h5'} not found "
                  "(perhaps not annotated)")
            continue
        if merged is None:
            merged = labels
        else:
            merged.image_paths = list(merged.image_paths) + list(
                labels.image_paths)
            merged.coords_xy = np.concatenate(
                [merged.coords_xy, labels.coords_xy])
    return merged
