"""Project creation (ref: deeplabcut/create_project/new.py:18-220).

The port's own copy of ``deepgraphpose_tpu/project/new.py``: host code
(numpy, OpenCV), no model and no device.

Creates the DLC directory skeleton + config.yaml:

    <project>-<experimenter>-<YYYY-MM-DD>/
        config.yaml
        videos/            (copies or symlinks of the input videos)
        labeled-data/<video-stem>/
        training-datasets/
        dlc-models/
        videos_dgp/        (DGP extension: unlabeled videos for step 2)

video_sets entries carry the full-frame crop string "0, w, 0, h" discovered
by decoding one frame per video (ref: new.py:112-135).
"""

from __future__ import annotations

import os
import shutil
from datetime import datetime
from pathlib import Path

from deepgraphpose_tpu_torch.core.config import ProjectConfig

VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".mpg")


def _video_dims(path: Path) -> tuple[int, int]:
    """(width, height) of the first readable frame."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    finally:
        cap.release()
    return w, h


def _expand_videos(videos: list, videotype: str) -> list[Path]:
    out = []
    for v in videos:
        p = Path(v)
        if p.is_dir():
            out.extend(sorted(q for q in p.iterdir()
                              if q.suffix.lower() == videotype.lower()))
        else:
            out.append(p)
    return out


def create_new_project(project: str, experimenter: str, videos: list,
                       working_directory: str | None = None,
                       copy_videos: bool = True, videotype: str = ".avi",
                       date: str | None = None) -> str:
    """Create the project skeleton; returns the config.yaml path.

    ``date`` may be given as YYYY-MM-DD (reference behavior: defaults to
    today; the config's ``date`` field uses the MonDD short form).
    """
    if date is None:
        dt = datetime.today()
    else:
        dt = datetime.strptime(date, "%Y-%m-%d")
    short_date = dt.strftime("%B")[:3] + str(dt.day)
    iso_date = dt.strftime("%Y-%m-%d")

    wd = Path(working_directory or ".").resolve()
    project_path = wd / f"{project}-{experimenter}-{iso_date}"
    if project_path.exists():
        print(f'Project "{project_path}" already exists!')
        return str(project_path / "config.yaml")

    for sub in ("videos", "labeled-data", "training-datasets", "dlc-models",
                "videos_dgp"):
        (project_path / sub).mkdir(parents=True)

    video_sets = {}
    for src in _expand_videos(videos, videotype):
        if not src.exists():
            print(f"warning: video {src} not found; skipping")
            continue
        dst = project_path / "videos" / src.name
        if copy_videos:
            shutil.copy2(src, dst)
        else:
            os.symlink(src.resolve(), dst)
        (project_path / "labeled-data" / src.stem).mkdir(exist_ok=True)
        w, h = _video_dims(dst)
        video_sets[str(Path("videos") / src.name)] = {
            "crop": f"0, {w}, 0, {h}"}
    if not video_sets:
        shutil.rmtree(project_path)
        raise FileNotFoundError("none of the given videos exist")

    proj = ProjectConfig(
        Task=project, scorer=experimenter, date=short_date,
        project_path=str(project_path),
        video_sets=video_sets,
        bodyparts=["bodypart1", "bodypart2", "bodypart3", "objectA"],
        skeleton=[["bodypart1", "bodypart2"], ["objectA", "bodypart3"]],
    )
    cfg_path = project_path / "config.yaml"
    proj.to_yaml(cfg_path)
    print(f'Generated "{cfg_path}"')
    return str(cfg_path)


def add_new_videos(config: str | Path, videos: list,
                   copy_videos: bool = True) -> None:
    """Append videos to an existing project (ref: create_project/add.py)."""
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    project_path = Path(proj.project_path or config.parent)
    for src in _expand_videos(videos, ".avi"):
        if not src.exists():
            print(f"warning: video {src} not found; skipping")
            continue
        dst = project_path / "videos" / src.name
        if copy_videos:
            shutil.copy2(src, dst)
        elif not dst.exists():
            os.symlink(src.resolve(), dst)
        (project_path / "labeled-data" / src.stem).mkdir(exist_ok=True)
        w, h = _video_dims(dst)
        proj.video_sets[str(Path("videos") / src.name)] = {
            "crop": f"0, {w}, 0, {h}"}
    proj.to_yaml(config)
