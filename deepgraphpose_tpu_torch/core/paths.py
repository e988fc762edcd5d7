"""DLC project filestructure layout (the north-star compatibility contract).

ref: deeplabcut/utils/auxiliaryfunctions.py:304-328 (GetModelFolder,
GetTrainingSetFolder, GetDataandMetaDataFilenames) and
demo/run_dgp_demo.py:269-283 (videos_dgp / videos_pred).
"""

from __future__ import annotations

from pathlib import Path

from deepgraphpose_tpu_torch.core.config import PoseConfig, ProjectConfig


def iteration_dir(cfg: ProjectConfig) -> str:
    return f"iteration-{cfg.iteration}"


def model_folder(train_fraction: float, shuffle: int, cfg: ProjectConfig) -> Path:
    """dlc-models/iteration-i/{Task}{date}-trainset{frac}shuffle{s}."""
    return Path("dlc-models") / iteration_dir(cfg) / (
        f"{cfg.Task}{cfg.date}-trainset{int(train_fraction * 100)}shuffle{shuffle}"
    )


def training_set_folder(cfg: ProjectConfig) -> Path:
    """training-datasets/iteration-i/UnaugmentedDataSet_{Task}{date}."""
    return Path("training-datasets") / iteration_dir(cfg) / (
        f"UnaugmentedDataSet_{cfg.Task}{cfg.date}"
    )


def data_and_metadata_filenames(
    trainingsetfolder: Path, train_fraction: float, shuffle: int,
    cfg: ProjectConfig,
) -> tuple[str, str]:
    """(.mat dataset, Documentation pickle) relative names.

    ref: auxiliaryfunctions.py:318-328.
    """
    stem = f"{cfg.Task}_{cfg.scorer}{int(100 * train_fraction)}shuffle{shuffle}"
    datafn = str(trainingsetfolder / f"{stem}.mat")
    metafn = str(
        trainingsetfolder
        / f"Documentation_data-{cfg.Task}_{int(100 * train_fraction)}shuffle{shuffle}.pickle"
    )
    return datafn, metafn


def train_dir(project_path: str | Path, cfg: ProjectConfig,
              shuffle: int = 1, trainingsetindex: int = 0) -> Path:
    frac = cfg.TrainingFraction[trainingsetindex]
    return Path(project_path) / model_folder(frac, shuffle, cfg) / "train"


def test_dir(project_path: str | Path, cfg: ProjectConfig,
             shuffle: int = 1, trainingsetindex: int = 0) -> Path:
    frac = cfg.TrainingFraction[trainingsetindex]
    return Path(project_path) / model_folder(frac, shuffle, cfg) / "test"


def snapshot_name(step: int, iteration: int | str, debug: str = "") -> str:
    """Snapshot naming contract: snapshot-step{N}-{it} (ref: fitdgp.py:237-245)."""
    return f"snapshot-step{step}{debug}-{iteration}"


def final_snapshot_name(step: int, debug: str = "") -> str:
    return f"snapshot-step{step}{debug}-final--0"


def labeled_data_dir(project_path: str | Path, video_name: str) -> Path:
    return Path(project_path) / "labeled-data" / video_name


def collected_data_file(project_path: str | Path, video_name: str,
                        scorer: str, ext: str = "csv") -> Path:
    return labeled_data_dir(project_path, video_name) / f"CollectedData_{scorer}.{ext}"


def videos_dgp_dir(project_path: str | Path) -> Path:
    return Path(project_path) / "videos_dgp"


def videos_pred_dir(project_path: str | Path) -> Path:
    return Path(project_path) / "videos_pred"


VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv")


def list_videos(directory: str | Path) -> list[str]:
    """All video files in a directory (ref: fitdgp.py:597-604)."""
    d = Path(directory)
    if not d.exists():
        return []
    return sorted(
        str(p) for p in d.iterdir()
        if p.is_file() and p.suffix.lower() in VIDEO_EXTS
    )


def resolve_project(dlcpath: str | Path, shuffle: int = 1,
                    trainingsetindex: int = 0):
    """(proj_cfg, pose_cfg, train_dir) from a DLC project directory."""
    from deepgraphpose_tpu_torch.utils.compile_cache import \
        ensure_compile_cache

    ensure_compile_cache()
    dlcpath = Path(dlcpath)
    proj = ProjectConfig.from_yaml(dlcpath / "config.yaml")
    proj.project_path = str(dlcpath)
    tdir = train_dir(dlcpath, proj, shuffle, trainingsetindex)
    pose_cfg = PoseConfig.from_yaml(tdir / "pose_cfg.yaml")
    pose_cfg.project_path = str(dlcpath)
    return proj, pose_cfg, tdir
