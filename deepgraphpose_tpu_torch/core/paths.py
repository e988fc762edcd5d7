"""DLC project filestructure layout (the north-star compatibility contract).

ref: deeplabcut/utils/auxiliaryfunctions.py:304-328 (GetModelFolder,
GetTrainingSetFolder) and demo/run_dgp_demo.py:269-283.
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


def train_dir(project_path: str | Path, cfg: ProjectConfig,
              shuffle: int = 1, trainingsetindex: int = 0) -> Path:
    frac = cfg.TrainingFraction[trainingsetindex]
    return Path(project_path) / model_folder(frac, shuffle, cfg) / "train"


def snapshot_name(step: int, iteration: int | str, debug: str = "") -> str:
    """Snapshot naming contract: snapshot-step{N}-{it} (ref: fitdgp.py:237-245)."""
    return f"snapshot-step{step}{debug}-{iteration}"


def final_snapshot_name(step: int, debug: str = "") -> str:
    return f"snapshot-step{step}{debug}-final--0"


def videos_pred_dir(project_path: str | Path) -> Path:
    return Path(project_path) / "videos_pred"


def resolve_project(dlcpath: str | Path, shuffle: int = 1,
                    trainingsetindex: int = 0):
    """(proj_cfg, pose_cfg, train_dir) from a DLC project directory."""
    dlcpath = Path(dlcpath)
    proj = ProjectConfig.from_yaml(dlcpath / "config.yaml")
    proj.project_path = str(dlcpath)
    tdir = train_dir(dlcpath, proj, shuffle, trainingsetindex)
    pose_cfg = PoseConfig.from_yaml(tdir / "pose_cfg.yaml")
    pose_cfg.project_path = str(dlcpath)
    return proj, pose_cfg, tdir
