"""Typed configuration layer (PyTorch port's own copy).

Two-tier config mirroring the reference's DLC project layout
(ref: deeplabcut/pose_estimation_tensorflow/default_config.py:16-59 and
deeplabcut/utils/auxiliaryfunctions.py:139-157):

* :class:`ProjectConfig` — the project-level ``config.yaml``.
* :class:`PoseConfig` — the model-level ``pose_cfg.yaml`` merged over
  defaults, extended with DGP hyperparameters (ws/wt/wn_*/gamma/...)
  (ref: src/deepgraphpose/models/fitdgp.py:637-654).

The field set and defaults equal ``deepgraphpose_tpu.core.config`` so a
pose_cfg.yaml written by either package reads back unchanged in the other.
``yaml`` is imported inside the file readers and writers: a host that only
runs inference from a config built in code needs no PyYAML.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

# ImageNet mean pixel, RGB order (ref: default_config.py:23).
MEAN_PIXEL = (123.68, 116.779, 103.939)


@dataclass
class PoseConfig:
    """Model configuration (pose_cfg.yaml semantics + DGP extensions)."""

    # --- network ---
    net_type: str = "resnet_50"
    num_joints: int = 0
    all_joints: list = field(default_factory=list)
    all_joints_names: list = field(default_factory=list)
    stride: float = 8.0
    output_stride: int = 16
    deconvolutionstride: int = 2
    mean_pixel: tuple = MEAN_PIXEL
    intermediate_supervision: bool = False
    intermediate_supervision_layer: int = 12
    location_refinement: bool = True
    locref_stdev: float = 7.2801
    locref_loss_weight: float = 0.05
    locref_huber_loss: bool = True
    weight_decay: float = 1e-4

    # --- data / targets ---
    dataset: str = ""
    metadataset: str = ""
    dataset_type: str = "default"
    deterministic: bool = False
    pos_dist_thresh: int = 17
    global_scale: float = 1.0
    scale_jitter_lo: float = 0.75
    scale_jitter_up: float = 1.25
    mirror: bool = False
    crop: bool = False
    cropratio: float = 0.25
    minsize: int = 100
    leftwidth: int = 400
    rightwidth: int = 400
    topheight: int = 400
    bottomheight: int = 400
    max_input_size: int = 1500
    min_input_size: int = 64

    # --- optimization ---
    optimizer: str = "sgd"
    batch_size: int = 1
    multi_step: list = field(
        default_factory=lambda: [[0.005, 10000], [0.02, 430000],
                                 [0.002, 730000], [0.001, 1030000]])
    display_iters: int = 1000
    save_iters: int = 50000
    max_to_keep: int = 5
    init_weights: str = ""
    snapshot_prefix: str = "snapshot"
    project_path: str = ""

    # --- DGP hyperparameters (ref fitdgp.py:343-359 step 1, 637-654 step 2) ---
    ws: float = 1000.0          # spatial clique weight
    ws_max: float = 1.2         # multiplier for limb-length upper bound
    wt: float = 0.0             # temporal clique weight
    wt_max: float = 0.0         # upper bound for temporal displacement
    wn_visible: float = 5.0     # network clique weight, visible frames
    wn_hidden: float = 3.0      # network clique weight, hidden frames
    gamma: float = 1.0          # softmax temperature for soft-argmax
    gauss_len: float = 1.0      # gaussian smoothing sigma in soft-argmax
    lengthscale: float = 1.0    # gaussian target map lengthscale
    gm2: int = 0                # confidence scaling mode for hidden CE input
    gm3: int = 0                # confidence weighting mode for hidden CE
    lr: float = 0.005
    n_times_all_frames: int = 100
    aug: bool = True

    # --- accelerator knobs ---
    compute_dtype: str = "float32"   # "bfloat16" for tensor-core convs
    infer_batch_size: int = 16       # frames per device step in streaming inference
    # Kept so pose_cfg.yaml round-trips between the two packages. The port
    # ignores it: on a CUDA tensor the hand-written decode kernel
    # (ops/kernels/softargmax_kernel.py) is always the decode.
    use_pallas_softargmax: bool = False

    # anything in the YAML we do not model explicitly
    extra: dict = field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str | Path, **overrides: Any) -> "PoseConfig":
        """Load a pose_cfg.yaml, merging over defaults (ref: config.py:39-55)."""
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        raw.update(overrides)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "PoseConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in raw.items() if k in names and k != "extra"}
        extra = {k: v for k, v in raw.items() if k not in names}
        cfg = cls(**known, extra=extra)
        if cfg.num_joints and not cfg.all_joints:
            cfg.all_joints = [[i] for i in range(cfg.num_joints)]
        return cfg

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        d.update(extra)
        d["mean_pixel"] = list(self.mean_pixel)
        return d

    def to_yaml(self, path: str | Path) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, default_flow_style=False)

    def replace(self, **kw: Any) -> "PoseConfig":
        return dataclasses.replace(self, **kw)

    @property
    def locref_scale(self) -> float:
        # ref: pose_dataset.py locref_scale = 1.0 / locref_stdev
        return 1.0 / self.locref_stdev


@dataclass
class ProjectConfig:
    """Project configuration (config.yaml semantics).

    ref: data/Reaching-Mackenzie-2018-08-30/config.yaml and
    deeplabcut/utils/auxiliaryfunctions.py:139-157 (read_config).
    """

    Task: str = ""
    scorer: str = ""
    date: str = ""
    project_path: str = ""
    bodyparts: list = field(default_factory=list)
    skeleton: list = field(default_factory=list)
    video_sets: dict = field(default_factory=dict)
    TrainingFraction: list = field(default_factory=lambda: [0.95])
    iteration: int = 0
    snapshotindex: int = -1
    pcutoff: float = 0.4
    cropping: bool = False
    start: float = 0.0
    stop: float = 1.0
    numframes2pick: int = 20
    batch_size: int = 4
    default_net_type: str = "resnet_50"
    dotsize: int = 12
    alphavalue: float = 0.7
    colormap: str = "jet"
    skeleton_color: str = "black"
    move2corner: bool = False
    corner2move2: list = field(default_factory=lambda: [50, 50])
    x1: int = 0
    x2: int = 640
    y1: int = 277
    y2: int = 624
    resnet: Any = None
    extra: dict = field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str | Path) -> "ProjectConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in raw.items() if k in names and k != "extra"}
        extra = {k: v for k, v in raw.items() if k not in names}
        cfg = cls(**known, extra=extra)
        if cfg.skeleton is None:
            cfg.skeleton = []
        return cfg

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        d.update(extra)
        return d

    def to_yaml(self, path: str | Path) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, default_flow_style=False,
                           sort_keys=False)

    def skeleton_incidence(self) -> "np.ndarray":
        """Limb incidence matrix S0 (n_limbs x n_joints), +1/-1 per edge.

        ref: src/deepgraphpose/models/fitdgp.py:607-617.
        """
        import numpy as np

        skeleton = self.skeleton or []
        S0 = np.zeros((len(skeleton), len(self.bodyparts)), dtype=np.float32)
        for s, (a, b) in enumerate(skeleton):
            S0[s, self.bodyparts.index(a)] = 1.0
            S0[s, self.bodyparts.index(b)] = -1.0
        return S0


def read_config(path: str | Path) -> ProjectConfig:
    return ProjectConfig.from_yaml(path)


def load_pose_config(path: str | Path, **overrides: Any) -> PoseConfig:
    return PoseConfig.from_yaml(path, **overrides)
