"""Training-set generation (ref: deeplabcut/generate_training_dataset/
trainingsetmanipulation.py:384-814).

The port's own copy of ``deepgraphpose_tpu/project/training_dataset.py``:
host code (numpy, OpenCV), no model and no device.

merge all CollectedData_<scorer> label files -> train/test split ->
MatlabData ``.mat`` + ``Documentation_data-*.pickle`` under
``training-datasets/iteration-i/UnaugmentedDataSet_<Task><date>/`` ->
train/test ``pose_cfg.yaml`` under
``dlc-models/iteration-i/<Task><date>-trainset<frac>shuffle<s>/``.

The .mat joints keep only labels strictly inside the image and are stored
as integers (ref: trainingsetmanipulation.py:646-672) so downstream
consumers (this package's MultiDataset and the original TF1 DGP alike) see
identical data.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core import paths as paths_lib
from deepgraphpose_tpu_torch.core.config import PoseConfig, ProjectConfig
from deepgraphpose_tpu_torch.data import project as project_io


def merge_annotated_datasets(proj: ProjectConfig, project_path: Path
                             ) -> tuple[list[str], np.ndarray]:
    """All labels across labeled-data/*: (image_paths, (n, nj, 2) xy).

    ref: trainingsetmanipulation.py:384-443 (merge_annotateddatasets); the
    merged CollectedData_<scorer>.{csv,h5} is also written next to the
    training set by the reference — we return the arrays and let
    create_training_dataset persist the .mat/pickle.
    """
    image_paths: list[str] = []
    coords: list[np.ndarray] = []
    nj = len(proj.bodyparts)
    for vdir in sorted((project_path / "labeled-data").glob("*")):
        if not vdir.is_dir():
            continue
        try:
            labels = project_io.read_labels(vdir, proj.scorer)
        except FileNotFoundError:
            continue
        for p, c in zip(labels.image_paths, labels.coords_xy):
            image_paths.append(str(p))
            c = np.asarray(c, np.float64)
            if c.shape[0] < nj:  # pad absent bodyparts
                c = np.vstack([c, np.full((nj - c.shape[0], 2), np.nan)])
            coords.append(c[:nj])
    if not image_paths:
        raise FileNotFoundError(
            f"no CollectedData_{proj.scorer} files under "
            f"{project_path / 'labeled-data'}")
    return image_paths, np.stack(coords)


def split_trials(n: int, train_fraction: float, seed: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Random train/test split (ref: trainingsetmanipulation.py:445-458
    SplitTrials — round(n * fraction) training items, shuffled)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(round(n * train_fraction))
    return np.sort(perm[:n_train]), np.sort(perm[n_train:])


def _default_init_weights(net_type: str) -> str:
    """Resolve a local ImageNet checkpoint for ``net_type``, the reference's
    Check4weights step when writing pose_cfg (ref:
    trainingsetmanipulation.py:741-747, auxfun_models.py:15-35). No egress:
    an absent checkpoint returns "" and training starts from scratch."""
    from deepgraphpose_tpu_torch.models.pretrained import find_pretrained

    found = find_pretrained(net_type)
    return str(found) if found is not None else ""


def create_training_dataset(config: str | Path, num_shuffles: int = 1,
                            Shuffles: list | None = None,
                            trainIndexes=None, testIndexes=None,
                            net_type: str | None = None,
                            seed: int | None = None) -> list[tuple]:
    """Build (shuffle x TrainingFraction) training sets; returns
    [(train_fraction, shuffle, n_train, n_test), ...]."""
    import cv2

    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    project_path = Path(proj.project_path or config.parent)
    net_type = net_type or proj.default_net_type or "resnet_50"

    image_paths, coords = merge_annotated_datasets(proj, project_path)
    n = len(image_paths)

    # per-image size + in-bounds integer joints (ref: 634-672)
    sizes, joints_all = [], []
    for p, c in zip(image_paths, coords):
        img = cv2.imread(str(project_path / p))
        if img is None:
            raise FileNotFoundError(f"labeled image missing: {p}")
        h, w = img.shape[:2]
        sizes.append([img.shape[2] if img.ndim == 3 else 1, h, w])
        rows = []
        for j, (x, y) in enumerate(c):
            if np.isfinite(x) and np.isfinite(y) and 0 <= x < w and 0 <= y < h:
                rows.append([j, x, y])
        joints_all.append(np.asarray(rows, dtype=np.int64).reshape(-1, 3))
    sizes = np.asarray(sizes, np.int64)

    ts_folder = paths_lib.training_set_folder(proj)
    (project_path / ts_folder).mkdir(parents=True, exist_ok=True)

    shuffles = (Shuffles if Shuffles is not None
                else list(range(1, num_shuffles + 1)))
    results = []
    for shuffle in shuffles:
        for frac in proj.TrainingFraction:
            if trainIndexes is None and testIndexes is None:
                tr, te = split_trials(n, frac,
                                      seed if seed is None
                                      else seed + shuffle)
            else:
                tr = np.asarray(trainIndexes)
                te = np.asarray(testIndexes)
            keep = [i for i in tr if joints_all[i].size > 0]

            datafn, metafn = paths_lib.data_and_metadata_filenames(
                ts_folder, frac, shuffle, proj)
            data = [{"image": image_paths[i], "size": sizes[i],
                     "joints": joints_all[i]} for i in keep]
            project_io.write_documentation_pickle(
                project_path / metafn, data, tr, te, frac)
            project_io.write_training_mat(
                project_path / datafn, [image_paths[i] for i in keep],
                [sizes[i] for i in keep], [joints_all[i] for i in keep])

            # model folder + train/test pose_cfg.yaml (ref: 694-814)
            mf = project_path / paths_lib.model_folder(frac, shuffle, proj)
            for sub in ("train", "test"):
                (mf / sub).mkdir(parents=True, exist_ok=True)
            pose_cfg = PoseConfig(
                net_type=net_type, num_joints=len(proj.bodyparts),
                all_joints=[[i] for i in range(len(proj.bodyparts))],
                all_joints_names=list(proj.bodyparts),
                dataset=datafn, metadataset=metafn,
                project_path=str(project_path),
                init_weights=proj.resnet or _default_init_weights(net_type))
            pose_cfg.to_yaml(mf / "train" / "pose_cfg.yaml")
            # test config: no dataset-dependent fields beyond scoring setup
            pose_cfg.replace(dataset=datafn).to_yaml(
                mf / "test" / "pose_cfg.yaml")
            results.append((frac, shuffle, len(tr), len(te)))
            print(f"training set: trainset{int(frac * 100)} shuffle{shuffle}"
                  f" ({len(tr)} train / {len(te)} test)")
    return results
