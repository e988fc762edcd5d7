"""Label refinement: fold machine predictions back into the training set.

The port's own copy of ``deepgraphpose_tpu/project/refine.py``: host code
(numpy, OpenCV), no model and no device.

ref: deeplabcut/refine_training_dataset — the reference's refine_labels is
a wx GUI where a human accepts/moves machine labels from
``machinelabels-iter<N>.h5``; the accepted points end up in the video's
``CollectedData_<scorer>`` files, and ``merge_datasets`` bumps the project
iteration so create_training_dataset picks them up. This module provides
the headless equivalents:

* :func:`accept_machine_labels` — merge machine predictions (above a
  likelihood cutoff; below it -> NaN, i.e. 'needs a human') into
  CollectedData, skipping frames a human already labeled.
* :func:`merge_datasets` — bump ``iteration`` in config.yaml after
  refinement (ref: trainingsetmanipulation/merge semantics).
* :func:`mergeandsplit` — frozen train/test split indices, uniform or
  leave-one-video-out (ref: trainingsetmanipulation.py:443-519).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.core.config import ProjectConfig
from deepgraphpose_tpu_torch.data import project as project_io


def accept_machine_labels(config: str | Path, video_name: str,
                          likelihood_cutoff: float = 0.9,
                          iteration: int | None = None) -> int:
    """Merge machinelabels-iter<N> into CollectedData_<scorer> for a video.

    Returns the number of frames added. Existing human-labeled frames are
    never overwritten.
    """
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    root = Path(proj.project_path or config.parent)
    vdir = root / "labeled-data" / video_name
    it = proj.iteration if iteration is None else iteration
    mfile = vdir / f"machinelabels-iter{it}.h5"
    if not mfile.exists():
        raise FileNotFoundError(mfile)

    from deepgraphpose_tpu_torch.infer.export import read_pose_table

    _, bps, labels, index = read_pose_table(mfile)
    nj = len(proj.bodyparts)
    coords = np.stack([labels["x"], labels["y"]], axis=-1)  # (n, nj, 2)
    coords = coords[:, :nj]
    lik = labels["likelihoods"][:, :nj]
    coords[lik < likelihood_cutoff] = np.nan

    try:
        existing = project_io.read_labels(vdir, proj.scorer)
        known = {str(p) for p in existing.image_paths}
        image_paths = list(existing.image_paths)
        all_coords = list(np.asarray(existing.coords_xy))
    except FileNotFoundError:
        known, image_paths, all_coords = set(), [], []

    added = 0
    for p, c in zip(index, coords):
        if str(p) in known:
            continue
        image_paths.append(str(p))
        all_coords.append(c)
        added += 1
    if added == 0:
        return 0

    order = np.argsort(image_paths)
    merged = project_io.Labels(
        scorer=proj.scorer, bodyparts=list(proj.bodyparts),
        image_paths=[image_paths[i] for i in order],
        coords_xy=np.stack([all_coords[i] for i in order]))
    # .csv + .h5 twin, like the reference's refinement SaveData
    # (ref: gui/refinement.py)
    project_io.write_collected_data(
        vdir / f"CollectedData_{proj.scorer}.csv", merged)
    print(f"accepted {added} machine-labeled frames into {vdir}")
    return added


def merge_datasets(config: str | Path) -> int:
    """Advance the active-learning iteration after refinement
    (ref: deeplabcut.merge_datasets bumps cfg['iteration'])."""
    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    proj.iteration = int(proj.iteration) + 1
    proj.to_yaml(config)
    print(f"iteration -> {proj.iteration}; re-run create_training_dataset")
    return proj.iteration


def mergeandsplit(config: str | Path, trainindex: int = 0,
                  uniform: bool = True, seed: int = 0
                  ) -> tuple[list, list]:
    """Frozen train/test indices over the merged labels.

    uniform=True: random split at TrainingFraction[trainindex].
    uniform=False: leave-one-video-out — the video at ``trainindex`` in
    video_sets becomes the test set (ref: trainingsetmanipulation.py:480-519).
    """
    from deepgraphpose_tpu_torch.project.training_dataset import (
        merge_annotated_datasets, split_trials)

    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    root = Path(proj.project_path or config.parent)
    image_paths, _ = merge_annotated_datasets(proj, root)
    n = len(image_paths)
    if uniform:
        frac = proj.TrainingFraction[trainindex]
        tr, te = split_trials(n, frac, seed=seed)
        return tr.tolist(), te.tolist()
    videos = list(proj.video_sets)
    held = Path(videos[trainindex]).stem
    te = [i for i, p in enumerate(image_paths)
          if Path(p).parent.name == held]
    tr = [i for i in range(n) if i not in set(te)]
    return tr, te
