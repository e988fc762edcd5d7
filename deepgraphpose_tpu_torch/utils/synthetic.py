"""A tiny self-contained synthetic DLC project.

The port's own copy of ``deepgraphpose_tpu/utils/synthetic.py``, written
by the port's own config, label and video code: for one set of arguments
it writes the same project files. ``chip_smoke.py`` and the demo's
``--test`` train on it.
"""

from __future__ import annotations

import os

import numpy as np


def make_synthetic_project(root, n_frames=40, n_labeled=6, hw=(64, 80),
                           nj=3, fps=20.0, seed=0):
    """Build a tiny self-contained DLC project: config.yaml, a synthetic
    video with a moving bright dot per joint, labels CSV, pose_cfg.yaml.

    Returns (project_path, label_frame_indices, coords_xy).
    """
    import cv2
    import yaml

    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.data.project import (Labels,
                                                      write_collected_data_csv)

    rng_ = np.random.default_rng(seed)
    root = os.path.abspath(str(root))
    h, w = hw
    bodyparts = [f"bp{i}" for i in range(nj)]
    video_name = "synthvid"
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    os.makedirs(os.path.join(root, "videos_dgp"), exist_ok=True)
    os.makedirs(os.path.join(root, "labeled-data", video_name), exist_ok=True)

    # joint trajectories: smooth sinusoids, distinct per joint
    t = np.arange(n_frames)
    cx = (w / 2 + (w / 3) * np.sin(2 * np.pi * t[:, None] / 25
                                   + np.arange(nj) * 2)).astype(np.float64)
    cy = (h / 2 + (h / 3) * np.cos(2 * np.pi * t[:, None] / 31
                                   + np.arange(nj))).astype(np.float64)

    video_path = os.path.join(root, "videos", f"{video_name}.avi")
    four = cv2.VideoWriter_fourcc(*"MJPG")
    wr = cv2.VideoWriter(video_path, four, fps, (w, h))
    colors = [(255, 60, 60), (60, 255, 60), (60, 60, 255)]
    for f in range(n_frames):
        frame = rng_.integers(0, 40, (h, w, 3), dtype=np.uint8)
        for j in range(nj):
            cv2.circle(frame, (int(cx[f, j]), int(cy[f, j])), 4,
                       colors[j % 3], -1)
        wr.write(frame)
    wr.release()
    # a copy in videos_dgp for the DGP step
    import shutil
    shutil.copy(video_path, os.path.join(root, "videos_dgp",
                                         f"{video_name}.avi"))

    lab_idx = np.linspace(2, n_frames - 3, n_labeled).astype(int)
    coords = np.stack([cx[lab_idx], cy[lab_idx]], axis=-1)  # (nl, nj, 2)
    image_paths = [f"labeled-data/{video_name}/img{int(i):03d}.png"
                   for i in lab_idx]
    labels = Labels(scorer="synth", bodyparts=bodyparts,
                    image_paths=image_paths, coords_xy=coords)
    write_collected_data_csv(
        os.path.join(root, "labeled-data", video_name,
                     "CollectedData_synth.csv"), labels)
    # also dump the labeled PNG frames (evaluate/extract paths use them)
    from deepgraphpose_tpu_torch.data.video import VideoReader
    rd = VideoReader(video_path)
    for i in lab_idx:
        frame = rd.read_frame(int(i))
        cv2.imwrite(os.path.join(root, f"labeled-data/{video_name}/"
                                 f"img{int(i):03d}.png"), frame[..., ::-1])
    rd.close()

    proj = dict(
        Task="Synth", scorer="synth", date="Jan1",
        project_path=root, bodyparts=bodyparts,
        skeleton=[[bodyparts[0], bodyparts[1]]] if nj >= 2 else [],
        video_sets={f"videos/{video_name}.avi":
                    {"crop": f"0, {w}, 0, {h}"}},
        TrainingFraction=[0.95], iteration=0, snapshotindex=-1, pcutoff=0.4,
        cropping=False, start=0, stop=1, numframes2pick=n_labeled,
        batch_size=4, default_net_type="resnet_50", dotsize=6,
        alphavalue=0.7, colormap="jet", skeleton_color="blue",
        move2corner=False, corner2move2=[50, 50], x1=0, x2=w, y1=0, y2=h,
        resnet=None,
    )
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(proj, f, sort_keys=False)

    model_dir = os.path.join(
        root, "dlc-models/iteration-0/SynthJan1-trainset95shuffle1")
    for sub in ("train", "test"):
        os.makedirs(os.path.join(model_dir, sub), exist_ok=True)
    pose_cfg = PoseConfig(
        net_type="resnet_50", num_joints=nj,
        all_joints=[[i] for i in range(nj)], all_joints_names=bodyparts,
        dataset=("training-datasets/iteration-0/UnaugmentedDataSet_SynthJan1/"
                 "Synth_synth95shuffle1.mat"),
        metadataset=("training-datasets/iteration-0/UnaugmentedDataSet_SynthJan1/"
                     "Documentation_data-Synth_95shuffle1.pickle"),
        pos_dist_thresh=9, global_scale=0.8, project_path=root,
        init_weights="", location_refinement=True)
    pose_cfg.to_yaml(os.path.join(model_dir, "train", "pose_cfg.yaml"))
    pose_cfg.to_yaml(os.path.join(model_dir, "test", "pose_cfg.yaml"))
    return root, lab_idx, coords
