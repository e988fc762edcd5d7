"""DeepLabCut's top-level names (DeepLabCut `__init__.py:30-58`) on the port.

The port's own copy of ``deepgraphpose_tpu/compat.py``. Every name that
``import deeplabcut`` exports resolves here to this package's equivalent,
so project scripts written against DeepLabCut run with
``import deepgraphpose_tpu_torch as deeplabcut``. The work is done in the
real modules; this file holds DeepLabCut's spellings, argument orders, and
the few behaviors that exist only at the API boundary (``load_demo_data``'s
path rewrite, the video-list reconciliation). The entry points that run a
model take the port's ``device=`` (default: the card).
"""

from __future__ import annotations

import os
from pathlib import Path


# ---- labeling / refinement (ref: deeplabcut.label_frames, refine_labels —
# wx toolboxes; here the browser UI, project/label_server.py) -------------

def label_frames(config, video: str | None = None, port: int = 8574):
    """Launch the browser labeling UI (blocking, like the reference GUI)."""
    from deepgraphpose_tpu_torch.project.label_server import LabelServer

    LabelServer(Path(config).parent, video=video, port=port).serve_forever()


def refine_labels(config, video: str | None = None, port: int = 8574):
    """Refinement = the same UI; machine labels preload as draggable marks
    (ref: refine_training_dataset/refinement.py)."""
    return label_frames(config, video=video, port=port)


def launch_dlc(config: str | None = None, port: int = 8574):
    """The reference's GUI launcher (ref: gui/launch_script.py:42-45 — a wx
    notebook with Welcome + Manage Project tabs). Headless equivalents:
    with a project config, launch the browser labeling UI (this repo's
    GUI); without one, print the Welcome tab's function — the guided
    workflow with the matching API/CLI invocations."""
    if config:
        return label_frames(config, port=port)
    print("""deepgraphpose_tpu_torch — workflow (ref GUI: welcome.py)
(CLI: python -m deepgraphpose_tpu_torch.cli <command>; add --device cpu
to run the model on the CPU)

  1. create a project      create_new_project(name, you, [videos])
                           | create-project
  2. extract frames        extract_frames(config)  | extract-frames
  3. label                 label_frames(config)  (browser UI; multi-animal:
                           multiple_individual_labeling_toolbox.show)
  4. build training set    create_training_dataset(config)
                           | create-training-dataset
  5. train (3 DGP steps)   fit_dlc / fit_dgp_labeledonly / fit_dgp | train
  6. evaluate              evaluate_network(config) / evaluate_dgp(...)
                           | evaluate
  7. analyze videos        analyze_videos(config, [videos])
                           | analyze-videos
  8. refine / iterate      extract_outlier_frames -> refine_labels
                           -> merge_datasets

launch_dlc(config=<path/to/config.yaml>) opens the labeling UI directly.""",
          flush=True)
    return None


# ---- training (ref: pose_estimation_tensorflow/training.py) -------------

def return_train_network_path(config, shuffle: int = 1,
                              trainingsetindex: int = 0):
    """(train pose_cfg path, test pose_cfg path, snapshot folder)
    (ref: training.py:14-40)."""
    from deepgraphpose_tpu_torch.train.fit import resolve_project

    _, _, train_dir = resolve_project(Path(config).parent, shuffle,
                                      trainingsetindex)
    train_dir = Path(train_dir)
    return (train_dir / "pose_cfg.yaml",
            train_dir.parent / "test" / "pose_cfg.yaml",
            train_dir)


def train_network(config, shuffle: int = 1, trainingsetindex: int = 0,
                  max_snapshots_to_keep: int = 5, displayiters=None,
                  saveiters=None, maxiters=None, allow_growth: bool = False,
                  gputouse=None, autotune: bool = False,
                  keepdeconvweights: bool = True, **kwargs):
    """Supervised training with the reference's argument surface
    (ref: training.py:42-144). gputouse/allow_growth/autotune are TF-GPU
    knobs; they are accepted and ignored (pass ``device=`` instead);
    keepdeconvweights=False re-initializes the deconv heads on warm start
    (ref behavior when changing bodypart count) — here snapshots either
    match or the head simply re-initializes, so it is accepted and ignored.
    Extra kwargs (bn_train, aug, data_parallel, device, ...) pass to
    fit_dlc.
    """
    del (allow_growth, gputouse, autotune, keepdeconvweights,
         max_snapshots_to_keep)  # cfg.max_to_keep governs snapshot pruning
    from deepgraphpose_tpu_torch.train.fit import fit_dlc, resolve_project

    # None means "use the project's pose_cfg values" (ref: training.py
    # reads display_iters/save_iters/multi_step from the train config);
    # an explicit 0/value is passed through untouched.
    if displayiters is None or saveiters is None or maxiters is None:
        _, pose_cfg, _ = resolve_project(Path(config).parent, shuffle,
                                         trainingsetindex)
        if displayiters is None:
            displayiters = getattr(pose_cfg, "display_iters", None) or 1000
        if saveiters is None:
            saveiters = getattr(pose_cfg, "save_iters", None) or 50000
        if maxiters is None:
            ms = getattr(pose_cfg, "multi_step", None)
            maxiters = int(ms[-1][1]) if ms else 200000
    return fit_dlc(dlcpath=Path(config).parent, shuffle=shuffle,
                   trainingsetindex=trainingsetindex,
                   displayiters=max(int(displayiters), 1),
                   saveiters=max(int(saveiters), 1),
                   maxiters=int(maxiters), **kwargs)


def return_evaluate_network_data(config, shuffle: int = 1,
                                 trainingsetindex: int = 0,
                                 comparisonbodyparts="all",
                                 Snapindex=None, rescale: bool = False,
                                 fulldata: bool = False,
                                 show_errors: bool = True, device=None):
    """Evaluation summary rows like the reference's
    (ref: evaluate.py:41-180): one
    [trainingsiterations, trainfraction, shuffle, trainerror, testerror,
    pcutoff, trainerrorpcutoff, net_type, snapshot] row per snapshot;
    with fulldata=True each row also carries the full evaluate_dgp dict.
    ``comparisonbodyparts`` restricts the errors to a bodypart subset;
    ``rescale=True`` evaluates at pose_cfg ``global_scale`` (errors stay
    in original label pixels). ``device`` runs the model (default: the
    card).
    """
    from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
    from deepgraphpose_tpu_torch.core.config import ProjectConfig
    from deepgraphpose_tpu_torch.evaluation.metrics import evaluate_dgp
    from deepgraphpose_tpu_torch.train.fit import resolve_project

    config = Path(config)
    proj = ProjectConfig.from_yaml(config)
    _, pose_cfg, train_dir = resolve_project(config.parent, shuffle,
                                             trainingsetindex)
    snaps = sorted(Path(train_dir).glob(f"snapshot-*{ckpt_lib.CKPT_SUFFIX}"),
                   key=lambda p: (ckpt_lib._step_num(p),
                                  ckpt_lib._snapshot_iter(p)))
    if Snapindex is not None and Snapindex != "all":
        snaps = [snaps[int(Snapindex)]]

    def _iters_label(snap: Path) -> int:
        # 'snapshot-step{N}-{it}' -> it; 'snapshot-step{N}-final--0' carries
        # no iteration in its name (core/checkpoint naming contract), so
        # label it one past the step's highest numbered sibling — keeping
        # rows numeric and monotone within a step for reference scripts
        # that pick the max-iteration row.
        it = ckpt_lib._snapshot_iter(snap)
        if it < 10 ** 12 - 1:
            return it
        sibling = [ckpt_lib._snapshot_iter(p) for p in snaps
                   if ckpt_lib._step_num(p) == ckpt_lib._step_num(snap)
                   and ckpt_lib._snapshot_iter(p) < 10 ** 12 - 1]
        return (max(sibling) + 1) if sibling else 0

    rows = []
    scale = float(pose_cfg.global_scale) if rescale else 1.0
    for snap in snaps:
        res = evaluate_dgp(config, snap, shuffle=shuffle,
                           trainingsetindex=trainingsetindex,
                           scale=scale,
                           comparisonbodyparts=comparisonbodyparts,
                           device=device)
        row = [_iters_label(snap),
               proj.TrainingFraction[trainingsetindex], shuffle,
               res["train_error"], res["test_error"], proj.pcutoff,
               res["train_error_pcutoff"], pose_cfg.net_type, snap.stem]
        if fulldata:
            row.append(res)
        rows.append(row)
        if show_errors:
            print(f"{snap.stem}: train {res['train_error']:.2f} px, "
                  f"test {res['test_error']:.2f} px")
    return rows


# ---- project scaffolding (ref: create_project/) --------------------------

def load_demo_data(config, createtrainingset: bool = True):
    """Re-root a copied/demo project at its current location: rewrite
    project_path, video_sets paths, and the pose_cfg project paths to
    absolute local paths (ref: create_project/demo_data.py:16-76), then
    optionally build the training set."""
    import yaml

    config = Path(config).resolve()
    root = config.parent
    with open(config) as f:
        cfg = yaml.safe_load(f)
    cfg["project_path"] = str(root)
    video_sets = {}
    for v, meta in (cfg.get("video_sets") or {}).items():
        video_sets[str(root / "videos" / Path(v).name)] = meta
    cfg["video_sets"] = video_sets
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    # re-root any shipped model configs too (ref: demo_data.py rewrites the
    # train/test pose_cfg.yaml project paths alongside config.yaml)
    for pc in root.glob("dlc-models/**/pose_cfg.yaml"):
        raw = yaml.safe_load(pc.read_text())
        changed = False
        for key in ("project_path", "init_weights", "dataset",
                    "metadataset"):
            val = raw.get(key)
            if isinstance(val, str) and os.path.isabs(val) and \
                    not val.startswith(str(root)):
                tail = val.split(os.sep)
                # longest suffix that exists under the new root
                for i in range(len(tail)):
                    cand = root / os.sep.join(tail[i:])
                    if cand.exists():
                        raw[key] = str(cand)
                        changed = True
                        break
        if raw.get("project_path") != str(root):
            raw["project_path"] = str(root)
            changed = True
        if changed:
            pc.write_text(yaml.safe_dump(raw, sort_keys=False))
            print(f"re-rooted {pc.relative_to(root)}")
    print(f"re-rooted {config} at {root}")
    if createtrainingset:
        from deepgraphpose_tpu_torch.project import create_training_dataset

        print("Loaded, now creating training data...")
        create_training_dataset(config, num_shuffles=1)


# MPII human-pose bodyparts/skeleton the reference hard-codes
# (ref: create_project/human_dataset.py:88-90)
MPII_BODYPARTS = ["ankle1", "knee1", "hip1", "hip2", "knee2", "ankle2",
                  "wrist1", "elbow1", "shoulder1", "shoulder2", "elbow2",
                  "wrist2", "chin", "forehead"]
MPII_SKELETON = [["ankle1", "knee1"], ["ankle2", "knee2"],
                 ["knee1", "hip1"], ["knee2", "hip2"], ["hip1", "hip2"],
                 ["shoulder1", "shoulder2"], ["shoulder1", "hip1"],
                 ["shoulder2", "hip2"], ["shoulder1", "elbow1"],
                 ["shoulder2", "elbow2"], ["chin", "forehead"],
                 ["elbow1", "wrist1"], ["elbow2", "wrist2"]]


def create_pretrained_human_project(project, experimenter, videos,
                                    working_directory=None,
                                    copy_videos=False, videotype=".avi",
                                    createlabeledvideo: bool = True,
                                    analyzevideo: bool = True,
                                    ckpt_path: str | None = None,
                                    device=None):
    """Human-pose project from a pretrained MPII model
    (ref: create_project/human_dataset.py:46-143).

    The reference downloads the DeeperCut MPII TF checkpoint
    (auxfun_models.py:58-76); this environment has no egress, so the
    weights come from ``ckpt_path`` — a local TF1 checkpoint prefix
    (converted on the fly via ``models/tf_import``) or one of this
    package's msgpack snapshots — or from
    ``models.pretrained.find_pretrained`` search roots. Everything else
    matches the reference: 14 MPII bodyparts + skeleton, resnet_101,
    train/test pose_cfg.yaml, then optional analyze + labeled video.

    ``device`` runs the optional analysis and labeled video (default: the
    card). Returns ``(config_path, train_pose_cfg_path)`` like the
    reference.
    """
    import yaml

    from deepgraphpose_tpu_torch.core import paths as paths_lib
    from deepgraphpose_tpu_torch.core.config import ProjectConfig
    from deepgraphpose_tpu_torch.models import pretrained as pretrained_lib
    from deepgraphpose_tpu_torch.project.new import create_new_project

    cfg_path = create_new_project(project, experimenter, videos,
                                  working_directory, copy_videos, videotype)
    cfg = yaml.safe_load(Path(cfg_path).read_text())
    cfg["bodyparts"] = list(MPII_BODYPARTS)
    cfg["skeleton"] = [list(p) for p in MPII_SKELETON]
    cfg["default_net_type"] = "resnet_101"
    Path(cfg_path).write_text(yaml.safe_dump(cfg, sort_keys=False))

    proj = ProjectConfig.from_yaml(cfg_path)
    proj.project_path = str(Path(cfg_path).parent)
    train_dir = Path(paths_lib.train_dir(Path(cfg_path).parent, proj,
                                         shuffle=1))
    test_dir = train_dir.parent / "test"
    train_dir.mkdir(parents=True, exist_ok=True)
    test_dir.mkdir(parents=True, exist_ok=True)

    if ckpt_path is None:
        found = pretrained_lib.find_pretrained("resnet_101")
        ckpt_path = str(found) if found is not None else ""
    # pose_cfg contract mirrors human_dataset.py:118-134 items2change
    n_joints = len(MPII_BODYPARTS)
    train_cfg = {
        "dataset": "dataset-test.mat",
        "metadataset": "",
        "num_joints": n_joints,
        "all_joints": [[i] for i in range(n_joints)],
        "all_joints_names": [str(b) for b in MPII_BODYPARTS],
        "init_weights": str(ckpt_path),
        "project_path": str(Path(cfg_path).parent),
        "net_type": "resnet_101",
        "dataset_type": "default",
        "max_input_size": 1500,
        "location_refinement": True,
        "locref_stdev": 7.2801,
        "global_scale": 1.0,
    }
    (train_dir / "pose_cfg.yaml").write_text(
        yaml.safe_dump(train_cfg, sort_keys=False))
    test_keys = ["dataset", "dataset_type", "num_joints", "all_joints",
                 "all_joints_names", "net_type", "init_weights",
                 "global_scale", "location_refinement", "locref_stdev"]
    test_cfg = {k: train_cfg[k] for k in test_keys}
    test_cfg["scoremap_dir"] = "test"
    (test_dir / "pose_cfg.yaml").write_text(
        yaml.safe_dump(test_cfg, sort_keys=False))

    if ckpt_path:
        _materialize_human_snapshot(train_dir, str(ckpt_path))
    else:
        print("note: no local resnet_101 checkpoint available "
              "(DGP_PRETRAINED_DIR / ckpt_path); project created without "
              "weights — analyze/label steps skipped")
        analyzevideo = createlabeledvideo = False

    video_dir = os.path.join(str(Path(cfg_path).parent), "videos")
    if analyzevideo:
        from deepgraphpose_tpu_torch.infer.analyze import analyze_videos

        analyze_videos(cfg_path, [video_dir], videotype, save_as_csv=True,
                       device=device)
    if createlabeledvideo:
        create_labeled_video(cfg_path, [video_dir], videotype, device=device)
        from deepgraphpose_tpu_torch.infer.plotting import plot_trajectories

        plot_trajectories(cfg_path, [video_dir])
    return cfg_path, str(train_dir / "pose_cfg.yaml")


def _materialize_human_snapshot(train_dir: Path, ckpt_path: str) -> None:
    """Convert a local checkpoint into ``snapshot-step0-final--0.ckpt`` in
    ``train_dir`` so analyze/evaluate resolve it like any trained model."""
    import shutil

    from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models.pose_model import init_model

    if ckpt_path.endswith(ckpt_lib.CKPT_SUFFIX):  # already our format
        shutil.copy(ckpt_path, train_dir /
                    f"snapshot-step0-final--0{ckpt_lib.CKPT_SUFFIX}")
        return
    from deepgraphpose_tpu_torch.models import tf_import

    cfg = PoseConfig.from_yaml(train_dir / "pose_cfg.yaml")
    # a conversion on the host: the snapshot holds the weights, not a device
    model = init_model(cfg, device="cpu")
    state, report = tf_import.import_tf_checkpoint(
        model.state_dict(), ckpt_path, net_type=cfg.net_type,
        scopes=("resnet", "pose"))
    model.load_state_dict(state)
    print(f"imported local TF checkpoint {ckpt_path} "
          f"({len(report['imported'])} vars)")
    ckpt_lib.save_snapshot(train_dir, 0, "final--0", model)


def create_training_model_comparison(config, trainindex: int = 0,
                                     num_shuffles: int = 1,
                                     net_types: list = ("resnet_50",),
                                     **kwargs):
    """One shuffle per (copy, net_type) so architectures train side by side
    (ref: generate_training_dataset/trainingsetmanipulation.py
    create_training_model_comparison). Returns the shuffle indices."""
    from deepgraphpose_tpu_torch.project import create_training_dataset

    shuffles = []
    shuffle = 0
    for net in net_types:
        for _ in range(num_shuffles):
            shuffle += 1
            create_training_dataset(config, Shuffles=[shuffle],
                                    net_type=net, **kwargs)
            shuffles.append(shuffle)
            print(f"shuffle {shuffle}: {net}")
    return shuffles


def adddatasetstovideolistandviceversa(config, prefix: str = "videos",
                                       width: int | None = None,
                                       height: int | None = None,
                                       suffix: str = ".avi"):
    """Reconcile config video_sets with labeled-data folders
    (ref: trainingsetmanipulation.py:67-120): folders without a video
    entry get one (prefix/name+suffix, crop from width/height or the
    folder's first image); entries without a folder are removed."""
    import yaml

    config = Path(config)
    root = config.parent
    with open(config) as f:
        cfg = yaml.safe_load(f)
    video_sets = dict(cfg.get("video_sets") or {})
    names = {Path(v).stem: v for v in video_sets}
    labeled_dir = root / "labeled-data"
    if not labeled_dir.is_dir():
        print(f"no labeled-data folder under {root}; nothing to reconcile")
        return 0, 0
    folders = [d.name for d in labeled_dir.iterdir()
               if d.is_dir() and "_labeled" not in d.name]

    removed = [v for stem, v in names.items() if stem not in folders]
    for v in removed:
        print(f"removing video entry without labeled-data: {v}")
        video_sets.pop(v)
    added = 0
    for folder in folders:
        if folder in names:
            continue
        w, h = width, height
        if w is None or h is None:
            import cv2

            imgs = sorted(p for ext in ("*.png", "*.jpg", "*.jpeg")
                          for p in (labeled_dir / folder).glob(ext))
            im = cv2.imread(str(imgs[0])) if imgs else None
            if im is not None:
                h, w = im.shape[:2]
            else:
                print(f"labeled-data/{folder}: no readable frames; "
                      f"skipping (pass width=/height= to add it)")
                continue
        entry = str(Path(prefix) / f"{folder}{suffix}")
        video_sets[entry] = {"crop": f"0, {w}, 0, {h}"}
        print(f"adding video entry for labeled-data/{folder}: {entry}")
        added += 1
    cfg["video_sets"] = video_sets
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return added, len(removed)


# ---- 3-D (ref: pose_estimation_3d) ---------------------------------------

def check_undistortion(config3d, cbrow: int = 8, cbcol: int = 6):
    """Re-detect the calibration checkerboards, undistort, triangulate,
    and report per-pair 3-D quality: the RMS deviation of the triangulated
    corners from their best-fit plane (a checkerboard is planar, so this
    number IS the stereo-calibration error in world units) plus the mean
    corner spacing. The reference saves plots of the same quantities
    (ref: pose_estimation_3d/camera_calibration.py check_undistortion);
    here the numbers return to the caller.
    """
    import cv2
    import numpy as np
    import yaml

    from deepgraphpose_tpu_torch.threed.calibration import (
        CameraSystem, detect_checkerboard)
    from deepgraphpose_tpu_torch.threed.triangulation import (
        triangulate_points, undistort_points)

    config3d = Path(config3d)
    with open(config3d) as f:
        cfg = yaml.safe_load(f)
    root = Path(cfg.get("project_path", config3d.parent))
    names = cfg["camera_names"]
    cs = CameraSystem.load(root / "camera_matrix" / "stereo_params.pickle")

    per_cam: dict[str, dict] = {n: {} for n in names}
    for n in names:
        img_dir = root / "calibration_images"
        for p in sorted(list(img_dir.glob(f"{n}-*.jpg"))
                        + list(img_dir.glob(f"{n}-*.png"))):
            img = cv2.imread(str(p))
            if img is None:
                continue
            corners = detect_checkerboard(img, cbrow, cbcol)
            if corners is not None:
                per_cam[n][p.stem[len(n) + 1:]] = corners
    common = sorted(set.intersection(*[set(per_cam[n]) for n in names]))
    reports = []
    for key in common:
        p1 = undistort_points(per_cam[names[0]][key], cs.K[names[0]],
                              cs.dist[names[0]], cs.P[names[0]])
        p2 = undistort_points(per_cam[names[1]][key], cs.K[names[1]],
                              cs.dist[names[1]], cs.P[names[1]])
        xyz = triangulate_points(cs.P[names[0]], cs.P[names[1]],
                                 p1.reshape(-1, 2), p2.reshape(-1, 2))
        centered = xyz - xyz.mean(0)
        *_, vt = np.linalg.svd(centered, full_matrices=False)
        plane_rms = float(np.sqrt(np.mean((centered @ vt[-1]) ** 2)))
        grid = xyz.reshape(cbrow * cbcol, 3)
        spacing = float(np.mean(np.linalg.norm(
            grid[1:cbcol] - grid[:cbcol - 1], axis=-1)))
        reports.append({"image": key, "plane_rms": plane_rms,
                        "corner_spacing": spacing})
        print(f"pair {key}: plane RMS {plane_rms:.4f}, "
              f"corner spacing {spacing:.4f} (square-size units)")
    if not reports:
        print("no checkerboard pairs found; run calibrate_cameras first")
    return reports


# ---- reference-spelled aliases -------------------------------------------

def comparevideolistsanddatafolders(config):
    from deepgraphpose_tpu_torch.project import \
        compare_video_lists_and_data_folders as f

    return f(config)


def dropannotationfileentriesduetodeletedimages(config):
    from deepgraphpose_tpu_torch.project import \
        drop_annotations_for_deleted_images as f

    return f(config)


def dropimagesduetolackofannotation(config):
    from deepgraphpose_tpu_torch.project import drop_unannotated_images as f

    return f(config)


def dropduplicatesinannotatinfiles(config):
    from deepgraphpose_tpu_torch.project import \
        drop_duplicates_in_annotation_files as f

    return f(config)


def ShortenVideo(vname, start: str = "00:00:01", stop: str = "00:01:00",
                 outsuffix: str = "short", outpath: str | None = None):
    """ref: utils/auxfun_videos.py ShortenVideo (HH:MM:SS bounds)."""
    from deepgraphpose_tpu_torch.data.video import shorten_video

    def _secs(ts):
        parts = [float(p) for p in str(ts).split(":")]
        while len(parts) < 3:
            parts.insert(0, 0.0)
        return parts[0] * 3600 + parts[1] * 60 + parts[2]

    return shorten_video(vname, start_s=_secs(start), stop_s=_secs(stop),
                         outsuffix=outsuffix, outpath=outpath)


def DownSampleVideo(vname, width: int = -1, height: int = 200,
                    outsuffix: str = "downsampled",
                    outpath: str | None = None, rotatecw: bool = False):
    """ref: utils/auxfun_videos.py DownSampleVideo. ``rotatecw`` is
    accepted and ignored (the reference shells out to ffmpeg's transpose;
    rotate before downsampling if needed)."""
    del rotatecw
    from deepgraphpose_tpu_torch.data.video import downsample_video

    return downsample_video(vname, width=width, height=height,
                            outsuffix=outsuffix, outpath=outpath)


def create_labeled_video(config, videos, videotype: str = "avi",
                         shuffle: int = 1, trainingsetindex: int = 0,
                         save_frames: bool = False, destfolder=None,
                         **kwargs):
    """Marker-annotated videos from trajectories
    (ref: utils/make_labeled_video.py create_labeled_video). ``kwargs``
    pass to ``plot_dgp`` and its ``estimate_pose`` (``device=``,
    ``quantize=``)."""
    from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
    from deepgraphpose_tpu_torch.infer.video_writer import plot_dgp
    from deepgraphpose_tpu_torch.train.fit import resolve_project

    del save_frames
    dlcpath = Path(config).parent
    _, _, train_dir = resolve_project(dlcpath, shuffle, trainingsetindex)
    snap = ckpt_lib.latest_snapshot(train_dir)
    if snap is None:
        raise FileNotFoundError(f"no snapshot under {train_dir}")
    from deepgraphpose_tpu_torch.core import paths as paths_lib

    # directory entries expand to their video files of the requested
    # videotype, like analyze_videos (ref: predict_videos.py GetVideoList)
    expanded = []
    for video in ([videos] if isinstance(videos, (str, os.PathLike))
                  else videos):
        if Path(video).is_dir():
            expanded.extend(
                v for v in paths_lib.list_videos(video)
                if v.lower().endswith(videotype.lower().lstrip(".")))
        else:
            expanded.append(video)
    outs = []
    for video in expanded:
        out = Path(destfolder) if destfolder else Path(video).parent
        outs.append(plot_dgp(video, out, proj_cfg_file=config,
                             dgp_model_file=snap, shuffle=shuffle, **kwargs))
    return outs
