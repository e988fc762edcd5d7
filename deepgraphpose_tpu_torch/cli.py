"""The port's command-line interface.

The same 25 commands as the JAX package's click group
(``deepgraphpose_tpu/cli.py``; ref: deeplabcut/cli.py:19-417 plus the DGP
pipeline of demo/run_dgp_demo.py:117-147), with the same arguments,
options, defaults and ``--x/--no-x`` pairs, written with ``argparse`` so
that it runs where ``click`` is not installed:

    create-project  add-videos  extract-frames  label-frames  check-labels
    create-training-dataset  train  train-heads  evaluate  analyze-videos
    filter-predictions  extract-outlier-frames  create-labeled-video
    analyze-skeleton  analyze-time-lapse-frames  plot-trajectories
    extract-maps  create-project-3d  calibrate-cameras  triangulate
    run-demo  export-model  convertcsv2h5  convert-windows-paths
    converth5-to-csv

One option besides: ``--device`` (before or after the command; default
the card) is passed to every entry point that runs the model. A command
that runs no model ignores it.

    python -m deepgraphpose_tpu_torch.cli --help
    python -m deepgraphpose_tpu_torch.cli train P/config.yaml --step 0
    python -m deepgraphpose_tpu_torch.cli analyze-videos P/config.yaml \\
        P/videos/ --int8 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


class CommandError(Exception):
    """A failure the command reports as ``Error: ...`` with exit code 1
    (click's ``ClickException``)."""

    exit_code = 1


class UsageError(CommandError):
    """Contradicting options: exit code 2 (click's ``UsageError``)."""

    exit_code = 2


def _existing(path: str) -> str:
    """click.Path(exists=True)."""
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"Path {path!r} does not exist.")
    return path


def _flag_pair(parser, on: str, off: str, dest: str, default, help=None):
    """click's ``--on/--off`` boolean pair: both write ``dest``."""
    parser.add_argument(on, dest=dest, action="store_true", help=help)
    parser.add_argument(off, dest=dest, action="store_false")
    parser.set_defaults(**{dest: default})


def _resolve_quantize(quantize, residual_int8):
    """Map the --int8/--no-int8 tri-state + --residual-int8 flag pair to
    the library quantize= argument, rejecting the contradiction."""
    if residual_int8:
        if quantize is False:
            raise UsageError(
                "--no-int8 and --residual-int8 conflict: --no-int8 keeps "
                "the float model, --residual-int8 requests the int8 carry "
                "mode")
        return "residual"
    return quantize


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

def create_project(a):
    """Create a new DLC/DGP project skeleton."""
    from deepgraphpose_tpu_torch.project import create_new_project

    print(create_new_project(a.project, a.experimenter, list(a.videos),
                             a.working_directory, a.copy_videos,
                             a.videotype))


def add_videos(a):
    """Add videos to an existing project."""
    from deepgraphpose_tpu_torch.project import add_new_videos

    add_new_videos(a.config, list(a.videos), a.copy_videos)


def extract_frames(a):
    """Extract frames for labeling (kmeans/uniform, or manual grab)."""
    from deepgraphpose_tpu_torch.project import extract_frames as _extract

    _extract(a.config, mode=a.mode, algo=a.algo, crop=a.crop, port=a.port,
             timeout=a.timeout)


def label_frames(a):
    """Browser labeling UI (headless replacement for the wx toolbox)."""
    from deepgraphpose_tpu_torch.project.label_server import LabelServer

    LabelServer(Path(a.config).parent, video=a.video,
                port=a.port).serve_forever()


def check_labels(a):
    """Render human labels onto the labeled frames for inspection."""
    from deepgraphpose_tpu_torch.infer.plotting import check_labels as _check

    _check(a.config)


def create_training_dataset(a):
    """Merge labels, split train/test, write .mat + pose_cfg.yaml."""
    from deepgraphpose_tpu_torch.project import \
        create_training_dataset as _create

    _create(a.config, num_shuffles=a.num_shuffles, net_type=a.net_type)


def train(a):
    """Train: all 3 steps by default, or a single --step."""
    from deepgraphpose_tpu_torch.train import fit as fit_lib

    kw = dict(dlcpath=Path(a.config).parent, shuffle=a.shuffle,
              displayiters=a.displayiters, saveiters=a.saveiters,
              device=a.device)
    if a.maxiters is not None:
        kw["maxiters"] = a.maxiters
    for s in [a.step] if a.step is not None else [0, 1, 2]:
        if s == 0:
            fit_lib.fit_dlc(snapshot=a.snapshot, **kw)
        elif s == 1:
            fit_lib.fit_dgp_labeledonly(
                snapshot=a.snapshot or "snapshot-step0-final--0", **kw)
        else:
            fit_lib.fit_dgp(
                snapshot=a.snapshot or "snapshot-step1-final--0",
                batch_size=a.batch_size, **kw)


def train_heads(a):
    """Head-only training on cached backbone features
    (train/headonly.py)."""
    from deepgraphpose_tpu_torch.train.headonly import fit_dlc_heads

    fit_dlc_heads(dlcpath=Path(a.config).parent, shuffle=a.shuffle,
                  maxiters=a.maxiters, displayiters=a.displayiters,
                  snapshot=a.snapshot, lr=a.lr, reinit_heads=a.reinit_heads,
                  device=a.device)


def evaluate(a):
    """RMSE vs human labels on the train/test split."""
    from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.evaluation.metrics import (
        evaluate_dgp, write_evaluation_csv)

    dlcpath = Path(a.config).parent
    proj, _, train_dir = resolve_project(dlcpath, a.shuffle)
    if a.snapshot:
        snap = Path(train_dir) / f"{a.snapshot}{ckpt_lib.CKPT_SUFFIX}"
    else:
        snap = ckpt_lib.latest_snapshot(train_dir)
    if snap is None or not Path(snap).exists():
        raise CommandError(f"no snapshot under {train_dir}")
    result = evaluate_dgp(a.config, snap, shuffle=a.shuffle,
                          quantize=a.quantize, device=a.device)
    if a.out:
        write_evaluation_csv(result, a.out)
    if a.plotting:
        from deepgraphpose_tpu_torch.infer.plotting import \
            plot_evaluation_frames

        folder = (dlcpath / "evaluation-results" /
                  f"iteration-{proj.iteration}" /
                  f"LabeledImages_{Path(snap).stem}")
        written = plot_evaluation_frames(
            result["image_paths"], result["true_xy"], result["pred_xy"],
            result["likelihood"], result["is_train"], folder,
            pcutoff=proj.pcutoff, dotsize=proj.dotsize,
            alpha=proj.alphavalue, colormap=proj.colormap,
            bodyparts=proj.bodyparts)
        print(f"wrote {len(written)} labeled evaluation images to {folder}")


def analyze_videos(a):
    """Batched full-video inference with DLC scorer-named outputs."""
    from deepgraphpose_tpu_torch.infer.analyze import \
        analyze_videos as _analyze

    _analyze(a.config, list(a.videos), shuffle=a.shuffle,
             batchsize=a.batchsize, save_as_csv=a.save_as_csv,
             destfolder=a.destfolder,
             quantize=_resolve_quantize(a.quantize, a.residual_int8),
             scale=a.scale, preset=a.preset,
             dynamic=(bool(a.dynamic[0]), a.dynamic[1], int(a.dynamic[2])),
             device=a.device)


def filter_predictions(a):
    """Median/Kalman filtering of analyzed trajectories."""
    from deepgraphpose_tpu_torch.evaluation.filtering import \
        filterpredictions

    filterpredictions(a.config, list(a.videos), filtertype=a.filtertype,
                      windowlength=a.windowlength)


def extract_outlier_frames(a):
    """Flag + extract outlier frames for relabeling."""
    from deepgraphpose_tpu_torch.evaluation.outliers import \
        extract_outlier_frames as _extract

    _extract(a.config, list(a.videos), outlieralgorithm=a.outlieralgorithm,
             epsilon=a.epsilon, p_bound=a.p_bound,
             extractionalgorithm=a.extractionalgorithm)


def create_labeled_video(a):
    """Render marker-annotated videos from trajectories."""
    from deepgraphpose_tpu_torch.core import checkpoint as ckpt_lib
    from deepgraphpose_tpu_torch.core.paths import resolve_project
    from deepgraphpose_tpu_torch.infer.video_writer import plot_dgp

    _, _, train_dir = resolve_project(Path(a.config).parent, a.shuffle)
    snap = ckpt_lib.latest_snapshot(train_dir)
    if snap is None:
        raise CommandError(f"no snapshot under {train_dir}")
    for video in a.videos:
        out = Path(a.destfolder) if a.destfolder else Path(video).parent
        plot_dgp(video, out, proj_cfg_file=a.config, dgp_model_file=snap,
                 shuffle=a.shuffle, device=a.device)


def analyze_skeleton(a):
    """Bone length/orientation per skeleton edge per frame."""
    from deepgraphpose_tpu_torch.evaluation.skeleton import analyzeskeleton

    analyzeskeleton(a.config, list(a.videos), shuffle=a.shuffle,
                    save_as_csv=not a.no_csv)


def analyze_time_lapse_frames(a):
    """Batched inference over a directory of same-sized images."""
    from deepgraphpose_tpu_torch.infer.analyze import \
        analyze_time_lapse_frames as _analyze

    _analyze(a.config, a.directory, frametype=a.frametype,
             shuffle=a.shuffle, device=a.device)


def plot_trajectories(a):
    """4-panel trajectory/likelihood plot per analyzed video."""
    from deepgraphpose_tpu_torch.infer.plotting import \
        plot_trajectories as _plot

    _plot(a.config, list(a.videos), filtered=a.filtered)


def extract_maps(a):
    """Save scoremap grids for labeled frames (network introspection)."""
    from deepgraphpose_tpu_torch.evaluation.maps import \
        extract_save_all_maps

    idx = [int(i) for i in a.indices.split(",")] if a.indices else None
    extract_save_all_maps(a.config, shuffle=a.shuffle, indices=idx,
                          device=a.device)


def create_project_3d(a):
    """Create a 3-D (stereo) project skeleton."""
    from deepgraphpose_tpu_torch.threed import create_new_project_3d

    print(create_new_project_3d(a.project, a.experimenter,
                                a.working_directory,
                                num_cameras=a.num_cameras))


def calibrate_cameras(a):
    """Stereo calibration from calibration_images/<camera>-*.jpg pairs."""
    from deepgraphpose_tpu_torch.threed import calibrate_cameras as _calib

    _calib(a.config3d, cbrow=a.cbrow, cbcol=a.cbcol,
           square_size=a.square_size)


def triangulate(a):
    """Triangulate two cameras' trajectory tables into 3-D."""
    from deepgraphpose_tpu_torch.threed import triangulate as _tri

    _tri(a.config3d, a.h5_cam1, a.h5_cam2, destfolder=a.destfolder)


def run_demo(a):
    """Full 4-step DGP pipeline (== deepgraphpose_tpu_torch/demo.py)."""
    from deepgraphpose_tpu_torch import demo

    argv = ["--dlcpath", str(a.dlcpath), "--shuffle", str(a.shuffle),
            "--batch_size", str(a.batch_size)]
    if a.dlcsnapshot:
        argv += ["--dlcsnapshot", a.dlcsnapshot]
    if a.test:
        argv += ["--test"]
    if a.device is not None:
        argv += ["--device", str(a.device)]
    return demo.main(argv)


def export_model(a):
    """Freeze a trained snapshot into a torch.export serving artifact."""
    from deepgraphpose_tpu_torch.infer.serving import export_from_snapshot

    in_hw = (a.height, a.width) if a.height and a.width else None
    quantize = _resolve_quantize(a.quantize, a.residual_int8)
    platforms = tuple(a.platforms.split(",")) if a.platforms else None
    path = export_from_snapshot(
        a.config, a.snapshot, a.out, batch_size=a.batch_size, in_hw=in_hw,
        shuffle=a.shuffle, platforms=platforms,
        quantize=False if quantize is None else quantize, device=a.device)
    print(f"wrote {path} (+ {path}.json metadata)")


def convertcsv2h5_cmd(a):
    """Rebuild CollectedData .h5 files from their .csv siblings
    (ref: utils/conversioncode.py:49-110)."""
    from deepgraphpose_tpu_torch.project.conversion import convertcsv2h5

    n = convertcsv2h5(a.config, userfeedback=a.userfeedback,
                      scorer=a.scorer)
    print(f"converted {n} folder(s)")


def convert_windows_paths(a):
    """Convert Windows-style annotation image paths to unix form
    (ref: utils/conversioncode.py:17-47)."""
    from deepgraphpose_tpu_torch.project.conversion import \
        convertannotationdata_fromwindows2unixstyle

    n = convertannotationdata_fromwindows2unixstyle(
        a.config, userfeedback=a.userfeedback)
    print(f"converted {n} folder(s)")


def converth5_to_csv(a):
    """Export pose .h5 tables next to videos as .csv
    (ref: utils/conversioncode.py:112-156)."""
    from deepgraphpose_tpu_torch.project.conversion import \
        analyze_videos_converth5_to_csv

    n = analyze_videos_converth5_to_csv(a.videopath, videotype=a.videotype)
    print(f"converted {n} file(s)")


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

_INT8_HELP = ("the int8-quantized backbone (models/quant.py; its convs run "
              "on the int8 GEMM kernel)")
_RESIDUAL_HELP = ("int8 backbone with int8 residual-stream carries "
                  "(its accuracy cost: EVAL.md)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m deepgraphpose_tpu_torch.cli",
        description="DeepGraphPose toolbox on PyTorch (the card by default).")
    parser.add_argument("--device", default=None,
                        help="torch device of every command that runs the "
                             "model (default: the card; 'cpu' runs on the "
                             "CPU)")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")
    sub.required = True

    def command(name, fn):
        p = sub.add_parser(name, help=fn.__doc__.split("\n")[0],
                           description=fn.__doc__)
        p.add_argument("--device", default=argparse.SUPPRESS,
                       help=argparse.SUPPRESS)
        p.set_defaults(func=fn)
        return p

    p = command("create-project", create_project)
    p.add_argument("project")
    p.add_argument("experimenter")
    p.add_argument("videos", nargs="*", type=_existing)
    p.add_argument("-d", "--wd", dest="working_directory", default=None,
                   help="directory to create the project in")
    _flag_pair(p, "--copy-videos", "--dont-copy-videos", "copy_videos", True)
    p.add_argument("--videotype", default=".avi")

    p = command("add-videos", add_videos)
    p.add_argument("config", type=_existing)
    p.add_argument("videos", nargs="*", type=_existing)
    _flag_pair(p, "--copy-videos", "--dont-copy-videos", "copy_videos", True)

    p = command("extract-frames", extract_frames)
    p.add_argument("config", type=_existing)
    p.add_argument("--mode", default="automatic",
                   choices=["automatic", "manual"],
                   help="'manual' = scrub-and-grab browser UI "
                        "(or $DGP_MANUAL_FRAMES)")
    p.add_argument("-a", "--algo", default="kmeans",
                   choices=["kmeans", "uniform"])
    p.add_argument("--crop", action="store_true", default=False)
    p.add_argument("--port", type=int, default=0,
                   help="manual-mode UI port (0 = any)")
    p.add_argument("--timeout", type=float, default=None,
                   help="manual-mode bound in seconds (default: wait "
                        "forever; on timeout, frames grabbed so far are "
                        "kept)")

    p = command("label-frames", label_frames)
    p.add_argument("config", type=_existing)
    p.add_argument("--video", default=None,
                   help="labeled-data video dir (default: first)")
    p.add_argument("--port", type=int, default=8574)

    p = command("check-labels", check_labels)
    p.add_argument("config", type=_existing)

    p = command("create-training-dataset", create_training_dataset)
    p.add_argument("config", type=_existing)
    p.add_argument("-num", "--num-shuffles", dest="num_shuffles", type=int,
                   default=1)
    p.add_argument("--net-type", default=None)

    p = command("train", train)
    p.add_argument("config", type=_existing)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--step", type=int, default=None,
                   help="run only one step (0=DLC, 1=DGP labeled-only, "
                        "2=DGP)")
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--maxiters", type=int, default=None)
    p.add_argument("--displayiters", type=int, default=100)
    p.add_argument("--saveiters", type=int, default=1000)
    p.add_argument("--snapshot", default=None,
                   help="warm-start snapshot name for the chosen step")

    p = command("train-heads", train_heads)
    p.add_argument("config", type=_existing)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--maxiters", type=int, default=5000)
    p.add_argument("--displayiters", type=int, default=500)
    p.add_argument("--snapshot", default=None,
                   help="backbone snapshot (defaults to latest step-0)")
    p.add_argument("--lr", type=float, default=None)
    _flag_pair(p, "--reinit-heads", "--keep-heads", "reinit_heads", False,
               help="re-initialise the head parameters before fitting")

    p = command("evaluate", evaluate)
    p.add_argument("config", type=_existing)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--snapshot", default=None,
                   help="snapshot name (defaults to latest step-2 final)")
    p.add_argument("--out", default=None,
                   help="write per-frame RMSE CSV here")
    _flag_pair(p, "--plotting", "--no-plotting", "plotting", False,
               help="write per-frame labeled evaluation images "
                    "(ref evaluate_network plotting=True)")
    _flag_pair(p, "--int8", "--no-int8", "quantize", False,
               help="evaluate " + _INT8_HELP)

    p = command("analyze-videos", analyze_videos)
    p.add_argument("config", type=_existing)
    p.add_argument("videos", nargs="*", type=_existing)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--batchsize", type=int, default=None)
    _flag_pair(p, "--save-as-csv", "--no-csv", "save_as_csv", True)
    p.add_argument("--destfolder", default=None)
    _flag_pair(p, "--int8", "--no-int8", "quantize", None,
               help=_INT8_HELP + "; --no-int8 keeps the float model even "
                                 "under --preset fast")
    p.add_argument("--residual-int8", action="store_true", default=False,
                   help=_RESIDUAL_HELP)
    p.add_argument("--scale", type=float, default=None,
                   help="resize frames by this factor before inference "
                        "(coordinates stay in original pixels)")
    p.add_argument("--preset", default=None, choices=["fast"],
                   help="'fast' = scale 0.75 + residual-int8")
    p.add_argument("--dynamic", nargs=3, type=float, default=(0, 0.5, 10),
                   metavar=("STATE", "THRESHOLD", "MARGIN"),
                   help="dynamic cropping: STATE THRESHOLD MARGIN "
                        "(ref predict_videos.py dynamic=(False,.5,10))")

    p = command("filter-predictions", filter_predictions)
    p.add_argument("config", type=_existing)
    p.add_argument("videos", nargs="*", type=_existing)
    p.add_argument("--filtertype", default="median",
                   choices=["median", "kalman", "arima"])
    p.add_argument("--windowlength", type=int, default=5)

    p = command("extract-outlier-frames", extract_outlier_frames)
    p.add_argument("config", type=_existing)
    p.add_argument("videos", nargs="*", type=_existing)
    p.add_argument("--outlieralgorithm", default="jump",
                   choices=["jump", "uncertain", "fitting"])
    p.add_argument("--epsilon", type=float, default=20.0)
    p.add_argument("--p-bound", type=float, default=0.01)
    p.add_argument("--extractionalgorithm", default="uniform",
                   choices=["uniform", "kmeans"])

    p = command("create-labeled-video", create_labeled_video)
    p.add_argument("config", type=_existing)
    p.add_argument("videos", nargs="*", type=_existing)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--destfolder", default=None)

    p = command("analyze-skeleton", analyze_skeleton)
    p.add_argument("config", type=_existing)
    p.add_argument("videos", nargs="*", type=_existing)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--no-csv", action="store_true", default=False)

    p = command("analyze-time-lapse-frames", analyze_time_lapse_frames)
    p.add_argument("config", type=_existing)
    p.add_argument("directory", type=_existing)
    p.add_argument("--frametype", default=".png")
    p.add_argument("--shuffle", type=int, default=1)

    p = command("plot-trajectories", plot_trajectories)
    p.add_argument("config", type=_existing)
    p.add_argument("videos", nargs="*", type=_existing)
    p.add_argument("--filtered", action="store_true", default=False)

    p = command("extract-maps", extract_maps)
    p.add_argument("config", type=_existing)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--indices", default=None,
                   help="comma-separated labeled-frame indices "
                        "(default: all)")

    p = command("create-project-3d", create_project_3d)
    p.add_argument("project")
    p.add_argument("experimenter")
    p.add_argument("-d", "--wd", dest="working_directory", default=None)
    p.add_argument("--num-cameras", type=int, default=2)

    p = command("calibrate-cameras", calibrate_cameras)
    p.add_argument("config3d", type=_existing)
    p.add_argument("--cbrow", type=int, default=8)
    p.add_argument("--cbcol", type=int, default=6)
    p.add_argument("--square-size", type=float, default=1.0)

    p = command("triangulate", triangulate)
    p.add_argument("config3d", type=_existing)
    p.add_argument("h5_cam1", type=_existing)
    p.add_argument("h5_cam2", type=_existing)
    p.add_argument("--destfolder", default=None)

    p = command("run-demo", run_demo)
    p.add_argument("--dlcpath", required=True, type=_existing)
    p.add_argument("--dlcsnapshot", default=None)
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--batch_size", "--batch-size", dest="batch_size",
                   type=int, default=10)
    p.add_argument("--test", action="store_true", default=False)

    p = command("export-model", export_model)
    p.add_argument("config", type=_existing)
    p.add_argument("out")
    p.add_argument("--snapshot", default="snapshot-step2-final--0",
                   help="snapshot name under the train dir")
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--platforms", default=None,
                   help="the platform to export for: 'cuda' or 'cpu', the "
                        "one the export runs on (--device). A torch.export "
                        "program runs only on the device it was exported "
                        "on, so any other platform is refused (default: "
                        "that device)")
    _flag_pair(p, "--int8", "--no-int8", "quantize", None,
               help="export " + _INT8_HELP)
    p.add_argument("--residual-int8", action="store_true", default=False,
                   help=_RESIDUAL_HELP)

    p = command("convertcsv2h5", convertcsv2h5_cmd)
    p.add_argument("config", type=_existing)
    p.add_argument("--scorer", default=None,
                   help="overwrite the annotator name in the rewritten "
                        "files")
    p.add_argument("--userfeedback", action="store_true", default=False,
                   help="ask per labeled-data folder before converting")

    p = command("convert-windows-paths", convert_windows_paths)
    p.add_argument("config", type=_existing)
    p.add_argument("--userfeedback", action="store_true", default=False)

    p = command("converth5-to-csv", converth5_to_csv)
    p.add_argument("videopath", type=_existing)
    p.add_argument("--videotype", default=".avi")
    return parser


def main(argv=None) -> int:
    """Run one command; returns its exit code: 0, 1 where it failed with a
    ``CommandError``, 2 for contradicting options (argparse itself exits
    with 2 on a malformed command line)."""
    args = build_parser().parse_args(argv)
    try:
        code = args.func(args)
    except CommandError as e:
        print(f"Error: {e}", file=sys.stderr)
        return e.exit_code
    return int(code or 0)


if __name__ == "__main__":
    raise SystemExit(main())
