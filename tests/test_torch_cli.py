"""The port's CLI and top-level names against the JAX package's, on the CPU.

* The command surface: each of the 25 commands of the JAX package's
  click group (``deepgraphpose_tpu.cli.main``) is a command of the port's
  argparse parser (``deepgraphpose_tpu_torch.cli.build_parser``) with the
  same parameter names, option strings, defaults, types, choices, nargs
  and ``--x/--no-x`` pairs. One documented difference: ``export-model
  --platforms`` defaults to the device the export runs on, since a
  ``torch.export`` program runs only where it was exported.
* The same argv through both CLIs (click's ``CliRunner`` for the JAX
  package, ``cli.main([..., "--device", "cpu"])`` for the port) on copies
  of one project: create-project, extract-frames, create-training-dataset
  write equal files and splits; train --step 0 --maxiters 2 writes the
  same snapshots and logs (each package from its own random init);
  analyze-videos from one JAX-written snapshot gives trajectories within
  ``tests/test_torch_analyze.py``'s bounds, and analyze-videos --int8
  with the JAX package's int8 state in both within its int8 bounds.
* filter-predictions and analyze-skeleton on one analysis write equal
  files; export-model --device cpu writes an artifact that serves what
  the live model computes.
* The top-level names: ``dir(deepgraphpose_tpu_torch)`` holds every lazy
  name of the JAX package and every DeepLabCut spelling of
  ``tests/test_api_surface.py``, and the compat helpers write what the
  JAX package's write.

The models are ``resnet_tiny`` (one unit a block, registered in both
packages while a test runs) on ``utils/synthetic.py``'s video at 48x64.
"""

import contextlib
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

import deepgraphpose_tpu as jax_pkg
import deepgraphpose_tpu_torch as port_pkg
from deepgraphpose_tpu import cli as jax_cli
from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.models import quant as jax_quant
from deepgraphpose_tpu.models.pose_model import init_model as jax_init_model
from deepgraphpose_tpu.train.fit import resolve_project as jax_resolve
from deepgraphpose_tpu.utils.synthetic import make_synthetic_project
from deepgraphpose_tpu_torch import cli
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core.paths import resolve_project
from deepgraphpose_tpu_torch.infer import export
from deepgraphpose_tpu_torch.models import quant
from chip_smoke import synthetic_track
from test_api_surface import REFERENCE_EXPORTS
from test_torch_fit import tiny_blocks
from test_torch_project import assert_same_tree, assert_same_value, twins

XY_TOL, LIK_TOL = 1e-3, 1e-4          # float32 analysis, test_torch_analyze
INT8_XY_TOL, INT8_LIK_TOL = 1e-2, 1e-3  # one package's int8 state in both
SERVE_TOL = 1e-5                      # the artifact against the live model
HW = (48, 64)
COMMANDS = sorted(jax_cli.main.commands)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs: the suite runs six files at
    once, and each torch process would otherwise start a thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def seeded_splits():
    """``np.random.default_rng(None)`` seeded with 0 inside the block: the
    CLI's create-training-dataset draws its split unseeded, in both
    packages, so that the two splits can be compared."""
    make = np.random.default_rng
    np.random.default_rng = lambda seed=None: make(0 if seed is None
                                                   else seed)
    try:
        yield
    finally:
        np.random.default_rng = make


def run_both(argv_jax: list, argv_port: list | None = None) -> None:
    """One command through each CLI; both must exit 0."""
    argv_jax = [str(a) for a in argv_jax]
    res = CliRunner().invoke(jax_cli.main, argv_jax,
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    argv_port = [str(a) for a in (argv_port or argv_jax)]
    assert cli.main(argv_port + ["--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# (a) the command surface
# ---------------------------------------------------------------------------

def _port_command(name):
    parser = cli.build_parser()
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return sub.choices[name]


def _port_params(parser) -> dict:
    """{dest: description} of a subcommand's arguments, in click's terms."""
    import argparse

    out = {}
    for a in parser._actions:
        if a.dest in ("help", "device") or a.default is argparse.SUPPRESS:
            continue
        d = out.setdefault(a.dest, {"opts": [], "secondary": []})
        kind = type(a).__name__
        if kind == "_StoreFalseAction":
            d["secondary"] = list(a.option_strings)
            continue
        d["opts"] = list(a.option_strings) or [a.dest]
        d["argument"] = not a.option_strings
        d["flag"] = kind in ("_StoreTrueAction", "_StoreFalseAction")
        d["default"] = parser.get_default(a.dest)
        d["choices"] = list(a.choices) if a.choices else None
        d["nargs"] = {None: 1, "*": -1}.get(a.nargs, a.nargs)
        d["required"] = (bool(a.required) if a.option_strings
                         else a.nargs not in ("*", "?"))
        d["type"] = {int: "integer", float: "float", cli._existing: "path",
                     None: "text"}[a.type]
        if d["flag"]:
            d["type"], d["nargs"] = "boolean", 1
        elif d["choices"]:
            d["type"] = "choice"
    return out


def _click_params(command) -> dict:
    import click

    out = {}
    for p in command.params:
        if p.name == "help":
            continue
        t = p.type
        d = {"opts": list(p.opts), "secondary": list(p.secondary_opts),
             "argument": isinstance(p, click.Argument),
             "flag": bool(getattr(p, "is_flag", False)),
             "default": p.default,
             "choices": (list(t.choices) if isinstance(t, click.Choice)
                         else None),
             "nargs": p.nargs, "required": p.required,
             "type": t.name if not isinstance(t, click.Tuple)
             else t.types[0].name}
        if isinstance(t, click.Path):
            d["type"] = "path" if t.exists else "text"
        if d["type"] == "boolean" and not d["flag"]:
            d["type"] = "text"
        if d["nargs"] == -1 or type(p.default).__name__ == "Sentinel":
            d["default"] = None        # click: () or UNSET, argparse: None
        out[p.name] = d
    return out


@pytest.mark.parametrize("name", COMMANDS)
def test_command_surface_matches(name):
    want = _click_params(jax_cli.main.commands[name])
    got = _port_params(_port_command(name))
    for d in got.values():
        if d["nargs"] == -1:
            d["default"] = None
    if name == "export-model":
        # the port exports for the device it runs on (--device)
        assert want["platforms"]["default"] == "tpu,cpu"
        assert got["platforms"]["default"] is None
        want["platforms"]["default"] = None
    if name == "analyze-videos":
        assert tuple(got["dynamic"]["default"]) == want["dynamic"]["default"]
        got["dynamic"]["default"] = want["dynamic"]["default"]
    assert list(got) == list(want)
    for param in want:
        assert got[param] == want[param], (name, param)


def test_help_and_device_option(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for name in COMMANDS:
        assert name in out
    assert "--device" in out
    with pytest.raises(SystemExit):
        cli.main(["export-model", "--help"])
    text = capsys.readouterr().out
    assert "cuda" in text
    text = text.replace("deepgraphpose_tpu_torch", "")
    assert "tpu" not in text.lower() and "mxu" not in text.lower()
    # --device before or after the command
    parser = cli.build_parser()
    for argv in (["--device", "cpu", "check-labels", "."],
                 ["check-labels", ".", "--device", "cpu"]):
        assert parser.parse_args(argv).device == "cpu"
    assert parser.parse_args(["check-labels", "."]).device is None
    # a path that does not exist is refused, as click.Path(exists=True)
    with pytest.raises(SystemExit) as e:
        cli.main(["check-labels", "/nonexistent/config.yaml"])
    assert e.value.code == 2


def test_conflicting_int8_options():
    with pytest.raises(cli.UsageError):
        cli._resolve_quantize(False, True)
    assert cli._resolve_quantize(None, True) == "residual"
    assert cli._resolve_quantize(True, False) is True
    assert cli._resolve_quantize(None, False) is None
    res = CliRunner().invoke(jax_cli.main, ["analyze-videos", ".",
                                            "--no-int8", "--residual-int8"])
    assert res.exit_code == cli.UsageError.exit_code == 2
    assert cli.main(["analyze-videos", ".", "--no-int8", "--residual-int8",
                     "--device", "cpu"]) == 2


# ---------------------------------------------------------------------------
# (b) the workflow through both CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def source_video(tmp_path_factory):
    root, idx, coords = make_synthetic_project(
        tmp_path_factory.mktemp("cli_src") / "p", n_frames=24, n_labeled=4,
        hw=HW)
    # chip_smoke's copy of the dots' formula labels the workflow's frames
    np.testing.assert_array_equal(synthetic_track(24, HW, 3)[idx], coords)
    return Path(root) / "videos" / "synthvid.avi"


@pytest.fixture(scope="module")
def workflow(tmp_path_factory, source_video):
    """create-project, extract-frames, labels, create-training-dataset
    through both CLIs: {"jax": root, "port": root, "dir": parent}."""
    work = tmp_path_factory.mktemp("cli")
    roots = {}
    for pkg in ("jax", "port"):
        (work / pkg).mkdir()
    run_both(["create-project", "Cli", "ann", source_video, "--wd",
              work / "jax"],
             ["create-project", "Cli", "ann", source_video, "--wd",
              work / "port"])
    for pkg in ("jax", "port"):
        (roots[pkg],) = (work / pkg).glob("Cli-ann-*")
    assert roots["jax"].name == roots["port"].name
    assert_same_tree(roots["jax"], roots["port"])
    bodyparts = ["bp0", "bp1", "bp2"]
    for root in roots.values():
        raw = yaml.safe_load((root / "config.yaml").read_text())
        raw.update(bodyparts=bodyparts, skeleton=[["bp0", "bp1"]],
                   numframes2pick=8, TrainingFraction=[0.75])
        (root / "config.yaml").write_text(yaml.safe_dump(raw,
                                                         sort_keys=False))
    run_both(["extract-frames", roots["jax"] / "config.yaml", "-a",
              "uniform"],
             ["extract-frames", roots["port"] / "config.yaml", "-a",
              "uniform"])
    assert_same_tree(roots["jax"], roots["port"])
    # the labels: the synthetic dots' positions at the extracted frames
    track = synthetic_track(24, HW, 3)
    from deepgraphpose_tpu_torch.data.project import (
        Labels, write_collected_data_csv)

    for root in roots.values():
        vdir = root / "labeled-data" / "synthvid"
        pngs = sorted(vdir.glob("img*.png"))
        assert len(pngs) == 8
        write_collected_data_csv(
            vdir / "CollectedData_ann.csv",
            Labels("ann", bodyparts,
                   [f"labeled-data/synthvid/{p.name}" for p in pngs],
                   track[[int(p.stem[3:]) for p in pngs]]))
    with seeded_splits():
        run_both(["create-training-dataset", roots["jax"] / "config.yaml",
                  "--net-type", "resnet_tiny"],
                 ["create-training-dataset", roots["port"] / "config.yaml",
                  "--net-type", "resnet_tiny"])
    return {**roots, "dir": work}


def test_project_files_match(workflow):
    """create-project -> extract-frames -> create-training-dataset: the
    same files, YAML, CSV, .mat and Documentation pickle (its split) in
    both projects."""
    assert_same_tree(workflow["jax"], workflow["port"])
    (doc,) = workflow["port"].rglob("Documentation_data-*.pickle")
    with open(doc, "rb") as f:
        import pickle

        _, train_idx, test_idx, frac = pickle.load(f)
    assert len(train_idx) == 6 and len(test_idx) == 2 and frac == 0.75
    _, cfg, _ = resolve_project(workflow["port"])
    assert cfg.net_type == "resnet_tiny"


def test_train_step0_matches(workflow, tmp_path):
    """train --step 0 --maxiters 2 through both CLIs, each from its own
    package's seeded init: the same snapshot files, the same variable
    names and shapes, the same learning_stats header and rows of
    iterations, finite losses."""
    roots = twins(workflow["jax"], tmp_path)
    with tiny_blocks():
        run_both(["train", roots["jax"] / "config.yaml", "--step", "0",
                  "--maxiters", "2", "--displayiters", "1"],
                 ["train", roots["port"] / "config.yaml", "--step", "0",
                  "--maxiters", "2", "--displayiters", "1"])
    dirs = {pkg: Path(resolve_project(r)[2])
            for pkg, r in roots.items()}
    names = {pkg: sorted(p.name for p in d.iterdir())
             for pkg, d in dirs.items()}
    assert names["port"] == names["jax"]
    assert "snapshot-step0-final--0.ckpt" in names["port"]
    trees = {pkg: ckpt.load_snapshot(d / "snapshot-step0-final--0.ckpt")
             for pkg, d in dirs.items()}

    def shapes(tree):
        return {"/".join(k): np.shape(v)
                for part in tree if part is not None
                for k, v in ckpt._flatten(part)}

    assert shapes(trees["port"]) == shapes(trees["jax"])
    stats = {pkg: (d / "learning_stats.csv").read_text().splitlines()
             for pkg, d in dirs.items()}
    assert stats["port"][0] == stats["jax"][0]
    assert [r.split(",")[0] for r in stats["port"]] == \
        [r.split(",")[0] for r in stats["jax"]]
    for row in stats["port"][1:]:
        assert all(np.isfinite(float(v)) for v in row.split(",")[1:])


@pytest.fixture(scope="module")
def analysis(workflow, tmp_path_factory):
    """Both projects with one JAX random-init resnet_tiny snapshot (heads
    scaled as in tests/test_torch_analyze.py) as the step-2 final, and
    analyze-videos of each CLI into ``<project>/analysis``."""
    roots = twins(workflow["jax"], tmp_path_factory.mktemp("cli_analysis"))
    with tiny_blocks():
        _, cfg, _ = jax_resolve(roots["jax"], 1)
        _, variables = jax_init_model(cfg, jax.random.PRNGKey(0), HW)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    for name, factor in (("part_pred", 0.1), ("locref_pred", 0.05)):
        head = variables["params"][name]["block4"]
        head["kernel"] = head["kernel"] * np.float32(factor)
        head["bias"] = head["bias"] * np.float32(factor)
    for root in roots.values():
        train_dir = Path(jax_resolve(root, 1)[2])
        jax_ckpt.save_snapshot(train_dir, 2, "final--0", variables)
    argv = {pkg: ["analyze-videos", root / "config.yaml",
                  root / "videos" / "synthvid.avi", "--destfolder",
                  root / "analysis"] for pkg, root in roots.items()}
    with tiny_blocks():
        run_both(argv["jax"], argv["port"])
    (h5,) = (roots["port"] / "analysis").glob("*.h5")
    return {**roots, "stem": h5.stem}


def _tables(roots, folder, stem):
    out = {}
    for pkg, root in roots.items():
        out[pkg] = export.read_pose_table(root / folder / f"{stem}.h5")
        csv = export.load_pose_from_dlc(str(root / folder / f"{stem}.csv"))
        for key in ("x", "y", "likelihoods"):
            np.testing.assert_array_equal(csv[key], out[pkg][2][key])
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][3] == out["jax"][3]
    return out["port"][2], out["jax"][2]


def _close(got, want, xy_tol, lik_tol):
    assert got["x"].shape == want["x"].shape == (24, 3)
    for key in ("x", "y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=xy_tol)
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=0, atol=lik_tol)


def test_analyze_videos_matches(analysis):
    roots = {k: analysis[k] for k in ("jax", "port")}
    got, want = _tables(roots, "analysis", analysis["stem"])
    _close(got, want, XY_TOL, LIK_TOL)
    names = {pkg: sorted(p.name for p in (r / "analysis").iterdir())
             for pkg, r in roots.items()}
    assert names["port"] == names["jax"]


def test_analyze_videos_int8_matches(analysis, tmp_path, monkeypatch):
    """analyze-videos --int8: the JAX CLI calibrates its own int8 state;
    the port's CLI runs with that state carried in
    (``quant_state_from_flax``), as ROADMAP's int8 caveat asks. The port's
    own calibration is held by tests/test_torch_analyze.py."""
    roots = twins(analysis["port"], tmp_path)
    made = {}
    make = jax_quant.quantize_model

    def recording(*args, **kw):
        made["jax"] = out = make(*args, **kw)
        return out
    monkeypatch.setattr(jax_quant, "quantize_model", recording)

    def with_jax_state(cfg_, model, calib, dtype, residual_int8):
        qvars = jax.tree_util.tree_map(np.asarray, made["jax"][1])
        qmodel = quant.QuantizedPoseModel(cfg_, dtype=dtype,
                                          residual_int8=residual_int8)
        qmodel.load_state_dict(ckpt.quant_state_from_flax(qvars),
                               strict=True)
        return qmodel.eval()
    monkeypatch.setattr(quant, "quantize_model", with_jax_state)
    argv = {pkg: ["analyze-videos", root / "config.yaml",
                  root / "videos" / "synthvid.avi", "--int8",
                  "--destfolder", root / "int8"]
            for pkg, root in roots.items()}
    with tiny_blocks():
        run_both(argv["jax"], argv["port"])
    got, want = _tables(roots, "int8", analysis["stem"])
    _close(got, want, INT8_XY_TOL, INT8_LIK_TOL)


def test_evaluate_matches(analysis, tmp_path):
    """evaluate --out through both CLIs from the JAX-written snapshot: the
    same frames and splits, per-frame RMSE within the float32 analysis
    bound plus the CSV's 3-decimal rounding. (A project built by
    create-training-dataset has no merged CollectedData next to its
    training set, so both packages evaluate the .mat's 6 training frames
    only, and report no test error.)"""
    import csv

    roots = twins(analysis["port"], tmp_path)
    argv = {pkg: ["evaluate", root / "config.yaml", "--out",
                  root / "rmse.csv"] for pkg, root in roots.items()}
    with tiny_blocks():
        run_both(argv["jax"], argv["port"])
    rows = {pkg: list(csv.reader(open(root / "rmse.csv")))
            for pkg, root in roots.items()}
    assert len(rows["port"]) == len(rows["jax"]) == 1 + 6
    for got, want in zip(rows["port"], rows["jax"]):
        assert got[:2] == want[:2]
        if got[0] == "frame":
            assert got == want
            continue
        np.testing.assert_allclose(
            [float(v) if v else np.nan for v in got[2:]],
            [float(v) if v else np.nan for v in want[2:]],
            rtol=0, atol=XY_TOL + 1e-3)


# ---------------------------------------------------------------------------
# (c) the commands after an analysis, and export-model
# ---------------------------------------------------------------------------

def test_filter_and_skeleton_match(analysis, tmp_path):
    """filter-predictions (median and kalman) and analyze-skeleton through
    both CLIs on one analysis (the JAX CLI's, beside the video in both
    projects): equal files."""
    roots = twins(analysis["jax"], tmp_path)
    for root in roots.values():
        for p in (root / "analysis").glob(f"{analysis['stem']}.*"):
            shutil.copy(p, root / "videos" / p.name)
    for extra in ([], ["--filtertype", "kalman", "--windowlength", "7"]):
        argv = {pkg: ["filter-predictions", root / "config.yaml",
                      root / "videos" / "synthvid.avi", *extra]
                for pkg, root in roots.items()}
        run_both(argv["jax"], argv["port"])
    argv = {pkg: ["analyze-skeleton", root / "config.yaml",
                  root / "videos" / "synthvid.avi"]
            for pkg, root in roots.items()}
    run_both(argv["jax"], argv["port"])
    written = sorted(p.name for p in (roots["port"] / "videos").iterdir())
    assert any(n.endswith("filtered.h5") for n in written)
    assert any(n.endswith("_skeleton.csv") for n in written)
    assert_same_tree(roots["jax"] / "videos", roots["port"] / "videos")


def test_export_model_cpu(analysis, tmp_path):
    """export-model --device cpu: the artifact serves what the live model
    computes on the same frames; a platform other than the device's is
    refused."""
    from deepgraphpose_tpu_torch.data.video import VideoReader
    from deepgraphpose_tpu_torch.infer import predict, serving
    from deepgraphpose_tpu_torch.infer.predict import load_model

    root = analysis["port"]
    out = tmp_path / "pose.pt2"
    with tiny_blocks():
        assert cli.main(["export-model", str(root / "config.yaml"), str(out),
                         "--batch-size", "4", "--device", "cpu"]) == 0
        call, meta = serving.load_infer_artifact(out)
        assert meta["input_shape"] == [4, *HW, 3]
        assert meta["platforms"] == ["cpu"] and not meta["quantized_int8"]
        reader = VideoReader(root / "videos" / "synthvid.avi")
        frames = np.stack([reader.read_frame(i) for i in range(4)])
        reader.close()
        x = torch.from_numpy(frames)
        mu, lik = call(x)
        _, cfg, train_dir = resolve_project(root)
        model = load_model(cfg, Path(train_dir) /
                           "snapshot-step2-final--0.ckpt", torch.float32,
                           "cpu")
        want_mu, want_lik = predict.infer_forward(model, cfg, x)
        np.testing.assert_allclose(mu.numpy(), want_mu.numpy(), rtol=0,
                                   atol=SERVE_TOL)
        np.testing.assert_allclose(lik.numpy(), want_lik.numpy(), rtol=0,
                                   atol=SERVE_TOL)
        with pytest.raises(ValueError, match="platforms"):
            cli.main(["export-model", str(root / "config.yaml"),
                      str(tmp_path / "x.pt2"), "--platforms", "cuda",
                      "--device", "cpu"])
        # a missing snapshot is a FileNotFoundError, never the init weights
        with pytest.raises(FileNotFoundError):
            cli.main(["export-model", str(root / "config.yaml"),
                      str(tmp_path / "y.pt2"), "--snapshot", "nope",
                      "--device", "cpu"])


def test_run_demo_calls_the_port_demo(monkeypatch, tmp_path):
    from deepgraphpose_tpu_torch import demo

    seen = []
    monkeypatch.setattr(demo, "main", lambda argv: seen.append(argv) or 0)
    assert cli.main(["run-demo", "--dlcpath", str(tmp_path), "--test",
                     "--batch-size", "3", "--device", "cpu"]) == 0
    assert seen == [["--dlcpath", str(tmp_path), "--shuffle", "1",
                     "--batch_size", "3", "--test", "--device", "cpu"]]


# ---------------------------------------------------------------------------
# the top-level names and compat.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(set(jax_pkg._LAZY_API)
                                        | set(REFERENCE_EXPORTS)))
def test_top_level_name_resolves(name):
    assert name in dir(port_pkg)
    value = getattr(port_pkg, name)
    assert callable(value) or hasattr(value, "show"), name
    module = getattr(value, "__module__", None) or value.__name__
    assert module.startswith("deepgraphpose_tpu_torch"), (name, module)


def test_compat_project_helpers_match(tmp_path):
    """load_demo_data, adddatasetstovideolistandviceversa,
    create_training_model_comparison and return_train_network_path of both
    packages on copies of one project: equal results and files."""
    root, _, _ = make_synthetic_project(tmp_path / "src" / "proj",
                                        n_frames=20, n_labeled=4, hw=HW)
    out = {}
    for pkg, mod in (("jax", jax_pkg), ("port", port_pkg)):
        moved = tmp_path / pkg / "moved"
        shutil.copytree(root, moved)
        mod.load_demo_data(moved / "config.yaml", createtrainingset=False)
        cfg = yaml.safe_load((moved / "config.yaml").read_text())
        assert cfg["project_path"] == str(moved)
        (moved / "labeled-data" / "orphanvid").mkdir()
        cfg["video_sets"]["videos/ghost.avi"] = {"crop": "0, 10, 0, 10"}
        (moved / "config.yaml").write_text(yaml.safe_dump(cfg,
                                                          sort_keys=False))
        out[pkg] = [mod.adddatasetstovideolistandviceversa(
            moved / "config.yaml", width=80, height=64)]
        out[pkg].append(mod.create_training_model_comparison(
            moved / "config.yaml", num_shuffles=1, seed=0,
            net_types=["resnet_50", "mobilenet_v2_0.35"]))
        tr, te, td = mod.return_train_network_path(moved / "config.yaml",
                                                   shuffle=2)
        assert tr.exists() and td.is_dir()
        out[pkg].append([p.relative_to(moved) for p in (tr, te, td)])
    assert_same_value(out["port"], out["jax"])
    assert out["port"][0] == (1, 1) and out["port"][1] == [1, 2]
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_create_pretrained_human_project_matches(tmp_path):
    """The local-checkpoint human project of both packages: equal config,
    pose_cfg files and the snapshot copied under the naming contract."""
    import cv2

    vid = tmp_path / "person.avi"
    wr = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (64, 48))
    for _ in range(4):
        wr.write(np.zeros((48, 64, 3), np.uint8))
    wr.release()
    snap = tmp_path / "mpii-local.ckpt"
    snap.write_bytes(b"msgpack-snapshot-bytes")
    out = {}
    for pkg, mod in (("jax", jax_pkg), ("port", port_pkg)):
        cfg_path, pose_cfg = mod.create_pretrained_human_project(
            "human", "tester", [str(vid)],
            working_directory=str(tmp_path / pkg), copy_videos=True,
            analyzevideo=False, createlabeledvideo=False,
            ckpt_path=str(snap))
        out[pkg] = (Path(cfg_path).relative_to(tmp_path / pkg),
                    Path(pose_cfg).relative_to(tmp_path / pkg))
        train_dir = Path(pose_cfg).parent
        assert (train_dir / "snapshot-step0-final--0.ckpt").read_bytes() \
            == b"msgpack-snapshot-bytes"
    assert out["port"] == out["jax"]
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    from deepgraphpose_tpu.compat import MPII_BODYPARTS as jax_mpii
    from deepgraphpose_tpu_torch.compat import MPII_BODYPARTS, MPII_SKELETON

    assert MPII_BODYPARTS == jax_mpii and len(MPII_SKELETON) == 13


def test_video_utilities_match(tmp_path):
    """ShortenVideo and DownSampleVideo (the DLC spellings of PR 13's
    video utilities) write what the JAX package's write."""
    root, _, _ = make_synthetic_project(tmp_path / "p", n_frames=30,
                                        n_labeled=2, hw=HW)
    video = Path(root) / "videos" / "synthvid.avi"
    for pkg, mod in (("jax", jax_pkg), ("port", port_pkg)):
        (tmp_path / pkg).mkdir()
        mod.ShortenVideo(str(video), start="00:00:00.2", stop="00:00:01",
                         outpath=str(tmp_path / pkg))
        mod.DownSampleVideo(str(video), width=32, height=-1,
                            outpath=str(tmp_path / pkg))
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
