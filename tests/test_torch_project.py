"""The port's DLC project tooling against the JAX package's, on the CPU.

``deepgraphpose_tpu_torch/project/`` and ``utils/experiments.py`` are the
port's own copies of the JAX package's host modules. Each case calls the
JAX package's function on one copy of a synthetic project and the port's
on another, and holds what they return and every file they write equal:
paths, YAML keys and values, CSV text, ``.mat`` and pickle contents, H5
datasets and attributes, PNG bytes, split indices and frame picks. The
cases mirror ``tests/test_project_tooling.py``, ``test_refine.py``,
``test_conversion.py``, ``test_hygiene.py``, ``test_experiments.py`` and
``test_label_server.py``.

The browser UIs (``LabelServer``, the manual frame grab, the crop
selection) bind port 0; every request carries a 10 s timeout, every
server is shut down in a ``finally``, and each such test runs under a
60 s alarm, so none can hang the suite.
"""

import contextlib
import json
import pickle
import shutil
import signal
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import yaml

import deepgraphpose_tpu as jax_pkg
import deepgraphpose_tpu_torch as port_pkg
from deepgraphpose_tpu.data import project as jax_io
from deepgraphpose_tpu.infer import export as jax_export
from deepgraphpose_tpu.project import conversion as jax_conversion
from deepgraphpose_tpu.project import crop_select as jax_crop
from deepgraphpose_tpu.project import extract as jax_extract
from deepgraphpose_tpu.project import hygiene as jax_hygiene
from deepgraphpose_tpu.project import label_server as jax_label
from deepgraphpose_tpu.project import multi_individual as jax_mi
from deepgraphpose_tpu.project import new as jax_new
from deepgraphpose_tpu.project import refine as jax_refine
from deepgraphpose_tpu.project import training_dataset as jax_td
from deepgraphpose_tpu.utils import experiments as jax_exp
from deepgraphpose_tpu_torch.data import project as port_io
from deepgraphpose_tpu_torch.infer import export as port_export
from deepgraphpose_tpu_torch.project import conversion as port_conversion
from deepgraphpose_tpu_torch.project import crop_select as port_crop
from deepgraphpose_tpu_torch.project import extract as port_extract
from deepgraphpose_tpu_torch.project import hygiene as port_hygiene
from deepgraphpose_tpu_torch.project import label_server as port_label
from deepgraphpose_tpu_torch.project import multi_individual as port_mi
from deepgraphpose_tpu_torch.project import new as port_new
from deepgraphpose_tpu_torch.project import refine as port_refine
from deepgraphpose_tpu_torch.project import training_dataset as port_td
from deepgraphpose_tpu_torch.utils import experiments as port_exp
from deepgraphpose_tpu_torch.utils.synthetic import make_synthetic_project

DATE = "2026-08-16"
SERVER_TIMEOUT = 10        # seconds: every request and server wait
TEST_ALARM = 60            # seconds a server test may take in all


# ---------------------------------------------------------------------------
# comparing what the two packages wrote
# ---------------------------------------------------------------------------

def assert_same_value(a, b, where=""):
    """Equal values: numpy arrays by shape, dtype and content (NaN equal
    NaN), containers element by element, everything else by ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        if a.dtype.names:                 # a .mat struct array
            for name in a.dtype.names:
                assert_same_value(a[name], b[name], f"{where}.{name}")
        elif a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                assert_same_value(x, y, f"{where}[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same_value(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_value(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, (where, a, b)


def _h5_contents(path: Path) -> dict:
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: np.asarray(v) for k, v in obj.attrs.items()}
            data = obj[()] if isinstance(obj, h5py.Dataset) else None
            out[name] = (attrs, data)
        f.visititems(visit)
        out["/"] = ({k: np.asarray(v) for k, v in f.attrs.items()}, None)
    return out


def _mat_contents(path: Path) -> dict:
    import scipy.io

    return {k: v for k, v in scipy.io.loadmat(str(path)).items()
            if not k.startswith("__")}


def assert_same_file(a: Path, b: Path, roots: tuple) -> None:
    """One file of each tree: text with the JAX tree's root replaced by
    the port's, YAML as values, H5 / .mat / pickle by content, anything
    else byte for byte."""
    suffix = a.suffix.lower()
    if suffix in (".yaml", ".csv", ".txt", ".json"):
        text = a.read_text().replace(str(roots[0]), str(roots[1]))
        if suffix == ".yaml":
            assert_same_value(yaml.safe_load(text),
                              yaml.safe_load(b.read_text()), str(a))
            return
        assert text == b.read_text(), a
    elif suffix == ".h5":
        assert_same_value(_h5_contents(a), _h5_contents(b), str(a))
    elif suffix == ".mat":
        assert_same_value(_mat_contents(a), _mat_contents(b), str(a))
    elif suffix == ".pickle":
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert_same_value(pickle.load(fa), pickle.load(fb), str(a))
    else:
        assert a.read_bytes() == b.read_bytes(), a


def tree(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*"))


def assert_same_tree(a: Path, b: Path, skip=()) -> None:
    """The two trees hold the same paths, and each file the same content
    (``assert_same_file``), except the relative paths in ``skip``."""
    a, b = Path(a), Path(b)
    assert tree(a) == tree(b)
    for rel in tree(a):
        if rel in skip or (a / rel).is_dir():
            continue
        assert_same_file(a / rel, b / rel, (a, b))


def twins(src: Path, dest: Path) -> dict:
    """Two copies of the project ``src`` under ``dest``, each with its
    own ``project_path``: {"jax": root, "port": root}."""
    roots = {}
    for pkg in ("jax", "port"):
        root = dest / pkg / src.name
        shutil.copytree(src, root)
        cfg = yaml.safe_load((root / "config.yaml").read_text())
        cfg["project_path"] = str(root)
        (root / "config.yaml").write_text(yaml.safe_dump(cfg,
                                                         sort_keys=False))
        roots[pkg] = root
    return roots


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def source_video(tmp_path_factory):
    import cv2

    path = tmp_path_factory.mktemp("srcvid") / "mouse1.avi"
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 20.0,
                         (64, 48))
    rng = np.random.default_rng(3)
    for f in range(50):
        frame = rng.integers(0, 30, (48, 64, 3), dtype=np.uint8)
        cv2.circle(frame, (10 + f, 20), 4, (250, 250, 250), -1)
        wr.write(frame)
    wr.release()
    return path


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root, _, _ = make_synthetic_project(
        tmp_path_factory.mktemp("synth") / "proj", n_frames=20,
        n_labeled=4, hw=(48, 64))
    return Path(root)


@pytest.fixture
def alarm():
    """Fail a test that runs past TEST_ALARM seconds instead of hanging."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {TEST_ALARM} s")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_ALARM)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@contextlib.contextmanager
def recorded_servers(monkeypatch):
    """Record every ``ThreadingHTTPServer`` made inside the block (the
    browser UIs bind port 0 and print their URL): yields a function that
    waits for the next server and returns its base URL."""
    import http.server

    made = []

    class Recorded(http.server.ThreadingHTTPServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(http.server, "ThreadingHTTPServer", Recorded)
    seen = [0]

    def next_url() -> str:
        deadline = time.monotonic() + SERVER_TIMEOUT
        while len(made) <= seen[0]:
            assert time.monotonic() < deadline, "no server started"
            time.sleep(0.02)
        server = made[seen[0]]
        seen[0] += 1
        return f"http://127.0.0.1:{server.server_address[1]}"

    try:
        yield next_url
    finally:
        for server in made:   # a server whose test failed midway
            server.shutdown()
            server.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=SERVER_TIMEOUT) as r:
        return r.status, r.read()


def _post(url, payload=None):
    data = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=SERVER_TIMEOUT) as r:
        return r.status, r.read()


def in_thread(fn, *args, **kwargs):
    """Run ``fn`` on a thread; returns (thread, result dict)."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as e:   # re-raised by the caller
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def joined(t, out):
    t.join(SERVER_TIMEOUT * 2)
    assert not t.is_alive(), "the UI did not return"
    if "error" in out:
        raise out["error"]
    return out["value"]


# ---------------------------------------------------------------------------
# utils/experiments.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [
    {"lr": [0.005, 0.02], "optimizer": ["sgd", "adam"], "ws": 1000.0,
     "multi_step": [[[0.001, 1000]]]},
    {"gm2": [0, 1, 2], "gm3": [0, 3], "wt": [0.0, 1.0]},
    {"net_type": "resnet_50"},
])
def test_create_schedule_matches(grid):
    assert_same_value(port_exp.create_schedule(grid),
                      jax_exp.create_schedule(grid))


@pytest.mark.parametrize("cfg", [
    {"net_type": "resnet_50", "lr": 0.005, "gm2": 2, "aug": True},
    {"net_type": "resnet_50", "eps": 1e-7, "steps": [1, 2, 3]},
    {"z": None, "a": 1.5e12, "m": [0.25, "x"], "b": False},
])
def test_generate_log_id_matches(cfg):
    assert port_exp.generate_log_id(cfg) == jax_exp.generate_log_id(cfg)
    assert port_exp.generate_log_id(dict(reversed(list(cfg.items())))) \
        == port_exp.generate_log_id(cfg)


# ---------------------------------------------------------------------------
# project/new.py, project/extract.py
# ---------------------------------------------------------------------------

def test_create_new_project_matches(tmp_path, source_video):
    paths = {}
    for pkg, new in (("jax", jax_new), ("port", port_new)):
        paths[pkg] = Path(new.create_new_project(
            "Testing", "alice", [str(source_video)],
            working_directory=str(tmp_path / pkg), date=DATE))
    assert paths["port"].parent.name == paths["jax"].parent.name \
        == "Testing-alice-2026-08-16"
    # the config's keys in the JAX package's order, and every value
    jax_text = paths["jax"].read_text().replace(
        str(paths["jax"].parent), str(paths["port"].parent))
    assert paths["port"].read_text() == jax_text
    assert_same_tree(paths["jax"].parent, paths["port"].parent)
    # an existing project is returned as it is; a missing video raises
    for pkg, new in (("jax", jax_new), ("port", port_new)):
        again = new.create_new_project(
            "Testing", "alice", [str(source_video)],
            working_directory=str(tmp_path / pkg), date=DATE)
        assert Path(again) == paths[pkg]
        with pytest.raises(FileNotFoundError):
            new.create_new_project("None", "bob", [str(tmp_path / "no.avi")],
                                   working_directory=str(tmp_path / pkg),
                                   date=DATE)
    # the date defaults to today in both
    today = {pkg: Path(new.create_new_project(
        "Today", "carol", [str(source_video.parent)],
        working_directory=str(tmp_path / pkg), copy_videos=False)).parent.name
        for pkg, new in (("jax", jax_new), ("port", port_new))}
    assert today["port"] == today["jax"]


def test_add_new_videos_matches(tmp_path, source_video, synthetic):
    roots = twins(synthetic, tmp_path)
    for pkg, new in (("jax", jax_new), ("port", port_new)):
        new.add_new_videos(roots[pkg] / "config.yaml", [str(source_video)])
        new.add_new_videos(roots[pkg] / "config.yaml", [str(source_video)],
                           copy_videos=False)
    assert_same_tree(roots["jax"], roots["port"])


@pytest.mark.parametrize("n, k, start, stop", [
    (50, 8, 0.0, 1.0), (50, 60, 0.0, 1.0), (1000, 20, 0.1, 0.6),
    (7, 3, 0.5, 0.5)])
def test_select_frames_uniform_matches(n, k, start, stop):
    assert_same_value(port_extract.select_frames_uniform(n, k, start, stop),
                      jax_extract.select_frames_uniform(n, k, start, stop))


def test_select_frames_kmeans_matches(source_video):
    pytest.importorskip("sklearn")
    for k, step, seed in ((5, 2, 42), (3, 1, 0)):
        got = port_extract.select_frames_kmeans(source_video, k, 0.0, 1.0,
                                                step=step, seed=seed)
        want = jax_extract.select_frames_kmeans(source_video, k, 0.0, 1.0,
                                                step=step, seed=seed)
        assert_same_value(got, want)
        assert 1 <= len(got) <= k and got.max() < 50


@pytest.mark.parametrize("algo", ["uniform", "kmeans"])
def test_extract_frames_matches(tmp_path, source_video, algo):
    if algo == "kmeans":
        pytest.importorskip("sklearn")
    picks = {}
    for pkg, new, extract in (("jax", jax_new, jax_extract),
                              ("port", port_new, port_extract)):
        cfg = Path(new.create_new_project(
            "Testing", "alice", [str(source_video)],
            working_directory=str(tmp_path / pkg), date=DATE))
        raw = yaml.safe_load(cfg.read_text())
        raw["numframes2pick"] = 6
        cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
        picks[pkg] = extract.extract_frames(cfg, algo=algo)
        # a crop stored in the config is applied to the PNGs
        picks[pkg + "_crop"] = extract.extract_frames(
            cfg, algo=algo, crop=True, videos=["videos/mouse1.avi"])
    assert_same_value(
        {Path(k).name: v for k, v in picks["port"].items()},
        {Path(k).name: v for k, v in picks["jax"].items()})
    (idxs,) = picks["port"].values()
    assert (len(idxs) == 6) if algo == "uniform" else (1 <= len(idxs) <= 6)
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("n, frac, seed", [
    (20, 0.8, 0), (20, 0.95, 1), (7, 0.5, 3), (1, 0.8, 2), (100, 0.3, 7)])
def test_split_trials_matches(n, frac, seed):
    got = port_td.split_trials(n, frac, seed=seed)
    assert_same_value(got, jax_td.split_trials(n, frac, seed=seed))
    assert not set(got[0]) & set(got[1])
    assert sorted(set(got[0]) | set(got[1])) == list(range(n))


def _diagonal_labels(root: Path, io) -> None:
    """testscript.py-style labels for every extracted frame, one NaN."""
    proj = yaml.safe_load((root / "config.yaml").read_text())
    frames = sorted((root / "labeled-data" / "mouse1").glob("*.png"))
    nj = len(proj["bodyparts"])
    coords = np.zeros((len(frames), nj, 2))
    for i in range(len(frames)):
        for j in range(nj):
            coords[i, j] = (5 + 3 * j + i, 4 + 2 * j)
    coords[0, -1] = np.nan
    io.write_collected_data_csv(
        root / "labeled-data/mouse1" / f"CollectedData_{proj['scorer']}.csv",
        io.Labels(scorer=proj["scorer"], bodyparts=list(proj["bodyparts"]),
                  image_paths=[f"labeled-data/mouse1/{p.name}"
                               for p in frames],
                  coords_xy=coords))


def test_create_training_dataset_matches(tmp_path, source_video):
    results = {}
    for pkg, new, extract, td, io in (
            ("jax", jax_new, jax_extract, jax_td, jax_io),
            ("port", port_new, port_extract, port_td, port_io)):
        cfg = Path(new.create_new_project(
            "Testing", "alice", [str(source_video)],
            working_directory=str(tmp_path / pkg), date=DATE))
        raw = yaml.safe_load(cfg.read_text())
        raw["numframes2pick"] = 9
        raw["TrainingFraction"] = [0.8, 0.5]
        cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
        extract.extract_frames(cfg, algo="uniform")
        _diagonal_labels(cfg.parent, io)
        merged = td.merge_annotated_datasets(
            (jax_pkg if pkg == "jax" else port_pkg).ProjectConfig.from_yaml(
                cfg), cfg.parent)
        results[pkg] = [merged,
                        td.create_training_dataset(cfg, num_shuffles=2,
                                                   seed=0),
                        td.create_training_dataset(
                            cfg, Shuffles=[5], net_type="mobilenet_v2_0.35",
                            seed=3),
                        td.create_training_dataset(
                            cfg, Shuffles=[7], trainIndexes=[0, 2, 4],
                            testIndexes=[1, 3])]
    assert_same_value(results["port"], results["jax"])
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    mats = list((tmp_path / "port").rglob("*.mat"))
    assert len(mats) == 2 * 2 + 2 + 2


def test_select_crop_parameters_matches(tmp_path, monkeypatch, synthetic,
                                        alarm):
    """``show``'s resolution order ($DGP_CROP, non-interactive full frame,
    the browser's one rectangle clipped to the frame) and
    ``extract_frames(crop=True)``'s write-back, also over a YAML-null
    video entry."""
    assert port_pkg.select_crop_parameters is port_crop
    img = np.zeros((60, 90, 3), np.uint8)
    monkeypatch.setenv("DGP_CROP", "5,80,6,50")
    assert port_crop.show(None, img) == jax_crop.show(None, img) \
        == [5, 80, 6, 50]
    monkeypatch.delenv("DGP_CROP")
    assert port_crop.show(None, img) == jax_crop.show(None, img) \
        == [0, 90, 0, 60]

    got = {}
    with recorded_servers(monkeypatch) as next_url:
        for pkg, crop in (("jax", jax_crop), ("port", port_crop)):
            t, out = in_thread(crop._browser_select, img, port=0,
                               timeout=SERVER_TIMEOUT)
            base = next_url()
            assert b"frame.png" in _get(base + "/")[1]
            assert _get(base + "/frame.png")[1][:4] == b"\x89PNG"
            _post(base + "/api/crop", {"x1": 3.2, "y1": 4.9, "x2": 200.0,
                                       "y2": 30.0})
            got[pkg] = joined(t, out)
    assert got["port"] == got["jax"] == [3, 90, 4, 30]

    roots = twins(synthetic, tmp_path)
    monkeypatch.setenv("DGP_CROP", "2,40,3,30")
    for null_entry in (False, True):
        for pkg, extract in (("jax", jax_extract), ("port", port_extract)):
            cfg = roots[pkg] / "config.yaml"
            raw = yaml.safe_load(cfg.read_text())
            vid = next(iter(raw["video_sets"]))
            if null_entry:
                raw["video_sets"][vid] = None
            else:
                raw["video_sets"][vid].pop("crop", None)
            cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
            extract.extract_frames(cfg, algo="uniform", crop=True)
            raw = yaml.safe_load(cfg.read_text())
            assert raw["video_sets"][vid]["crop"] == "2, 40, 3, 30"
        assert_same_tree(roots["jax"], roots["port"])


def test_extract_frames_manual_matches(tmp_path, monkeypatch, synthetic,
                                       alarm):
    """mode='manual': $DGP_MANUAL_FRAMES, then the scrub-and-grab UI
    driven over HTTP the same way for both packages."""
    roots = twins(synthetic, tmp_path)
    for root in roots.values():
        for d in (root / "labeled-data").glob("*"):
            shutil.rmtree(d)
    got = {}
    monkeypatch.setenv("DGP_MANUAL_FRAMES", "1,5,5,9,400")
    for pkg, extract in (("jax", jax_extract), ("port", port_extract)):
        got[pkg] = extract.extract_frames(roots[pkg] / "config.yaml",
                                          mode="manual")
    monkeypatch.delenv("DGP_MANUAL_FRAMES")
    (picked,) = got["port"].values()
    assert list(picked) == [1, 5, 9]
    assert_same_tree(roots["jax"], roots["port"])

    with recorded_servers(monkeypatch) as next_url:
        for pkg, extract in (("jax", jax_extract), ("port", port_extract)):
            for png in (roots[pkg] / "labeled-data").rglob("*.png"):
                png.unlink()
            t, out = in_thread(extract.extract_frames,
                               roots[pkg] / "config.yaml", mode="manual",
                               port=0, timeout=SERVER_TIMEOUT)
            base = next_url()
            assert b"Grab Frame" in _get(base + "/")[1]
            state = json.loads(_get(base + "/api/state")[1])
            assert state == {"n_frames": 20, "grabbed": []}
            assert _get(base + "/frame/2.png")[1][:4] == b"\x89PNG"
            for i in (2, 7, 99):
                _post(base + "/api/grab", {"index": i})
            _post(base + "/api/done", {})
            got[pkg] = joined(t, out)
    assert_same_value({Path(k).name: v for k, v in got["port"].items()},
                      {Path(k).name: v for k, v in got["jax"].items()})
    assert list(next(iter(got["port"].values()))) == [2, 7]
    assert_same_tree(roots["jax"], roots["port"])


def test_launch_dlc_headless(capsys):
    assert port_pkg.launch_dlc() is None
    out = capsys.readouterr().out
    for name in ("create_new_project", "extract_frames", "label_frames",
                 "create_training_dataset", "analyze_videos",
                 "deepgraphpose_tpu_torch.cli"):
        assert name in out, name


# ---------------------------------------------------------------------------
# project/multi_individual.py
# ---------------------------------------------------------------------------

def test_multi_individual_matches(tmp_path):
    h5py = pytest.importorskip("h5py")
    assert port_pkg.multiple_individual_labeling_toolbox is port_mi
    args = ("Ann", ["single", "m1", "m2"], ["tailbase"], ["nose", "ear"])
    assert port_mi.create_dataframe_columns(*args) \
        == jax_mi.create_dataframe_columns(*args)
    for ind in args[1]:
        assert port_mi.bodyparts_for(ind, args[2], args[3]) \
            == jax_mi.bodyparts_for(ind, args[2], args[3])
    imgs = ["labeled-data/v/img0.png", "labeled-data/v/img1.png"]
    written = {}
    for pkg, mi in (("jax", jax_mi), ("port", port_mi)):
        lab = mi.MultiIndividualLabels.empty(*args, imgs)
        lab.set_label(imgs[0], "m1", "nose", 10.5, 20.25)
        lab.set_label(imgs[1], "single", "tailbase", 1.0, 2.0)
        written[pkg] = lab.save(tmp_path / pkg)
        back = mi.read_multi_individual_csv(written[pkg])
        assert back.columns == lab.columns
        np.testing.assert_array_equal(back.values, lab.values)
    assert written["port"].name == written["jax"].name
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    with h5py.File(tmp_path / "port" / "CollectedData_Ann.h5") as f:
        assert f["df_with_missing"].attrs["axis0_nlevels"] == 4

    # per-individual browser sessions merged into the 4-level file
    for pkg, mi, io in (("jax", jax_mi, jax_io), ("port", port_mi, port_io)):
        proj = tmp_path / f"merge_{pkg}"
        vdir = proj / "labeled-data" / "v"
        vdir.mkdir(parents=True)
        (proj / "config.yaml").write_text(yaml.safe_dump(dict(
            Task="t", scorer="Ann", individuals=["single", "m1"],
            uniquebodyparts=["tailbase"],
            multianimalbodyparts=["nose", "ear"],
            bodyparts=["nose", "ear"], video_sets={})))
        io.write_collected_data(
            vdir / "CollectedData_Ann_idv_single",
            io.Labels("Ann_idv_single", ["tailbase"],
                      ["labeled-data/v/img0.png"], np.array([[[7.0, 8.0]]])))
        io.write_collected_data(
            vdir / "CollectedData_Ann_idv_m1",
            io.Labels("Ann_idv_m1", ["nose", "ear"],
                      ["labeled-data/v/img0.png", "labeled-data/v/img1.png"],
                      np.array([[[1.0, 2.0], [3.0, 4.0]],
                                [[np.nan, np.nan], [5.5, 6.0]]])))
        merged = mi.merge_individual_sessions(proj / "config.yaml", "v")
        assert merged.name == "CollectedData_Ann.csv"
        assert not list(vdir.glob("*_idv_*"))
    assert_same_tree(tmp_path / "merge_jax", tmp_path / "merge_port",
                     skip=("config.yaml",))


# ---------------------------------------------------------------------------
# project/refine.py
# ---------------------------------------------------------------------------

def test_refine_matches(tmp_path, synthetic):
    pytest.importorskip("h5py")
    roots = twins(synthetic, tmp_path)
    out = {}
    for pkg, refine, export, io in (
            ("jax", jax_refine, jax_export, jax_io),
            ("port", port_refine, port_export, port_io)):
        root = roots[pkg]
        vdir = root / "labeled-data" / "synthvid"
        before = io.read_labels(vdir, "synth")
        new_frames = [f"labeled-data/synthvid/img{900 + i:03d}.png"
                      for i in range(2)]
        lik = np.full((3, 3), 0.95)
        lik[1, 0] = 0.1
        export.write_pose_h5(vdir / "machinelabels-iter0.h5", "m",
                             ["bp0", "bp1", "bp2"],
                             {"x": np.full((3, 3), 7.0),
                              "y": np.full((3, 3), 9.0),
                              "likelihoods": lik},
                             index=new_frames + [str(before.image_paths[0])])
        cfg = root / "config.yaml"
        out[pkg] = [refine.accept_machine_labels(cfg, "synthvid",
                                                 likelihood_cutoff=0.5),
                    refine.accept_machine_labels(cfg, "synthvid",
                                                 likelihood_cutoff=0.5),
                    refine.mergeandsplit(cfg, uniform=True),
                    refine.mergeandsplit(cfg, trainindex=0, uniform=False),
                    refine.merge_datasets(cfg),
                    refine.merge_datasets(cfg)]
    assert_same_value(out["port"], out["jax"])
    assert out["port"][:2] == [2, 0] and out["port"][4:] == [1, 2]
    assert_same_tree(roots["jax"], roots["port"])


# ---------------------------------------------------------------------------
# project/hygiene.py
# ---------------------------------------------------------------------------

def test_hygiene_matches(tmp_path, synthetic):
    roots = twins(synthetic, tmp_path)
    out = {}
    for pkg, hygiene, io in (("jax", jax_hygiene, jax_io),
                             ("port", port_hygiene, port_io)):
        root = roots[pkg]
        cfg = root / "config.yaml"
        (root / "labeled-data" / "ghostvid").mkdir()
        vdir = root / "labeled-data" / "synthvid"
        labels = io.read_labels(vdir, "synth")
        io.write_collected_data_csv(
            vdir / "CollectedData_synth.csv",
            io.Labels(scorer="synth", bodyparts=list(labels.bodyparts),
                      image_paths=list(labels.image_paths)
                      + [labels.image_paths[0]],
                      coords_xy=np.concatenate(
                          [labels.coords_xy, labels.coords_xy[:1] + 99])))
        out[pkg] = [hygiene.compare_video_lists_and_data_folders(cfg),
                    hygiene.drop_duplicates_in_annotation_files(cfg)]
        (root / labels.image_paths[0]).unlink()
        out[pkg].append(hygiene.drop_annotations_for_deleted_images(cfg))
        orphan = vdir / "img999.png"
        orphan.write_bytes((root / labels.image_paths[1]).read_bytes())
        found = hygiene.drop_unannotated_images(cfg, delete=False)
        out[pkg].append([p.relative_to(root) for p in found])
        assert orphan.exists()
        hygiene.drop_unannotated_images(cfg, delete=True)
        assert not orphan.exists()
    assert_same_value(out["port"], out["jax"])
    assert out["port"][1:3] == [1, 1]
    assert "ghostvid" in out["port"][0]["folders_without_videos"]
    assert_same_tree(roots["jax"], roots["port"])
    # the DLC spellings reach the same functions
    for alias, name in (
            ("comparevideolistsanddatafolders",
             "compare_video_lists_and_data_folders"),
            ("dropduplicatesinannotatinfiles",
             "drop_duplicates_in_annotation_files"),
            ("dropannotationfileentriesduetodeletedimages",
             "drop_annotations_for_deleted_images")):
        assert_same_value(getattr(port_pkg, alias)(
            roots["port"] / "config.yaml"), getattr(port_pkg, name)(
            roots["port"] / "config.yaml"))
    assert port_pkg.dropimagesduetolackofannotation(
        roots["port"] / "config.yaml") == []


# ---------------------------------------------------------------------------
# project/conversion.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["csv2h5", "csv2h5_scorer", "windows",
                                  "merge_windows"])
def test_conversion_matches(tmp_path, synthetic, case):
    pytest.importorskip("h5py")
    roots = twins(synthetic, tmp_path)
    out = {}
    for pkg, conv, io in (("jax", jax_conversion, jax_io),
                          ("port", port_conversion, port_io)):
        cfg = roots[pkg] / "config.yaml"
        if case == "csv2h5":
            out[pkg] = conv.convertcsv2h5(cfg)
        elif case == "csv2h5_scorer":
            out[pkg] = conv.convertcsv2h5(cfg, scorer="bob")
        elif case == "windows":
            vdir = roots[pkg] / "labeled-data" / "synthvid"
            labels = io.read_labels(vdir, "synth")
            labels.image_paths = [p.replace("/", "\\")
                                  for p in labels.image_paths]
            io.write_collected_data_csv(vdir / "CollectedData_synth.csv",
                                        labels)
            out[pkg] = conv.convertannotationdata_fromwindows2unixstyle(cfg)
        else:
            merged = conv.merge_windowsannotationdataONlinuxsystem(
                dict(project_path=str(roots[pkg]), scorer="synth"))
            out[pkg] = (merged.image_paths, merged.coords_xy)
    assert_same_value(out["port"], out["jax"])
    assert_same_tree(roots["jax"], roots["port"])
    for s in (r"labeled-data\vid\img001.png", "labeled-data/vid/img001.png",
              "C:\\a\\b", ""):
        assert port_conversion.pathmagic(s) == jax_conversion.pathmagic(s)


def test_converth5_to_csv_matches(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(1)
    labels = dict(x=rng.uniform(0, 64, (7, 3)), y=rng.uniform(0, 48, (7, 3)),
                  likelihoods=rng.uniform(0, 1, (7, 3)))
    out = {}
    for pkg, conv, export in (("jax", jax_conversion, jax_export),
                              ("port", port_conversion, port_export)):
        d = tmp_path / pkg
        d.mkdir()
        (d / "myvid.avi").write_bytes(b"stub")
        (d / "other.avi").write_bytes(b"stub")
        export.write_pose_h5(d / "myvidDGP_resnet50.h5", "DGP_resnet50",
                             ["a", "b", "c"], labels)
        out[pkg] = conv.analyze_videos_converth5_to_csv(d)
    assert out["port"] == out["jax"] == 1
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


# ---------------------------------------------------------------------------
# project/label_server.py
# ---------------------------------------------------------------------------

def test_label_server_matches(tmp_path, synthetic, alarm):
    """The labeling UI of each package over real HTTP: the index page, the
    state with preloaded labels, a frame's bytes, a label placed and one
    cleared, then saved; a missing frame is a 404. The saved files and
    every response equal."""
    roots = twins(synthetic, tmp_path)
    got = {}
    for pkg, label in (("jax", jax_label), ("port", port_label)):
        srv = label.LabelServer(roots[pkg], port=0).start()
        try:
            page = _get(srv.url)
            state = json.loads(_get(srv.url + "api/state")[1])
            first = state["frames"][0]
            frame = _get(srv.url + "frame/" + first)
            _post(srv.url + "api/label",
                  {"image": first, "joint": 1, "x": 12.5, "y": 20.25})
            _post(srv.url + "api/label",
                  {"image": first, "joint": 2, "x": None, "y": None})
            saved = _post(srv.url + "api/save")
            with pytest.raises(urllib.error.HTTPError) as missing:
                _get(srv.url + "frame/nope.png")
            after = json.loads(_get(srv.url + "api/state")[1])
        finally:
            srv.stop()
        got[pkg] = [page, state, frame, saved[0],
                    saved[1].decode().replace(str(roots[pkg]), "ROOT"),
                    missing.value.code, after]
    assert_same_value(got["port"], got["jax"])
    assert got["port"][0][0] == 200 and b"<canvas" in got["port"][0][1]
    assert got["port"][1]["bodyparts"] == ["bp0", "bp1", "bp2"]
    assert got["port"][5] == 404
    assert_same_tree(roots["jax"], roots["port"])
    labels = port_io.read_collected_data_csv(
        roots["port"] / "labeled-data" / "synthvid"
        / "CollectedData_synth.csv")
    i = labels.image_paths.index(
        f"labeled-data/synthvid/{got['port'][1]['frames'][0]}")
    np.testing.assert_allclose(labels.coords_xy[i, 1], [12.5, 20.25])
    assert np.isnan(labels.coords_xy[i, 2]).all()


def test_label_state_save_matches(tmp_path, synthetic):
    """``_State.save`` writes the CSV and its H5 twin, and the DLC names
    ``label_frames``/``refine_labels`` serve the same UI."""
    pytest.importorskip("h5py")
    roots = twins(synthetic, tmp_path)
    for pkg, label in (("jax", jax_label), ("port", port_label)):
        state = label._State(roots[pkg], "synthvid", "synth",
                             ["bp0", "bp1", "bp2"])
        out = state.save()
        assert out.with_suffix(".h5").exists()
    assert_same_tree(roots["jax"], roots["port"])
    assert port_pkg.LabelServer is port_label.LabelServer
    served = []

    class Recorder:
        def __init__(self, root, video=None, port=0):
            served.append((Path(root), video, port))

        def serve_forever(self):
            pass

    cfg = roots["port"] / "config.yaml"
    original = port_label.LabelServer
    port_label.LabelServer = Recorder
    try:
        port_pkg.label_frames(cfg, video="synthvid", port=0)
        port_pkg.refine_labels(cfg, port=0)
        port_pkg.launch_dlc(cfg, port=0)
    finally:
        port_label.LabelServer = original
    assert served == [(roots["port"], "synthvid", 0),
                      (roots["port"], None, 0), (roots["port"], None, 0)]
