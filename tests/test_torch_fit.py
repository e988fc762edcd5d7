"""The port's fit loops against the JAX package's, on the CPU.

Both packages train on copies of one synthetic project
(``make_synthetic_project(hw=(48, 64))``) with the one-unit-per-block
ResNet (``resnet_tiny``, registered in both), and warm-start from one
snapshot that the JAX package writes, so ``bn_train`` resolves to off in
both:

* the host feed, the chain fit_dlc (scale jitter) -> fit_dgp_labeledonly
  -> fit_dgp, both DGP steps augmenting on the host, three updates a
  step: the batches come from the same numpy stream, and every logged
  loss (``displayiters=1``) agrees within 1e-4 relative, the final
  parameters within 1e-4 of each tensor's largest value. Steps 0 and 1
  run free (each warm-starts from its own package's snapshot of the step
  before); step 2 warm-starts from the JAX package's step-1 snapshot. Run
  free, step 2 crosses a point where the float32 update jumps: the JAX
  package itself, warm-started 1e-7 relative away from itself, parts
  there as far as the port does, past the 1e-4 bound
  (``test_free_running_chain_parts_as_jax_does`` measures both and holds
  the port to twice JAX's own parting);
* the device-resident pools: a deterministic fit_dlc and fit_dgp(aug=False)
  through the port's pools equal its host feed within 1e-6 of each
  tensor's largest value, and agree with the JAX package's pooled runs
  within the tolerances above;
* the options that raised until their slice (data parallelism and the
  multi-window updates, ROADMAP item 16) run at world 1 (the two-rank
  runs and the JAX parity are ``tests/test_torch_fit_dp.py``'s), and the
  reference's own fallbacks warn as it does (the spill tier, the
  superstep and the device flow have their own files:
  ``tests/test_torch_{spill,superstep,flow_device}.py``).
"""

import contextlib
import shutil
from pathlib import Path

import flax

import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core import checkpoint as jax_ckpt
from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
from deepgraphpose_tpu.models import resnet as jax_resnet
from deepgraphpose_tpu.models.pose_model import PoseModel as JaxPoseModel
from deepgraphpose_tpu.train import fit as jax_fit
from deepgraphpose_tpu.utils.synthetic import make_synthetic_project
from deepgraphpose_tpu_torch.core import checkpoint as ckpt
from deepgraphpose_tpu_torch.core import paths
from deepgraphpose_tpu_torch.models import resnet as torch_resnet
from deepgraphpose_tpu_torch.train import device_data as dd
from deepgraphpose_tpu_torch.train import fit
from test_torch_train import random_variables

LOSS_RTOL = 1e-4           # port against JAX, every logged loss
PARAM_RTOL = 1e-4          # port against JAX, of each tensor's largest value
FEED_RTOL = 1e-6           # the port's pools against its host feed
HW = (48, 64)
WARM = "snapshot-step9-warm"
NUDGED = "snapshot-step9-nudged"   # WARM times (1 + 1e-7 N(0, 1))
NUDGE = 1e-7
CHAIN = [
    ("fit_dlc", 0,
     dict(maxiters=3, displayiters=1, device_data=False, jitter=True)),
    ("fit_dgp_labeledonly", 1, dict(maxiters=3, displayiters=1, nepoch=1,
                                    aug=True, device_data=False)),
    ("fit_dgp", 2, dict(batch_size=3, maxiters=3, displayiters=1, nepoch=1,
                        aug=True, device_data=False)),
]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads while this file runs: the suite runs six files at
    once, and each torch process would otherwise start a thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def tiny_blocks():
    """``resnet_tiny`` registered in both packages while the block runs."""
    tables = (jax_resnet.BLOCK_UNITS, torch_resnet.BLOCK_UNITS)
    for table in tables:
        table["resnet_tiny"] = (1, 1, 1, 1)
    try:
        yield "resnet_tiny"
    finally:
        for table in tables:
            del table["resnet_tiny"]


@pytest.fixture
def tiny_resnet():
    with tiny_blocks() as name:
        yield name


@pytest.fixture
def work(tmp_path):
    """A scratch directory, removed after the test (each fit writes
    snapshots of 32-65 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def base_project(tmp_path_factory):
    """A synthetic project on resnet_tiny with two JAX-written warm-start
    snapshots in its train directory: WARM, and NUDGED 1e-7 relative away
    from it."""
    root, _, _ = make_synthetic_project(tmp_path_factory.mktemp("fit") / "p",
                                        hw=HW)
    _, cfg, train_dir = paths.resolve_project(root)
    cfg.net_type = "resnet_tiny"
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    jm = JaxPoseModel(JaxPoseConfig(net_type="resnet_tiny", num_joints=3))
    with tiny_blocks():
        variables = random_variables(jm, HW, seed=3)
    jax_ckpt.save_snapshot(train_dir, 9, "warm", variables)
    rng = np.random.default_rng(11)
    nudged = {k: (v * (1 + NUDGE * rng.standard_normal(v.shape)))
              .astype(np.float32)
              for k, v in flax.traverse_util.flatten_dict(variables).items()}
    jax_ckpt.save_snapshot(train_dir, 9, "nudged",
                           flax.traverse_util.unflatten_dict(nudged))
    return Path(root)


@pytest.fixture(scope="module")
def jax_chains(base_project, tmp_path_factory):
    """The JAX package's free-running host-fed chain (CHAIN) from WARM and
    from NUDGED: two project roots."""
    work = tmp_path_factory.mktemp("jax_chains")
    roots = []
    with tiny_blocks():
        for warm in (WARM, NUDGED):
            root = project_copy(base_project, work / warm)
            run_chain(jax_fit, root, warm)
            roots.append(root)
    yield roots
    shutil.rmtree(work, ignore_errors=True)


def project_copy(base: Path, dest: Path, **pose_cfg) -> Path:
    shutil.copytree(base, dest)
    _, cfg, train_dir = paths.resolve_project(dest)
    for key, value in pose_cfg.items():
        setattr(cfg, key, value)
    cfg.to_yaml(train_dir / "pose_cfg.yaml")
    return dest


def run_chain(package, root: Path, warm: str, handoff: Path | None = None,
              **device):
    """CHAIN through ``package``'s fit module, each step warm-starting from
    the step before; with ``handoff``, step 2 warm-starts from the step-1
    snapshot in that project instead."""
    for name, step, kw in CHAIN:
        if step == 0:
            kw = dict(kw, snapshot=warm)
        if step == 2 and handoff is not None:
            final = "snapshot-step1-final--0.ckpt"
            shutil.copy(train_dir(handoff) / final, train_dir(root) / final)
        out = getattr(package, name)(dlcpath=root, **kw, **device)
        assert out == train_dir(root) / f"snapshot-step{step}-final--0.ckpt"


def train_dir(root: Path) -> Path:
    return paths.resolve_project(root)[2]


def logged_losses(root: Path) -> list:
    rows = (train_dir(root) / "learning_stats.csv").read_text().split()[1:]
    return [[int(r.split(",")[0]), float(r.split(",")[1])] for r in rows]


def final_params(root: Path, step: int) -> dict:
    path = train_dir(root) / f"snapshot-step{step}-final--0.ckpt"
    return ckpt.state_dict_from_flax(ckpt.load_snapshot(path)[0])


def param_deviation(got: dict, want: dict) -> float:
    """The largest deviation of a tensor, over that tensor's largest
    value."""
    assert set(got) == set(want)
    return max((got[k] - v).abs().max().item() / v.abs().max().item()
               for k, v in want.items())


def assert_params_close(got: dict, want: dict, rtol: float):
    assert set(got) == set(want)
    for key, value in want.items():
        scale = value.abs().max().item()
        assert (got[key] - value).abs().max().item() <= rtol * scale, key


def assert_losses_close(got: list, want: list, rtol: float):
    assert [it for it, _ in got] == [it for it, _ in want]
    for (it, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, rel=rtol), it


def test_host_fed_chain_matches_jax(tiny_resnet, base_project, jax_chains,
                                    work):
    jroot = jax_chains[0]
    troot = project_copy(base_project, work / "torch")
    run_chain(fit, troot, WARM, handoff=jroot, device="cpu")
    for step in range(3):
        assert_params_close(final_params(troot, step),
                            final_params(jroot, step), PARAM_RTOL)
    got, want = logged_losses(troot), logged_losses(jroot)
    assert len(want) == 9 and np.isfinite([v for _, v in got]).all()
    assert_losses_close(got, want, LOSS_RTOL)


def test_free_running_chain_parts_as_jax_does(tiny_resnet, base_project,
                                              jax_chains, work):
    """The divergence trial: the port's chain run free, against the JAX
    package's; and the JAX package's chain from NUDGED against its own from
    WARM. Every logged loss of the port stays within 1e-4 relative of
    JAX's; the port's final parameters of each step part from JAX's by no
    more than 1e-4 of a tensor's largest value or twice the JAX package's
    own parting under the 1e-7 nudge, whichever is larger."""
    jroot, nudged = jax_chains
    troot = project_copy(base_project, work / "torch")
    run_chain(fit, troot, WARM, device="cpu")
    for step in range(3):
        want = final_params(jroot, step)
        port = param_deviation(final_params(troot, step), want)
        own = param_deviation(final_params(nudged, step), want)
        print(f"step {step}: port {port:.4g}, JAX from the nudge {own:.4g}")
        assert port <= max(PARAM_RTOL, 2.0 * own), step
    assert_losses_close(logged_losses(troot), logged_losses(jroot),
                        LOSS_RTOL)


@pytest.mark.parametrize("name", ["fit_dlc", "fit_dgp"])
def test_pooled_matches_host_and_jax(tiny_resnet, base_project, work,
                                     name):
    """A deterministic fit_dlc (fixed sample order, no jitter) and
    fit_dgp(aug=False): no random draw on either feed."""
    kw = (dict(snapshot=WARM, maxiters=4, displayiters=1) if name == "fit_dlc"
          else dict(snapshot=WARM, batch_size=3, maxiters=4, displayiters=1,
                    nepoch=1, aug=False))
    step = 0 if name == "fit_dlc" else 2
    roots = {}
    for feed in ("jax_pool", "pool", "host"):
        roots[feed] = project_copy(base_project, work / feed,
                                   dataset_type="deterministic")
    getattr(jax_fit, name)(dlcpath=roots["jax_pool"], device_data=True, **kw)
    getattr(fit, name)(dlcpath=roots["pool"], device_data=True,
                       device="cpu", **kw)
    getattr(fit, name)(dlcpath=roots["host"], device_data=False,
                       device="cpu", **kw)
    pooled = final_params(roots["pool"], step)
    assert_params_close(pooled, final_params(roots["host"], step), FEED_RTOL)
    assert_params_close(pooled, final_params(roots["jax_pool"], step),
                        PARAM_RTOL)
    assert_losses_close(logged_losses(roots["pool"]),
                        logged_losses(roots["host"]), FEED_RTOL)
    assert_losses_close(logged_losses(roots["pool"]),
                        logged_losses(roots["jax_pool"]), LOSS_RTOL)


def test_pooled_augmented_runs_on_the_pools(tiny_resnet, base_project,
                                            work, capsys):
    """The defaults: fit_dlc picks the labeled pool with scale jitter on the
    device, fit_dgp the frame pool with the reference augmentation there;
    losses stay finite and the step-2 run repeats for one seed."""
    root = project_copy(base_project, work / "p")
    fit.fit_dlc(snapshot=WARM, dlcpath=root, maxiters=3, displayiters=1,
                device="cpu")
    assert "device-resident pool of 6 images" in capsys.readouterr().out
    finals = []
    for debug in ("", "_again"):
        fit.fit_dgp(snapshot="snapshot-step0-final--0", dlcpath=root,
                    batch_size=3, maxiters=3, displayiters=1, nepoch=1,
                    debug=debug, device="cpu")
        assert "on-device augmentation" in capsys.readouterr().out
        path = train_dir(root) / f"snapshot-step2{debug}-final--0.ckpt"
        finals.append(ckpt.state_dict_from_flax(ckpt.load_snapshot(path)[0]))
    assert_params_close(finals[1], finals[0], 0.0)
    assert np.isfinite([v for _, v in logged_losses(root)]).all()


def final_snapshot_loads(root: Path, step: int) -> None:
    """The step's final snapshot loads into a port model whose forward is
    finite."""
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel

    _, cfg, _ = paths.resolve_project(root)
    model = PoseModel(cfg)
    model.load_state_dict(final_params(root, step), strict=True)
    with torch.no_grad():
        out = model.eval()(torch.zeros((1, *HW, 3), dtype=torch.uint8))
    assert torch.isfinite(out["part_pred"]).all()


# the options that raised until their slice (``item``: the ROADMAP item
# that brought them) now run on the CPU, in a data group of world 1
@pytest.mark.parametrize("kw,item", [
    (dict(data_parallel=True), "item 16"),
    (dict(data_parallel=2), "item 16"),
])
def test_fit_dlc_raises_for_later_slices(tiny_resnet, base_project, work,
                                         kw, item):
    """``data_parallel=True`` is the process group's world, 1 here: the
    single-device run, finite losses and a final snapshot that loads.
    ``data_parallel=2`` asks for more ranks than the world has: the
    reference's ValueError (``deepgraphpose_tpu/train/fit.py:82-90``);
    ``tests/test_torch_fit_dp.py`` runs two ranks."""
    root = project_copy(base_project, work / "p")
    if kw["data_parallel"] is not True:
        with pytest.raises(ValueError, match="exceeds the 1 ranks"):
            fit.fit_dlc(snapshot=WARM, dlcpath=root, maxiters=1,
                        device="cpu", **kw)
        return
    fit.fit_dlc(snapshot=WARM, dlcpath=root, maxiters=2, displayiters=1,
                device="cpu", **kw)
    assert np.isfinite([v for _, v in logged_losses(root)]).all()
    final_snapshot_loads(root, 0)


@pytest.mark.parametrize("kw,item", [
    (dict(data_parallel=True), "item 16"),
    (dict(windows_per_device=2), "item 16"),
    (dict(windows_per_device=4, wt=1.0, device_flow=True), "item 16"),
])
def test_fit_dgp_raises_for_later_slices(tiny_resnet, base_project, work,
                                         capsys, kw, item):
    """Each option runs at world 1: ``data_parallel=True`` as the
    single-window run, ``windows_per_device`` as the group update over
    the frame pool (with the device flow for wt > 0); finite losses and a
    final snapshot that loads."""
    root = project_copy(base_project, work / "p")
    fit.fit_dgp(snapshot=WARM, dlcpath=root, batch_size=3, maxiters=8,
                displayiters=1, nepoch=1, device="cpu", **kw)
    out = capsys.readouterr().out
    g = kw.get("windows_per_device", 1)
    assert (f"x {g} windows = {g} windows/update" in out) == (g > 1)
    assert ("on-device LK flow" in out) == ("device_flow" in kw)
    losses = logged_losses(root)
    assert losses and np.isfinite([v for _, v in losses]).all()
    assert [it for it, _ in losses] == list(range(0, len(losses) * g, g))
    final_snapshot_loads(root, 2)


@pytest.mark.parametrize("device_data", [None, True])
def test_fit_dgp_raises_where_the_reference_spills(
        tiny_resnet, base_project, work, monkeypatch, capsys, device_data):
    """Frame pools over the budget rotate through the card in segments
    (``tests/test_torch_spill.py``); where one segment cannot hold a
    window, the reference's plan raises and fit_dgp warns and feeds from
    the host, as the JAX package does."""
    monkeypatch.setattr(dd, "DEFAULT_POOL_BUDGET_BYTES", 1000)
    root = project_copy(base_project, work / "p")
    fit.fit_dgp_labeledonly(snapshot=WARM, dlcpath=root, maxiters=2,
                            displayiters=1, nepoch=1,
                            device_data=device_data, device="cpu")
    out = capsys.readouterr().out
    assert "segment budget" in out and "falling back to host batches" in out
    assert ("using rotating segments" in out) == bool(device_data)
    assert np.isfinite([v for _, v in logged_losses(root)]).all()


def test_reference_fallbacks_warn_and_train(tiny_resnet, base_project,
                                            work, capsys):
    """fit_dlc(aug=True) on the host feed uses jitter only; fit_dgp with
    device_data=True and wt != 0 (no device flow) uses host batches with
    the Farneback flow; a second fit_dgp returns the final snapshot."""
    root = project_copy(base_project, work / "p")
    fit.fit_dlc(snapshot=WARM, dlcpath=root, maxiters=2, displayiters=1,
                device_data=False, aug=True, device="cpu")
    assert "falling back to jitter-only host batches" in \
        capsys.readouterr().out
    kw = dict(snapshot=WARM, dlcpath=root, batch_size=3, maxiters=2,
              displayiters=1, nepoch=1, wt=1.0, device_data=True,
              device="cpu")
    first = fit.fit_dgp(**kw)
    assert "falling back to host batches" in capsys.readouterr().out
    assert fit.fit_dgp(**kw) == first
    assert "exists; skipping" in capsys.readouterr().out
    assert np.isfinite([v for _, v in logged_losses(root)]).all()


def test_fit_needs_a_card_unless_told_the_cpu(base_project,
                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit.fit_dlc(dlcpath=base_project, maxiters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit.fit_dgp_labeledonly(dlcpath=base_project, maxiters=1)
