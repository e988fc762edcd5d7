"""The port's DLC decoders (``ops/decode.py``), ``make_multi_infer_fn`` and
the multi-output export against the JAX package's, on the CPU.

The cases of ``tests/test_decode.py``, on the same seeded numpy inputs in
both packages: integer locations exactly equal, values within 1e-6 (the
same float32 operations in the same order; the numpy loop of the
reference keeps its own 1e-5). A bfloat16 case whose sigmoid saturates
into ties: the port's argmax and top-k pick the cells that ``jnp.argmax``
and ``jax.lax.top_k`` pick, best-first and the lower index first among
equal scores. The multi-output files are byte-equal to the JAX package's
(CSV) and equal dataset by dataset (H5).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgraphpose_tpu.ops import decode as jax_decode
from deepgraphpose_tpu_torch.ops import decode

VAL_TOL = 1e-6


def _np_argmax_decode(part_pred, locref, stride, locref_stdev):
    """The reference loop (predict.py:62-77) for one image."""
    scmap = 1 / (1 + np.exp(-part_pred))
    h, w, nj = scmap.shape
    off = (locref.reshape(h, w, nj, 2) * locref_stdev
           if locref is not None else None)
    out = []
    for j in range(nj):
        r, c = np.unravel_index(np.argmax(scmap[:, :, j]), (h, w))
        o = off[r, c, j][::-1] if off is not None else np.zeros(2)
        pos = np.array([r, c], float) * stride + 0.5 * stride + o
        out.append([pos[1], pos[0], scmap[r, c, j]])
    return np.array(out)


def both(fn_name, *arrays, **kw):
    """(port result, JAX result) as numpy for the same numpy inputs."""
    got = getattr(decode, fn_name)(
        *[None if a is None else torch.from_numpy(a) for a in arrays], **kw)
    want = getattr(jax_decode, fn_name)(
        *[None if a is None else jnp.asarray(a) for a in arrays], **kw)
    if isinstance(got, tuple):
        return ([None if g is None else g.numpy() for g in got],
                [None if w is None else np.asarray(w) for w in want])
    return got.numpy(), np.asarray(want)


def test_argmax_decode_matches_jax_and_reference_loop(rng):
    b, h, w, nj = 3, 10, 14, 4
    part = rng.standard_normal((b, h, w, nj)).astype(np.float32) * 3
    locref = rng.standard_normal((b, h, w, 2 * nj)).astype(np.float32)
    got, want = both("argmax_pose_decode", part, locref, stride=8.0,
                     locref_stdev=7.2801)
    assert got.shape == (b, nj, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=VAL_TOL)
    for i in range(b):
        np.testing.assert_allclose(
            got[i], _np_argmax_decode(part[i], locref[i], 8.0, 7.2801),
            rtol=1e-5, atol=1e-5)


def test_argmax_decode_without_locref(rng):
    part = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    got, want = both("argmax_pose_decode", part, None, stride=4.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=VAL_TOL)
    for i in range(2):
        np.testing.assert_allclose(
            got[i], _np_argmax_decode(part[i], None, 4.0, 0.0), rtol=1e-5)


def test_extract_cnn_output_scaling(rng):
    part = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
    locref = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    (scmap, off), (jscmap, joff) = both("extract_cnn_output", part, locref,
                                        locref_stdev=7.2801)
    np.testing.assert_allclose(scmap, jscmap, rtol=0, atol=VAL_TOL)
    np.testing.assert_allclose(off, joff, rtol=0, atol=VAL_TOL)
    np.testing.assert_allclose(scmap, 1 / (1 + np.exp(-part)), rtol=1e-5)
    np.testing.assert_allclose(off, locref.reshape(1, 4, 4, 2, 2) * 7.2801,
                               rtol=1e-5)
    (_, none), _ = both("extract_cnn_output", part, None)
    assert none is None


def test_get_top_values_order(rng):
    scmap = np.zeros((1, 6, 6, 1), np.float32)
    scmap[0, 2, 3, 0] = 5.0
    scmap[0, 4, 1, 0] = 3.0
    scmap[0, 0, 5, 0] = 1.0
    (Y, X), (jY, jX) = both("get_top_values", scmap, n_top=3)
    assert (Y[0, :, 0].tolist(), X[0, :, 0].tolist()) == ([2, 4, 0],
                                                          [3, 1, 5])
    np.testing.assert_array_equal(Y, jY)
    np.testing.assert_array_equal(X, jX)
    # random maps, several joints: the same locations as jax.lax.top_k
    scmap = rng.standard_normal((3, 9, 11, 4)).astype(np.float32)
    (Y, X), (jY, jX) = both("get_top_values", scmap, n_top=5)
    np.testing.assert_array_equal(Y, jY)
    np.testing.assert_array_equal(X, jX)


def test_multi_pose_decode_first_peak_equals_argmax(rng):
    b, h, w, nj = 2, 9, 11, 3
    part = rng.standard_normal((b, h, w, nj)).astype(np.float32) * 3
    locref = rng.standard_normal((b, h, w, 2 * nj)).astype(np.float32)
    multi, jmulti = both("multi_pose_decode", part, locref, num_outputs=3)
    single, _ = both("argmax_pose_decode", part, locref)
    assert multi.shape == (b, nj, 3, 3)
    np.testing.assert_allclose(multi, jmulti, rtol=0, atol=VAL_TOL)
    np.testing.assert_array_equal(multi[:, :, 0], single)
    assert (np.diff(multi[..., 2], axis=2) <= 0).all()


def test_bf16_saturated_ties_follow_jax(rng):
    """bfloat16 logits of 4-12 saturate the sigmoid, computed in bfloat16 as
    jax.nn.sigmoid computes it, to a few values, mostly 1.0: every joint's
    map is full of ties. The argmax is the first maximum and the top k
    come best-first, the lower flat index first among ties, as
    jnp.argmax and jax.lax.top_k give them."""
    b, h, w, nj = 2, 12, 13, 3
    part = rng.integers(4, 13, (b, h, w, nj)).astype(np.float32)
    locref = rng.standard_normal((b, h, w, 2 * nj)).astype(np.float32)
    part_t = torch.from_numpy(part).to(torch.bfloat16)
    locref_t = torch.from_numpy(locref).to(torch.bfloat16)
    part_j = jnp.asarray(part, jnp.bfloat16)
    locref_j = jnp.asarray(locref, jnp.bfloat16)

    scmap, _ = decode.extract_cnn_output(part_t, locref_t)
    jscmap, _ = jax_decode.extract_cnn_output(part_j, locref_j)
    assert scmap.dtype == torch.bfloat16
    np.testing.assert_array_equal(scmap.float().numpy(),
                                  np.asarray(jscmap, np.float32))
    assert (scmap == 1).float().mean() > 0.5

    Y, X = decode.get_top_values(scmap, 20)
    jY, jX = jax_decode.get_top_values(jscmap, 20)
    np.testing.assert_array_equal(Y.numpy(), np.asarray(jY))
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    flat = (Y * w + X).numpy()
    assert (np.diff(flat, axis=1) > 0).all()   # all ties: index order

    for fn, kw in (("argmax_pose_decode", {}),
                   ("multi_pose_decode", {"num_outputs": 4})):
        got = getattr(decode, fn)(part_t, locref_t, **kw)
        want = getattr(jax_decode, fn)(part_j, locref_j, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=VAL_TOL)


def test_top_k_uses_a_stable_order_on_large_maps():
    """At the full-frame maps' size (94 x 104 cells) with every score
    tied, the top k are the first k cells, as jax.lax.top_k returns."""
    scmap = torch.ones(1, 94, 104, 2)
    Y, X = decode.get_top_values(scmap, 6)
    assert Y[0, :, 0].tolist() == [0] * 6
    assert X[0, :, 1].tolist() == list(range(6))


@pytest.fixture(scope="module")
def resnet_pair():
    """One JAX ResNet-50 init (2 joints, 32x32 frames, the JAX test's) and
    the port's PoseModel with its weights."""
    from deepgraphpose_tpu.core.config import PoseConfig as JaxPoseConfig
    from deepgraphpose_tpu.models.pose_model import init_model
    from deepgraphpose_tpu_torch.core.checkpoint import state_dict_from_flax
    from deepgraphpose_tpu_torch.core.config import PoseConfig
    from deepgraphpose_tpu_torch.models.pose_model import PoseModel

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jcfg = JaxPoseConfig(num_joints=2, net_type="resnet_50",
                         all_joints_names=["a", "b"])
    jmodel, jvars = init_model(jcfg, jax.random.PRNGKey(0), (32, 32))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    for name, factor in (("part_pred", 0.1), ("locref_pred", 0.05)):
        head = jvars["params"][name]["block4"]
        head["kernel"] = head["kernel"] * np.float32(factor)
        head["bias"] = head["bias"] * np.float32(factor)
    cfg = PoseConfig(num_joints=2, net_type="resnet_50",
                     all_joints_names=["a", "b"])
    model = PoseModel(cfg)
    model.load_state_dict(state_dict_from_flax(jvars), strict=True)
    yield jcfg, jmodel, jvars, cfg, model.eval()
    torch.set_num_threads(n)


def test_make_multi_infer_fn_matches_jax(resnet_pair, rng):
    """The model and the top-k decode on the same frames: locations equal,
    x / y within 1e-3 px and likelihood within 1e-4 (float32 convolutions
    summed in another order, as tests/test_torch_infer.py holds them;
    the heads are scaled as in tests/test_torch_analyze.py)."""
    from deepgraphpose_tpu.infer.predict import make_multi_infer_fn as jax_fn
    from deepgraphpose_tpu_torch.infer.predict import make_multi_infer_fn

    jcfg, jmodel, jvars, cfg, model = resnet_pair
    frames = rng.integers(0, 255, (3, 32, 32, 3), dtype=np.uint8)
    got = make_multi_infer_fn(model, cfg, 2)(torch.from_numpy(frames))
    want = np.asarray(jax_fn(jmodel, jcfg, 2)(jvars, jnp.asarray(frames)))
    assert got.shape == (3, 2, 2, 3)
    got = got.numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-4)
    assert (np.diff(got[..., 2], axis=2) <= 0).all()


def test_multi_export_and_read_back_equal_jax(tmp_path, rng):
    from deepgraphpose_tpu.infer import export as jax_export
    from deepgraphpose_tpu_torch.infer import export

    pose = rng.uniform(0, 100, (5, 2, 3, 3))
    jax_export.export_multi_pose_like_dlc(pose, "scorer", ["a", "b"],
                                          str(tmp_path / "jax"))
    export.export_multi_pose_like_dlc(pose, "scorer", ["a", "b"],
                                      str(tmp_path / "port"))
    assert ((tmp_path / "jax.csv").read_bytes()
            == (tmp_path / "port.csv").read_bytes())
    lines = (tmp_path / "port.csv").read_text().splitlines()
    assert lines[2].split(",")[1:10] == ["x", "y", "likelihood", "x2", "y2",
                                         "likelihood2", "x3", "y3",
                                         "likelihood3"]
    with h5py.File(tmp_path / "jax.h5") as a, \
            h5py.File(tmp_path / "port.h5") as b:
        ga, gb = a["df_with_missing"], b["df_with_missing"]
        assert set(ga) == set(gb) and dict(ga.attrs) == dict(gb.attrs)
        assert gb.attrs["num_outputs"] == 3
        for name in ga:
            assert ga[name].dtype == gb[name].dtype
            np.testing.assert_array_equal(ga[name][()], gb[name][()])


def test_read_pose_table_equals_jax(tmp_path, rng):
    """Both packages' readers on each package's single-output files, with
    the default integer index and with image-path strings."""
    from deepgraphpose_tpu.infer import export as jax_export
    from deepgraphpose_tpu_torch.infer import export

    labels = {k: rng.uniform(0, 100, (4, 3))
              for k in ("x", "y", "likelihoods")}
    names = ["a", "b", "c"]
    index = [f"labeled-data/v/img{i:03d}.png" for i in range(4)]
    jax_export.write_pose_h5(tmp_path / "j.h5", "sc", names, labels)
    export.write_pose_h5(tmp_path / "p.h5", "sc", names, labels)
    jax_export.write_pose_h5(tmp_path / "ji.h5", "sc", names, labels,
                             index=index)
    for path in ("j.h5", "p.h5", "ji.h5"):
        got = export.read_pose_table(tmp_path / path)
        want = jax_export.read_pose_table(tmp_path / path)
        assert got[0] == want[0] == "sc" and got[1] == want[1] == names
        assert got[3] == want[3]
        for key in labels:
            np.testing.assert_array_equal(got[2][key], want[2][key])
            np.testing.assert_array_equal(got[2][key], labels[key])
    assert export.read_pose_table(tmp_path / "ji.h5")[3] == index
