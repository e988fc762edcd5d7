"""The port's host data layer against the JAX package's, exactly.

Config (S0), paths, video, project labels, hidden frames, flow, the host
augmenter and the batcher run in both packages on the reference's
synthetic project (``deepgraphpose_tpu/utils/synthetic.py``) or on seeded
numpy inputs. Every comparison is exact: the same arrays, masks and
schedules for the same seed.
"""

import numpy as np
import pytest
import torch

from deepgraphpose_tpu.core import config as jax_config
from deepgraphpose_tpu.core import paths as jax_paths
from deepgraphpose_tpu.data import augment as jax_augment
from deepgraphpose_tpu.data import batcher as jax_batcher
from deepgraphpose_tpu.data import flow as jax_flow
from deepgraphpose_tpu.data import hidden as jax_hidden
from deepgraphpose_tpu.data import project as jax_project
from deepgraphpose_tpu.data import video as jax_video
from deepgraphpose_tpu_torch.core import config as torch_config
from deepgraphpose_tpu_torch.core import paths as torch_paths
from deepgraphpose_tpu_torch.data import augment as torch_augment
from deepgraphpose_tpu_torch.data import batcher as torch_batcher
from deepgraphpose_tpu_torch.data import flow as torch_flow
from deepgraphpose_tpu_torch.data import hidden as torch_hidden
from deepgraphpose_tpu_torch.data import project as torch_project
from deepgraphpose_tpu_torch.data import video as torch_video


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    from deepgraphpose_tpu.utils.synthetic import make_synthetic_project

    root, lab_idx, coords = make_synthetic_project(
        tmp_path_factory.mktemp("torch_data_proj"), n_frames=40,
        n_labeled=6, hw=(64, 80), nj=3)
    return root, lab_idx, coords


def video_path(root):
    return f"{root}/videos/synthvid.avi"


def both(name):
    """(reference, port) config objects read from the project."""
    return (jax_config.read_config(name), torch_config.read_config(name))


def test_skeleton_incidence_matches(project):
    root, _, _ = project
    ref, port = both(f"{root}/config.yaml")
    np.testing.assert_array_equal(port.skeleton_incidence(),
                                  ref.skeleton_incidence())
    for cfg in (ref, port):
        cfg.bodyparts = ["a", "b", "c", "d"]
        cfg.skeleton = [["a", "b"], ["b", "c"], ["d", "a"]]
    got = port.skeleton_incidence()
    np.testing.assert_array_equal(got, ref.skeleton_incidence())
    assert got.shape == (3, 4) and got.dtype == np.float32


def test_paths_match(project):
    root, _, _ = project
    ref, port = both(f"{root}/config.yaml")
    folder_r = jax_paths.training_set_folder(ref)
    folder_p = torch_paths.training_set_folder(port)
    assert folder_p == folder_r
    assert torch_paths.data_and_metadata_filenames(
        folder_p, 0.95, 1, port) == jax_paths.data_and_metadata_filenames(
        folder_r, 0.95, 1, ref)
    for fn in ("train_dir", "test_dir"):
        assert getattr(torch_paths, fn)(root, port, 1, 0) == getattr(
            jax_paths, fn)(root, ref, 1, 0)
    assert torch_paths.labeled_data_dir(root, "synthvid") == (
        jax_paths.labeled_data_dir(root, "synthvid"))
    for ext in ("csv", "h5"):
        assert torch_paths.collected_data_file(
            root, "synthvid", "synth", ext) == jax_paths.collected_data_file(
            root, "synthvid", "synth", ext)
    assert torch_paths.videos_dgp_dir(root) == jax_paths.videos_dgp_dir(root)
    assert torch_paths.videos_pred_dir(root) == jax_paths.videos_pred_dir(
        root)
    for d in (f"{root}/videos", f"{root}/videos_dgp", f"{root}/missing"):
        assert torch_paths.list_videos(d) == jax_paths.list_videos(d)
    assert torch_paths.list_videos(f"{root}/videos") == [video_path(root)]


def test_video_reads_match(project):
    root, lab_idx, _ = project
    ref = jax_video.VideoReader(video_path(root))
    port = torch_video.VideoReader(video_path(root))
    idx = np.array([7, 3, 30, 3, 0])
    np.testing.assert_array_equal(port.read_frames(idx), ref.read_frames(idx))
    # the JPEG cache: the reference's OpenCV decode, frame by frame
    want = sorted(set(int(i) for i in lab_idx) | {0, 39})
    cache_r = jax_video.FrameCache(ref, want)
    cache_p = torch_video.FrameCache(port, want)
    assert cache_p.nbytes == cache_r.nbytes > 0
    assert all(i in cache_p for i in want) and 1 not in cache_p
    got = cache_p.get_batch([want[2], 1, want[0]])
    np.testing.assert_array_equal(got[0], cache_r.get(want[2]))
    np.testing.assert_array_equal(got[1], ref.read_frame(1))
    np.testing.assert_array_equal(got[2], cache_r.get(want[0]))
    ref.close()
    port.close()
    for resize_to in (256, 32, None):
        np.testing.assert_array_equal(
            torch_video.motion_energy(video_path(root), resize_to),
            jax_video.motion_energy(video_path(root), resize_to))


def test_project_labels_roundtrip(project, tmp_path):
    root, lab_idx, coords = project
    d = f"{root}/labeled-data/synthvid"
    ref = jax_project.read_labels(d, "synth")
    port = torch_project.read_labels(d, "synth")
    assert (port.scorer, port.bodyparts, port.image_paths) == (
        ref.scorer, ref.bodyparts, ref.image_paths)
    np.testing.assert_array_equal(port.coords_xy, ref.coords_xy)
    np.testing.assert_array_equal(port.frame_indices, lab_idx)
    # NaN (unlabeled) joints survive both writers, read by the other side
    labels = torch_project.Labels(
        scorer="s", bodyparts=["a", "b"],
        image_paths=["labeled-data/v/img004.png", "labeled-data/v/img017.png"],
        coords_xy=np.array([[[1.5, 2.25], [np.nan, np.nan]],
                            [[3.0, np.nan], [7.125, 8.0]]]))
    torch_project.write_collected_data(tmp_path / "CollectedData_s", labels)
    for read in (jax_project.read_collected_data_csv,
                 jax_project.read_collected_data_h5):
        got = read(tmp_path / ("CollectedData_s." + (
            "csv" if read.__name__.endswith("csv") else "h5")))
        assert got.image_paths == labels.image_paths
        np.testing.assert_array_equal(got.coords_xy, labels.coords_xy)
    jax_project.write_collected_data_h5(tmp_path / "ref.h5", labels)
    got = torch_project.read_collected_data_h5(tmp_path / "ref.h5")
    assert (got.scorer, got.bodyparts) == ("s", ["a", "b"])
    np.testing.assert_array_equal(got.coords_xy, labels.coords_xy)
    assert torch_project.read_labels(tmp_path, "s").image_paths == (
        labels.image_paths)
    with pytest.raises(FileNotFoundError):
        torch_project.read_labels(tmp_path, "nobody")


def test_hidden_frames_match(project, tmp_path):
    root, lab_idx, _ = project
    rng = np.random.default_rng(3)
    anchors = np.array([0, 5, 6, 38])
    np.testing.assert_array_equal(
        torch_hidden.neighboring_window(anchors, 2, 40),
        jax_hidden.neighboring_window(anchors, 2, 40))
    rank = rng.permutation(200)
    for ns, n_max, jump in ((3, 60, None), (5, 200, 2), (10, 30, None)):
        np.testing.assert_array_equal(
            torch_hidden.select_hidden_frames(lab_idx, rank, 200, ns, n_max,
                                              jump),
            jax_hidden.select_hidden_frames(lab_idx, rank, 200, ns, n_max,
                                            jump))
    got = torch_hidden.hidden_frames_for_video(
        video_path(root), lab_idx, 40, 2, 36, cache_dir=tmp_path / "p")
    want = jax_hidden.hidden_frames_for_video(
        video_path(root), lab_idx, 40, 2, 36, cache_dir=tmp_path / "r")
    np.testing.assert_array_equal(got, want)
    assert got.size > 0
    np.testing.assert_array_equal(  # and again from the port's .npy cache
        torch_hidden.hidden_frames_for_video(
            video_path(root), lab_idx, 40, 2, 36, cache_dir=tmp_path / "p"),
        want)


def test_flow_matches(project):
    root, _, _ = project
    frames = jax_video.VideoReader(video_path(root)).read_frames(
        np.arange(10, 14))
    got = torch_flow.flow_magnitude_sequence(frames)
    np.testing.assert_array_equal(
        got, jax_flow.flow_magnitude_sequence(frames))
    assert got.shape == (3, 64, 80) and got.dtype == np.float32
    assert torch_flow.flow_magnitude_sequence(frames[:1]).shape == (0, 64, 80)


@pytest.mark.parametrize("apply_prob", [0.8, 1.0])
def test_augmenter_matches(apply_prob):
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 255, (4, 48, 56, 3)).astype(np.float32)
    rc = rng.uniform(1, 5, (4, 3, 2)).astype(np.float32)
    rc[1, 2] = np.nan                       # an unlabeled joint stays NaN
    visible = np.array([True, True, False, True])
    cfg = torch_config.PoseConfig(num_joints=3)
    kw = dict(apply_prob=apply_prob, crop_pad_prob=apply_prob / 2)
    got = torch_augment.Augmenter(**kw)(images, rc, visible, cfg,
                                        rng=np.random.default_rng(9))
    want = jax_augment.Augmenter(**kw)(images, rc, visible, cfg,
                                       rng=np.random.default_rng(9))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.isnan(got[1][1, 2]).all()
    np.testing.assert_array_equal(got[0][2], images[2])   # not visible


def test_scoremap_coords_match():
    xy = np.random.default_rng(2).uniform(0, 200, (5, 3, 2))
    rc = torch_batcher.xy_to_scoremap(xy, 8.0)
    np.testing.assert_array_equal(rc, jax_batcher.xy_to_scoremap(xy, 8.0))
    np.testing.assert_array_equal(torch_batcher.scoremap_to_xy(rc, 8.0),
                                  jax_batcher.scoremap_to_xy(rc, 8.0))
    np.testing.assert_allclose(torch_batcher.scoremap_to_xy(rc, 8.0), xy,
                               rtol=0, atol=1e-12)


def multi_datasets(root, cache_dir):
    """(reference, port) MultiDatasets over the project's video."""
    out = []
    for config, batcher in ((jax_config, jax_batcher),
                            (torch_config, torch_batcher)):
        proj = config.read_config(f"{root}/config.yaml")
        pose = config.PoseConfig(num_joints=3, stride=8.0)
        out.append(batcher.MultiDataset(
            proj, pose, [video_path(root)], ns=3, n_max_frames=30,
            cache_dir=cache_dir))
    return out


def test_multidataset_schedule_and_batches_match(project, tmp_path):
    root, _, _ = project
    ref, port = multi_datasets(root, tmp_path)
    for name in ("n_visible_frames_total", "n_hidden_frames_selected",
                 "n_frames_total", "n_hidden_frames_total"):
        assert getattr(port, name) == getattr(ref, name), name
    np.testing.assert_array_equal(port.batch_ratios, ref.batch_ratios)
    d_r, d_p = ref.datasets[0], port.datasets[0]
    for name in ("visible_frames", "hidden_frames", "chunk", "labels_xy",
                 "labels_rc"):
        np.testing.assert_array_equal(getattr(d_p, name), getattr(d_r, name))
    assert (d_p.nx_out, d_p.ny_out) == (d_r.nx_out, d_r.ny_out)

    args = ([d.visible_frames for d in port.datasets],
            [d.hidden_frames for d in port.datasets],
            [d.chunk for d in port.datasets], 5, 10, 7)
    sched = torch_batcher.generate_batch_schedule(*args, seed=11)
    want = jax_batcher.generate_batch_schedule(*args, seed=11)
    assert len(sched) == len(want) == 7
    for (i, f), (j, g) in zip(sched, want):
        assert i == j
        np.testing.assert_array_equal(f, g)

    for k, (_, frames) in enumerate(sched[:3]):
        vis = np.intersect1d(frames, d_p.visible_frames)
        hid = np.setdiff1d(frames, vis)
        kw = dict(pad_to=6, wt=1.5, compute_flow=True)
        got = torch_batcher.assemble_batch(
            d_p, vis, hid, augmenter=torch_augment.Augmenter(),
            rng=np.random.default_rng(k), **kw)
        want = jax_batcher.assemble_batch(
            d_r, vis, hid, augmenter=jax_augment.Augmenter(),
            rng=np.random.default_rng(k), **kw)
        for name in ("targets", "visible_mask", "hidden_mask", "frame_mask",
                     "wt_batch", "pair_mask", "flow", "frames"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), name)
        # the port's cache decodes with OpenCV; the reference's batch read
        # may take its libjpeg decoder: both against the same frames
        ref_frames = np.stack([d_r.cache.get(int(f)) for f in got.frames
                               if f >= 0])
        plain = torch_batcher.assemble_batch(d_p, vis, hid, pad_to=6)
        np.testing.assert_array_equal(plain.images[:len(ref_frames)],
                                      ref_frames)
        assert got.images.dtype == np.uint8 and got.images.shape[0] == 6

        tensors = got.as_torch(device="cpu")
        for name, value in got.as_np().items():
            assert tensors[name].device.type == "cpu"
            np.testing.assert_array_equal(tensors[name].numpy(), value)
        flow = torch.zeros(5, 64, 80)
        assert got.as_torch(flow=flow, device="cpu")["flow"] is flow


def test_assemble_batch_without_images_and_errors(project, tmp_path):
    root, _, _ = project
    _, port = multi_datasets(root, tmp_path)
    d = port.datasets[0]
    b = torch_batcher.assemble_batch(d, d.visible_frames[:2],
                                     d.hidden_frames[:1], pad_to=4,
                                     with_images=False)
    assert b.images.shape == (4, 1, 1, 3) and b.flow.shape == (3, 1, 1)
    assert b.visible_mask.reshape(4, 3)[:2].all()
    with pytest.raises(ValueError):
        torch_batcher.assemble_batch(d, [], [], pad_to=4)
    with pytest.raises(ValueError):
        torch_batcher.assemble_batch(d, d.visible_frames, [], pad_to=2)


def test_as_torch_needs_the_card_unless_told_cpu(project, tmp_path):
    root, _, _ = project
    _, port = multi_datasets(root, tmp_path)
    d = port.datasets[0]
    b = torch_batcher.assemble_batch(d, d.visible_frames[:1], [], pad_to=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            b.as_torch()
