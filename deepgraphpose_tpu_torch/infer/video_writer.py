"""Labeled-video rendering.

The port's own copy of ``deepgraphpose_tpu/infer/video_writer.py``
(ref: eval.py:816-874 plot_dgp, 46-119 create_annotated_movie, 122-144
the side-by-side comparison; deeplabcut/utils/make_labeled_video.py
CreateVideo). Markers below ``mask_threshold`` likelihood are hidden
(ref: plot_dgp mask_threshold=0.1). The drawing and encoding are OpenCV
on the host; :func:`plot_dgp`'s inference is ``estimate_pose`` on the
card, with the decode kernel.

The default ``jet`` colours are computed here from matplotlib's segment
data, so the labeled video needs no matplotlib; any other colormap name
imports it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepgraphpose_tpu_torch.data.video import VideoReader, write_video

# matplotlib's "jet" (matplotlib/_cm.py): per channel, the (x, y0, y1)
# rows of a LinearSegmentedColormap of N = 256 entries
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
_LUT_N = 256


def _lookup_table(data, n: int = _LUT_N) -> np.ndarray:
    """matplotlib's ``colors._create_lookup_table(n, data)``: y1 of a row
    to y0 of the next, linearly, sampled at n points of [0, 1]."""
    rows = np.asarray(data, dtype=float)
    x, y0, y1 = rows[:, 0] * (n - 1), rows[:, 1], rows[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _jet(value: float) -> tuple:
    """matplotlib's ``colormaps["jet"](value)[:3]`` for value in [0, 1]."""
    i = min(int(np.float64(value) * _LUT_N), _LUT_N - 1)
    return tuple(_lookup_table(_JET_DATA[c])[i]
                 for c in ("red", "green", "blue"))


def colormap_colors(n: int, name: str = "jet") -> list:
    """n RGB tuples 0-255 from a matplotlib colormap ("jet" without
    matplotlib)."""
    if name == "jet":
        cmap = _jet
    else:
        import matplotlib

        cmap = matplotlib.colormaps.get_cmap(name)
    return [tuple(int(255 * c) for c in cmap(i / max(n - 1, 1))[:3])
            for i in range(n)]


def create_annotated_movie(video_file: str | Path, out_file: str | Path,
                           labels: dict, mask_threshold: float = 0.1,
                           dotsize: int = 6, colormap: str = "jet",
                           max_frames: int | None = None) -> Path:
    """Draw per-bodypart circles over every frame and re-encode."""
    import cv2

    reader = VideoReader(video_file)
    x, y, lik = labels["x"], labels["y"], labels["likelihoods"]
    nj = x.shape[1]
    colors = colormap_colors(nj, colormap)
    n = x.shape[0] if max_frames is None else min(max_frames, x.shape[0])

    def frames():
        for i, frame in reader.iter_frames(stop=n):
            frame = frame.copy()
            for j in range(nj):
                if i < len(lik) and lik[i, j] > mask_threshold \
                        and np.isfinite(x[i, j]):
                    cv2.circle(frame, (int(round(x[i, j])),
                                       int(round(y[i, j]))),
                               dotsize, colors[j], -1)
            yield frame

    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    write_video(out_file, frames(), reader.fps,
                (reader.width, reader.height))
    reader.close()
    return out_file


def create_comparison_movie(video_file: str | Path, out_file: str | Path,
                            labels_a: dict, labels_b: dict,
                            mask_threshold: float = 0.1, dotsize: int = 6,
                            max_frames: int | None = None) -> Path:
    """Side-by-side annotated comparison (ref: eval.py:122-144)."""
    import cv2

    reader = VideoReader(video_file)
    nj = labels_a["x"].shape[1]
    colors = colormap_colors(nj)
    n = labels_a["x"].shape[0]
    if max_frames is not None:
        n = min(n, max_frames)

    def draw(frame, labels, i):
        f = frame.copy()
        for j in range(nj):
            if (labels["likelihoods"][i, j] > mask_threshold
                    and np.isfinite(labels["x"][i, j])
                    and np.isfinite(labels["y"][i, j])):
                cv2.circle(f, (int(round(labels["x"][i, j])),
                               int(round(labels["y"][i, j]))),
                           dotsize, colors[j], -1)
        return f

    def frames():
        for i, frame in reader.iter_frames(stop=n):
            yield np.concatenate([draw(frame, labels_a, i),
                                  draw(frame, labels_b, i)], axis=1)

    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    write_video(out_file, frames(), reader.fps,
                (reader.width * 2, reader.height))
    reader.close()
    return out_file


def plot_dgp(video_file: str | Path, output_dir: str | Path,
             proj_cfg_file: str | Path, dgp_model_file: str | Path,
             shuffle: int = 1, save_str: str = "",
             mask_threshold: float = 0.1, dotsize: int = 6,
             max_frames: int | None = None, **estimate_kwargs) -> Path:
    """Run inference (``estimate_pose``, with ``estimate_kwargs``: e.g.
    ``quantize=``, ``device=``), then write the labeled video
    ``<output_dir>/<video stem><save_str>_labeled.mp4``
    (ref: eval.py:816-874)."""
    from deepgraphpose_tpu_torch.infer.predict import estimate_pose

    video_file = Path(video_file)
    output_dir = Path(output_dir)
    labels = estimate_pose(proj_cfg_file, dgp_model_file, video_file,
                           output_dir, shuffle=shuffle, save_str=save_str,
                           max_frames=max_frames, **estimate_kwargs)
    out = output_dir / f"{video_file.stem}{save_str}_labeled.mp4"
    return create_annotated_movie(video_file, out, labels,
                                  mask_threshold=mask_threshold,
                                  dotsize=dotsize, max_frames=max_frames)
