"""Trajectory export in DLC format (CSV + HDF5).

ref: eval.py:621-645 (export_pose_like_dlc): a (scorer, bodyparts,
[x, y, likelihood]) MultiIndex table. The files are byte-compatible with
the JAX package's ``infer/export.py``: the CSV writes pandas' MultiIndex
header rows and ``repr`` floats; the H5 is the same h5py layout (group
``df_with_missing`` with ``data``, ``bodyparts``, ``coords``, ``index``
and a ``scorer`` attribute). ``h5py`` is imported where it is used.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _table(labels: dict) -> np.ndarray:
    x, y, lik = labels["x"], labels["y"], labels["likelihoods"]
    n_frames, nj = np.asarray(x).shape
    data = np.empty((n_frames, 3 * nj), dtype=np.float64)
    data[:, 0::3] = x
    data[:, 1::3] = y
    data[:, 2::3] = lik
    return data


def export_pose_like_dlc(labels: dict, scorer: str, joints_names: list,
                         save_file: str) -> None:
    """Write <save_file>.csv and <save_file>.h5."""
    data = _table(labels)
    nj = data.shape[1] // 3
    with open(save_file + ".csv", "w", newline="") as f:
        f.write("scorer," + ",".join([scorer] * 3 * nj) + "\n")
        f.write("bodyparts," + ",".join(
            [bp for bp in joints_names for _ in range(3)]) + "\n")
        f.write("coords," + ",".join(["x", "y", "likelihood"] * nj) + "\n")
        for i in range(data.shape[0]):
            f.write(str(i) + "," + ",".join(repr(float(v))
                                            for v in data[i]) + "\n")
    write_pose_h5(save_file + ".h5", scorer, joints_names, labels)


def write_pose_h5(path: str | Path, scorer: str, joints_names: list,
                  labels: dict, index=None) -> None:
    """Self-describing h5py trajectory table (see module docstring)."""
    import h5py

    data = _table(labels)
    with h5py.File(str(path), "w") as f:
        g = f.create_group("df_with_missing")
        g.attrs["scorer"] = scorer
        g.create_dataset("data", data=data)
        g.create_dataset("bodyparts",
                         data=np.array(joints_names, dtype="S"))
        g.create_dataset("coords", data=np.array(["x", "y", "likelihood"],
                                                 dtype="S"))
        if index is None:
            g.create_dataset("index", data=np.arange(data.shape[0]))
        else:
            g.create_dataset("index", data=np.array(index, dtype="S"))


def read_pose_table(path: str | Path) -> tuple[str, list, dict, list]:
    """(scorer, bodyparts, {'x','y','likelihoods'}, index) from a pose .h5."""
    import h5py

    with h5py.File(str(path), "r") as f:
        g = f["df_with_missing"]
        data = g["data"][()]
        scorer = g.attrs.get("scorer", "")
        if isinstance(scorer, bytes):
            scorer = scorer.decode()
        bodyparts = [b.decode() if isinstance(b, bytes) else str(b)
                     for b in g["bodyparts"][()]]
        index = [i.decode() if isinstance(i, bytes) else i
                 for i in g["index"][()]]
    labels = {"x": data[:, 0::3], "y": data[:, 1::3],
              "likelihoods": data[:, 2::3]}
    return scorer, bodyparts, labels, index


def export_multi_pose_like_dlc(pose: np.ndarray, scorer: str,
                               joints_names: list, save_file: str) -> None:
    """num_outputs > 1 export of (T, nj, k, 3) [x, y, likelihood] per peak.

    Columns as the reference names them (ref: predict_videos.py:188-196):
    per joint ['x', 'y', 'likelihood', 'x2', 'y2', 'likelihood2', ...],
    the first peak unsuffixed. Writes <save_file>.csv and <save_file>.h5
    (``write_multi_pose_h5``).
    """
    t, nj, k, _ = pose.shape
    suffixes = [""] + [str(s + 1) for s in range(1, k)]
    labs = [f"{ax}{s}" for s in suffixes for ax in ("x", "y", "likelihood")]
    flat = pose.reshape(t, nj * 3 * k)       # peak-major within a joint
    with open(save_file + ".csv", "w", newline="") as f:
        f.write("scorer," + ",".join([scorer] * nj * 3 * k) + "\n")
        f.write("bodyparts," + ",".join(
            [bp for bp in joints_names for _ in range(3 * k)]) + "\n")
        f.write("coords," + ",".join(labs * nj) + "\n")
        for i in range(t):
            f.write(str(i) + "," + ",".join(repr(float(v))
                                            for v in flat[i]) + "\n")
    write_multi_pose_h5(save_file + ".h5", scorer, joints_names, flat, labs,
                        k)


def write_multi_pose_h5(path: str | Path, scorer: str, joints_names: list,
                        flat: np.ndarray, labs: list, k: int) -> None:
    """The multi-output table in the h5py layout of ``write_pose_h5``, with
    an ``num_outputs`` attribute and the suffixed ``coords``."""
    import h5py

    with h5py.File(str(path), "w") as f:
        g = f.create_group("df_with_missing")
        g.attrs["scorer"] = scorer
        g.attrs["num_outputs"] = k
        g.create_dataset("data", data=flat)
        g.create_dataset("bodyparts",
                         data=np.array(joints_names, dtype="S"))
        g.create_dataset("coords", data=np.array(labs, dtype="S"))
        g.create_dataset("index", data=np.arange(flat.shape[0]))


def load_pose_from_dlc(filename: str) -> dict:
    """Read a DLC-format trajectory CSV back into {'x','y','likelihoods'}
    (ref: eval.py:648-653 load_pose_from_dlc_to_dict)."""
    with open(filename) as f:
        lines = f.read().strip().split("\n")
    rows = [[float(v) for v in line.split(",")[1:]] for line in lines[3:]]
    arr = np.asarray(rows, dtype=np.float64)
    return {"x": arr[:, 0::3], "y": arr[:, 1::3], "likelihoods": arr[:, 2::3]}


def load_pose_h5(filename: str) -> dict:
    import h5py

    with h5py.File(filename, "r") as f:
        data = f["df_with_missing"]["data"][()]
    return {"x": data[:, 0::3], "y": data[:, 1::3],
            "likelihoods": data[:, 2::3]}
