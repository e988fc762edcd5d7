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
