"""DLC project label and training-set files, read and written.

The port's own copy of ``deepgraphpose_tpu/data/project.py``:

* ``CollectedData_{scorer}.csv``: 3 header rows (scorer / bodyparts /
  coords), one row per labeled image (ref layout:
  labeled-data/{video}/CollectedData_*.csv);
* its ``.h5`` twin in pandas' fixed format, through raw h5py (no pytables);
* the training ``.mat`` (DLC MatlabData, through scipy.io) and its
  Documentation pickle (``project.py:255-359``), which ``fit_dlc`` reads.

``h5py`` is imported inside the H5 functions and ``scipy.io`` inside the
``.mat`` functions.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class Labels:
    """Labeled keypoints for one video's frames."""

    scorer: str
    bodyparts: list
    image_paths: list          # relative paths like labeled-data/vid/img001.png
    coords_xy: np.ndarray      # (n_frames, nj, 2) pixel (x, y); NaN = unlabeled

    @property
    def frame_indices(self) -> np.ndarray:
        """Frame numbers parsed from imgNNN.png names."""
        out = []
        for p in self.image_paths:
            stem = Path(p).stem
            digits = "".join(ch for ch in stem if ch.isdigit())
            out.append(int(digits) if digits else -1)
        return np.asarray(out, dtype=np.int64)


def read_collected_data_csv(path: str | Path) -> Labels:
    """Parse a DLC CollectedData CSV."""
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    scorer_row, bp_row, coord_row = rows[0], rows[1], rows[2]
    scorer = next(x for x in scorer_row[1:] if x)
    bodyparts: list[str] = []
    for bp in bp_row[1:]:
        if bp and (not bodyparts or bodyparts[-1] != bp):
            bodyparts.append(bp)
    nj = len(bodyparts)
    assert coord_row[1:1 + 2 * nj][0] in ("x", "y")

    image_paths = []
    coords = []
    for row in rows[3:]:
        if not row or not row[0]:
            continue
        image_paths.append(row[0])
        vals = [float(v) if v not in ("", "nan") else np.nan
                for v in row[1:1 + 2 * nj]]
        coords.append(vals)
    arr = np.asarray(coords, dtype=np.float64).reshape(len(image_paths), nj, 2)
    return Labels(scorer=scorer, bodyparts=bodyparts, image_paths=image_paths,
                  coords_xy=arr)


def write_collected_data_csv(path: str | Path, labels: Labels) -> None:
    import csv

    nj = len(labels.bodyparts)
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["scorer"] + [labels.scorer] * (2 * nj))
        wr.writerow(["bodyparts"] + [bp for bp in labels.bodyparts for _ in range(2)])
        wr.writerow(["coords"] + ["x", "y"] * nj)
        for p, c in zip(labels.image_paths, labels.coords_xy):
            row = [p]
            for v in c.reshape(-1):
                row.append("" if np.isnan(v) else repr(float(v)))
            wr.writerow(row)


def _h5_str_array(g, name: str, values: list, kind: str = "string",
                  idx_name: str | None = None) -> None:
    """Write a fixed-width bytes array with the pytables/pandas attrs the
    reference's ``pd.read_hdf`` expects on index arrays."""
    import numpy as np

    enc = [str(v).encode("utf-8") for v in values]
    arr = np.asarray(enc, dtype=f"S{max((len(e) for e in enc), default=1)}")
    d = g.create_dataset(name, data=arr)
    d.attrs["CLASS"] = np.bytes_("ARRAY")
    d.attrs["VERSION"] = np.bytes_("2.4")
    d.attrs["TITLE"] = np.bytes_("")
    d.attrs["FLAVOR"] = np.bytes_("numpy")
    d.attrs["kind"] = np.bytes_(kind)
    d.attrs["name"] = np.bytes_(idx_name) if idx_name else np.bytes_("N.")
    d.attrs["transposed"] = False


def _h5_int_array(g, name: str, values) -> None:
    import numpy as np

    d = g.create_dataset(name, data=np.asarray(values, np.int64))
    d.attrs["CLASS"] = np.bytes_("ARRAY")
    d.attrs["VERSION"] = np.bytes_("2.4")
    d.attrs["TITLE"] = np.bytes_("")
    d.attrs["FLAVOR"] = np.bytes_("numpy")
    d.attrs["kind"] = np.bytes_("integer")
    d.attrs["transposed"] = False


def write_collected_data_h5(path: str | Path, labels: Labels,
                            key: str = "df_with_missing") -> None:
    """Write the CollectedData ``.h5`` twin in pandas' fixed format via raw
    h5py (pytables absent here), so a reference DeepLabCut installation's
    ``pd.read_hdf(path, 'df_with_missing')`` consumes this repo's labels
    (ref save paths: gui/labeling_toolbox.py SaveData,
    gui/refinement.py SaveData — both write .h5 + .csv pairs).

    Layout (mirrors pandas.io.pytables BlockManagerFixed.write): group
    ``df_with_missing`` with a 3-level MultiIndex axis0
    (scorer/bodyparts/coords) stored as level+label arrays, the image-path
    index as axis1, one float64 block stored (n_rows, n_cols) with
    ``transposed=True``, and ``block0_items`` mirroring axis0.
    :func:`read_collected_data_h5` is the read side.
    """
    import h5py
    import numpy as np

    nj = len(labels.bodyparts)
    cols_l0 = [labels.scorer]
    cols_l1 = list(labels.bodyparts)
    cols_l2 = ["x", "y"]
    lab0 = [0] * (2 * nj)
    lab1 = [j for j in range(nj) for _ in range(2)]
    lab2 = [0, 1] * nj
    values = labels.coords_xy.reshape(len(labels.image_paths), 2 * nj)

    with h5py.File(path, "w") as f:
        g = f.create_group(key)
        a = g.attrs
        a["CLASS"] = np.bytes_("GROUP")
        a["VERSION"] = np.bytes_("1.0")
        a["TITLE"] = np.bytes_("")
        a["pandas_type"] = np.bytes_("frame")
        a["pandas_version"] = np.bytes_("0.15.2")
        a["encoding"] = np.bytes_("UTF-8")
        a["errors"] = np.bytes_("strict")
        a["ndim"] = np.int64(2)
        a["nblocks"] = np.int64(1)
        a["axis0_variety"] = np.bytes_("multi")
        a["axis0_nlevels"] = np.int64(3)
        a["axis1_variety"] = np.bytes_("regular")
        a["block0_items_variety"] = np.bytes_("multi")
        a["block0_items_nlevels"] = np.int64(3)

        for prefix in ("axis0", "block0_items"):
            _h5_str_array(g, f"{prefix}_level0", cols_l0, idx_name="scorer")
            _h5_str_array(g, f"{prefix}_level1", cols_l1,
                          idx_name="bodyparts")
            _h5_str_array(g, f"{prefix}_level2", cols_l2, idx_name="coords")
            _h5_int_array(g, f"{prefix}_label0", lab0)
            _h5_int_array(g, f"{prefix}_label1", lab1)
            _h5_int_array(g, f"{prefix}_label2", lab2)
        _h5_str_array(g, "axis1", labels.image_paths)

        d = g.create_dataset("block0_values",
                             data=np.asarray(values, np.float64))
        d.attrs["CLASS"] = np.bytes_("ARRAY")
        d.attrs["VERSION"] = np.bytes_("2.4")
        d.attrs["TITLE"] = np.bytes_("")
        d.attrs["FLAVOR"] = np.bytes_("numpy")
        d.attrs["transposed"] = True


def write_collected_data(path_base: str | Path, labels: Labels) -> None:
    """Write the CSV + H5 CollectedData pair, like every reference save
    path (labeling, refinement, conversion tooling)."""
    base = Path(path_base)
    if base.suffix in (".csv", ".h5"):
        base = base.with_suffix("")
    write_collected_data_csv(base.with_suffix(".csv"), labels)
    write_collected_data_h5(base.with_suffix(".h5"), labels)


def read_collected_data_h5(path: str | Path) -> Labels:
    """Read a pandas-written CollectedData H5 via raw h5py (no pytables).

    Supports the 'fixed' format layout pandas uses for MultiIndex frames.
    Falls back to the sibling CSV if parsing fails.
    """
    import h5py

    try:
        with h5py.File(path, "r") as f:
            g = f["df_with_missing"]
            # pandas fixed format: axis0 stores column tuples via level arrays
            if "axis0_label0" not in g:
                raise KeyError("not a fixed-format frame")
            lvl0 = [x.decode() for x in g["axis0_level0"][()]]
            lvl1 = [x.decode() for x in g["axis0_level1"][()]]
            lvl2 = [x.decode() for x in g["axis0_level2"][()]]
            l0 = g["axis0_label0"][()]
            l1 = g["axis0_label1"][()]
            l2 = g["axis0_label2"][()]
            cols = [(lvl0[a], lvl1[b], lvl2[c]) for a, b, c in zip(l0, l1, l2)]
            index = [x.decode() if isinstance(x, bytes) else str(x)
                     for x in g["axis1"][()]]
            values = g["block0_values"][()]
        scorer = cols[0][0]
        bodyparts: list[str] = []
        for _, bp, _ in cols:
            if not bodyparts or bodyparts[-1] != bp:
                bodyparts.append(bp)
        nj = len(bodyparts)
        coords = np.full((len(index), nj, 2), np.nan)
        for ci, (_, bp, coord) in enumerate(cols):
            j = bodyparts.index(bp)
            k = 0 if coord == "x" else 1
            coords[:, j, k] = values[:, ci]
        return Labels(scorer=scorer, bodyparts=bodyparts, image_paths=index,
                      coords_xy=coords)
    except Exception:
        csv_path = Path(path).with_suffix(".csv")
        if csv_path.exists():
            return read_collected_data_csv(csv_path)
        raise


def read_labels(labeled_data_dir: str | Path, scorer: str) -> Labels:
    """Load labels for a video dir, preferring CSV (env has no pytables)."""
    d = Path(labeled_data_dir)
    csv_path = d / f"CollectedData_{scorer}.csv"
    if csv_path.exists():
        return read_collected_data_csv(csv_path)
    h5_path = d / f"CollectedData_{scorer}.h5"
    if h5_path.exists():
        return read_collected_data_h5(h5_path)
    raise FileNotFoundError(f"no CollectedData for scorer {scorer} in {d}")


# ---------------------------------------------------------------------------
# training-set .mat + Documentation pickle
# ---------------------------------------------------------------------------

@dataclass
class TrainingSet:
    """Parsed training dataset (.mat + Documentation pickle)."""

    image_paths: list                    # per item, project-relative
    sizes: np.ndarray                    # (n, 3) channels/height/width
    joints: list                         # per item (k, 3): [joint_id, x, y]
    train_indices: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    test_indices: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    train_fraction: float = 0.95

    def coords_for(self, num_joints: int) -> np.ndarray:
        """(n, nj, 2) pixel (x, y) with NaN for absent joints."""
        out = np.full((len(self.image_paths), num_joints, 2), np.nan)
        for i, j in enumerate(self.joints):
            for row in np.atleast_2d(j):
                jid = int(row[0])
                out[i, jid, 0] = row[1]
                out[i, jid, 1] = row[2]
        return out


def read_training_mat(path: str | Path) -> TrainingSet:
    """Parse the DLC MatlabData training file via scipy.io."""
    import scipy.io as sio

    m = sio.loadmat(path)
    d = m["dataset"]
    image_paths, sizes, joints = [], [], []
    for i in range(d.shape[1]):
        e = d[0, i]
        img = e["image"]
        while isinstance(img, np.ndarray):
            img = img[0]
        image_paths.append(str(img))
        sizes.append(np.asarray(e["size"]).reshape(-1)[:3])
        j = e["joints"]
        while isinstance(j, np.ndarray) and j.dtype == object:
            j = j[0, 0] if j.ndim == 2 else j[0]
        joints.append(np.asarray(j, dtype=np.float64))
    return TrainingSet(image_paths=image_paths,
                       sizes=np.asarray(sizes, dtype=np.int64),
                       joints=joints)


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickler that stubs unavailable classes (e.g. ruamel.yaml scalars)."""

    class _Stub(dict):
        def __setstate__(self, state):
            if isinstance(state, dict):
                self.update(state)

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except Exception:
            return type(name, (self._Stub,), {"__module__": module})


def read_documentation_pickle(path: str | Path) -> tuple:
    """(data, train_indices, test_indices, train_fraction)."""
    with open(path, "rb") as f:
        doc = _TolerantUnpickler(f).load()
    data, train_idx, test_idx, frac = doc[0], doc[1], doc[2], doc[3]
    try:
        frac = float(frac)
    except Exception:
        frac = 0.95
    return data, np.asarray(train_idx), np.asarray(test_idx), frac


def write_documentation_pickle(path: str | Path, data: list,
                               train_idx, test_idx, frac: float) -> None:
    with open(path, "wb") as f:
        pickle.dump([data, np.asarray(train_idx), np.asarray(test_idx),
                     float(frac)], f)


def read_training_set(mat_path: str | Path,
                      doc_path: str | Path | None = None) -> TrainingSet:
    ts = read_training_mat(mat_path)
    if doc_path is not None and Path(doc_path).exists():
        _, tr, te, frac = read_documentation_pickle(doc_path)
        ts.train_indices = tr.astype(np.int64)
        ts.test_indices = te.astype(np.int64)
        ts.train_fraction = frac
    else:
        ts.train_indices = np.arange(len(ts.image_paths), dtype=np.int64)
    return ts


def write_training_mat(path: str | Path, image_paths: list,
                       sizes: np.ndarray, joints: list) -> None:
    """Write a DLC-compatible MatlabData .mat training file."""
    import scipy.io as sio

    items = np.zeros((1, len(image_paths)),
                     dtype=[("image", "O"), ("size", "O"), ("joints", "O")])
    for i, (p, s, j) in enumerate(zip(image_paths, sizes, joints)):
        items[0, i]["image"] = np.asarray([p])
        items[0, i]["size"] = np.asarray(s, dtype=np.int64).reshape(1, 3)
        cell = np.zeros((1, 1), dtype="O")
        cell[0, 0] = np.asarray(j)
        items[0, i]["joints"] = cell
    sio.savemat(path, {"dataset": items})
