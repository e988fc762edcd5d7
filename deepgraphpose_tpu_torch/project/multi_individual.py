"""Headless multi-individual labeling
(ref: generate_training_dataset/multiple_individual_labeling_toolbox.py).

The port's own copy of ``deepgraphpose_tpu/project/multi_individual.py``:
host code (numpy, OpenCV), no model and no device.

The reference's wx toolbox labels several individuals per frame and saves a
CollectedData pair whose columns carry a 4-level MultiIndex
(scorer, individuals, bodyparts, coords) — ref: toolbox lines 620-641
(create_dataframe) and 862-872 (saveDataSet). On this display-less host the
same workflow runs as:

* ``show(config, video)`` — one browser labeling session per individual
  (the project/label_server.py UI, scoped to that individual's bodyparts
  and a session scorer), then :func:`merge_individual_sessions` assembles
  the reference 4-level CollectedData CSV + H5 pair;
* programmatic: :class:`MultiIndividualLabels` with ``set_label`` +
  ``save`` for scripted labeling.

Config keys honored exactly as the reference toolbox reads them:
``individuals`` (default ``['single']``), ``uniquebodyparts`` (labeled only
for the ``'single'`` individual), ``multianimalbodyparts`` (every other
individual); a plain single-animal config falls back to ``bodyparts``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

_SESSION_SEP = "_idv_"  # session-scorer suffix for per-individual runs


def _read_multi_cfg(config: str | Path):
    import yaml

    cfg = yaml.safe_load(Path(config).read_text())
    individuals = cfg.get("individuals") or ["single"]
    unique = cfg.get("uniquebodyparts")
    multi = (cfg.get("multianimalbodyparts") or cfg.get("bodyparts") or [])
    return cfg, list(individuals), unique, list(multi)


def bodyparts_for(individual: str, uniquebodyparts, multibodyparts) -> list:
    """The reference's per-individual bodypart choice (toolbox:624-637):
    'single' labels the unique bodyparts when they exist, every other
    individual labels the multi-animal bodyparts."""
    if uniquebodyparts is not None and individual == "single":
        return list(uniquebodyparts)
    return list(multibodyparts)


def create_dataframe_columns(scorer: str, individuals,
                             uniquebodyparts, multibodyparts
                             ) -> list[tuple]:
    """Ordered 4-level column tuples, exactly the reference's
    create_dataframe concat order (toolbox:620-641)."""
    cols = []
    for prefix in individuals:
        for bp in bodyparts_for(prefix, uniquebodyparts, multibodyparts):
            cols.append((scorer, prefix, bp, "x"))
            cols.append((scorer, prefix, bp, "y"))
    return cols


@dataclasses.dataclass
class MultiIndividualLabels:
    """In-memory 4-level CollectedData (rows = images, cols = 4-tuples)."""

    scorer: str
    individuals: list
    uniquebodyparts: list | None
    multibodyparts: list
    image_paths: list
    values: np.ndarray  # (n_images, n_cols) float64, NaN = unlabeled

    @classmethod
    def empty(cls, scorer, individuals, uniquebodyparts, multibodyparts,
              image_paths):
        cols = create_dataframe_columns(scorer, individuals,
                                        uniquebodyparts, multibodyparts)
        vals = np.full((len(image_paths), len(cols)), np.nan)
        return cls(scorer, list(individuals), uniquebodyparts,
                   list(multibodyparts), list(image_paths), vals)

    @property
    def columns(self) -> list[tuple]:
        return create_dataframe_columns(self.scorer, self.individuals,
                                        self.uniquebodyparts,
                                        self.multibodyparts)

    def set_label(self, image_path: str, individual: str, bodypart: str,
                  x: float | None, y: float | None) -> None:
        cols = self.columns
        r = self.image_paths.index(image_path)
        cx = cols.index((self.scorer, individual, bodypart, "x"))
        self.values[r, cx] = np.nan if x is None else float(x)
        self.values[r, cx + 1] = np.nan if y is None else float(y)

    def save(self, out_dir: str | Path) -> Path:
        """CollectedData_{scorer}.csv + .h5 pair with the reference's
        4-level header (scorer/individuals/bodyparts/coords)."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        base = out_dir / f"CollectedData_{self.scorer}"
        cols = self.columns
        lines = []
        for li, name in enumerate(("scorer", "individuals", "bodyparts",
                                   "coords")):
            lines.append(",".join([name] + [c[li] for c in cols]))
        for p, row in zip(self.image_paths, self.values):
            cells = ["" if np.isnan(v) else repr(float(v)) for v in row]
            lines.append(",".join([p] + cells))
        base.with_suffix(".csv").write_text("\n".join(lines) + "\n")
        write_multi_individual_h5(base.with_suffix(".h5"), self)
        return base.with_suffix(".csv")


def write_multi_individual_h5(path: str | Path,
                              labels: MultiIndividualLabels,
                              key: str = "df_with_missing") -> None:
    """4-level pandas fixed-format twin via raw h5py — the same layout
    data/project.py::write_collected_data_h5 emits for 3 levels, with the
    ``individuals`` level inserted, so a reference installation's
    ``pd.read_hdf`` consumes it (ref save: toolbox saveDataSet:862-872)."""
    import h5py

    from deepgraphpose_tpu_torch.data.project import (_h5_int_array,
                                                      _h5_str_array)

    cols = labels.columns
    level_names = ("scorer", "individuals", "bodyparts", "coords")
    levels, codes = [], []
    for li in range(4):
        vals = []
        code = []
        for c in cols:
            if c[li] not in vals:
                vals.append(c[li])
            code.append(vals.index(c[li]))
        levels.append(vals)
        codes.append(code)

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
        a["axis0_nlevels"] = np.int64(4)
        a["axis1_variety"] = np.bytes_("regular")
        a["block0_items_variety"] = np.bytes_("multi")
        a["block0_items_nlevels"] = np.int64(4)
        for prefix in ("axis0", "block0_items"):
            for li in range(4):
                _h5_str_array(g, f"{prefix}_level{li}", levels[li],
                              idx_name=level_names[li])
                _h5_int_array(g, f"{prefix}_label{li}", codes[li])
        _h5_str_array(g, "axis1", labels.image_paths)
        d = g.create_dataset("block0_values",
                             data=np.asarray(labels.values, np.float64))
        d.attrs["CLASS"] = np.bytes_("ARRAY")
        d.attrs["VERSION"] = np.bytes_("2.4")
        d.attrs["TITLE"] = np.bytes_("")
        d.attrs["FLAVOR"] = np.bytes_("numpy")
        d.attrs["transposed"] = True


def read_multi_individual_csv(path: str | Path) -> MultiIndividualLabels:
    """Read a 4-level CollectedData CSV back (inverse of save)."""
    lines = Path(path).read_text().strip().split("\n")
    hdr = [ln.split(",") for ln in lines[:4]]
    assert hdr[0][0] == "scorer" and hdr[1][0] == "individuals"
    cols = list(zip(hdr[0][1:], hdr[1][1:], hdr[2][1:], hdr[3][1:]))
    scorer = cols[0][0]
    individuals, seen = [], set()
    for c in cols:
        if c[1] not in seen:
            individuals.append(c[1])
            seen.add(c[1])
    by_ind = {i: [] for i in individuals}
    for c in cols:
        if c[3] == "x":
            by_ind[c[1]].append(c[2])
    image_paths, rows = [], []
    for ln in lines[4:]:
        cells = ln.split(",")
        image_paths.append(cells[0])
        rows.append([float(v) if v else np.nan for v in cells[1:]])
    multis = [i for i in individuals if i != "single"]
    multibodyparts = by_ind[multis[0]] if multis else by_ind[individuals[0]]
    unique = by_ind.get("single") if "single" in by_ind and multis else None
    out = MultiIndividualLabels(scorer, individuals, unique, multibodyparts,
                                image_paths, np.asarray(rows, np.float64))
    assert out.columns == cols, "column order mismatch on read-back"
    return out


def merge_individual_sessions(config: str | Path, video: str,
                              cleanup: bool = True) -> Path | None:
    """Assemble per-individual session files
    (``CollectedData_{scorer}_idv_{name}``, written by :func:`show`'s
    per-individual browser runs) into the reference 4-level pair."""
    from deepgraphpose_tpu_torch.data.project import read_collected_data_csv

    config = Path(config)
    cfg, individuals, unique, multi = _read_multi_cfg(config)
    scorer = cfg.get("scorer", "scorer")
    vdir = config.parent / "labeled-data" / video

    sessions = {}
    for ind in individuals:
        p = vdir / f"CollectedData_{scorer}{_SESSION_SEP}{ind}.csv"
        if p.exists():
            sessions[ind] = read_collected_data_csv(p)
    if not sessions:
        print(f"no per-individual session files under {vdir}; nothing to "
              "merge")
        return None
    image_paths = sorted({p for s in sessions.values()
                          for p in s.image_paths})
    out = MultiIndividualLabels.empty(scorer, individuals, unique, multi,
                                      image_paths)
    for ind, labels in sessions.items():
        for r, ip in enumerate(labels.image_paths):
            for j, bp in enumerate(labels.bodyparts):
                x, y = labels.coords_xy[r, j]
                if not (np.isnan(x) and np.isnan(y)):
                    out.set_label(ip, ind, bp,
                                  None if np.isnan(x) else float(x),
                                  None if np.isnan(y) else float(y))
    saved = out.save(vdir)
    if cleanup:
        for ind in sessions:
            for suf in (".csv", ".h5"):
                p = vdir / f"CollectedData_{scorer}{_SESSION_SEP}{ind}{suf}"
                if p.exists():
                    p.unlink()
    print(f"merged {len(sessions)} individual sessions -> {saved}")
    return saved


def show(config: str | Path, video: str | None = None, port: int = 0):
    """The toolbox's ``show(config)`` as sequential browser sessions: one
    labeling UI per individual (ctrl-c advances to the next), then the
    4-level merge. Blocking, like the reference GUI."""
    from deepgraphpose_tpu_torch.project.label_server import LabelServer

    config = Path(config)
    cfg, individuals, unique, multi = _read_multi_cfg(config)
    scorer = cfg.get("scorer", "scorer")
    for ind in individuals:
        bps = bodyparts_for(ind, unique, multi)
        if not bps:  # e.g. uniquebodyparts: [] — nothing to label
            print(f"=== individual '{ind}' has no bodyparts; skipping ===",
                  flush=True)
            continue
        print(f"=== labeling individual '{ind}' "
              f"({len(bps)} bodyparts; ctrl-c to finish this session) ===",
              flush=True)
        srv = LabelServer(config.parent, video=video, port=port,
                          scorer=f"{scorer}{_SESSION_SEP}{ind}",
                          bodyparts=bps)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            print(f"session for '{ind}' closed", flush=True)
        finally:
            # release the socket so the next individual's session can bind
            # the same explicit port
            srv.stop()
        video = video or srv.state.video
    if video is None:  # every individual was skipped; no session ran
        print("no labeling sessions ran; nothing to merge")
        return None
    return merge_individual_sessions(config, video)
