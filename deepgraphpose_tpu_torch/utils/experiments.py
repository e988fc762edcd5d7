"""Experiment helpers: hyperparameter sweeps + run identifiers.

The port's own copy of ``deepgraphpose_tpu/utils/experiments.py``: host code
(numpy, OpenCV), no model and no device.

ref: src/deepgraphpose/helpers/scheduling.py:90-133 (create_schedule —
cartesian product over dict values that are lists) and
helpers/logging_utils.py:8-46 (generate_log_id — a stable run-id string
from a config dict). Small, but part of the reference's component
inventory (SURVEY §2a), and handy for sweeping DGP hyperparameters
(ws/wt/gm2/gm3/lr).
"""

from __future__ import annotations

import itertools

import numpy as np


def create_schedule(grid: dict) -> list[dict]:
    """Expand {key: value-or-list} into the cartesian product of configs.

    Scalar values are broadcast; list values enumerate. List-typed
    hyperparameters that should NOT be swept (e.g. ``multi_step``) are
    passed as a one-element list of the list, exactly as the reference does
    (ref: scheduling.py:17 ``"multi_step": [[[0.001, 1000]]]``).
    """
    keys = list(grid)
    axes = [v if isinstance(v, list) else [v] for v in grid.values()]
    return [dict(zip(keys, combo)) for combo in itertools.product(*axes)]


def generate_log_id(config: dict, method_key: str = "net_type") -> str:
    """Deterministic run-id string: ``net_type-<m>--k1-v1--k2-v2...``
    over sorted keys (ref: logging_utils.py:8-46, incl. its float
    formatting: %.5f above 1e-5, full precision below)."""
    method = config.get(method_key, "unknownM")
    parts = [f"{method_key}-{method}"]
    for key in sorted(config):
        if key == method_key:
            continue
        val = config[key]
        if isinstance(val, bool):
            val_str = str(val)
        elif isinstance(val, str):
            val_str = val
        elif isinstance(val, int):
            val_str = f"{val:d}"
        elif isinstance(val, float):
            if val == 0 or np.log10(np.abs(val)) >= -5:
                val_str = f"{val:.5f}"
            else:
                val_str = f"{val:.20f}".rstrip("0")
        elif isinstance(val, (list, tuple)):
            val_str = "_".join(str(v) for v in np.ravel(np.asarray(
                val, dtype=object)))
        elif val is None:
            val_str = "None"
        else:
            raise NotImplementedError(f"log id for {type(val)}")
        parts.append(f"{key}-{val_str}")
    return "--".join(parts)
