"""One module a backbone family, found by a configuration's ``family``:
``families/<family>.py``. A new family is a new file here; nothing else
of the reference changes.

A family module gives:

* ``specs(cfg, conv, bn) -> int``: declares the backbone's weights, in
  the program's state-dict names, through the two helpers that
  ``models.param_specs`` passes in, in the order they are drawn; returns
  the feature depth;
* ``backbone(cfg, w, x, conv) -> Tensor``: NCHW float32 input (mean pixel
  subtracted) to NCHW float32 features, every convolution through
  ``conv``;
* ``layers(cfg, hw, add) -> (feature_hw, feature_depth)``: every
  convolution of the backbone for frames of ``hw``, recorded in order
  through ``arch.layers``' ``add``;
* optionally ``init(role, z, shape) -> Tensor | None``: the scaling of a
  role of its own, which ``data.make_weights`` does not know.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType


def find(cfg: dict) -> ModuleType:
    """The module of ``cfg["family"]``."""
    name = cfg["family"]
    path = Path(__file__).parent / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise ValueError(f"unknown architecture family {name!r}: no file "
                         f"{path}")
    return importlib.import_module(f"{__name__}.{name}")
