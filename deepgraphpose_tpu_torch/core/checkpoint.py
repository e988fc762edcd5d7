"""Read the JAX package's msgpack snapshots and bridge them to PyTorch.

Snapshot format (written by ``deepgraphpose_tpu.core.checkpoint``): flax
``msgpack_serialize`` of ``{"variables": {"params", "batch_stats"}[,
"opt_state"]}`` in one ``snapshot-step{N}-{it}.ckpt`` file. Array leaves
are msgpack ExtType 1 (ndarray) or 3 (numpy scalar) whose payload is itself
msgpack ``(shape, dtype_name, C-order bytes)``; leaves above 2**30 bytes
are stored as ``{"__msgpack_chunked_array__", "shape", "chunks"}`` dicts.
This module decodes that with plain ``msgpack``, so no flax is needed.

Weights bridge (:func:`state_dict_from_flax`):

* ``nn.Conv`` kernel (kh, kw, in, out) -> ``Conv2d.weight`` (out, in, kh, kw);
* ``nn.ConvTranspose`` kernel (kh, kw, in, out), the heads' ``block4`` ->
  ``ConvTranspose2d.weight`` (in, out, kh, kw) with both spatial axes
  flipped (see models/heads.py);
* ``FrozenBatchNorm``: ``params/{scale, bias}`` and
  ``batch_stats/{mean, var}`` keep their names;
* the backbone subtree, auto-named by flax inside ``PoseModel``, becomes
  the port's ``backbone`` attribute.

:func:`quant_state_from_flax` bridges the JAX package's int8 variables
(``models/quant.py::quantize_model``) to the port's ``QuantizedPoseModel``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

CKPT_SUFFIX = ".ckpt"
HEAD_NAMES = ("part_pred", "locref_pred", "intermediate_supervision")

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the top 16 bits into float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def load_snapshot(path: str | Path):
    """Read a snapshot; returns (variables, opt_state_or_None) as nested
    dicts of numpy arrays (ref: deepgraphpose_tpu core/checkpoint.py:50-65,
    without the flax template restore)."""
    import msgpack

    raw = msgpack.unpackb(Path(path).read_bytes(), ext_hook=_ext_hook,
                          raw=False, strict_map_key=False)
    raw = _unchunk(raw)
    return raw["variables"], raw.get("opt_state")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays -> the port's
    ``PoseModel`` state_dict (float32 tensors), one entry per leaf."""
    tops = set(variables.get("params", {})) | set(
        variables.get("batch_stats", {}))
    backbones = sorted(tops - set(HEAD_NAMES))
    if len(backbones) != 1:
        raise ValueError(f"expected one backbone subtree, found {backbones}")
    return _torch_state(variables, backbones[0])


def _torch_state(variables: dict, backbone: str | None = None) -> dict:
    """The leaves of a flax tree as torch state; ``backbone`` names the
    subtree that becomes the ``backbone`` attribute."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
            top = "backbone" if path[0] == backbone else path[0]
            *mods, name = (top,) + tuple(path[1:])
            if name == "kernel":
                if path[0] in HEAD_NAMES:       # nn.ConvTranspose
                    arr = arr.permute(2, 3, 0, 1).flip(-2, -1)
                else:                           # nn.Conv
                    arr = arr.permute(3, 2, 0, 1)
                name = "weight"
            key = ".".join(mods + [name])
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = arr.contiguous()
    return out


def quant_state_from_flax(qvariables: dict) -> dict:
    """The JAX package's ``quantize_model`` variables, as numpy, -> the
    port's ``QuantizedPoseModel`` state_dict.

    Each site's int8 HWIO kernel becomes the GEMM kernel's (K = kh*kw*Cin,
    N = Cout) matrix; ``oscale`` and ``bias`` carry over as float32, and
    the calibrated input scale as a Python float (the site's extra state,
    never a device tensor). The heads map as in :func:`state_dict_from_flax`.
    """
    out = _torch_state({"params": qvariables["heads"]})
    for site, w in qvariables["qw"].items():
        w = np.asarray(w)
        if w.dtype != np.int8 or w.ndim != 4:
            raise ValueError(f"{site}: expected an int8 HWIO kernel, got "
                             f"{w.dtype} {w.shape}")
        out[f"sites.{site}.qw"] = torch.from_numpy(
            w.reshape(-1, w.shape[-1]).copy())
        for key in ("oscale", "bias"):
            out[f"sites.{site}.{key}"] = torch.from_numpy(
                np.array(qvariables[key][site], dtype=np.float32))
        out[f"sites.{site}._extra_state"] = {
            "act_scale": float(np.float32(qvariables["act_scale"][site]))}
    return out
