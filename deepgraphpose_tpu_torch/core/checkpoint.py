"""Snapshots in the JAX package's msgpack format, read and written, and the
weights bridge between its flax trees and the port's PyTorch models.

Snapshot format (``deepgraphpose_tpu.core.checkpoint``): flax
``msgpack_serialize`` of ``{"variables": {"params", "batch_stats"}[,
"opt_state"]}`` in one ``snapshot-step{N}-{it}.ckpt`` file, every dict's
keys in sorted order. Array leaves are msgpack ExtType 1 (ndarray) or 3
(numpy scalar) whose payload is itself msgpack ``(shape, dtype_name,
C-order bytes)``; leaves above 2**30 bytes are stored as
``{"__msgpack_chunked_array__", "shape", "chunks"}`` dicts. This module
reads and writes that with plain ``msgpack``, so no flax is needed: for
the same arrays it writes the bytes flax writes.

``opt_state`` is flax's ``to_state_dict`` of the optax chain the JAX
package trains with (``train/steps.py::make_optimizer``): tuples become
dicts keyed "0", "1", ...; ``clip_by_global_norm`` and a float learning
rate hold no state ({}); ``sgd``'s momentum keeps ``{"trace": <params
tree>}`` and a schedule ``{"count": int32}``::

    clip + float lr:  {"0": {}, "1": {"0": {"trace": T}, "1": {}}}
    clip + schedule:  {"0": {}, "1": {"0": {"trace": T}, "1": {"count": c}}}
    schedule, no clip: {"0": {"0": {"trace": T}, "1": {"count": c}}}

:func:`opt_state_tree` and :func:`load_optimizer_state` carry
``ClippedSGD``'s momentum buffers and update count through that layout.

Weights bridge (:func:`state_dict_from_flax`, inverted by
:func:`flax_from_state_dict`, both bit-exact):

* ``nn.Conv`` kernel (kh, kw, in, out) -> ``Conv2d.weight`` (out, in, kh, kw);
* ``nn.ConvTranspose`` kernel (kh, kw, in, out), the heads' ``block4`` ->
  ``ConvTranspose2d.weight`` (in, out, kh, kw) with both spatial axes
  flipped (see models/heads.py);
* ``FrozenBatchNorm``: ``params/{scale, bias}`` and
  ``batch_stats/{mean, var}`` keep their names;
* the backbone subtree, auto-named by flax inside ``PoseModel``
  (``ResNetV1_0`` or ``MobileNetV2_0``), becomes the port's ``backbone``
  attribute. MobileNetV2's depthwise kernels, flax (3, 3, 1, C), map as
  any ``nn.Conv`` kernel, to ``Conv2d.weight`` (C, 1, 3, 3).

:func:`quant_state_from_flax` bridges the JAX package's int8 variables
(``models/quant.py::quantize_model``) to the port's ``QuantizedPoseModel``.

The snapshot bookkeeping (names, pruning to ``max_to_keep``, skip-if-final,
the newest intermediate snapshot for a mid-step resume) is the JAX
package's (ref: fitdgp.py:150-152, 237-245; ``final--0`` sorts last).

The Orbax backend (:func:`save_snapshot_orbax`, :func:`load_snapshot_orbax`)
keeps the same payload in a ``snapshot-step{N}-{it}.orbax/`` directory in
the layout orbax's ``StandardCheckpointer`` writes and restores, read and
written here with ``tensorstore`` (orbax itself imports JAX): an OCDBT
key-value store (``manifest.ocdbt``, ``d/``) holding one zarr v2 array a
leaf under the leaf's tree path joined by ``.`` (``variables.params.
ResNetV1_0.conv1.kernel/``: ``.zarray`` and its chunks, zstd level 1), the
tree in ``_METADATA`` (JSON: each leaf's keys and value type, an empty
dict as ``Dict`` with ``skip_deserialize``; ``use_ocdbt: true``,
``use_zarr3: false``) and ``_CHECKPOINT_METADATA``. orbax writes a
process's arrays under ``ocdbt.process_0/`` and names that subtree in the
root manifest; this writer commits them into the root store, which orbax
reads the same way. tensorstore is imported inside the two functions.
"""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from deepgraphpose_tpu_torch.core import paths as paths_lib

CKPT_SUFFIX = ".ckpt"
ORBAX_SUFFIX = ".orbax"
ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                 "StandardCheckpointHandler")
HEAD_NAMES = ("part_pred", "locref_pred", "intermediate_supervision")
# flax's auto-names of the backbone module inside the JAX PoseModel
RESNET_SCOPE = "ResNetV1_0"
MOBILENET_SCOPE = "MobileNetV2_0"
BN_STATS = ("mean", "var")
MAX_CHUNK_BYTES = 2 ** 30         # flax.serialization.MAX_CHUNK_SIZE

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


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot write a {type(x).__name__} into a snapshot")


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, MAX_CHUNK_BYTES // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _canonical(tree):
    """Sorted keys at every level (flax maps the tree through jax, which
    sorts them) and oversized arrays chunked, as flax writes them."""
    if isinstance(tree, dict):
        return {str(k): _canonical(v) for k, v in sorted(tree.items())}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_BYTES:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree: dict) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a tree
    of dicts with numpy leaves."""
    import msgpack

    return msgpack.packb(_canonical(tree), default=_ext_pack,
                         strict_types=True)


def load_snapshot(path: str | Path, model: torch.nn.Module | None = None,
                  optimizer=None):
    """Read a snapshot; returns (variables, opt_state_or_None) as nested
    dicts of numpy arrays (ref: deepgraphpose_tpu core/checkpoint.py:50-65).

    With ``model``, its weights are loaded (every tensor); with
    ``optimizer`` (a ``train/steps.py::ClippedSGD`` over ``model``'s
    parameters) too, its momentum buffers and update count, where the
    snapshot holds an optimizer state."""
    import msgpack

    raw = msgpack.unpackb(Path(path).read_bytes(), ext_hook=_ext_hook,
                          raw=False, strict_map_key=False)
    return _restore(_unchunk(raw), model, optimizer)


def _restore(raw: dict, model, optimizer):
    variables, opt_state = raw["variables"], raw.get("opt_state")
    if model is not None:
        model.load_state_dict(state_dict_from_flax(variables))
        if optimizer is not None and opt_state is not None:
            load_optimizer_state(optimizer, model, opt_state)
    return variables, opt_state


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


def backbone_scope(keys) -> str:
    """The JAX package's backbone scope for a port state's keys: a
    MobileNetV2 has a ``conv_stem``, a ResNet none."""
    mobile = any(k.startswith("backbone.conv_stem.") for k in keys)
    return MOBILENET_SCOPE if mobile else RESNET_SCOPE


def flax_from_state_dict(state: dict) -> dict:
    """A ``PoseModel`` state_dict -> the JAX package's ``{"params",
    "batch_stats"}`` tree of numpy arrays: the inverse of
    :func:`state_dict_from_flax`, bit for bit. A state of parameters alone
    (a momentum trace) gives a tree with ``params`` only."""
    out: dict = {}
    scope = backbone_scope(state)
    for key, value in state.items():
        *mods, name = key.split(".")
        arr = value.detach().to("cpu", torch.float32)
        if mods[0] == "backbone":
            mods[0] = scope
        if name == "weight":
            if mods[0] in HEAD_NAMES:           # nn.ConvTranspose
                arr = arr.flip(-2, -1).permute(2, 3, 0, 1)
            else:                               # nn.Conv
                arr = arr.permute(2, 3, 1, 0)
            name = "kernel"
        collection = "batch_stats" if name in BN_STATS else "params"
        node = out.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = arr.contiguous().numpy()
    return out


def quant_state_from_flax(qvariables: dict) -> dict:
    """The JAX package's ``quantize_model`` variables, as numpy, -> the
    port's ``QuantizedPoseModel`` state_dict.

    Each site's int8 HWIO kernel becomes the GEMM kernel's (K = kh*kw*Cin,
    N = Cout) matrix; ``oscale`` and ``bias`` carry over as float32, and
    the calibrated input scale as a Python float (the site's extra state,
    never a device tensor). MobileNetV2's float depthwise sites
    (``qvariables["dw"]``: folded (3, 3, 1, C) kernel ``w`` and bias
    ``b``) become ``dw.<site>.weight`` (C, 1, 3, 3) and ``dw.<site>.bias``.
    The heads map as in :func:`state_dict_from_flax`.
    """
    out = _torch_state({"params": qvariables["heads"]})
    for site, wb in qvariables.get("dw", {}).items():
        out[f"dw.{site}.weight"] = torch.from_numpy(
            np.array(wb["w"], dtype=np.float32)).permute(3, 2, 0, 1
                                                         ).contiguous()
        out[f"dw.{site}.bias"] = torch.from_numpy(
            np.array(wb["b"], dtype=np.float32))
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


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------

def opt_state_tree(optimizer, model: torch.nn.Module) -> dict:
    """``ClippedSGD``'s state in the layout of the optax chain's
    ``to_state_dict`` (module docstring): the momentum trace (zeros before
    the first update) and, under a schedule, the update count."""
    trace = {}
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        trace[name] = torch.zeros_like(p) if buf is None else buf
    sgd = {"0": {"trace": flax_from_state_dict(trace)["params"]},
           "1": ({"count": np.asarray(optimizer.count, np.int32)}
                 if optimizer.schedule is not None else {})}
    return {"0": {}, "1": sgd} if optimizer.clip_norm is not None else {
        "0": sgd}


def _find(tree, key: str):
    """The value under the first ``key`` met in a depth-first walk."""
    if not isinstance(tree, dict):
        return None
    if key in tree:
        return tree[key]
    for value in tree.values():
        found = _find(value, key)
        if found is not None:
            return found
    return None


def load_optimizer_state(optimizer, model: torch.nn.Module,
                         opt_state: dict) -> None:
    """Set ``optimizer``'s momentum buffers (and its update count, where the
    state holds one) from a snapshot's ``opt_state``."""
    trace = state_dict_from_flax({"params": _find(opt_state, "trace")})
    params = dict(model.named_parameters())
    if set(trace) != set(params):
        raise ValueError("the snapshot's momentum trace does not match the "
                         "model's parameters")
    for name, p in params.items():
        optimizer.state[p]["momentum_buffer"] = trace[name].to(
            p.device, p.dtype)
    count = _find(opt_state, "count")
    if count is not None:
        optimizer.count = int(count)


# ---------------------------------------------------------------------------
# snapshots on disk
# ---------------------------------------------------------------------------

def save_snapshot(train_dir: str | Path, step: int, iteration: int | str,
                  model: torch.nn.Module, optimizer=None,
                  max_to_keep: int = 5, debug: str = "") -> Path:
    """Write ``snapshot-step{step}-{iteration}.ckpt`` (the model's weights,
    and the optimizer's state when given) and prune old ones. The card's
    tensors are copied to the host here, the one sync a snapshot costs."""
    train_dir = Path(train_dir)
    train_dir.mkdir(parents=True, exist_ok=True)
    name = paths_lib.snapshot_name(step, iteration, debug)
    path = train_dir / f"{name}{CKPT_SUFFIX}"
    path.write_bytes(msgpack_serialize(_payload(model, optimizer)))
    _prune_snapshots(train_dir, step, max_to_keep, debug)
    return path


def _payload(model: torch.nn.Module, optimizer) -> dict:
    """A snapshot's tree: the weights and, when given, the optimizer's
    state, in the JAX package's names."""
    payload = {"variables": flax_from_state_dict(model.state_dict())}
    if optimizer is not None:
        payload["opt_state"] = opt_state_tree(optimizer, model)
    return payload


def restore_backbone_and_heads(model: torch.nn.Module,
                               snapshot_path: str | Path) -> torch.nn.Module:
    """Load every tensor of a snapshot whose name and shape match ``model``;
    the rest keep their init (the reference's scope-filtered Saver restore
    of ['pose/part_pred', 'pose/locref_pred', 'resnet'], ref:
    fitdgp.py:688-695, as the JAX package merges it)."""
    variables, _ = load_snapshot(snapshot_path)
    saved = state_dict_from_flax(variables)
    merged = {k: saved[k] if k in saved and saved[k].shape == v.shape else v
              for k, v in model.state_dict().items()}
    model.load_state_dict(merged)
    return model


def snapshot_exists(train_dir: str | Path, step: int, debug: str = "") -> bool:
    """Skip-if-done check (ref: fitdgp.py:112-116, 361-365, 656-660)."""
    name = paths_lib.final_snapshot_name(step, debug)
    return (Path(train_dir) / f"{name}{CKPT_SUFFIX}").exists()


def latest_snapshot(train_dir: str | Path, step: int | None = None,
                    debug: str = "") -> Path | None:
    """Most recent snapshot, preferring final, else highest iteration."""
    train_dir = Path(train_dir)
    if not train_dir.exists():
        return None
    if step is not None:
        final = train_dir / (f"{paths_lib.final_snapshot_name(step, debug)}"
                             f"{CKPT_SUFFIX}")
        if final.exists():
            return final
        pats = sorted(train_dir.glob(
            f"snapshot-step{step}{debug}-*{CKPT_SUFFIX}"), key=_snapshot_iter)
    else:
        # across steps: prefer the highest pipeline step, then the highest
        # iteration (finals sort last within a step)
        pats = sorted(train_dir.glob(f"snapshot-*{CKPT_SUFFIX}"),
                      key=lambda p: (_step_num(p), _snapshot_iter(p)))
    return pats[-1] if pats else None


def _step_num(p: Path) -> int:
    m = re.search(r"snapshot-step(\d+)", p.name)
    return int(m.group(1)) if m else -1


def _snapshot_iter(p: Path) -> int:
    if p.name.endswith(f"final--0{CKPT_SUFFIX}"):
        return 10 ** 12  # 'final--0' sorts last
    m = re.search(r"-(\d+)\.ckpt$", p.name)
    return int(m.group(1)) if m else 10 ** 12 - 1


def _prune_snapshots(train_dir: Path, step: int, max_to_keep: int,
                     debug: str) -> None:
    snaps = [p for p in train_dir.glob(
        f"snapshot-step{step}{debug}-*{CKPT_SUFFIX}") if "final" not in p.name]
    snaps.sort(key=_snapshot_iter)
    for p in snaps[:-max_to_keep] if max_to_keep > 0 else []:
        p.unlink(missing_ok=True)


def latest_intermediate_snapshot(train_dir: str | Path, step: int,
                                 debug: str = "") -> tuple[Path, int] | None:
    """(path, iteration) of the newest non-final snapshot, for a mid-step
    resume (the reference can only skip-if-final)."""
    snaps = [p for p in Path(train_dir).glob(
        f"snapshot-step{step}{debug}-*{CKPT_SUFFIX}") if "final" not in p.name]
    if not snaps:
        return None
    best = max(snaps, key=_snapshot_iter)
    m = re.search(r"-(\d+)\.ckpt$", best.name)
    return (best, int(m.group(1))) if m else None


# ---------------------------------------------------------------------------
# Orbax snapshots (see the module docstring)
# ---------------------------------------------------------------------------

def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "Orbax snapshots are read and written with tensorstore, which "
            "this host lacks; save_snapshot / load_snapshot (.ckpt) need "
            "only msgpack") from e
    return tensorstore


def _leaves_and_empties(tree: dict, prefix=()):
    """(keys, leaf) in depth-first order; an empty dict is a leaf."""
    for k, v in tree.items():
        keys = prefix + (str(k),)
        if isinstance(v, dict) and v:
            yield from _leaves_and_empties(v, keys)
        else:
            yield keys, v


def _tree_entry(keys: tuple, value_type: str, skip: bool) -> dict:
    return {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": value_type,
                               "skip_deserialize": skip}}


def _zarr_spec(path: Path, keys) -> dict:
    return {"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{path}/",
        "path": ".".join(keys) + "/"}}


def save_snapshot_orbax(train_dir: str | Path, step: int,
                        iteration: int | str, model: torch.nn.Module,
                        optimizer=None, debug: str = "") -> Path:
    """Write ``snapshot-step{step}-{iteration}.orbax/`` (replacing one of
    that name): the payload of :func:`save_snapshot` in orbax's layout,
    which the JAX package's ``load_snapshot_orbax`` restores. Requires
    tensorstore."""
    ts = _tensorstore()
    train_dir = Path(train_dir)
    train_dir.mkdir(parents=True, exist_ok=True)
    name = paths_lib.snapshot_name(step, iteration, debug)
    path = (train_dir / f"{name}{ORBAX_SUFFIX}").resolve()
    payload = _payload(model, optimizer)
    started = time.time_ns()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir()
    context, txn = ts.Context(), ts.Transaction()
    tree, writes = {}, []
    for keys, leaf in _leaves_and_empties(payload):
        if isinstance(leaf, dict):
            tree[repr(keys)] = _tree_entry(keys, "Dict", True)
            continue
        arr = np.array(leaf, order="C")    # keeps a 0-d leaf 0-d
        spec = dict(_zarr_spec(path, keys), metadata={
            "shape": list(arr.shape), "chunks": list(arr.shape),
            "dtype": arr.dtype.str, "fill_value": None, "order": "C",
            "compressor": {"id": "zstd", "level": 1}, "filters": None,
            "dimension_separator": "."})
        store = ts.open(spec, create=True, context=context,
                        transaction=txn).result()
        writes.append(store.write(arr))
        tree[repr(keys)] = _tree_entry(keys, "np.ndarray", False)
    for w in writes:
        w.result()
    txn.commit_sync()
    (path / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    (path / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": ORBAX_HANDLER, "metrics": {},
        "performance_metrics": {}, "init_timestamp_nsecs": started,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}))
    return path


def load_snapshot_orbax(path: str | Path,
                        model: torch.nn.Module | None = None,
                        optimizer=None):
    """Read an Orbax snapshot directory (the JAX package's or
    :func:`save_snapshot_orbax`'s); mirrors :func:`load_snapshot`: returns
    (variables, opt_state_or_None) as nested dicts of numpy arrays and
    loads ``model`` and ``optimizer`` when given. Requires tensorstore."""
    ts = _tensorstore()
    path = Path(path).resolve()
    meta = json.loads((path / "_METADATA").read_text())
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{path}: only orbax's OCDBT layout of zarr v2 "
                         "arrays is read (use_ocdbt true, use_zarr3 false)")
    context = ts.Context()
    raw: dict = {}
    reads = []
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        node = raw
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            if value["value_type"] != "Dict":
                raise ValueError(f"{path}: unexpected empty "
                                 f"{value['value_type']} at {keys}")
            node[keys[-1]] = {}
            continue
        store = ts.open(_zarr_spec(path, keys), open=True,
                        context=context).result()
        reads.append((node, keys[-1], store.read()))
    for node, key, read in reads:
        node[key] = np.asarray(read.result())
    return _restore(raw, model, optimizer)
