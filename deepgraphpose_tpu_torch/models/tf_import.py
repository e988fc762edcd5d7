"""TF-checkpoint -> PyTorch weight importer.

The port's own copy of ``deepgraphpose_tpu/models/tf_import.py``, in
both directions: TF arrays into a port state_dict, and a port state_dict
out to TF-named arrays and a TF1 checkpoint the original DLC/DGP stack
restores.

The reference initializes its backbone from slim's ImageNet
``resnet_v1_50.ckpt`` (ref: README.md:50-53, demo/run_dgp_demo.py:108-111)
and each training step restores the previous step's TF1 snapshot by
variable-scope filters ``resnet`` / ``pose/part_pred`` / ``pose/locref_pred``
(ref: src/deepgraphpose/models/fitdgp.py:393-400, 688-695). The TF names
map onto the JAX package's flax paths, and the port's state_dict reaches
those through ``core/checkpoint.py``'s bridge, so a TF checkpoint loads
into a port model exactly as into the JAX model.

Layout notes:
* slim conv weights are HWIO, as flax ``nn.Conv`` kernels;
* TF ``conv2d_transpose`` kernels are (H, W, out, in) and spatially
  mirrored relative to flax ``nn.ConvTranspose`` (H, W, in, out): imported
  deconv kernels are flipped along both spatial axes and have their
  channel axes swapped;
* TF depthwise kernels are (H, W, C, 1); flax's grouped conv kernels
  (H, W, 1, C): the last two axes swap;
* slim BatchNorm {gamma, beta, moving_mean, moving_variance} map onto
  FrozenBatchNorm {scale, bias} and {mean, var}.

TensorFlow is imported inside :func:`load_tf_checkpoint_arrays` and
:func:`write_tf_checkpoint` only; :func:`import_tf_arrays` and
:func:`export_tf_arrays` are pure numpy and torch, so they run on a host
without TensorFlow.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import numpy as np

from deepgraphpose_tpu_torch.core.checkpoint import (flax_from_state_dict,
                                                     state_dict_from_flax)

_BN_MAP = {
    # (flax collection, flax leaf) -> slim BatchNorm suffix
    ("params", "scale"): "gamma",
    ("params", "bias"): "beta",
    ("batch_stats", "mean"): "moving_mean",
    ("batch_stats", "var"): "moving_variance",
}

_HEAD_SCOPES = {
    "part_pred": "pose/part_pred",
    "locref_pred": "pose/locref_pred",
    "intermediate_supervision": "pose/intermediate_supervision",
}


def _deconv_from_tf(arr: np.ndarray) -> np.ndarray:
    """TF conv2d_transpose (H, W, out, in) -> flax ConvTranspose
    (H, W, in, out), mirrored spatially (see the module docstring)."""
    return np.ascontiguousarray(arr[::-1, ::-1].transpose(0, 1, 3, 2))


def _deconv_to_tf(arr: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_deconv_from_tf` (used by the exporter)."""
    return np.ascontiguousarray(arr.transpose(0, 1, 3, 2)[::-1, ::-1])


def _depthwise_from_tf(arr: np.ndarray) -> np.ndarray:
    """TF depthwise (H, W, C, mult=1) -> flax grouped conv (H, W, 1, C):
    TF applies filter [:, :, c, 0] to channel c, flax kernel[:, :, 0, c].
    Self-inverse (mult == 1), so the exporter reuses it."""
    return np.ascontiguousarray(arr.transpose(0, 1, 3, 2))


# flat slim index of (block, unit): slim names the 17 inverted-residual ops
# expanded_conv, expanded_conv_1 ... expanded_conv_16 in order
_V2_UNITS = (1, 2, 3, 4, 3, 3, 1)
_V2_OFFSETS = tuple(sum(_V2_UNITS[:b]) for b in range(len(_V2_UNITS)))


def _mobilenet_scope(block: int, unit: int) -> str:
    flat = _V2_OFFSETS[block] + unit
    suffix = "" if flat == 0 else f"_{flat}"
    return f"MobilenetV2/expanded_conv{suffix}"


def backbone_tf_scope(net_type: str) -> str:
    """The TF variable scope of a backbone's weights: the prefix of an
    ImageNet warm start's restore (ref: fitdgp.py:393-400)."""
    return "MobilenetV2" if net_type.startswith("mobilenet") else "resnet"


def tf_name_for_path(path: tuple[str, ...], net_type: str) -> tuple[str, Callable] | None:
    """Map one Flax variable path to (tf_variable_name, array_transform).

    ``path`` is a flax path (collection, module..., leaf), e.g.
    ``("params", "ResNetV1_0", "block1_unit2", "conv1", "kernel")``, as
    ``core/checkpoint.py::flax_from_state_dict`` names the port's tensors.
    Returns None for paths with no TF counterpart.
    """
    scope = f"resnet_v1_{net_type.split('_')[-1]}"
    collection, *mods, leaf = path
    ident = lambda a: a

    # --- backbone ---
    if mods and mods[0].startswith("ResNetV1"):
        mods = mods[1:]
        if not mods:
            return None
        if mods[0] == "conv1" and leaf == "kernel":
            return f"{scope}/conv1/weights", ident
        if mods[0] == "bn1":
            return (f"{scope}/conv1/BatchNorm/{_BN_MAP[(collection, leaf)]}",
                    ident)
        m = re.fullmatch(r"block(\d+)_unit(\d+)", mods[0])
        if m:
            base = (f"{scope}/block{m.group(1)}/unit_{m.group(2)}/"
                    "bottleneck_v1")
            sub = mods[1]
            cm = re.fullmatch(r"conv(\d)", sub)
            if cm and leaf == "kernel":
                return f"{base}/conv{cm.group(1)}/weights", ident
            bm = re.fullmatch(r"bn(\d)", sub)
            if bm:
                return (f"{base}/conv{bm.group(1)}/BatchNorm/"
                        f"{_BN_MAP[(collection, leaf)]}", ident)
            if sub == "shortcut_conv" and leaf == "kernel":
                return f"{base}/shortcut/weights", ident
            if sub == "shortcut_bn":
                return (f"{base}/shortcut/BatchNorm/"
                        f"{_BN_MAP[(collection, leaf)]}", ident)
        return None

    # --- MobileNetV2 backbone (slim scope MobilenetV2, ref:
    # pose_net_mobilenet.py:31-200 / mobilenet_v2.py) ---
    if mods and mods[0].startswith("MobileNetV2"):
        mods = mods[1:]
        if not mods:
            return None
        bn_leaf = _BN_MAP.get((collection, leaf))
        if mods[0] == "conv_stem" and leaf == "kernel":
            return "MobilenetV2/Conv/weights", ident
        if mods[0] == "stem_bn" and bn_leaf:
            return f"MobilenetV2/Conv/BatchNorm/{bn_leaf}", ident
        if mods[0] == "conv_head" and leaf == "kernel":
            return "MobilenetV2/Conv_1/weights", ident
        if mods[0] == "head_bn" and bn_leaf:
            return f"MobilenetV2/Conv_1/BatchNorm/{bn_leaf}", ident
        m = re.fullmatch(r"block(\d+)_unit(\d+)", mods[0])
        if m:
            base = _mobilenet_scope(int(m.group(1)), int(m.group(2)))
            sub = mods[1]
            if sub == "depthwise" and leaf == "kernel":
                return (f"{base}/depthwise/depthwise_weights",
                        _depthwise_from_tf)
            if sub in ("expand", "project") and leaf == "kernel":
                return f"{base}/{sub}/weights", ident
            bm = re.fullmatch(r"(expand|depthwise|project)_bn", sub)
            if bm and bn_leaf:
                return f"{base}/{bm.group(1)}/BatchNorm/{bn_leaf}", ident
        return None

    # --- heads: pose/{part_pred,locref_pred,intermediate_supervision}/block4 ---
    if mods and mods[0] in _HEAD_SCOPES:
        # flax: params/<head>/block4/{kernel,bias}
        tf_scope = _HEAD_SCOPES[mods[0]]
        if leaf == "kernel":
            return f"{tf_scope}/block4/weights", _deconv_from_tf
        if leaf == "bias":
            return f"{tf_scope}/block4/biases", ident
    return None


def _iter_paths(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _iter_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_path(tree: dict, path: tuple[str, ...], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def import_tf_arrays(state: Mapping, arrays: Mapping[str, np.ndarray],
                     net_type: str = "resnet_50",
                     scopes: tuple[str, ...] | None = None,
                     strict_shapes: bool = True) -> tuple[dict, dict]:
    """Copy TF-named arrays into a port ``PoseModel`` state_dict.

    Args:
      state: the model's state_dict (``model.state_dict()``).
      arrays: mapping of TF variable name -> numpy array (e.g. from
        :func:`load_tf_checkpoint_arrays`).
      net_type: resnet_50 / resnet_101 / resnet_152 / mobilenet_v2_*.
      scopes: if given, only TF names starting with one of these prefixes are
        imported (mirrors the reference's scope-filtered restores,
        ref: fitdgp.py:393-400 — e.g. ``("resnet",)`` for ImageNet
        warm-start, ``("resnet", "pose")`` for a full DGP snapshot).
      strict_shapes: raise on shape mismatch instead of skipping.

    Returns:
      (new_state, report): a float32 state_dict for ``load_state_dict``,
      and report = {'imported': [...], 'missing': [...tf names wanted but
      absent...], 'skipped': [...flax paths with no import...]}.
    """
    variables = flax_from_state_dict(state)
    report = {"imported": [], "missing": [], "skipped": []}
    for path, leaf in list(_iter_paths(variables)):
        entry = tf_name_for_path(path, net_type)
        if entry is None:
            report["skipped"].append("/".join(path))
            continue
        tf_name, transform = entry
        if scopes is not None and not tf_name.startswith(tuple(scopes)):
            report["skipped"].append("/".join(path))
            continue
        if tf_name not in arrays:
            report["missing"].append(tf_name)
            continue
        arr = transform(np.asarray(arrays[tf_name]))
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            msg = (f"shape mismatch for {tf_name}: checkpoint {arr.shape} "
                   f"vs model {np.shape(leaf)}")
            if strict_shapes:
                raise ValueError(msg)
            report["missing"].append(tf_name + f" ({msg})")
            continue
        _set_path(variables, path, np.asarray(arr, dtype=np.float32))
        report["imported"].append(tf_name)
    return state_dict_from_flax(variables), report


def load_tf_checkpoint_arrays(ckpt_path: str,
                              prefix_filter: tuple[str, ...] | None = None
                              ) -> dict[str, np.ndarray]:
    """Read every (optionally prefix-filtered) tensor from a TF checkpoint.

    Works for both slim ImageNet checkpoints (``resnet_v1_50.ckpt``) and TF1
    DGP snapshots (``snapshot-step2-final--0``). Requires tensorflow (reader
    only), imported here so the rest of the port never imports TF.
    """
    try:
        from tensorflow.python.training import py_checkpoint_reader
    except ImportError as e:
        raise ImportError(
            "reading TF checkpoints requires tensorflow; alternatively "
            "export the variables to .npz and use import_tf_arrays") from e
    reader = py_checkpoint_reader.NewCheckpointReader(str(ckpt_path))
    out = {}
    for name in reader.get_variable_to_shape_map():
        if prefix_filter and not name.startswith(tuple(prefix_filter)):
            continue
        out[name] = reader.get_tensor(name)
    return out


def import_tf_checkpoint(state: Mapping, ckpt_path: str,
                         net_type: str = "resnet_50",
                         scopes: tuple[str, ...] | None = None
                         ) -> tuple[dict, dict]:
    """Load + import a TF checkpoint in one call (see import_tf_arrays)."""
    arrays = load_tf_checkpoint_arrays(ckpt_path)
    return import_tf_arrays(state, arrays, net_type=net_type, scopes=scopes)


def export_tf_arrays(state: Mapping,
                     net_type: str = "resnet_50") -> dict[str, np.ndarray]:
    """A port ``PoseModel`` state_dict -> TF-named float32 arrays: the exact
    inverse of :func:`import_tf_arrays` (ResNet-50/101/152, every
    MobileNetV2 width), through the same name map."""
    out = {}
    for path, leaf in _iter_paths(flax_from_state_dict(state)):
        entry = tf_name_for_path(path, net_type)
        if entry is None:
            continue
        tf_name, transform = entry
        arr = np.asarray(leaf, dtype=np.float32)
        if transform is _deconv_from_tf:
            arr = _deconv_to_tf(arr)
        elif transform is _depthwise_from_tf:
            arr = _depthwise_from_tf(arr)
        out[tf_name] = arr
    return out


def write_tf_checkpoint(state: Mapping, ckpt_prefix: str,
                        net_type: str = "resnet_50") -> str:
    """Write a TF1 checkpoint a DLC/DGP TF harness can restore:
    ``<ckpt_prefix>.{index,data-...}`` with slim's variable names
    (``resnet_v1_50/...``, ``pose/part_pred/block4/...``), from a port
    state_dict; the reverse of :func:`import_tf_checkpoint`. Returns the
    prefix the Saver wrote. Requires tensorflow."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "writing TF checkpoints requires tensorflow, which this host "
            "lacks; export_tf_arrays gives the same arrays without it") from e

    arrays = export_tf_arrays(state, net_type)
    g = tf.Graph()
    with g.as_default():
        tf_vars = [tf.compat.v1.get_variable(name,
                                             initializer=tf.constant(val))
                   for name, val in arrays.items()]
        saver = tf.compat.v1.train.Saver(var_list=tf_vars)
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            out = saver.save(sess, str(ckpt_prefix))
    return out
