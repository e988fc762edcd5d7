"""Local pretrained-weight resolution (ref: utils/auxfun_models.py).

The port's own copy of the local lookup in
``deepgraphpose_tpu/models/pretrained.py``. The reference's
``Check4weights`` resolves ImageNet TF checkpoints under
``pose_estimation_tensorflow/models/pretrained/`` (ref:
auxfun_models.py:15-35); here the same resolution contract runs against
local search roots only, and nothing is ever downloaded
(:func:`download_weights` raises). When a
checkpoint is absent the training entry points fall back to a seeded
random init (``fit_dlc`` then trains batch-norm).

Search order for ``check_for_weights``:

1. an explicit ``parent_path`` (mirrors the reference's signature),
2. ``$DGP_PRETRAINED_DIR``,
3. ``deepgraphpose_tpu_torch/models/pretrained/`` next to this file.
"""

from __future__ import annotations

import os
from pathlib import Path

# reference filename contract (auxfun_models.py:17-26)
MODEL_FILENAMES = {
    "resnet_50": "resnet_v1_50.ckpt",
    "resnet_101": "resnet_v1_101.ckpt",
    "resnet_152": "resnet_v1_152.ckpt",
    "mobilenet_v2_1.0": "mobilenet_v2_1.0_224.ckpt",
    "mobilenet_v2_0.75": "mobilenet_v2_0.75_224.ckpt",
    "mobilenet_v2_0.5": "mobilenet_v2_0.5_224.ckpt",
    "mobilenet_v2_0.35": "mobilenet_v2_0.35_224.ckpt",
}

# DeeperCut MPII human model the reference downloads for
# create_pretrained_human_project (auxfun_models.py:58-76)
MPII_SNAPSHOT = "snapshot-1030000"


def pretrained_search_roots(parent_path: str | Path | None = None
                            ) -> list[Path]:
    roots: list[Path] = []
    if parent_path:
        roots.append(Path(parent_path))
    env = os.environ.get("DGP_PRETRAINED_DIR")
    if env:
        roots.append(Path(env))
    roots.append(Path(__file__).resolve().parent / "pretrained")
    return roots


def _tf_ckpt_exists(prefix: Path) -> bool:
    return Path(str(prefix) + ".index").exists() or prefix.exists()


def find_pretrained(modeltype: str,
                    parent_path: str | Path | None = None) -> Path | None:
    """Return the checkpoint prefix for ``modeltype`` if present locally."""
    fname = MODEL_FILENAMES.get(modeltype)
    if fname is None:
        return None
    for root in pretrained_search_roots(parent_path):
        prefix = root / fname
        if _tf_ckpt_exists(prefix):
            return prefix
    return None


def check_for_weights(modeltype: str,
                      parent_path: str | Path | None = None,
                      num_shuffles: int = 1) -> tuple[str, int]:
    """Reference-shaped ``Check4weights`` (auxfun_models.py:15-35).

    Returns ``(checkpoint_prefix, num_shuffles)``; unknown model types set
    ``num_shuffles=-1`` exactly as the reference does. A missing checkpoint
    is NOT an error here: the path is still returned so pose_cfg.yaml can
    record the canonical ``init_weights``, and training falls back to
    from-scratch init (trainable BN) when the file never appears.
    """
    if modeltype not in MODEL_FILENAMES:
        print("Currently ResNet (50, 101, 152) and MobilenetV2 "
              "(1, 0.75, 0.5 and 0.35) are supported, please change "
              "'resnet' entry in config.yaml!")
        return str(parent_path or ""), -1
    found = find_pretrained(modeltype, parent_path)
    if found is not None:
        return str(found), num_shuffles
    roots = pretrained_search_roots(parent_path)
    canonical = roots[-1] / MODEL_FILENAMES[modeltype]
    print(f"note: no local {modeltype} ImageNet checkpoint found under "
          f"{[str(r) for r in roots]}; place "
          f"{MODEL_FILENAMES[modeltype]}.{{index,data-*}} there or set "
          f"DGP_PRETRAINED_DIR. Training will fall back to from-scratch "
          f"init (trainable BN).")
    return str(canonical), num_shuffles


def download_weights(modeltype: str, model_path: str | Path) -> None:
    """The reference downloads from tensorflow.org (auxfun_models.py:37-56);
    this package has no network access and downloads nothing."""
    raise RuntimeError(
        f"no network egress to download '{modeltype}' weights; place the "
        f"TF checkpoint at {model_path} yourself (any slim "
        f"resnet_v1_*/mobilenet_v2_* export works — "
        f"deepgraphpose_tpu_torch.models.tf_import converts it on load) or "
        f"set DGP_PRETRAINED_DIR to a directory that holds it")
