"""DLC-style decoders: argmax + locref refinement, and top-k multi-output.

Counterpart of ``deepgraphpose_tpu/ops/decode.py`` (ref:
deeplabcut/pose_estimation_tensorflow/nnet/predict.py: extract_cnn_output
45-60, argmax_pose_predict 62-77, get_top_values / multi_pose_predict
79-116, 186-216). They complement the DGP soft-argmax decode: DLC's
analyze and evaluate paths use the hard argmax, and ``evaluate_dgp``
compares both. Batched tensor ops on the heads' device; no hand kernel,
since the reference left this math to XLA.

Order among equal scores follows the JAX package: the argmax is the first
maximum (``torch.argmax`` and ``jnp.argmax`` agree), and the top k are
best-first with the lower flat index first among ties, as
``jax.lax.top_k`` returns them. ``torch.topk`` promises no order among
ties, so the top k come from a stable descending sort.
"""

from __future__ import annotations

import torch


def extract_cnn_output(part_pred: torch.Tensor,
                       locref: torch.Tensor | None,
                       locref_stdev: float = 7.2801) -> tuple:
    """(sigmoid scoremap, locref offsets in px) from raw head outputs.

    part_pred: (B, H, W, nj) logits; locref: (B, H, W, 2*nj) or None.
    locref comes back as (B, H, W, nj, 2) * locref_stdev, (dx, dy) last.
    Both run in the heads' own dtype as JAX computes them: the sigmoid as
    1 / (1 + exp(-x)) with each step rounded to it (XLA's lowering of
    ``jax.nn.sigmoid``; in bfloat16 up to a step from ``torch.sigmoid``'s
    correctly rounded value, which decides the ties), and locref_stdev
    rounded to it before the product.
    """
    scmap = 1.0 / (1.0 + torch.exp(-part_pred))
    if locref is None:
        return scmap, None
    b, h, w, _ = locref.shape
    nj = part_pred.shape[-1]
    return scmap, (locref.reshape(b, h, w, nj, 2)
                   * locref.new_tensor(locref_stdev))


def _pixels(rows, cols, stride: float, off) -> tuple:
    """Cell indices -> (x, y) px: loc * stride + stride/2, plus the locref
    offset stored (dx, dy) and applied onto (col, row)."""
    x = cols.to(torch.float32) * stride + 0.5 * stride
    y = rows.to(torch.float32) * stride + 0.5 * stride
    if off is not None:
        x = x + off[..., 0]
        y = y + off[..., 1]
    return x, y


def _gather_cells(t: torch.Tensor, rows, cols) -> torch.Tensor:
    """t[b, rows[b, ..., j], cols[b, ..., j], j, ...] for (B, ..., nj)
    indices into a (B, H, W, nj, ...) tensor."""
    b = torch.arange(t.shape[0], device=t.device).view(
        -1, *([1] * (rows.dim() - 1)))
    j = torch.arange(t.shape[3], device=t.device)
    return t[b, rows, cols, j]


def argmax_pose_decode(part_pred: torch.Tensor,
                       locref: torch.Tensor | None,
                       stride: float = 8.0,
                       locref_stdev: float = 7.2801) -> torch.Tensor:
    """Batched argmax + locref decode -> (B, nj, 3) [x, y, likelihood]."""
    scmap, off = extract_cnn_output(part_pred, locref, locref_stdev)
    b, h, w, nj = scmap.shape
    idx = scmap.reshape(b, h * w, nj).argmax(dim=1)          # (B, nj)
    rows, cols = idx // w, idx % w
    x, y = _pixels(rows, cols, stride,
                   None if off is None else _gather_cells(off, rows, cols))
    lik = _gather_cells(scmap, rows, cols)
    return torch.stack([x, y, lik.to(x.dtype)], dim=-1)


def get_top_values(scmap: torch.Tensor, n_top: int) -> tuple:
    """Top-k scoremap peaks per joint (ref: predict.py:186-199).

    scmap: (B, H, W, nj) -> (Y, X) each (B, n_top, nj) integer locations,
    best-first, the lower flat index first among equal scores.
    """
    b, h, w, nj = scmap.shape
    flat = scmap.reshape(b, h * w, nj).transpose(1, 2)       # (B, nj, HW)
    idx = torch.sort(flat, dim=-1, descending=True,
                     stable=True).indices[..., :n_top]
    idx = idx.transpose(1, 2)                                # (B, k, nj)
    return idx // w, idx % w


def multi_pose_decode(part_pred: torch.Tensor, locref: torch.Tensor | None,
                      num_outputs: int, stride: float = 8.0,
                      locref_stdev: float = 7.2801) -> torch.Tensor:
    """Top-k decode -> (B, nj, num_outputs, 3) [x, y, likelihood] per peak
    (ref: predict.py:79-116, the num_outputs > 1 path of analyze_videos)."""
    scmap, off = extract_cnn_output(part_pred, locref, locref_stdev)
    Y, X = get_top_values(scmap, num_outputs)                # (B, k, nj)
    lik = _gather_cells(scmap, Y, X)
    x, y = _pixels(Y, X, stride,
                   None if off is None else _gather_cells(off, Y, X))
    out = torch.stack([x, y, lik.to(x.dtype)], dim=-1)       # (B, k, nj, 3)
    return out.transpose(1, 2)                               # (B, nj, k, 3)
