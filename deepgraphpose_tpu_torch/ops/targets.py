"""Target rasterization on the device, in PyTorch.

The port's own copy of ``deepgraphpose_tpu/ops/targets.py``. The reference
rasterizes scoremap / location-refinement targets on the host with
per-pixel Python loops (ref: deeplabcut/pose_estimation_tensorflow/
dataset/pose_defaultdataset.py:220-266 compute_target_part_scoremap, and
src/deepgraphpose/dataset.py:246-271 coord2map) and builds Gaussian target
maps in-graph (ref: src/deepgraphpose/models/fitdgp.py:964-976). Here every
target is a vectorized broadcast over the (H, W) grid, computed inside the
train step from keypoint coordinates: the host ships only (T, nj, 2)
coords. NaN coordinates (hidden joints) rasterize to nothing.
"""

from __future__ import annotations

import torch


def _grid(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device)


def gaussian_target_maps(coords: torch.Tensor, height: int, width: int,
                         lengthscale: float) -> torch.Tensor:
    """Per-marker Gaussian bump maps, peak-normalized to 1.

    Args:
      coords: (N, 2) target (row, col) coordinates in scoremap space.
      height, width: scoremap dims.
      lengthscale: Gaussian lengthscale (ref cfg.lengthscale).

    Returns:
      (N, height, width) maps ``exp(-((r-r0)^2+(c-c0)^2)/(2*ls^2)) / (max+1e-5)``
      (ref: fitdgp.py:968-976; the reference divides by max + 1e-5).
    """
    rows = _grid(height, coords)[None, :, None]
    cols = _grid(width, coords)[None, None, :]
    dr = rows - coords[:, 0][:, None, None]
    dc = cols - coords[:, 1][:, None, None]
    g = torch.exp(-(dr * dr + dc * dc) / (2.0 * lengthscale ** 2))
    peak = torch.amax(g, dim=(1, 2), keepdim=True) + 1e-5
    return g / peak


def dlc_scoremap_targets(
    coords_xy: torch.Tensor,
    present: torch.Tensor,
    height: int,
    width: int,
    stride: float,
    pos_dist_thresh: float,
    locref_stdev: float,
    scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized DLC disk scoremap + locref targets.

    Args:
      coords_xy: (T, nj, 2) keypoint (x, y) *pixel* coordinates (input space,
        already multiplied by any global scale). NaNs allowed where absent.
      present: (T, nj) bool/float: joint labeled in this frame.
      height, width: scoremap dims.
      stride: total network stride (8).
      pos_dist_thresh: disk radius in *scoremap* units before scaling
        (ref: pose_defaultdataset.py:221 ``dist_thresh = pos_dist_thresh * scale``).
      locref_stdev: locref normalization (offsets scaled by 1/locref_stdev).
      scale: the global/jitter scale applied to the image.

    Returns:
      scmap:       (T, H, W, nj)    binary disk targets
      locref_map:  (T, H, W, nj*2)  (dx, dy) * (1/locref_stdev) inside disk
      locref_mask: (T, H, W, nj*2)  disk indicator
    """
    dtype = torch.promote_types(coords_xy.dtype, torch.float32)
    coords_xy = torch.nan_to_num(coords_xy.to(dtype), nan=-1e6)
    present = present.to(dtype)

    dist_thresh = pos_dist_thresh * scale
    half_stride = stride / 2.0
    # grid point centers in pixel space (ref: pose_defaultdataset.py:246-250)
    pt_y = _grid(height, coords_xy)[None, :, None, None] * stride + half_stride
    pt_x = _grid(width, coords_xy)[None, None, :, None] * stride + half_stride

    jx = coords_xy[..., 0][:, None, None, :]  # (T,1,1,nj)
    jy = coords_xy[..., 1][:, None, None, :]
    dx = jx - pt_x
    dy = jy - pt_y
    dist_sq = dx * dx + dy * dy
    inside = (dist_sq <= dist_thresh * dist_thresh).to(dtype)
    inside = inside * present[:, None, None, :]

    locref_scale = 1.0 / locref_stdev
    lx = dx * locref_scale * inside
    ly = dy * locref_scale * inside
    # interleave to channel layout [dx_0, dy_0, dx_1, dy_1, ...]
    t, nj = coords_xy.shape[:2]
    locref_map = torch.stack([lx, ly], dim=-1).reshape(t, height, width,
                                                       nj * 2)
    locref_mask = torch.stack([inside, inside], dim=-1).reshape(
        t, height, width, nj * 2)
    return inside, locref_map, locref_mask


def locref_targets_from_scoremap_coords(
    coords_rc: torch.Tensor,
    present: torch.Tensor,
    height: int,
    width: int,
    stride: float,
    pos_dist_thresh: float,
    locref_stdev: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DGP's coord2map: targets given (row, col) *scoremap-space* coords.

    The reference converts scoremap coords back to pixels with the hard-coded
    ``* 8 + 4`` (ref: src/deepgraphpose/dataset.py:246-271, line 252) then
    rasterizes with DLC's routine; here the stride is a parameter.
    """
    coords_xy = torch.stack(
        [coords_rc[..., 1] * stride + stride / 2.0,
         coords_rc[..., 0] * stride + stride / 2.0], dim=-1)
    return dlc_scoremap_targets(
        coords_xy, present, height, width, stride,
        pos_dist_thresh, locref_stdev, scale=1.0)
