"""Hidden-frame selection by motion energy (the port's own copy).

Semantics per the reference (ref: src/deepgraphpose/dataset.py:46-101
select_hidden_frames, 104-119 get_neighboring_window, 517-556
_find_good_hidden_frames): rank unlabeled frames by motion energy
descending, greedily accept frames that are (a) outside the +/-ns window
around visible frames, (b) at least ns away from already-accepted frames,
(c) keep |selected ∪ windows| <= n_max_frames.
"""

from __future__ import annotations

import os

from pathlib import Path

import numpy as np


def neighboring_window(anchors: np.ndarray, ns: int, n_frames: int,
                       n_min: int = 0) -> np.ndarray:
    """Union of [a-ns, a+ns] around each anchor, clipped to [n_min, n_frames)."""
    anchors = np.asarray(anchors, dtype=np.int64)
    if anchors.size == 0:
        return np.empty(0, dtype=np.int64)
    offsets = np.arange(-ns, ns + 1)
    win = np.unique(anchors[:, None] + offsets[None, :])
    return win[(win >= n_min) & (win < n_frames)]


def select_hidden_frames(visible: np.ndarray, me_rank: np.ndarray,
                         n_frames: int, ns: int, n_max_frames: int,
                         ns_jump: int | None = None) -> np.ndarray:
    """Greedy hidden-frame pick from a motion-energy-sorted candidate list.

    Args:
      visible: labeled frame indices.
      me_rank: ALL frame indices sorted by motion energy, descending.
      n_frames: video length.
      ns: one-sided window size.
      n_max_frames: cap on |selected ∪ windows|.
      ns_jump: closeness slack; min spacing is max(ns - ns_jump, 1)
        (defaults to ns, i.e. spacing 1 — reference default).
    """
    visible = np.asarray(visible, dtype=np.int64)
    if ns_jump is None:
        ns_jump = ns
    ns_small = max(ns - ns_jump, 1)

    vis_windowed = neighboring_window(visible, ns, n_frames)
    selected = np.empty(0, dtype=np.int64)
    if len(vis_windowed) >= n_max_frames:
        return selected

    candidates = me_rank[~np.isin(me_rank, vis_windowed)]
    accepted = visible.copy()
    for c in candidates:
        if len(accepted) > 0 and np.min(np.abs(c - accepted)) < ns_small:
            continue
        covered = neighboring_window(np.append(accepted, c), ns, n_frames)
        if len(covered) > n_max_frames:
            break
        selected = np.append(selected, c)
        accepted = np.append(accepted, c)
    return selected


def hidden_frames_for_video(video_path: str | Path, visible: np.ndarray,
                            n_frames: int, ns: int, n_max_frames: int,
                            cache_dir: str | Path | None = None,
                            resize_to: int | None = 256) -> np.ndarray:
    """Motion-energy pass + greedy selection, with .npy caching.

    The reference caches under the video's directory
    (ref: dataset.py:546-556); here the cache dir is configurable because
    the project may be read-only.
    """
    from deepgraphpose_tpu_torch.data.video import motion_energy

    video_path = Path(video_path)
    me = None
    cache_file = None
    if cache_dir is not None:
        cache_file = (Path(cache_dir)
                      / f"{video_path.stem}_motion_energy.npy")
        if cache_file.exists():
            me = np.load(cache_file)
    if me is None:
        me = motion_energy(video_path, resize_to=resize_to)
        if cache_file is not None:
            # written whole, then renamed: ranks of a data-parallel run
            # may build the same cache at once
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            part = cache_file.with_suffix(f".{os.getpid()}.npy")
            np.save(part, me)
            os.replace(part, cache_file)
    if len(me) < n_frames:
        me = np.pad(me, (0, n_frames - len(me)))
    rank = np.argsort(me[:n_frames])[::-1].astype(np.int64)
    return select_hidden_frames(visible, rank, n_frames, ns, n_max_frames)
