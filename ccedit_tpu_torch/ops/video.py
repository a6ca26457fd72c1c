"""Layout transforms for the pseudo-3D factorization (port of
``ccedit_tpu/ops/video.py``).  Layouts are channels-last, as in the JAX
package:

  video   : (B, T, H, W, C)
  spatial : (B*T, H, W, C)
  temporal: (H*B*W, T, C)  — rows in h-major order

Under a frame shard (``parallel/shard.py``: the clip's frames split over the
ranks) the fold to temporal rows is an all-to-all: each rank gives up its
frames of the other ranks' blocks of rows and gets every frame of its own
block; the unfold trades them back.  Under a height or width shard the fold
is local, as the h-major order keeps a row's frames together.

Padding (``parallel/shard.py``): under a frame split the (B*H*W) rows are
padded with zero rows to a multiple of the world before the all-to-all and
trimmed after it; under a spatial split a padded level's rows fold to
temporal rows as they are.  ``temporal_apply`` runs a temporal function with
the shard told where its rows' padding lies (``ClipShard.fold_padding``),
which only W8A8's per-tensor amax reads: every temporal op is row-local.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..parallel.shard import active
from ..utils import trace


def fold_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*T, H, W, C)."""
    b, t, h, w, c = x.shape
    return x.reshape(b * t, h, w, c)


def unfold_time(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*T, H, W, C) -> (B, T, H, W, C)."""
    bt, h, w, c = x.shape
    return x.reshape(batch, bt // batch, h, w, c)


def tokens_to_temporal(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*T, H, W, C) -> (H*B*W, T, C); row r holds (h, b, w) =
    (r // (B*W), (r // W) % B, r % W), the JAX package's h-major order."""
    bt, h, w, c = x.shape
    t = bt // batch
    x = x.reshape(batch, t, h, w, c).permute(2, 0, 3, 1, 4)  # (H, B, W, T, C)
    x = x.reshape(batch * h * w, t, c)
    shard = active()
    return shard.frames_to_rows(x) if shard is not None and shard.frame else x


def temporal_to_tokens(x: torch.Tensor, batch: int, h: int, w: int) -> torch.Tensor:
    """(H*B*W, T, C) -> (B*T, H, W, C), inverse of ``tokens_to_temporal``."""
    shard = active()
    if shard is not None and shard.frame:
        x = shard.rows_to_frames(x, batch * h * w)
    _, t, c = x.shape
    x = x.reshape(h, batch, w, t, c).permute(1, 3, 0, 2, 4)  # (B, T, H, W, C)
    return x.reshape(batch * t, h, w, c)


def temporal_apply(xs: torch.Tensor, batch: int, fn: Callable) -> torch.Tensor:
    """``fn`` over the temporal rows of ``xs`` (B*T, H, W, C): (B*T, H, W,
    C') out.  Under a shard whose fold carries padding, ``fn`` runs with the
    shard told where it lies (``ClipShard.folded``)."""
    _, h, w, _ = xs.shape
    shard = active()
    with trace.span(trace.TEMPORAL):
        pad = shard.fold_padding(xs, batch) if shard is not None and shard.world > 1 else None
        xt = tokens_to_temporal(xs, batch)
        with shard.folded(pad) if pad is not None else contextlib.nullcontext():
            y = fn(xt)
        return temporal_to_tokens(y, batch, h, w)


def repeat_ctx_temporal(context: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, L, D) -> (H*B*W, L, D), aligned with ``tokens_to_temporal`` (this
    rank's block of the rows, zero rows padding them, under a frame
    shard)."""
    inner = torch.repeat_interleave(context, w, dim=0)  # (B*W, L, D), b-major
    rows = inner.repeat(h, 1, 1)
    shard = active()
    if shard is None or not shard.frame:
        return rows
    per = shard.blocks(rows.shape[0])
    if per * shard.world != rows.shape[0]:
        rows = torch.cat([rows, rows.new_zeros((per * shard.world - rows.shape[0],)
                                               + tuple(rows.shape[1:]))])
    return shard.block(rows, 0)
