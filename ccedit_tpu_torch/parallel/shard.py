"""Single-clip sharding over ``torch.distributed``: the shard context and its
collectives (port of the mesh half of ``ccedit_tpu/ops/attention.py``:
``mesh_context``, ``_sharded_attention``, and of the collectives that GSPMD
inserts for ``ccedit_tpu/parallel/sampling.py``).

One clip's latents (B, T, H, W, C) are split over the ranks of a process
group in contiguous blocks along one axis: the frame axis (1), the height
axis (2) or the width axis (3) (``parallel/sampling.py::pick_clip_axis``).
While a ``ClipShard`` is entered (``mesh_context``), the network's modules
read it and issue, explicitly, the collectives that XLA inserts for the JAX
package:

* height or width axis (a spatial shard): a k x k convolution takes k // 2
  halo rows (or columns) from each neighbour, zeros only at the clip's true
  edges (``halo``; a stride-2 one only the row before its block); a
  GroupNorm that normalises images all-reduces its per-(sample, group) sum
  and sum of squares in fp32 (``all_reduce_stats``); a self-attention over
  clip tokens gathers its k and v along the token axis, q staying local
  (``gather_tokens``, JAX's token branch).  The temporal ops stay local:
  the h-major fold keeps a (h, b, w) row's frames on one rank.  Under W8A8
  a k x k ``QConv`` takes its halo rows as int8 (``halo`` of the int8
  rows, census kind "int8_halo").
* frame axis: the spatial ops are local.  The fold to temporal rows and
  back is an all-to-all that trades frame blocks for blocks of the h-major
  (H*B*W) rows (``frames_to_rows`` / ``rows_to_frames``, JAX's batch branch
  of the folded axis), and the centre frame (the CFCA anchor, the
  appearance branch's input) is broadcast by the rank that holds it
  (``centre_frame``).
* any axis, under W8A8: each per-tensor quantization's amax is the whole
  clip's, a MAX all-reduce of its fp32 bits (``all_reduce_amax``).

At world 1 every op is the unsharded one, so a world-1 sample equals
``engine.sample`` bit for bit.  Each collective adds a record to every open
``census``.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

AXES = {1: "frame", 2: "height", 3: "width"}

# all_gather_into_tensor under its newer name where torch has it
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_ACTIVE: List[Optional["ClipShard"]] = []
_CENSUS: List[list] = []


class ClipShard:
    """This rank's place in a clip split along ``axis`` (1, 2 or 3 of the
    (B, T, H, W, C) latents) over ``group`` (the default group when None;
    world 1 outside a process group).  ``frames`` is the clip's T."""

    def __init__(self, axis: int, frames: int, group=None):
        if axis not in AXES:
            raise ValueError(f"clip axis {axis} (one of {sorted(AXES)})")
        self.axis, self.frames, self.group = axis, frames, group
        if dist.is_initialized():
            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1
        if axis == 1 and frames % self.world:
            raise ValueError(f"{frames} frames do not divide over {self.world} ranks")

    @property
    def spatial(self) -> bool:
        """Split along height or width, over more than one rank."""
        return self.world > 1 and self.axis in (2, 3)

    @property
    def frame(self) -> bool:
        """Split along the frames, over more than one rank."""
        return self.world > 1 and self.axis == 1

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous block of ``x`` along ``dim``."""
        n = x.shape[dim]
        if n % self.world:
            raise ValueError(f"size {n} of dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {self.world} ranks")
        size = n // self.world
        return x.narrow(dim, self.rank * size, size)

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------
    def _record(self, kind: str, t: torch.Tensor, received: int, **more) -> None:
        for census in _CENSUS:
            census.append(dict(kind=kind, shape=tuple(t.shape), dtype=str(t.dtype),
                               bytes=received * t.element_size(), **more))

    def halo(self, x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
        """``x`` with ``before`` rows of the previous rank's block and
        ``after`` of the next rank's on either side along ``dim``, zero rows
        past the clip's edges."""
        if x.shape[dim] < max(before, after):
            raise ValueError(f"a block of {x.shape[dim]} rows is narrower than a halo of "
                             f"{max(before, after)}")
        prev_rank = self.rank - 1 if self.rank > 0 else None
        next_rank = self.rank + 1 if self.rank < self.world - 1 else None
        glob = lambda r: dist.get_global_rank(self.group, r) if self.group is not None else r
        ops, top, bottom = [], None, None

        def rows(start, n):
            return x.narrow(dim, start, n).contiguous()

        def empty(n):
            shape = list(x.shape)
            shape[dim] = n
            return x.new_zeros(shape)

        if before:
            top = empty(before)
            if prev_rank is not None:
                ops.append(dist.P2POp(dist.irecv, top, glob(prev_rank), self.group))
            if next_rank is not None:
                ops.append(dist.P2POp(dist.isend, rows(x.shape[dim] - before, before),
                                      glob(next_rank), self.group))
        if after:
            bottom = empty(after)
            if next_rank is not None:
                ops.append(dist.P2POp(dist.irecv, bottom, glob(next_rank), self.group))
            if prev_rank is not None:
                ops.append(dist.P2POp(dist.isend, rows(0, after), glob(prev_rank), self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        received = ((before if prev_rank is not None else 0)
                    + (after if next_rank is not None else 0))
        row = x.numel() // x.shape[dim]
        self._record("int8_halo" if x.dtype == torch.int8 else "halo", x, received * row,
                     rows=(before, after), row=row)
        return torch.cat([t for t in (top, x, bottom) if t is not None], dim=dim)

    def all_reduce_stats(self, stats: torch.Tensor) -> torch.Tensor:
        """Sum ``stats`` (a GroupNorm's fp32 sums) over the ranks, in place."""
        dist.all_reduce(stats, group=self.group)
        self._record("norm_all_reduce", stats, stats.numel() * (self.world - 1))
        return stats

    def all_reduce_amax(self, word: torch.Tensor) -> torch.Tensor:
        """The MAX over the ranks of ``word``, in place: int32 views of
        non-negative fp32 amaxes (kernel 8's amax word), which order as
        their bits, so the clip's amax comes out exactly in any order."""
        dist.all_reduce(word, op=dist.ReduceOp.MAX, group=self.group)
        self._record("amax_all_reduce", word, word.numel() * (self.world - 1))
        return word

    def gather_tokens(self, x: torch.Tensor, segments: int = 1) -> torch.Tensor:
        """(N, segments * L, C) blocks of tokens -> (N, segments * world * L,
        C): each segment's blocks in rank order (the global token order under
        height sharding, h-major; under width sharding a permutation of it,
        which attention does not see)."""
        n, l, c = x.shape
        out = x.new_empty((self.world * n, l, c))
        _all_gather_single(out, x.contiguous(), group=self.group)
        self._record("kv_all_gather", x, x.numel() * (self.world - 1))
        out = out.view(self.world, n, segments, l // segments, c).permute(1, 2, 0, 3, 4)
        return out.reshape(n, segments * self.world * (l // segments), c)

    def frames_to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(R, T / world, C) temporal rows of this rank's frames -> (R /
        world, T, C): this rank's block of the rows with every frame."""
        r, t, c = x.shape
        if r % self.world:
            raise ValueError(f"{r} temporal rows do not divide over {self.world} ranks")
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.group)
        self._record("all_to_all", x, x.numel() // self.world * (self.world - 1))
        out = out.view(self.world, r // self.world, t, c)
        return out.permute(1, 0, 2, 3).reshape(r // self.world, self.world * t, c)

    def rows_to_frames(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of ``frames_to_rows``: (R / world, T, C) -> (R, T / world, C)."""
        r, t, c = x.shape
        src = x.view(r, self.world, t // self.world, c).permute(1, 0, 2, 3)
        src = src.reshape(self.world * r, t // self.world, c)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        self._record("all_to_all", x, x.numel() // self.world * (self.world - 1))
        return out.reshape(self.world * r, t // self.world, c)

    def local_centre(self) -> Optional[int]:
        """The local index of the clip's centre frame T // 2 on the rank
        that holds it, else None (every rank holds it unless frame-split)."""
        if not self.frame:
            return None
        per = self.frames // self.world
        owner, index = divmod(self.frames // 2, per)
        return index if owner == self.rank else None

    def centre_frame(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T / world, ...) -> the clip's centre frame (B, ...), broadcast
        by the rank that holds it."""
        per = self.frames // self.world
        owner, index = divmod(self.frames // 2, per)
        buf = x[:, index].contiguous() if owner == self.rank else x.new_empty(
            (x.shape[0],) + tuple(x.shape[2:]))
        src = dist.get_global_rank(self.group, owner) if self.group is not None else owner
        dist.broadcast(buf, src, group=self.group)
        self._record("broadcast", buf, 0 if owner == self.rank else buf.numel())
        return buf


def active() -> Optional[ClipShard]:
    """The entered shard, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def mesh_context(shard: ClipShard):
    """``with mesh_context(shard): engine.sample(...)``: the network's
    modules read ``shard`` while the block runs."""
    _ACTIVE.append(shard)
    try:
        yield shard
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def unsharded():
    """No shard while the block runs: for work every rank repeats on the
    same whole tensors (a frame shard's broadcast centre frame)."""
    _ACTIVE.append(None)
    try:
        yield
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def census():
    """Collect every collective the block issues: a list of records
    ``{"kind", "shape" (the local tensor sent), "dtype", "bytes"
    (received by this rank)}``, kind one of "halo", "int8_halo" (a W8A8
    convolution's int8 rows), "norm_all_reduce", "amax_all_reduce" (a
    per-tensor quantization's amax), "kv_all_gather", "all_to_all" and
    "broadcast"; a halo's record also has ``rows`` (taken from the previous
    and the next rank) and ``row`` (the elements of one row)."""
    records: list = []
    _CENSUS.append(records)
    try:
        yield records
    finally:
        _CENSUS.remove(records)


def clip_randn(shape: Sequence[int], generator: Optional[torch.Generator],
               device, dtype=torch.float32) -> torch.Tensor:
    """A standard normal draw of ``shape``; under a shard, ``shape`` is this
    rank's block and the draw is the whole clip's, of which the block is
    kept, so the stream does not depend on the world size."""
    shard = active()
    if shard is None or shard.world == 1:
        return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
    full = list(shape)
    full[shard.axis] *= shard.world
    draw = torch.randn(tuple(full), generator=generator, device=device, dtype=dtype)
    return shard.block(draw, shard.axis).contiguous()
