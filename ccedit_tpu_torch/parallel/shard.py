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
  (``centre_frame``; the first and the last frame likewise, for the
  interpolation branch, ``frame_at``).  Blending and the k/v reuse across
  frames gather the frames they move (``gather``).
* any axis, under W8A8: each per-tensor quantization's amax is the whole
  clip's, a MAX all-reduce of its fp32 bits (``all_reduce_amax``).

Padding, GSPMD's layout for what does not divide: a UNet level of R rows
on a spatial split's axis lies in blocks of ceil(R / world) rows, rank r
holding rows [r * block, (r + 1) * block), and the rows past R (the tail of
the clip, on the last ranks; a rank may hold only padding) are padding.
The shard reads a level's R from the size of its other spatial axis, which
no rank splits (``size``, the latent's (H, W); the levels halve both).
Padding rows hold anything except where an op reads across rows: a k x k
convolution zeroes them first (``zero_padding``), as the clip's zero
padding would read; an image GroupNorm leaves them out of its statistics
(``padding``); the k/v gather drops their tokens; under W8A8 they are zero
where a per-tensor amax reads them (``layers.padded``).  A stride-2 level
transition or an upsampling that does not keep the blocks 2:1 moves rows
between the ranks (``reblock``, census kind "reblock").  The temporal rows
a padded level folds to carry its padding (``fold_padding``, entered by
``ops/video.py::temporal_apply``); under a frame split the (B*H*W) rows
the fold trades are padded with zero rows to a multiple of the world.  A
level that divides is exactly the unpadded block, with no op and no
collective more.

At world 1 every op is the unsharded one, so a world-1 sample equals
``engine.sample`` bit for bit.  Each collective adds a record to every open
``census``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = {1: "frame", 2: "height", 3: "width"}

# all_gather_into_tensor under its newer name where torch has it
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_ACTIVE: List[Optional["ClipShard"]] = []
_CENSUS: List[list] = []


@dataclasses.dataclass(frozen=True)
class Padding:
    """Where a tensor's padding lies on this rank: viewed as ``lead`` + (-1,)
    (its leading dims), the entries past ``valid`` along ``dim`` are
    padding; the level holds ``rows`` real rows in blocks of
    ``lead[dim]``."""

    lead: Tuple[int, ...]
    dim: int
    valid: int
    rows: int

    @property
    def block(self) -> int:
        return self.lead[self.dim]

    def real(self, x: torch.Tensor) -> torch.Tensor:
        """x's real part, its leading dims (``lead``) kept, the rest flat."""
        return x.reshape(self.lead + (-1,)).narrow(self.dim, 0, self.valid)


class ClipShard:
    """This rank's place in a clip split along ``axis`` (1, 2 or 3 of the
    (B, T, H, W, C) latents) over ``group`` (the default group when None;
    world 1 outside a process group).  ``frames`` is the clip's T; ``size``
    the latent's (H, W), from which a spatial split reads every level's
    rows."""

    def __init__(self, axis: int, frames: int, group=None, *, size: Tuple[int, int]):
        if axis not in AXES:
            raise ValueError(f"clip axis {axis} (one of {sorted(AXES)})")
        self.axis, self.frames, self.group = axis, frames, group
        self.size = tuple(size)
        self._folds: List[Optional[Padding]] = []
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
    # padding (GSPMD's layout of a level that does not divide)
    # ------------------------------------------------------------------
    def blocks(self, rows: int) -> int:
        """The block of a level of ``rows`` rows: ceil(rows / world)."""
        return -(-rows // self.world)

    def valid(self, rows: int, block: int) -> int:
        """How many of this rank's ``block`` rows are real."""
        return max(0, min(block, rows - self.rank * block))

    def split_dim(self, x) -> int:
        """The split axis's dim of an image (N, H, W, C) or a clip (B, T, H,
        W, C) ``x`` (anything with a ``shape``)."""
        return self.axis - 5 + len(x.shape)

    def level_rows(self, x, dim: int) -> int:
        """The rows of ``x``'s level on the split axis (``dim`` of an image
        or a clip), read from its other spatial axis, which no rank splits:
        the levels halve both."""
        block = x.shape[dim]
        other = dim + 1 if self.axis == 2 else dim - 1
        split, whole = self.size if self.axis == 2 else self.size[::-1]
        rows, rem = divmod(split * x.shape[other], whole)
        if rem or self.blocks(rows) != block:
            raise ValueError(f"{tuple(x.shape)} is no level of a {self.size} latent split "
                             f"on {AXES[self.axis]} over {self.world} ranks")
        return rows

    def padding(self, x) -> Optional[Padding]:
        """Where ``x``'s padding lies, or None where it has none: an image or
        a clip under a spatial split at a level that does not divide; the
        temporal rows of the fold entered last (``fold_padding``)."""
        if len(x.shape) == 3:
            pad = self._folds[-1] if self._folds else None
            return pad if pad is not None and x.shape[0] == math.prod(pad.lead) else None
        if not self.spatial:
            return None
        dim = self.split_dim(x)
        rows = self.level_rows(x, dim)
        block = x.shape[dim]
        if rows == block * self.world:
            return None
        return Padding(tuple(x.shape[:dim + 1]), dim, self.valid(rows, block), rows)

    def zero_padding(self, x: torch.Tensor, pad: Optional[Padding] = None) -> torch.Tensor:
        """``x`` with its padding (``pad``, else ``padding(x)``) zeroed: a
        copy, or x itself where it has none."""
        pad = pad if pad is not None else self.padding(x)
        if pad is None:
            return x
        y = x.clone(memory_format=torch.contiguous_format)
        y.view(pad.lead + (-1,)).narrow(pad.dim, pad.valid, pad.block - pad.valid).zero_()
        return y

    def fold_padding(self, x: torch.Tensor, batch: int) -> Optional[Padding]:
        """The padding of the temporal rows that ``x`` (B*T, H, W, C), this
        rank's block, folds to (``ops/video.py``): h-major (h, b, w) rows,
        whose padding is a padded level's rows under a spatial split and the
        zero rows ``frames_to_rows`` adds under a frame split."""
        if self.frame:
            rows = batch * x.shape[1] * x.shape[2]
            per = self.blocks(rows)
            if per * self.world == rows:
                return None
            return Padding((per,), 0, self.valid(rows, per), rows)
        pad = self.padding(x)
        if pad is None:
            return None
        _, h, w, _ = x.shape
        lead = (h, batch * w) if pad.dim == 1 else (h * batch, w)
        return Padding(lead, pad.dim - 1, pad.valid, pad.rows)

    @contextlib.contextmanager
    def folded(self, pad: Optional[Padding]):
        """While the block runs, ``padding`` of the temporal rows is ``pad``."""
        self._folds.append(pad)
        try:
            yield
        finally:
            self._folds.pop()

    def stride2_blocks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``, an image in front of a stride-2 level transition (a
        stride-2 convolution, a 2x2 pool), in blocks of twice the next
        level's block (``reblock``) where its own are not."""
        rows = self.level_rows(x, dim)
        block = 2 * self.blocks(-(-rows // 2))
        return x if block == x.shape[dim] else self.reblock(x, dim, rows, block)

    def upsampled_blocks(self, y: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
        """``y``, the 2x nearest upsampling of this rank's block of a level,
        in the blocks of its own level of ``rows`` rows (``reblock``) where
        twice the input's are not."""
        block = self.blocks(rows)
        return y if block == y.shape[dim] else self.reblock(y, dim, rows, block)

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

    def reblock(self, x: torch.Tensor, dim: int, rows: int, block: int) -> torch.Tensor:
        """``x``, this rank's block along ``dim`` of a level of ``rows`` rows
        in blocks of x.shape[dim] -> its block in blocks of ``block``, zero
        rows past ``rows``: each rank sends each other the real rows that
        change hands, nothing else."""
        have = x.shape[dim]
        glob = lambda r: dist.get_global_rank(self.group, r) if self.group is not None else r
        shape = list(x.shape)
        shape[dim] = block
        out = x.new_zeros(shape)

        def overlap(src, dst):  # global rows [start, end) of src's block in dst's
            start = max(src * have, dst * block)
            return start, min(src * have + have, dst * block + block, rows)

        ops, landed, moves = [], [], []
        row = x.numel() // have
        for r in range(self.world):
            got = sent = 0
            start, end = overlap(r, self.rank)  # what r holds of mine
            if end > start:
                part = out.narrow(dim, start - self.rank * block, end - start)
                if r == self.rank:
                    part.copy_(x.narrow(dim, start - r * have, end - start))
                else:
                    buf = torch.empty_like(part, memory_format=torch.contiguous_format)
                    ops.append(dist.P2POp(dist.irecv, buf, glob(r), self.group))
                    landed.append((part, buf))
                    got = end - start
            start, end = overlap(self.rank, r)  # what I hold of r's
            if end > start and r != self.rank:
                rows_out = x.narrow(dim, start - self.rank * have, end - start).contiguous()
                ops.append(dist.P2POp(dist.isend, rows_out, glob(r), self.group))
                sent = end - start
            if got or sent:
                moves.append((r, got, sent))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for part, buf in landed:
            part.copy_(buf)
        self._record("reblock", x, sum(m[1] for m in moves) * row, rows=rows,
                     blocks=(have, block), row=row, moves=tuple(moves))
        return out

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

    def token_level(self, n_tokens: int) -> Optional[Tuple[int, int, int]]:
        """(rows, block, whole) of the level whose block of tokens (h-major
        (rows, whole) under a height split, (whole, rows) under a width
        split) has ``n_tokens`` tokens on each rank, where that level does
        not divide; None where it divides."""
        split, whole = self.size if self.axis == 2 else self.size[::-1]
        f = 1
        while split % f == 0 and whole % f == 0:
            rows, block = split // f, self.blocks(split // f)
            if block * (whole // f) == n_tokens:
                return None if rows == block * self.world else (rows, block, whole // f)
            f *= 2
        raise ValueError(f"{n_tokens} tokens a rank are no level of a {self.size} latent")

    def gather_tokens(self, x: torch.Tensor, segments: int = 1) -> torch.Tensor:
        """(N, segments * L, C) blocks of tokens -> (N, segments * world * L,
        C): each segment's blocks in rank order (the global token order under
        height sharding, h-major; under width sharding a permutation of it,
        which attention does not see).  At a level that does not divide, the
        padding's tokens are left out of every segment (the global order on
        either axis)."""
        n, l, c = x.shape
        out = x.new_empty((self.world * n, l, c))
        _all_gather_single(out, x.contiguous(), group=self.group)
        self._record("kv_all_gather", x, x.numel() * (self.world - 1))
        level = self.token_level(l // segments)
        if level is None:
            out = out.view(self.world, n, segments, l // segments, c).permute(1, 2, 0, 3, 4)
            return out.reshape(n, segments * self.world * (l // segments), c)
        rows, block, whole = level
        if self.axis == 2:  # (rank, n, segment, row, column, c)
            out = out.view(self.world, n, segments, block, whole, c).permute(1, 2, 0, 3, 4, 5)
            out = out.reshape(n, segments, self.world * block, whole, c).narrow(2, 0, rows)
        else:  # (rank, n, segment, row, column, c): columns split
            out = out.view(self.world, n, segments, whole, block, c).permute(1, 2, 3, 0, 4, 5)
            out = out.reshape(n, segments, whole, self.world * block, c).narrow(3, 0, rows)
        return out.reshape(n, segments * rows * whole, c)

    def frames_to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(R, T / world, C) temporal rows of this rank's frames -> (ceil(R /
        world), T, C): this rank's block of the rows with every frame, the
        rows padded with zero rows to a multiple of the world."""
        r, t, c = x.shape
        per = self.blocks(r)
        if per * self.world != r:
            x = torch.cat([x, x.new_zeros((per * self.world - r, t, c))])
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.group)
        self._record("all_to_all", x, x.numel() // self.world * (self.world - 1))
        out = out.view(self.world, per, t, c)
        return out.permute(1, 0, 2, 3).reshape(per, self.world * t, c)

    def rows_to_frames(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """Inverse of ``frames_to_rows``: (ceil(R / world), T, C) -> (R, T /
        world, C), ``rows`` the R of the clip (the padding dropped)."""
        r, t, c = x.shape
        src = x.view(r, self.world, t // self.world, c).permute(1, 0, 2, 3)
        src = src.reshape(self.world * r, t // self.world, c)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        self._record("all_to_all", x, x.numel() // self.world * (self.world - 1))
        return out if rows == out.shape[0] else out[:rows]

    def local_frame(self, index: int) -> Optional[int]:
        """Under a frame split, the local index of the clip's frame
        ``index`` on the rank that holds it, else None."""
        owner, local = divmod(index, self.frames // self.world)
        return local if owner == self.rank else None

    def frame_at(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """(B, T / world, ...) -> the clip's frame ``index`` (B, ...),
        broadcast by the rank that holds it."""
        owner, local = divmod(index, self.frames // self.world)
        buf = x[:, local].contiguous() if owner == self.rank else x.new_empty(
            (x.shape[0],) + tuple(x.shape[2:]))
        src = dist.get_global_rank(self.group, owner) if self.group is not None else owner
        dist.broadcast(buf, src, group=self.group)
        self._record("broadcast", buf, 0 if owner == self.rank else buf.numel())
        return buf

    def centre_frame(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T / world, ...) -> the clip's centre frame (B, ...), broadcast
        by the rank that holds it."""
        return self.frame_at(x, self.frames // 2)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of ``x`` along ``dim``, in rank order, on every
        rank (the frames that blending and the k/v reuse move)."""
        parts = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single(parts, x.contiguous(), group=self.group)
        self._record("all_gather", x, x.numel() * (self.world - 1))
        return torch.cat(parts.view((self.world,) + tuple(x.shape)).unbind(0), dim=dim)


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
    per-tensor quantization's amax), "kv_all_gather", "all_to_all",
    "broadcast", "reblock" (rows moved at a level transition that touches a
    padded level) and "all_gather" (frames gathered by blending and the k/v
    reuse); a halo's record also has ``rows`` (taken from the previous and
    the next rank) and ``row`` (the elements of one row), a reblock's
    ``rows`` (the level's), ``blocks`` (from, to), ``row`` and ``moves``
    ((peer, rows received, rows sent), one a peer it trades with)."""
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
    dim = shard.axis - 5 + len(shape)  # a clip's (B, T, H, W, C) or an image's
    full = list(shape)
    full[dim] *= shard.world
    draw = torch.randn(tuple(full), generator=generator, device=device, dtype=dtype)
    return shard.block(draw, dim).contiguous()
