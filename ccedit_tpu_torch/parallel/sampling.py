"""Single-clip sampling over several GPUs: ONE clip split across the ranks
(port of ``ccedit_tpu/parallel/sampling.py``).

The JAX package jits ``engine.sample`` with the latent's frame axis
sharded, or its height axis when T does not divide the mesh, and lets GSPMD
insert the collectives.  PyTorch has no GSPMD: each rank (one process per
GPU under ``torchrun``, NCCL; gloo on the CPU) runs ``engine.sample`` on its
contiguous block of the clip inside ``mesh_context`` (``parallel/shard.py``),
whose modules issue every collective explicitly.  The sample equals the
one-process sample on the same noise, up to the order of reductions.

    call = make_frame_sharded_sample(engine, (1, 17, 64, 96, 4), 30)
    block = call(c, uc, generator=gen)        # this rank's block
    latents = gather_clip(block, call.axis)   # the whole clip, on every rank

The latent is a clip (B, T, H, W, C) or, for RAIG's 2-D network, an image
(B, H, W, C), whose rows or columns are split (the JAX package's axis 1
or 2 of it: its "T" is H).  A UNet level whose rows do not divide the world
is padded as GSPMD pads it: blocks of ceil(R / world) rows, the padding at
the clip's tail (``parallel/shard.py``); under a frame split the temporal
rows (B*H*W) likewise.  So every shape the JAX package's
``make_frame_sharded_sample`` takes samples here, but a 2-D latent whose
rows and columns both do not divide (the JAX package then splits its
channels; the port's multiple-of-64 pixel sizes never do that).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .shard import ClipShard, mesh_context

# conditioning entries carrying per-frame (T at dim 1) and spatial (H, W at
# dims 2, 3) axes: video-shaped tensors (control_hint_features is the
# precomputed latent-resolution hint pyramid)
_CLIP_KEYS = ("control_hint", "control_hint_features", "concat")
# clip-shaped arguments of ``engine.sample``, split like its output
_CLIP_ARGS = ("x_prior", "init_noise", "inpaint_x0", "inpaint_mask")


def pick_clip_axis(world: int, shape: Sequence[int]) -> int:
    """The latent axis to split: the frame axis (1) when T divides the
    world (zero-communication spatial ops, collectives only at the temporal
    ops), else the height axis (2), else the width axis (3): convolutions
    take halos, and because H is the outer dim of the (h w) token flatten
    the split survives into the attention's token axis contiguously (q stays
    split, k/v are gathered).  The production T = 17 clip at 512x768 has
    H/8 = 64 rows."""
    t = shape[1]
    if t % world == 0:
        return 1
    if len(shape) > 2 and shape[2] % world == 0:
        return 2
    if len(shape) > 3 and shape[3] % world == 0:
        return 3
    raise ValueError(f"no shardable clip axis for shape {tuple(shape)} over {world} ranks")


def _block(x: torch.Tensor, dim: int, rank: int, world: int) -> torch.Tensor:
    size = x.shape[dim] // world
    if size * world != x.shape[dim]:
        raise ValueError(f"size {x.shape[dim]} of dim {dim} of {tuple(x.shape)} does not "
                         f"divide over {world} ranks")
    return x.narrow(dim, rank * size, size).contiguous()


def shard_clip_cond(cond: Dict, shape: Sequence[int], axis: int, rank: int,
                    world: int) -> Dict:
    """This rank's conditioning: the video-shaped entries (``_CLIP_KEYS``
    with T at dim 1; the pixel-space hint's rows scale with the latent's by
    the VAE factor, which keeps them divisible) cut to this rank's block on
    ``axis``; every other entry whole (replicated)."""
    t = shape[1]
    out = {}
    for k, v in cond.items():
        if k in _CLIP_KEYS and torch.is_tensor(v) and v.dim() >= 4 and v.shape[1] == t:
            out[k] = _block(v, axis, rank, world)
        else:
            out[k] = v
    return out


def make_frame_sharded_sample(engine, shape: Sequence[int], num_steps: Optional[int],
                              group=None, **sample_kwargs):
    """``call(c, uc, generator=None, x_prior=None, ...)`` running
    ``engine.sample`` on this rank's block of ONE clip of ``shape`` split
    over ``group`` (the default group; world 1 outside a process group), on
    ``pick_clip_axis``'s axis; it returns this rank's block of the latents
    (on dim ``call.axis``; ``gather_clip`` assembles them).  ``c`` and
    ``uc`` are the whole conditioning, as every rank computes it;
    ``x_prior``, ``init_noise``, ``inpaint_x0``, ``inpaint_mask`` (whole
    clips) and ``loop_noise`` (whole rows) are cut like the output.  Draws
    from ``generator`` are the whole clip's, of which each rank keeps its
    block, so the stream does not depend on the world size.  Under W8A8
    (``CCEDIT_QUANT_MATMUL``, ``CCEDIT_INT8``) each per-tensor quantization
    takes the whole clip's scale (``ops/quant.py``)."""
    shape = tuple(shape)
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    axis = pick_clip_axis(world, shape)  # a dim of the latent
    image = len(shape) == 4
    if image and axis == 3:
        raise ValueError(f"the 2-D latent {shape} splits over {world} ranks only on its "
                         "channels, which the port does not split")
    shard = ClipShard(axis + image, 1 if image else shape[1], group,
                      size=shape[1:3] if image else shape[2:4])
    if shape[axis] % world:
        raise ValueError(f"axis {axis} of {shape} does not divide over {world} ranks")
    local = list(shape)
    local[axis] //= world

    def cut(x, dim):
        return None if x is None else _block(torch.as_tensor(x), dim, rank, world)

    def call(c: Dict, uc: Optional[Dict], generator: Optional[torch.Generator] = None,
             loop_noise=None, **kwargs):
        for name in _CLIP_ARGS:
            if kwargs.get(name) is not None:
                kwargs[name] = cut(kwargs[name], axis)
        if isinstance(loop_noise, dict):
            loop_noise = {k: cut(v, axis + 1) for k, v in loop_noise.items()}
        else:
            loop_noise = cut(loop_noise, axis + 1)
        c = shard_clip_cond(c, shape, axis, rank, world)
        uc = shard_clip_cond(uc, shape, axis, rank, world) if uc is not None else None
        with mesh_context(shard):
            return engine.sample(c, uc, tuple(local), num_steps=num_steps, generator=generator,
                                 loop_noise=loop_noise, **sample_kwargs, **kwargs)

    call.axis, call.shard = axis, shard
    return call


def gather_clip(block: torch.Tensor, axis: int, group=None) -> torch.Tensor:
    """Every rank's block of a clip, concatenated on ``axis`` in rank order,
    on every rank."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return block
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, block.contiguous(), group=group)
    return torch.cat(parts, dim=axis)
