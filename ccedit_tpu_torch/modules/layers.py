"""Shared primitive layers (port of ``ccedit_tpu/modules/layers.py``).

Activations keep the JAX package's channels-last layout: (N, H, W, C) images,
(N, L, C) tokens.  The convolutions are ``nn.Conv2d``/``nn.Conv1d`` applied to
a channels-first view of that memory, so cuDNN runs them in its
channels-last format; parameters keep PyTorch's (O, I, kh, kw) layout and the
reference sgm names (``weight``, ``bias``).  The JAX package's ``QConv``
and ``QDense`` (its opt-in W8A8 path, ``ops/quant.py``) are these convs
built with ``quant=True`` and ``QLinear``: exact unless W8A8 is on; a conv
or Linear built without the flag (the JAX package's plain ``nn.Conv`` and
``nn.Dense``) never quantizes.  Under W8A8 a GroupNorm -> SiLU -> ``QConv``
chain (``NormActConv``, ``norm_silu_conv``) hands the conv kernel 8's
fused norm form (``quant.norm_silu_quantize``: the int8 rows of the SiLU's
output, no bf16 copy of the norm's or the SiLU's) in place of its input.

A GroupNorm keeps its statistics and its affine map in fp32 and rounds
only its output to the input's dtype, as flax's ``nn.GroupNorm(dtype=...)``
does (torch's own GroupNorm of a bf16 input keeps bf16 statistics): on the
CPU through ``quant.plain_group_norm``, on the card through kernel 8's norm
form (``quant.group_norm``), whose statistics the fused form shares.

Under a spatial clip shard (``parallel/shard.py``: the clip's rows or
columns split over the ranks) ``Conv2d`` takes halo rows from its
neighbours and a ``GroupNorm`` that normalises images all-reduces its
statistics; a ``temporal`` GroupNorm (the pseudo-3D blocks' temporal
preludes, the transformers' temporal norms) normalises (H*B*W, T, C) rows,
which every shard keeps whole on one rank, and stays local.  Under W8A8 a
``QConv`` quantizes its input with one scale for the whole clip (the
per-tensor amax all-reduced over the ranks, ``ops/quant.py``) and takes its
halo rows as int8.

At a level that does not divide over the ranks (``parallel/shard.py``'s
padding) a convolution zeroes the padding rows of its input before it
reads them (a stride-2 one first takes the blocks that halve into the next
level's), a GroupNorm leaves them out of its statistics, and under W8A8 the
GroupNorm -> SiLU -> ``QConv`` chain runs unfused (``padded``): the fused
form's amax would read the normalised padding, which the conv zeroes
before it quantizes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import build, quant
from ..parallel.shard import active


def _autocast(device_type: str) -> bool:
    """Whether autocast is on for ``device_type`` (never for a device that
    has none, such as ``meta``)."""
    return device_type in ("cuda", "cpu") and torch.is_autocast_enabled(device_type)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embeddings, [cos | sin] ordering, fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _w8a8(module: nn.Module) -> bool:
    """Whether a layer built with ``quant=True`` runs W8A8 now."""
    return module.quant and quant.quantized_matmul_enabled()


def padded(x) -> bool:
    """Whether ``x`` (an image, or the temporal rows of a fold) has padding
    under the entered shard: where kernel 8's fused norm form would read
    it into its amax."""
    shard = active()
    return shard is not None and shard.world > 1 and shard.padding(x) is not None


def _level_input(conv: nn.Conv2d, shard, x):
    """A convolution's input at its level under a spatial shard: in front
    of a stride-2 transition in blocks that halve into the next level's,
    its padding zeroed (the conv reads it, and under W8A8 its amax)."""
    dim = shard.split_dim(x)
    if conv.stride[dim - 1] == 2 and isinstance(x, torch.Tensor):
        moved = shard.stride2_blocks(x, dim)
        if moved is not x:  # zero rows past the level's
            return moved
    pad = shard.padding(x)
    if pad is None:
        return x
    if isinstance(x, quant.QuantizedActivation):  # the int8 rows' padding, as 0
        n, h, w = x.shape[:3]
        q = shard.zero_padding(x.q.view(n, h, w, -1), pad)
        return dataclasses.replace(x, q=q.view(x.q.shape))
    return shard.zero_padding(x, pad)


def _split_rows(conv: nn.Conv2d, x_rows: int, pads, dim: int):
    """A k x k convolution's rows on a spatial shard's split axis (``dim``
    of (N, H, W, C)): the halo rows (before, after) it takes from the
    previous and the next rank, and its padding with that axis's set to
    zero.  ``pads``: ((top, bottom), (left, right))."""
    i = dim - 1
    k, s, p = conv.kernel_size[i], conv.stride[i], pads[i][0]
    after = k - s - p
    if x_rows % s or after < 0:
        raise ValueError(f"a {k}x{k} stride-{s} convolution cannot split a block of "
                         f"{x_rows} rows")
    pads = list(pads)
    pads[i] = (0, 0)
    return p, after, tuple(pads)


class Conv2d(nn.Conv2d):
    """(N, H, W, C) -> (N, H', W', C') convolution.  Under a spatial clip
    shard a k > 1 convolution reads ``padding`` rows of the previous rank's
    block and k - stride - padding of the next one's (zero rows at the
    clip's edges), then convolves its block without padding on that axis:
    k // 2 rows each side at stride 1, the row above alone at stride 2.

    ``quant``: a ``QConv`` site (W8A8 when it is on).  ``explicit_pad``
    ((top, bottom), (left, right)) zero-pads the input first (the VAE
    downsample's (0, 1)); the W8A8 kernel takes it as its window's
    padding."""

    def __init__(self, *args, quant: bool = False, explicit_pad=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant
        self.explicit_pad = explicit_pad

    def forward(self, x) -> torch.Tensor:
        shard = active()
        spatial = shard is not None and shard.spatial
        split = spatial and self.kernel_size != (1, 1)
        w8a8 = _w8a8(self)
        if split or (spatial and w8a8):
            x = _level_input(self, shard, x)
        if w8a8:  # x may be a quant.QuantizedActivation (norm_silu_conv)
            pads = self.explicit_pad or tuple((p, p) for p in self.padding)
            if split:  # the halo rows as int8, under the clip's one scale
                qa = x if isinstance(x, quant.QuantizedActivation) else quant.quantize_activation(x)
                dim = shard.axis - 1
                before, after, pads = _split_rows(self, qa.shape[dim], pads, dim)
                x = quant.with_halo(qa, shard, dim, before, after)
            return quant.qconv(x, self.weight, self.bias, self.stride, pads)
        if self.explicit_pad is not None:
            (t, b), (left, right) = self.explicit_pad
            x = F.pad(x, (0, 0, left, right, t, b))
        if not split:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dim = shard.axis - 1  # H (1) or W (2) of (N, H, W, C)
        before, after, pads = _split_rows(self, x.shape[dim], tuple((p, p) for p in self.padding),
                                          dim)
        y = F.conv2d(shard.halo(x, dim, before, after).permute(0, 3, 1, 2), self.weight,
                     self.bias, self.stride, tuple(p for p, _ in pads), self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Conv1d(nn.Conv1d):
    """(N, L, C) -> (N, L, C') convolution over L ('same' padding for odd
    k); ``quant``: a ``QConv`` site."""

    def __init__(self, *args, quant: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x) -> torch.Tensor:
        if _w8a8(self):  # x may be a quant.QuantizedActivation (norm_silu_conv)
            shard = active()
            if shard is not None and isinstance(x, torch.Tensor):  # padding out of the amax
                x = shard.zero_padding(x)
            return quant.qconv(x, self.weight, self.bias, self.stride,
                               tuple((p, p) for p in self.padding))
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class QLinear(nn.Linear):
    """A ``QDense`` site: ``nn.Linear``, in W8A8 when it is on."""

    quant = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _w8a8(self):
            return quant.qlinear(x, self.weight, self.bias)
        return super().forward(x)


def conv2d(cin: int, cout: int, k: int = 3, stride: int = 1, zero: bool = False,
           quant: bool = False) -> Conv2d:
    """k x k convolution with torch's symmetric padding k // 2 (the JAX
    package pads stride-2 convs explicitly ((1, 1), (1, 1)) to match it);
    ``quant``: a ``QConv`` site."""
    conv = Conv2d(cin, cout, k, stride=stride, padding=k // 2, quant=quant)
    if zero:
        zero_module(conv)
    return conv


def temporal_conv(cin: int, cout: int, k: int = 3, zero: bool = True,
                  quant: bool = False) -> Conv1d:
    """The zero-initialised 1-D temporal twin (zero_module(conv_nd(1, ...)));
    ``quant``: the JAX ``TemporalConv``, a ``QConv``."""
    conv = Conv1d(cin, cout, k, padding=k // 2, quant=quant)
    if zero:
        zero_module(conv)
    return conv


def zero_module(module: nn.Module) -> nn.Module:
    """Zero every parameter: the ControlNet / temporal-layer idiom, so a new
    branch is an identity perturbation at initialisation."""
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


class GroupNorm(nn.GroupNorm):
    """Group norm over a channels-last tensor (N, ..., C).  ``temporal``:
    it normalises folded (H*B*W, T, C) rows.  Otherwise it normalises
    images (N, H, W, C), or (B, T, H, W, C) clips, whose statistics span a
    spatial clip shard's rows (and a frame shard's frames for a clip): there
    each rank's per-(sample, group) sum and sum of squares (fp32 moments,
    summed in fp64) are all-reduced."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, temporal: bool = False):
        super().__init__(num_groups, num_channels, eps=eps, affine=affine)
        self.temporal = temporal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = active()
        if self.spans_shard(x, shard):
            return self._sharded(x, shard)
        if _autocast(x.device.type):  # torch's fp32 GroupNorm, left to autocast
            return F.group_norm(x.movedim(-1, 1), self.num_groups, self.weight,
                                self.bias, self.eps).movedim(1, -1)
        # kernel 8 has no backward: a call that autograd differentiates runs
        # torch's fp32 GroupNorm, as does an fp32 or fp64 x
        if (x.is_cuda and x.dtype == torch.bfloat16
                and not build.needs_grad(x, *self.parameters())):
            return quant.group_norm(x, self)  # raises for a shape it does not take
        return quant.plain_group_norm(x, self)

    def spans_shard(self, x: torch.Tensor, shard) -> bool:
        """Whether x's statistics span the ranks of ``shard``: an image
        GroupNorm under a spatial shard, or a clip's under a frame shard."""
        return (shard is not None and not self.temporal
                and (shard.spatial or (shard.frame and x.dim() == 5)))

    def sharded_affine(self, x: torch.Tensor, shard):
        """Each (sample, channel)'s (scale, shift) of x's normalisation over
        the ranks of ``shard``: each rank's per-(sample, group) sum and sum of
        squares (from fp32 moments, fp64 for an fp64 x) summed in fp64 over the
        ranks, of its real rows alone at a padded level.  Two (N, C) tensors
        of x's compute dtype (fp32, or fp64), and x in that dtype (the copy
        the moments read)."""
        n, c, g = x.shape[0], x.shape[-1], self.num_groups
        dtype = torch.promote_types(x.dtype, torch.float32)
        xg = x.reshape(n, -1, g, c // g).to(dtype)
        count = xg.shape[1] * xg.shape[3]
        total = count * shard.world
        pad = shard.padding(x)
        real = xg if pad is None else pad.real(x).reshape(n, -1, g, c // g).to(dtype)
        if pad is not None:  # the level's real rows over the ranks
            total = count // pad.block * pad.rows
        if real.shape[1]:
            var, mean = (m.double() for m in torch.var_mean(real, dim=(1, 3), correction=0))
            # (2, N, G) sum and sum of squares, in fp64 so that the variance's
            # E[x^2] - E[x]^2 does not cancel the fp32 statistics' digits away
            stats = torch.stack([mean, var + mean * mean]) * (real.shape[1] * real.shape[3])
        else:  # a rank that holds only padding
            stats = torch.zeros((2, n, g), dtype=torch.float64, device=x.device)
        shard.all_reduce_stats(stats)
        mean = stats[0] / total
        var = (stats[1] / total - mean * mean).clamp_min(0.0)
        scale = (torch.rsqrt(var + self.eps)[..., None]
                 * self.weight.double().view(g, c // g)).to(dtype)
        shift = (self.bias.double().view(g, c // g) - mean[..., None] * scale).to(dtype)
        return scale.reshape(n, c), shift.reshape(n, c), xg.view(x.shape)

    def _sharded(self, x: torch.Tensor, shard) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        scale, shift, xf = self.sharded_affine(x, shard)
        shape = (n,) + (1,) * (x.dim() - 2) + (c,)
        return (xf * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


def group_norm(channels: int, eps: float = 1e-5, temporal: bool = False) -> GroupNorm:
    return GroupNorm(32, channels, eps=eps, temporal=temporal)


def norm_silu_conv(norm: GroupNorm, conv: nn.Module, x: torch.Tensor,
                   add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv(silu(norm(x + add))), ``add`` (N, C) one value a sample (x's
    first axis) and channel, or None.  Where ``conv`` runs W8A8 the norm,
    the SiLU and the conv input's quantization are one launch of kernel 8's
    fused norm form, the conv reading its int8 rows; otherwise the modules
    run in turn, as they also do at a level with padding (``padded``), whose
    conv zeroes it before it quantizes."""
    if _w8a8(conv) and not padded(x):
        return conv(quant.norm_silu_quantize(x, norm, add))
    if add is not None:
        x = x + quant.sample_addend(x, add)
    return conv(F.silu(norm(x)))


class NormActConv(nn.Sequential):
    """GroupNorm -> SiLU [-> Identity (dropout)] -> conv, keyed by index as
    sgm's ``in_layers``/``out_layers`` (``in_layers.0``, ``in_layers.2``):
    ``norm_silu_conv`` of its first and last modules, ``add`` the ResBlock's
    embedding.  A slice (``in_layers[:2]``) runs as a plain
    ``nn.Sequential``."""

    def forward(self, x: torch.Tensor, add: Optional[torch.Tensor] = None) -> torch.Tensor:
        mods = list(self)
        if (len(mods) >= 3 and isinstance(mods[0], GroupNorm) and isinstance(mods[1], nn.SiLU)
                and all(isinstance(m, nn.Identity) for m in mods[2:-1])):
            return norm_silu_conv(mods[0], mods[-1], x, add)
        if add is not None:
            raise ValueError("only a GroupNorm -> SiLU -> conv chain takes an addend")
        return super().forward(x)


class TimeEmbed(nn.Sequential):
    """time_embed MLP: Linear(4*ch) -> SiLU -> Linear(4*ch); sgm keys
    ``time_embed.0`` / ``time_embed.2``."""

    def __init__(self, in_features: int, features: int):
        super().__init__(nn.Linear(in_features, features), nn.SiLU(),
                         nn.Linear(features, features))
