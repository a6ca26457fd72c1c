"""Auxiliary UNet variants from the tail of sgm's openaimodel (port of
``ccedit_tpu/modules/unet_extras.py``):

* ``NoTimeUNetModel``: a ``UNetModel`` that zeroes its timesteps;
* ``AttentionBlock``: the legacy pre-transformer spatial self-attention
  (GN32 -> k=1 qkv -> multi-head softmax -> zero-init k=1 proj, residual);
* ``AttentionPool2d``: CLIP-style attention pooling (the mean token
  prepended, a learned positional embedding, token 0 out);
* ``EncoderUNetModel``: the classifier half-UNet with adaptive / attention
  / spatial / spatial_v2 pooling heads.

No shipped config uses them.  These are cold classifier paths whose
attention is a plain einsum in the JAX package, so it stays plain torch here.
State-dict names and shapes are sgm's (``qkv`` / ``proj_out`` /
``qkv_proj`` / ``c_proj`` are k=1 Conv1d, ``positional_embedding`` is
(C, N + 1)); the fused qkv's channels are laid out as the JAX function reads
them: all heads' q, then k, then v.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .blocks import Downsample, ResBlock
from .layers import Conv1d, TimeEmbed, conv2d, group_norm, timestep_embedding, zero_module
from .unet import UNetModel


class NoTimeUNetModel(UNetModel):
    """UNetModel that ignores its timestep input."""

    def forward(self, x, timesteps, *args, **kwargs):
        return super().forward(x, torch.zeros_like(timesteps), *args, **kwargs)


def _heads(channels: int, num_heads: int, num_head_channels: int) -> int:
    if num_head_channels == -1:
        return num_heads
    if channels % num_head_channels:
        raise ValueError(f"channels {channels} not divisible by num_head_channels "
                         f"{num_head_channels}")
    return channels // num_head_channels


def qkv_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, 3C) -> (B, T, C) multi-head softmax attention, q and k each
    scaled by d^-1/4, the softmax in fp32."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // n_heads
    q, k, v = qkv.reshape(b, t, 3, n_heads, d).unbind(2)  # (B, T, H, D)
    scale = 1.0 / float(d) ** 0.25
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k * scale)
    w = torch.softmax(logits.float(), dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, c)


class AttentionBlock(nn.Module):
    """Legacy spatial self-attention block over (N, H, W, C)."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1):
        super().__init__()
        self.num_heads = _heads(channels, num_heads, num_head_channels)
        self.norm = group_norm(channels)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = zero_module(Conv1d(channels, channels, 1))

    def forward(self, x):
        n, h, w, c = x.shape
        tokens = self.norm(x).reshape(n, h * w, c)
        out = self.proj_out(qkv_attention(self.qkv(tokens), self.num_heads))
        return x + out.reshape(n, h, w, c)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling of (N, H, W, C) to (N, output_dim)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads_channels: int,
                 output_dim: Optional[int] = None):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = Conv1d(embed_dim, output_dim or embed_dim, 1)
        self.num_heads = embed_dim // num_heads_channels

    def forward(self, x):
        n, h, w, c = x.shape
        tokens = x.reshape(n, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.t()[None].to(tokens.dtype)
        out = self.c_proj(qkv_attention(self.qkv_proj(tokens), self.num_heads))
        return out[:, 0]


class _SpatialMean(nn.Module):
    """(N, H, W, C) -> (N, 1, 1, C): AdaptiveAvgPool2d((1, 1))."""

    def forward(self, x):
        return x.mean(dim=(1, 2), keepdim=True)


class EncoderUNetModel(nn.Module):
    """The half UNet with a pooled classification head; sgm keys
    ``time_embed``, ``input_blocks``, ``middle_block`` and ``out``."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int, attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int] = (1, 2, 4, 8), conv_resample: bool = True,
                 num_heads: int = 1, num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 pool: str = "adaptive"):
        super().__init__()
        if pool not in ("adaptive", "attention", "spatial", "spatial_v2"):
            raise NotImplementedError(f"Unexpected {pool} pooling")
        ch = self.model_channels = model_channels
        self.pool = pool
        emb = 4 * ch
        attn = lambda c: AttentionBlock(c, num_heads, num_head_channels)
        self.time_embed = TimeEmbed(ch, emb)
        blocks = [nn.ModuleList([conv2d(in_channels, ch)])]
        feature_size, cur, ds = ch, ch, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                blk = [ResBlock(cur, emb, mult * ch, use_scale_shift_norm=use_scale_shift_norm)]
                cur = mult * ch
                if ds in attention_resolutions:
                    blk.append(attn(cur))
                blocks.append(nn.ModuleList(blk))
                feature_size += cur
            if level != len(channel_mult) - 1:
                down = (ResBlock(cur, emb, down=True, use_scale_shift_norm=use_scale_shift_norm)
                        if resblock_updown else Downsample(cur, use_conv=conv_resample))
                blocks.append(nn.ModuleList([down]))
                feature_size += cur
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        ssn = dict(use_scale_shift_norm=use_scale_shift_norm)
        self.middle_block = nn.ModuleList(
            [ResBlock(cur, emb, **ssn), attn(cur), ResBlock(cur, emb, **ssn)])
        feature_size += cur
        if pool == "adaptive":
            self.out = nn.Sequential(group_norm(cur), nn.SiLU(), _SpatialMean(),
                                     conv2d(cur, out_channels, k=1, zero=True), nn.Flatten())
        elif pool == "attention":
            if num_head_channels == -1:
                raise ValueError("attention pooling needs num_head_channels")
            self.out = nn.Sequential(group_norm(cur), nn.SiLU(), AttentionPool2d(
                image_size // ds, cur, num_head_channels, out_channels))
        elif pool == "spatial":
            self.out = nn.Sequential(nn.Linear(feature_size, 2048), nn.ReLU(),
                                     nn.Linear(2048, out_channels))
        else:
            self.out = nn.Sequential(nn.Linear(feature_size, 2048), group_norm(2048), nn.SiLU(),
                                     nn.Linear(2048, out_channels))

    def forward(self, x, timesteps):
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(x.dtype))
        means = []
        h = x
        for blk in list(self.input_blocks) + [self.middle_block]:
            for mod in blk:
                h = mod(h, emb) if isinstance(mod, ResBlock) else mod(h)
            if self.pool.startswith("spatial"):
                means.append(h.mean(dim=(1, 2)).to(x.dtype))
        if self.pool.startswith("spatial"):
            return self.out(torch.cat(means, dim=-1))
        return self.out(h)
