"""Transformer blocks: 2D spatial, factorised 3D spatio-temporal and the 3D
one with cross-frame cross-attention, CFCA (port of
``ccedit_tpu/modules/transformer.py``; the RAIG ``SpatialTransformerCA`` is
not ported).

Tokens are channels-last.  Every attention goes through the one dispatch
point, ``ops.attention.dot_product_attention``.  Two numerics follow the JAX
package rather than the sgm reference, so that the port matches it: LayerNorm
epsilon 1e-6 (flax's default; sgm uses torch's 1e-5) and the tanh-approximate
GELU inside GEGLU (flax's default; sgm uses the exact erf form).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.video import fold_time, temporal_to_tokens, tokens_to_temporal
from .layers import Conv1d, conv2d, group_norm, zero_module

LN_EPS = 1e-6


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None.  q/k/v
    projections have no bias, the output projection does (``to_out.0``)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def forward(self, x, context=None):
        context = x if context is None else context

        def split_heads(t):  # (B, L, H*D) -> (B, H, L, D), a view
            b, l, _ = t.shape
            return t.view(b, l, self.heads, self.dim_head).permute(0, 2, 1, 3)

        out = dot_product_attention(split_heads(self.to_q(x)),
                                    split_heads(self.to_k(context)),
                                    split_heads(self.to_v(context)))
        b, h, l, d = out.shape
        return self.to_out(out.permute(0, 2, 1, 3).reshape(b, l, h * d))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU -> (dropout) -> Linear; sgm keys ``net.0.proj`` / ``net.2``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """self-attn -> text cross-attn -> GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, n_heads, d_head, context_dim=context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class BasicTransformerSingleLayerBlock(nn.Module):
    """One attention + FF.  Used as self-attention with ``context=x``, whose
    context is the un-normalised x."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, n_heads, d_head, context_dim=context_dim)
        self.ff = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x), context=context)
        return x + self.ff(self.norm2(x))


class SpatialTransformer(nn.Module):
    """2D token transformer over (N, H, W, C) with 1x1-conv projections.
    ``disable_text_ca`` (the TVI2V appearance ControlNet) makes its blocks
    self-attention single blocks, without text cross-attention."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 disable_text_ca: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.norm = group_norm(in_channels, eps=1e-6)
        self.proj_in = conv2d(in_channels, inner, k=1)
        self.disable_text_ca = disable_text_ca
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerSingleLayerBlock(inner, n_heads, d_head) if disable_text_ca
            else BasicTransformerBlock(inner, n_heads, d_head, context_dim=context_dim)
            for _ in range(depth))
        self.proj_out = conv2d(inner, in_channels, k=1, zero=True)

    def forward(self, x, context=None):
        n, h, w, _ = x.shape
        y = self.proj_in(self.norm(x))
        y = y.reshape(n, h * w, -1)
        for blk in self.transformer_blocks:
            y = blk(y, context=None if self.disable_text_ca else context)
        return self.proj_out(y.reshape(n, h, w, -1)) + x


class SpatialTransformer3D(nn.Module):
    """Factorised video transformer: spatial attention over (B*T, H*W, C),
    then temporal attention over (H*B*W, T, C) with zero-initialised
    temporal projections and a residual.  Input/output: (B, T, H, W, C).
    Only ``disable_temporal_text_ca=True`` (the shipped CCEdit setting) is
    ported: the temporal blocks are self-attention single blocks."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = group_norm(in_channels, eps=1e-6)
        self.proj_in = conv2d(in_channels, inner, k=1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim=context_dim)
            for _ in range(depth))
        self.proj_out = conv2d(inner, in_channels, k=1, zero=True)
        self.norm_temporal = group_norm(in_channels, eps=1e-6)
        self.proj_in_temporal = zero_module(Conv1d(in_channels, inner, 1))
        self.transformer_blocks_temporal = nn.ModuleList(
            BasicTransformerSingleLayerBlock(inner, n_heads, d_head)
            for _ in range(depth))
        self.proj_out_temporal = zero_module(Conv1d(inner, in_channels, 1))

    def _spatial(self, x, context):
        n, h, w, _ = x.shape
        y = self.proj_in(self.norm(x)).reshape(n, h * w, -1)
        for blk in self.transformer_blocks:
            y = blk(y, context=context)
        return self.proj_out(y.reshape(n, h, w, -1)) + x

    def _temporal(self, x):
        y = self.proj_in_temporal(self.norm_temporal(x))
        for blk in self.transformer_blocks_temporal:
            y = blk(y, context=y)  # un-normalised y as context
        return x + self.proj_out_temporal(y)

    def forward(self, x, context=None):
        b, t, h, w, c = x.shape
        ctx = torch.repeat_interleave(context, t, dim=0) if context is not None else None
        xs = self._spatial(fold_time(x), ctx)
        xt = self._temporal(tokens_to_temporal(xs, b))
        return temporal_to_tokens(xt, b, h, w).reshape(b, t, h, w, c)



class SpatialTransformer3DCA(SpatialTransformer3D):
    """SpatialTransformer3D + a fifth attention: cross-frame cross-attention
    (CFCA) of every frame's tokens against an anchor, after the temporal
    attention.  ``ca_type``: "center" (the centre frame's tokens), "self"
    (the frame's own) or "center_self" (centre then own, concatenated: the
    TVI2V network's, with n_k = 2 * n_q).  ``ref_context`` (B, H*W, C), the
    appearance branch's banked tokens, replaces the anchor when given."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 ca_type: str = "center"):
        super().__init__(in_channels, n_heads, d_head, depth, context_dim)
        if ca_type not in ("center", "self", "center_self"):
            raise ValueError(f"ca_type {ca_type!r}")
        inner = n_heads * d_head
        self.ca_type = ca_type
        self.norm_temporal_ca = group_norm(in_channels, eps=1e-6)
        self.proj_in_temporal_ca = conv2d(in_channels, inner, k=1)
        self.transformer_blocks_temporal_ca = nn.ModuleList(
            [BasicTransformerSingleLayerBlock(inner, n_heads, d_head)])
        self.proj_out_temporal_ca = conv2d(inner, in_channels, k=1, zero=True)

    def _cfca(self, x, b, t, ref_context):
        n, h, w, _ = x.shape
        y = self.proj_in_temporal_ca(self.norm_temporal_ca(x)).reshape(n, h * w, -1)
        if ref_context is not None:
            anchor = torch.repeat_interleave(ref_context, t, dim=0)  # (B*T, hw, C)
        elif self.ca_type == "self":
            anchor = y
        else:
            centre = y.reshape(b, t, h * w, -1)[:, t // 2]
            anchor = torch.repeat_interleave(centre, t, dim=0)  # b-major
            if self.ca_type == "center_self":
                anchor = torch.cat([anchor, y], dim=1)
        y = self.transformer_blocks_temporal_ca[0](y, context=anchor)
        return self.proj_out_temporal_ca(y.reshape(n, h, w, -1)) + x

    def forward(self, x, context=None, ref_context=None):
        b, t, h, w, c = x.shape
        ctx = torch.repeat_interleave(context, t, dim=0) if context is not None else None
        xs = self._spatial(fold_time(x), ctx)
        xt = self._temporal(tokens_to_temporal(xs, b))
        xs = self._cfca(temporal_to_tokens(xt, b, h, w), b, t, ref_context)
        return xs.reshape(b, t, h, w, c)
