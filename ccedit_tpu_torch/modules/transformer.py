"""Transformer blocks: 2D spatial (with the RAIG reference sub-layer),
factorised 3D spatio-temporal and the 3D one with cross-frame
cross-attention, CFCA (port of ``ccedit_tpu/modules/transformer.py``).

Tokens are channels-last.  Every attention goes through the one dispatch
point, ``ops.attention.dot_product_attention``.  Two numerics follow the JAX
package rather than the sgm reference, so that the port matches it: LayerNorm
epsilon 1e-6 (flax's default; sgm uses torch's 1e-5) and the tanh-approximate
GELU inside GEGLU (flax's default; sgm uses the exact erf form).

Options, as in the JAX modules: ``use_linear`` (Linear projections in place
of the 1x1 convs, spatial, temporal and CFCA), ``disable_self_attn`` (the
first attention of a full block attends to the context), the TokenFlow k/v
reuse (``kv_reuse_every``), ``disable_temporal_text_ca=False`` (the temporal
blocks are full blocks whose cross-attention reads the text context, one
copy per (h, w) row) and ``use_learnable_alpha`` (``alpha_temporal`` blends
the temporal branch with its input).

Under a spatial clip shard (``parallel/shard.py``) the attentions whose keys
are clip tokens (``token_kv``: the spatial self-attentions, the CFCA and
the reference attentions) gather k and v along the token axis, without a
padded level's padding, and keep q local; the text cross-attention and the
temporal attentions need nothing.  Under a frame shard the CFCA's centre
frame comes from the rank that holds it, and the k/v reuse gathers the
folded batch over the frames.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.video import fold_time, repeat_ctx_temporal, temporal_apply
from ..parallel.shard import active
from .layers import Conv1d, QLinear, conv2d, group_norm, zero_module

LN_EPS = 1e-6


def _reuse(t: torch.Tensor, n: int, shard) -> torch.Tensor:
    """TokenFlow's k/v reuse over a folded batch (b, t): row j takes row
    (j // n) * n's.  Under a frame shard the rows are this rank's frames of
    each sample, and the source of a row may lie on another rank (or, where
    n does not divide T, in another sample): the folded batch is gathered
    over the frames, reused, and this rank's frames kept."""
    frame = shard is not None and shard.frame
    if frame:
        per = shard.frames // shard.world
        whole = shard.gather(t.reshape((t.shape[0] // per, per) + tuple(t.shape[1:])), 1)
        t = whole.reshape((-1,) + tuple(t.shape[1:]))
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} is not a multiple of kv_reuse_every {n}")
    t = torch.repeat_interleave(t[::n], n, dim=0)
    if frame:
        t = shard.block(t.reshape((-1, shard.frames) + tuple(t.shape[1:])), 1)
        t = t.reshape((-1,) + tuple(t.shape[2:]))
    return t


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None.  q/k/v
    projections have no bias, the output projection does (``to_out.0``).
    ``kv_reuse_every=n`` (TokenFlow's cross-frame reuse): every n-th batch
    entry's keys and values serve it and the n - 1 entries after it.
    ``token_kv``: k and v come from clip tokens, split like the queries
    under a spatial clip shard, whose blocks ``forward`` gathers
    (``kv_segments`` runs of tokens, each gathered in place)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 context_dim: Optional[int] = None, token_kv: bool = False):
        super().__init__()
        self.token_kv = token_kv
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = QLinear(query_dim, inner, bias=False)
        self.to_k = QLinear(context_dim, inner, bias=False)
        self.to_v = QLinear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(QLinear(inner, query_dim), nn.Identity())

    def forward(self, x, context=None, kv_reuse_every: int = 0, kv_segments: int = 1):
        context = x if context is None else context
        k, v = self.to_k(context), self.to_v(context)
        shard = active()
        if kv_reuse_every:
            k, v = (_reuse(t, kv_reuse_every, shard) for t in (k, v))
        if self.token_kv and shard is not None and shard.spatial:
            k, v = shard.gather_tokens(k, kv_segments), shard.gather_tokens(v, kv_segments)

        def split_heads(t):  # (B, L, H*D) -> (B, H, L, D), a view
            b, l, _ = t.shape
            return t.view(b, l, self.heads, self.dim_head).permute(0, 2, 1, 3)

        out = dot_product_attention(split_heads(self.to_q(x)), split_heads(k), split_heads(v))
        b, h, l, d = out.shape
        return self.to_out(out.permute(0, 2, 1, 3).reshape(b, l, h * d))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = QLinear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU -> (dropout) -> Linear; sgm keys ``net.0.proj`` / ``net.2``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Identity(), QLinear(inner, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """self-attn -> text cross-attn -> GEGLU FF, pre-LN residuals.  With
    ``disable_self_attn`` the first attention reads the context too.
    ``token_kv``: the self-attention's tokens are a clip's (spatial)."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, disable_self_attn: bool = False,
                 token_kv: bool = False):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(dim, n_heads, d_head,
                                    context_dim=context_dim if disable_self_attn else None,
                                    token_kv=token_kv and not disable_self_attn)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, n_heads, d_head, context_dim=context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, context=None, kv_reuse_every: int = 0):
        if self.disable_self_attn:
            x = x + self.attn1(self.norm1(x), context=context)
        else:
            x = x + self.attn1(self.norm1(x), kv_reuse_every=kv_reuse_every)
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class BasicTransformerSingleLayerBlock(nn.Module):
    """One attention + FF.  Used as self-attention with ``context=x``, whose
    context is the un-normalised x.  ``token_kv``: the attention's keys are
    clip tokens (``kv_segments`` runs of them)."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, token_kv: bool = False):
        super().__init__()
        self.attn1 = CrossAttention(dim, n_heads, d_head, context_dim=context_dim,
                                    token_kv=token_kv)
        self.ff = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, context=None, kv_segments: int = 1):
        x = x + self.attn1(self.norm1(x), context=context, kv_segments=kv_segments)
        return x + self.ff(self.norm2(x))


def proj(cin: int, cout: int, use_linear: bool, zero: bool = False) -> nn.Module:
    """proj_in / proj_out: a Linear (``use_linear``) or a 1x1 conv.  Both act
    on the channels of an (N, H, W, C) tensor, so the JAX package's order of
    the token reshape and the projection does not matter."""
    m = QLinear(cin, cout) if use_linear else conv2d(cin, cout, k=1, quant=True)
    return zero_module(m) if zero else m


def temporal_proj(cin: int, cout: int, use_linear: bool) -> nn.Module:
    """The zero-initialised temporal projection: a Linear or a k=1 Conv1d."""
    return zero_module(QLinear(cin, cout) if use_linear else Conv1d(cin, cout, 1, quant=True))


class SpatialTransformer(nn.Module):
    """2D token transformer over (N, H, W, C).  ``disable_text_ca`` (the
    TVI2V appearance ControlNet) makes its blocks self-attention single
    blocks, without text cross-attention."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 disable_text_ca: bool = False, use_linear: bool = False,
                 disable_self_attn: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.norm = group_norm(in_channels, eps=1e-6)
        self.proj_in = proj(in_channels, inner, use_linear)
        self.disable_text_ca = disable_text_ca
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerSingleLayerBlock(inner, n_heads, d_head, token_kv=True)
            if disable_text_ca
            else BasicTransformerBlock(inner, n_heads, d_head, context_dim=context_dim,
                                       disable_self_attn=disable_self_attn, token_kv=True)
            for _ in range(depth))
        self.proj_out = proj(inner, in_channels, use_linear, zero=True)

    def forward(self, x, context=None, kv_reuse_every: int = 0):
        n, h, w, _ = x.shape
        y = self.proj_in(self.norm(x))
        y = y.reshape(n, h * w, -1)
        for blk in self.transformer_blocks:
            if self.disable_text_ca:
                y = blk(y)
            else:
                y = blk(y, context=context, kv_reuse_every=kv_reuse_every)
        return self.proj_out(y.reshape(n, h, w, -1)) + x


class SpatialTransformerCA(SpatialTransformer):
    """``SpatialTransformer`` + the RAIG reference sub-layer (sgm's
    SpatialTransformerCA): its tokens attend to ``ref_context`` (N, hw_ref,
    C), banked appearance-branch activations used as they are (not
    normalised), through ``norm_ca`` / ``proj_in_ca`` /
    ``transformer_blocks_ca.0`` / ``proj_out_ca``.  Without a
    ``ref_context`` it is the ``SpatialTransformer``."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 disable_text_ca: bool = False, use_linear: bool = False,
                 disable_self_attn: bool = False):
        super().__init__(in_channels, n_heads, d_head, depth, context_dim, disable_text_ca,
                         use_linear, disable_self_attn)
        inner = n_heads * d_head
        self.norm_ca = group_norm(in_channels, eps=1e-6)
        self.proj_in_ca = proj(in_channels, inner, use_linear)
        self.transformer_blocks_ca = nn.ModuleList(
            [BasicTransformerSingleLayerBlock(inner, n_heads, d_head, token_kv=True)])
        self.proj_out_ca = proj(inner, in_channels, use_linear, zero=True)

    def forward(self, x, context=None, ref_context=None, kv_reuse_every: int = 0):
        x = super().forward(x, context=context, kv_reuse_every=kv_reuse_every)
        if ref_context is None:
            return x
        n, h, w, _ = x.shape
        y = self.proj_in_ca(self.norm_ca(x)).reshape(n, h * w, -1)
        y = self.transformer_blocks_ca[0](y, context=ref_context)
        return self.proj_out_ca(y.reshape(n, h, w, -1)) + x


class SpatialTransformer3D(nn.Module):
    """Factorised video transformer: spatial attention over (B*T, H*W, C),
    then temporal attention over (H*B*W, T, C) with zero-initialised
    temporal projections and a residual (or, with ``use_learnable_alpha``,
    ``alpha * x + (1 - alpha) * temporal``).  Input/output: (B, T, H, W, C).
    With ``disable_temporal_text_ca`` (the shipped CCEdit setting) the
    temporal blocks are self-attention single blocks; without it they are
    full blocks whose cross-attention reads the text context repeated for
    every (h, w) row, in the temporal tokens' h-major order."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 use_linear: bool = False, disable_self_attn: bool = False,
                 disable_temporal_text_ca: bool = True, use_learnable_alpha: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.disable_temporal_text_ca = disable_temporal_text_ca
        self.norm = group_norm(in_channels, eps=1e-6)
        self.proj_in = proj(in_channels, inner, use_linear)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim=context_dim,
                                  disable_self_attn=disable_self_attn, token_kv=True)
            for _ in range(depth))
        self.proj_out = proj(inner, in_channels, use_linear, zero=True)
        self.norm_temporal = group_norm(in_channels, eps=1e-6, temporal=True)
        self.proj_in_temporal = temporal_proj(in_channels, inner, use_linear)
        self.transformer_blocks_temporal = nn.ModuleList(
            BasicTransformerSingleLayerBlock(inner, n_heads, d_head) if disable_temporal_text_ca
            else BasicTransformerBlock(inner, n_heads, d_head, context_dim=context_dim,
                                       disable_self_attn=disable_self_attn)
            for _ in range(depth))
        self.proj_out_temporal = temporal_proj(inner, in_channels, use_linear)
        self.alpha_temporal = nn.Parameter(torch.ones(1)) if use_learnable_alpha else None

    def _spatial(self, x, context):
        n, h, w, _ = x.shape
        y = self.proj_in(self.norm(x)).reshape(n, h * w, -1)
        for blk in self.transformer_blocks:
            y = blk(y, context=context)
        return self.proj_out(y.reshape(n, h, w, -1)) + x

    def _temporal(self, x, context_tok):
        y = self.proj_in_temporal(self.norm_temporal(x))
        for blk in self.transformer_blocks_temporal:
            # single blocks: the un-normalised y as context
            y = blk(y, context=y if self.disable_temporal_text_ca else context_tok)
        y = self.proj_out_temporal(y)
        if self.alpha_temporal is not None:
            return self.alpha_temporal * x + (1 - self.alpha_temporal) * y
        return x + y

    def _spatial_temporal(self, x, context):
        """The spatial then the temporal attention; (B*T, H, W, C) out."""
        b, t, h, w, _ = x.shape
        ctx = torch.repeat_interleave(context, t, dim=0) if context is not None else None
        xs = self._spatial(fold_time(x), ctx)
        ctx_tok = None
        if not self.disable_temporal_text_ca and context is not None:
            ctx_tok = repeat_ctx_temporal(context, h, w)  # (H*B*W, L, D)
        return temporal_apply(xs, b, lambda xt: self._temporal(xt, ctx_tok))

    def forward(self, x, context=None):
        return self._spatial_temporal(x, context).reshape(x.shape)


class SpatialTransformer3DCA(SpatialTransformer3D):
    """SpatialTransformer3D + a fifth attention: cross-frame cross-attention
    (CFCA) of every frame's tokens against an anchor, after the temporal
    attention.  ``ca_type``: "center" (the centre frame's tokens), "self"
    (the frame's own) or "center_self" (centre then own, concatenated: the
    TVI2V network's, with n_k = 2 * n_q).  ``ref_context`` (B, H*W, C), the
    appearance branch's banked tokens, replaces the anchor when given."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 ca_type: str = "center", **kwargs):
        super().__init__(in_channels, n_heads, d_head, depth, context_dim, **kwargs)
        if ca_type not in ("center", "self", "center_self"):
            raise ValueError(f"ca_type {ca_type!r}")
        inner = n_heads * d_head
        use_linear = kwargs.get("use_linear", False)
        self.ca_type = ca_type
        self.norm_temporal_ca = group_norm(in_channels, eps=1e-6)
        self.proj_in_temporal_ca = proj(in_channels, inner, use_linear)
        self.transformer_blocks_temporal_ca = nn.ModuleList(
            [BasicTransformerSingleLayerBlock(inner, n_heads, d_head, token_kv=True)])
        self.proj_out_temporal_ca = proj(inner, in_channels, use_linear, zero=True)

    def _cfca(self, x, b, t, ref_context):
        n, h, w, _ = x.shape
        y = self.proj_in_temporal_ca(self.norm_temporal_ca(x)).reshape(n, h * w, -1)
        segments = 1
        if ref_context is not None:
            anchor = torch.repeat_interleave(ref_context, t, dim=0)  # (B*T, hw, C)
        elif self.ca_type == "self":
            anchor = y
        else:
            shard = active()
            frames = y.reshape(b, t, h * w, -1)
            centre = (shard.centre_frame(frames) if shard is not None and shard.frame
                      else frames[:, t // 2])
            anchor = torch.repeat_interleave(centre, t, dim=0)  # b-major
            if self.ca_type == "center_self":
                anchor = torch.cat([anchor, y], dim=1)
                segments = 2
        y = self.transformer_blocks_temporal_ca[0](y, context=anchor, kv_segments=segments)
        return self.proj_out_temporal_ca(y.reshape(n, h, w, -1)) + x

    def forward(self, x, context=None, ref_context=None):
        b, t = x.shape[:2]
        xs = self._cfca(self._spatial_temporal(x, context), b, t, ref_context)
        return xs.reshape(x.shape)
