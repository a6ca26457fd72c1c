"""Plain PyTorch CCEdit networks: the pseudo-3D SD-1.5 UNet with its
structure ControlNet, the TVI2V appearance ControlNet and cross-frame
cross-attention (CFCA), the KL-f8 VAE and the CLIP ViT-L/14 text encoder.

Written from the sgm / CCEdit model definitions (``openaimodel.py``,
``controlmodel.py``, ``attention.py``, ``autoencoder.py``) in PyTorch's own
channels-first layout, with nothing but ``torch`` operations, so that it
shares no code with the program it judges.  Parameter names are the public
checkpoint's (``model.diffusion_model.*`` without that prefix, ``first_stage_model.*``,
``cond_stage_model.transformer.*``), so one seeded state dict loads into
both.  Two numerics are those that each configuration file states under
``assumed.numerics`` (the port's and the JAX package's, flax's defaults),
not sgm's: the transformer LayerNorms use epsilon 1e-6 (sgm: torch's 1e-5)
and GEGLU's GELU is the tanh approximation (sgm: the exact GELU); a video
is (B, T, C, H, W).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
SCORES_PER_CALL = 2 ** 28  # attention scores one call may hold


def heads_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (N, L, heads * d) tokens, a few
    sequences at a time (``SCORES_PER_CALL``)."""
    n, lq, inner = q.shape
    d = inner // heads
    step = max(1, SCORES_PER_CALL // (heads * lq * k.shape[1]))
    out = []
    for i in range(0, n, step):
        qs, ks, vs = (t[i:i + step] for t in (q, k, v))
        split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)
        o = F.scaled_dot_product_attention(split(qs), split(ks), split(vs))
        out.append(o.transpose(1, 2).reshape(o.shape[0], lq, inner))
    return torch.cat(out)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def gn(c: int, eps: float = 1e-5) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=eps)


def video_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B*H*W, C, T): one row a pixel, its frames along T."""
    b, t, c, h, w = x.shape
    return x.permute(0, 3, 4, 2, 1).reshape(b * h * w, c, t)


def rows_video(r: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    n, c, t = r.shape
    return r.reshape(b, h, w, c, t).permute(0, 4, 3, 1, 2)


def st(x: torch.Tensor, spatial, temporal) -> torch.Tensor:
    """The pseudo-3D pattern: ``spatial`` on every frame, then the rows plus
    ``temporal`` of them."""
    b, t = x.shape[:2]
    y = spatial(x.flatten(0, 1))
    y = y.reshape((b, t) + y.shape[1:])
    r = video_rows(y)
    return rows_video(r + temporal(r), b, y.shape[3], y.shape[4])


def per_frame(x: torch.Tensor, fn) -> torch.Tensor:
    b, t = x.shape[:2]
    y = fn(x.flatten(0, 1))
    return y.reshape((b, t) + y.shape[1:])


def up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


# ---------------------------------------------------------------------------
# transformers
# ---------------------------------------------------------------------------

class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None):
        super().__init__()
        inner, context_dim = heads * dim_head, context_dim or dim
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        context = x if context is None else context
        return self.to_out(heads_attention(self.to_q(x), self.to_k(context), self.to_v(context),
                                           self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, 4 * dim), nn.Dropout(0.0), nn.Linear(4 * dim, dim))

    def forward(self, x):
        return self.net(x)


class FullBlock(nn.Module):
    """Self-attention, text cross-attention, feed-forward; pre-LN residuals."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=LN_EPS) for _ in range(3))

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SingleBlock(nn.Module):
    """One attention (keys from ``context``, else from its normalised input)
    and a feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.norm1, self.norm2 = nn.LayerNorm(dim, eps=LN_EPS), nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x), context)
        return x + self.ff(self.norm2(x))


def tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def untokens(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return y.transpose(1, 2).reshape(y.shape[0], -1, h, w)


class SpatialTransformer(nn.Module):
    """Image transformer over (N, C, H, W); ``self_only``: one self-attention
    block without the text (the appearance ControlNet's)."""

    def __init__(self, c: int, heads: int, dim_head: int, context_dim: int,
                 self_only: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.self_only = self_only
        self.norm = gn(c, 1e-6)
        self.proj_in = nn.Conv2d(c, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [SingleBlock(inner, heads, dim_head) if self_only
             else FullBlock(inner, heads, dim_head, context_dim)])
        self.proj_out = nn.Conv2d(inner, c, 1)

    def forward(self, x, context):
        h, w = x.shape[2:]
        y = tokens(self.proj_in(self.norm(x)))
        blk = self.transformer_blocks[0]
        y = blk(y) if self.self_only else blk(y, context)
        return self.proj_out(untokens(y, h, w)) + x


class VideoTransformer(nn.Module):
    """Spatial transformer on every frame, then temporal self-attention over
    each pixel's frames; with ``cfca`` a fifth attention of every frame's
    tokens against the centre frame's and its own (CFCA)."""

    def __init__(self, c: int, heads: int, dim_head: int, context_dim: int, cfca: bool):
        super().__init__()
        inner = heads * dim_head
        self.cfca = cfca
        self.norm = gn(c, 1e-6)
        self.proj_in = nn.Conv2d(c, inner, 1)
        self.transformer_blocks = nn.ModuleList([FullBlock(inner, heads, dim_head, context_dim)])
        self.proj_out = nn.Conv2d(inner, c, 1)
        self.norm_temporal = gn(c, 1e-6)
        self.proj_in_temporal = nn.Conv1d(c, inner, 1)
        self.transformer_blocks_temporal = nn.ModuleList([SingleBlock(inner, heads, dim_head)])
        self.proj_out_temporal = nn.Conv1d(inner, c, 1)
        if cfca:
            self.norm_temporal_ca = gn(c, 1e-6)
            self.proj_in_temporal_ca = nn.Conv2d(c, inner, 1)
            self.transformer_blocks_temporal_ca = nn.ModuleList([SingleBlock(inner, heads,
                                                                             dim_head)])
            self.proj_out_temporal_ca = nn.Conv2d(inner, c, 1)

    def spatial(self, x, context):
        h, w = x.shape[2:]
        y = self.transformer_blocks[0](tokens(self.proj_in(self.norm(x))), context)
        return self.proj_out(untokens(y, h, w)) + x

    def temporal(self, r):
        y = self.proj_in_temporal(self.norm_temporal(r)).transpose(1, 2)  # (N, T, inner)
        y = self.transformer_blocks_temporal[0](y, y)
        return self.proj_out_temporal(y.transpose(1, 2))

    def forward(self, x, context):
        b, t = x.shape[:2]
        ctx = context.repeat_interleave(t, dim=0)
        x = st(x, lambda f: self.spatial(f, ctx), self.temporal)
        if not self.cfca:
            return x
        f = x.flatten(0, 1)
        h, w = f.shape[2:]
        y = tokens(self.proj_in_temporal_ca(self.norm_temporal_ca(f)))  # (B*T, hw, inner)
        frames = y.reshape((b, t) + y.shape[1:])
        centre = frames[:, t // 2].repeat_interleave(t, dim=0)
        y = self.transformer_blocks_temporal_ca[0](y, torch.cat([centre, y], dim=1))
        return (self.proj_out_temporal_ca(untokens(y, h, w)) + f).reshape(x.shape)


# ---------------------------------------------------------------------------
# residual and resampling blocks
# ---------------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, cin: int, emb: int, cout: int):
        super().__init__()
        self.in_layers = nn.Sequential(gn(cin), nn.SiLU(), nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, cout))
        self.out_layers = nn.Sequential(gn(cout), nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = nn.Identity() if cin == cout else nn.Conv2d(cin, cout, 1)

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class ResBlock3D(nn.Module):
    """Every 2-D conv of the block is followed by a temporal conv over the
    frames, added to it; the temporal convs of the two 3x3 convs have their
    own GroupNorm and SiLU."""

    def __init__(self, cin: int, emb: int, cout: int):
        super().__init__()
        self.in_layers = nn.Sequential(gn(cin), nn.SiLU(), nn.Conv2d(cin, cout, 3, padding=1))
        self.in_layers_temporal = nn.Sequential(gn(cout), nn.SiLU(),
                                                nn.Conv1d(cout, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, cout))
        self.out_layers = nn.Sequential(gn(cout), nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        self.out_layers_temporal = nn.Sequential(gn(cout), nn.SiLU(), nn.Dropout(0.0),
                                                 nn.Conv1d(cout, cout, 3, padding=1))
        if cin != cout:
            self.skip_connection = nn.Conv2d(cin, cout, 1)
            self.skip_connection_temporal = nn.Conv1d(cout, cout, 1)

    def forward(self, x, emb):
        h = st(x, self.in_layers, self.in_layers_temporal)
        h = h + self.emb_layers(emb)[:, None, :, None, None]
        h = st(h, self.out_layers, self.out_layers_temporal)
        if hasattr(self, "skip_connection"):
            x = st(x, self.skip_connection, self.skip_connection_temporal)
        return x + h


class Down(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = nn.Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Down3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = nn.Conv2d(c, c, 3, stride=2, padding=1)
        self.conv_temporal = nn.Conv1d(c, c, 3, padding=1)

    def forward(self, x):
        return st(x, self.op, self.conv_temporal)


class Up3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)
        self.conv_temporal = nn.Conv1d(c, c, 3, padding=1)

    def forward(self, x):
        return st(per_frame(x, up2), self.conv, self.conv_temporal)


# ---------------------------------------------------------------------------
# the UNet and the ControlNets
# ---------------------------------------------------------------------------

class UNet(nn.Module):
    """sgm's ``UNetModel`` at its SD-1.5 options; ``video``: the pseudo-3D
    UNet (``cfca``: with cross-frame cross-attention), else the 2-D encoder
    trunk of a ControlNet (``self_only`` transformers: without the text)."""

    def __init__(self, p: dict, video: bool, encoder_only: bool = False, cfca: bool = False,
                 self_only: bool = False):
        super().__init__()
        ch, mult, nrb = p["model_channels"], p["channel_mult"], p["num_res_blocks"]
        heads, ctx, att = p["num_heads"], p["context_dim"], p["attention_resolutions"]
        self.video, self.ch = video, ch
        res = (lambda a, b: ResBlock3D(a, 4 * ch, b)) if video else (
            lambda a, b: ResBlock(a, 4 * ch, b))

        def transformer(c):
            if video:
                return VideoTransformer(c, heads, c // heads, ctx, cfca)
            return SpatialTransformer(c, heads, c // heads, ctx, self_only)

        self.time_embed = nn.Sequential(nn.Linear(ch, 4 * ch), nn.SiLU(), nn.Linear(4 * ch, 4 * ch))
        blocks = [nn.ModuleList([nn.Conv2d(p["in_channels"], ch, 3, padding=1)])]
        chans, cur, ds = [ch], ch, 1
        for level, m in enumerate(mult):
            for _ in range(nrb):
                blk = [res(cur, m * ch)]
                cur = m * ch
                if ds in att:
                    blk.append(transformer(cur))
                blocks.append(nn.ModuleList(blk))
                chans.append(cur)
            if level != len(mult) - 1:
                blocks.append(nn.ModuleList([Down3D(cur) if video else Down(cur)]))
                chans.append(cur)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        if video:
            self.input_blocks_temporal = nn.Sequential(nn.Conv1d(ch, ch, 3, padding=1))
        self.middle_block = nn.ModuleList([res(cur, cur), transformer(cur), res(cur, cur)])
        self.chans = chans
        if encoder_only:
            return
        blocks = []
        for level, m in reversed(list(enumerate(mult))):
            for i in range(nrb + 1):
                blk = [res(cur + chans.pop(), m * ch)]
                cur = m * ch
                if ds in att:
                    blk.append(transformer(cur))
                if level and i == nrb:
                    blk.append(Up3D(cur))
                    ds //= 2
                blocks.append(nn.ModuleList(blk))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(gn(ch), nn.SiLU(), nn.Conv2d(ch, p["out_channels"], 3, padding=1))
        self.out_temporal = nn.Sequential(nn.SiLU(), nn.Conv1d(p["out_channels"],
                                                               p["out_channels"], 3, padding=1))

    def embed(self, t: torch.Tensor) -> torch.Tensor:
        return self.time_embed(timestep_embedding(t, self.ch))

    @staticmethod
    def run(blk, h, emb, context):
        for mod in blk:
            if isinstance(mod, (ResBlock, ResBlock3D)):
                h = mod(h, emb)
            elif isinstance(mod, (SpatialTransformer, VideoTransformer)):
                h = mod(h, context)
            else:
                h = mod(h)
        return h

    def forward(self, x, t, context, control: List[torch.Tensor],
                img_control: Optional[List[torch.Tensor]] = None):
        """x (B, T, C, h, w); ``control`` the 13 structure taps (B, T, C, .);
        ``img_control`` the 13 appearance taps (B, C, .), added onto the centre
        frame after every encoder block and the middle block."""
        emb = self.embed(t)
        control, img_control = list(control), list(img_control or [])

        def inject(h):
            if img_control:
                h = h.clone()
                h[:, h.shape[1] // 2] += img_control.pop(0)
            return h

        hs, h = [], x
        for i, blk in enumerate(self.input_blocks):
            if i == 0:
                h = st(h, blk[0], self.input_blocks_temporal)
            else:
                h = self.run(blk, h, emb, context)
            h = inject(h)
            hs.append(h)
        h = inject(self.run(self.middle_block, h, emb, context)) + control.pop()
        for blk in self.output_blocks:
            h = self.run(blk, torch.cat([h, hs.pop() + control.pop()], dim=2), emb, context)
        return st(h, self.out, self.out_temporal)


HINT_LADDER = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


class ControlNet(UNet):
    """The encoder trunk run on images, its 13 activations through
    zero convs.  ``hint_channels`` RGB: an 8-conv pyramid turns the hint into
    features added to the stem's output; ``identity_hint``: the hint (a
    latent) goes through the stem conv and replaces the input."""

    def __init__(self, p: dict, hint_channels: int = 3, identity_hint: bool = False,
                 self_only: bool = False):
        super().__init__(p, video=False, encoder_only=True, self_only=self_only)
        self.identity_hint = identity_hint
        if not identity_hint:
            layers, cin = [], hint_channels
            for c, s in HINT_LADDER:
                layers += [nn.Conv2d(cin, c, 3, stride=s, padding=1), nn.SiLU()]
                cin = c
            layers.append(nn.Conv2d(cin, p["model_channels"], 3, padding=1))
            self.input_hint_block = nn.Sequential(*layers)
        self.zero_convs = nn.ModuleList(nn.Sequential(nn.Conv2d(c, c, 1)) for c in self.chans)
        self.middle_block_out = nn.Sequential(nn.Conv2d(self.chans[-1], self.chans[-1], 1))

    def hint_features(self, hint: torch.Tensor) -> torch.Tensor:
        return (self.input_blocks[0][0] if self.identity_hint else self.input_hint_block)(hint)

    def forward(self, x, features, t, context):
        """x (N, C, h, w) latents, ``features`` from ``hint_features``: the 13
        taps."""
        emb = self.embed(t)
        outs = []
        h = x
        for i, blk in enumerate(self.input_blocks):
            if i == 0:
                h = features if self.identity_hint else blk[0](h) + features
            else:
                h = self.run(blk, h, emb, context)
            outs.append(self.zero_convs[i](h))
        outs.append(self.middle_block_out(self.run(self.middle_block, h, emb, context)))
        return outs


class Network(UNet):
    """The pseudo-3D UNet, the structure ControlNet (``controlnet``) and the
    optional appearance ControlNet (``controlnet_img``): (x, t, cond) -> eps."""

    def __init__(self, p: dict):
        super().__init__(p, video=True, cfca=bool(p.get("enable_attention3d_crossframe", False)))
        cn = p["controlnet_config"]["params"]
        self.controlnet = ControlNet(cn, hint_channels=cn.get("hint_channels", 3))
        img = p.get("controlnet_img_config")
        if img is not None:
            ip = img["params"]
            self.controlnet_img = ControlNet(ip, hint_channels=ip.get("hint_channels", 4),
                                             identity_hint=True, self_only=True)

    def hint_features(self, hint: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) hint in [-1, 1] -> (B, T, C, h, w) pyramid features
        (ControlNet 1.1 inverts the hint first)."""
        return per_frame((1.0 - (hint + 1.0) / 2.0).permute(0, 1, 4, 2, 3),
                         self.controlnet.hint_features)

    def forward(self, x, t, context, features, cond_feat=None):
        """x (B, T, C, h, w) latents, t (B,) timesteps, ``context`` (B, L, D),
        ``features`` from ``hint_features``, ``cond_feat`` (B, 4, h, w) the
        appearance latent."""
        b, tt = x.shape[:2]
        taps = self.controlnet(x.flatten(0, 1), features.flatten(0, 1),
                               t.repeat_interleave(tt), context.repeat_interleave(tt, dim=0))
        control = [c.reshape((b, tt) + c.shape[1:]) for c in taps]
        img = None
        if cond_feat is not None:
            cn = self.controlnet_img
            img = cn(x[:, tt // 2], cn.hint_features(cond_feat), t, context)
        return UNet.forward(self, x, t, context, control, img)


# ---------------------------------------------------------------------------
# the KL-f8 autoencoder
# ---------------------------------------------------------------------------

class VAEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = gn(cin, 1e-6), nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = gn(cout, 1e-6), nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class VAEAttn(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = gn(c, 1e-6)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1) for _ in range(4))

    def forward(self, x):
        h, w = x.shape[2:]
        n = self.norm(x)
        o = heads_attention(tokens(self.q(n)), tokens(self.k(n)), tokens(self.v(n)), 1)
        return x + self.proj_out(untokens(o, h, w))


class VAEMid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = VAEResBlock(c, c), VAEAttn(c), VAEResBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class VAEDown(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEUp(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(up2(x))


class VAELevel(nn.Module):
    def __init__(self, blocks, **resample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        for name, mod in resample.items():
            self.add_module(name, mod)


class VAE(nn.Module):
    """LDM's ``AutoencoderKL`` without attention at any level (SD's)."""

    def __init__(self, dd: dict, embed_dim: int = 4):
        super().__init__()
        ch, mult, nrb, z = dd["ch"], dd["ch_mult"], dd["num_res_blocks"], dd["z_channels"]
        enc = nn.Module()
        enc.conv_in = nn.Conv2d(dd["in_channels"], ch, 3, padding=1)
        levels, cur = [], ch
        for i, m in enumerate(mult):
            blocks = []
            for _ in range(nrb):
                blocks.append(VAEResBlock(cur, ch * m))
                cur = ch * m
            extra = {} if i == len(mult) - 1 else {"downsample": VAEDown(cur)}
            levels.append(VAELevel(blocks, **extra))
        enc.down = nn.ModuleList(levels)
        enc.mid, enc.norm_out = VAEMid(cur), gn(cur, 1e-6)
        enc.conv_out = nn.Conv2d(cur, 2 * z, 3, padding=1)
        dec = nn.Module()
        dec.conv_in = nn.Conv2d(z, cur, 3, padding=1)
        dec.mid = VAEMid(cur)
        levels = [None] * len(mult)
        for i in reversed(range(len(mult))):
            blocks = []
            for _ in range(nrb + 1):
                blocks.append(VAEResBlock(cur, ch * mult[i]))
                cur = ch * mult[i]
            levels[i] = VAELevel(blocks, **({"upsample": VAEUp(cur)} if i else {}))
        dec.up = nn.ModuleList(levels)
        dec.norm_out, dec.conv_out = gn(cur, 1e-6), nn.Conv2d(cur, dd["out_ch"], 3, padding=1)
        self.encoder, self.decoder = enc, dec
        self.quant_conv = nn.Conv2d(2 * z, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z, 1)

    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) pixels in [-1, 1] -> the posterior mean (N, 4, h, w)."""
        e = self.encoder
        h = e.conv_in(x)
        for level in e.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = e.conv_out(F.silu(e.norm_out(e.mid(h))))
        return self.quant_conv(h).chunk(2, dim=1)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, 4, h, w) unscaled latents -> (N, 3, H, W) pixels."""
        d = self.decoder
        h = d.mid(d.conv_in(self.post_quant_conv(z)))
        for i in reversed(range(len(d.up))):
            for blk in d.up[i].block:
                h = blk(h)
            if i:
                h = d.up[i].upsample(h)
        return d.conv_out(F.silu(d.norm_out(h)))


# ---------------------------------------------------------------------------
# CLIP ViT-L/14 text
# ---------------------------------------------------------------------------

class CLIPLayer(nn.Module):
    def __init__(self, w: int, heads: int):
        super().__init__()
        self.heads = heads
        attn = self.self_attn = nn.Module()
        attn.q_proj, attn.k_proj, attn.v_proj, attn.out_proj = (nn.Linear(w, w) for _ in range(4))
        self.layer_norm1, self.layer_norm2 = nn.LayerNorm(w), nn.LayerNorm(w)
        mlp = self.mlp = nn.Module()
        mlp.fc1, mlp.fc2 = nn.Linear(w, 4 * w), nn.Linear(4 * w, w)

    def forward(self, x):
        a, n, l = self.self_attn, self.layer_norm1(x), x.shape[1]
        d = x.shape[-1] // self.heads
        split = lambda t: t.reshape(t.shape[0], l, self.heads, d).transpose(1, 2)
        o = F.scaled_dot_product_attention(split(a.q_proj(n)), split(a.k_proj(n)),
                                           split(a.v_proj(n)), is_causal=True)
        x = x + a.out_proj(o.transpose(1, 2).reshape(x.shape))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class CLIPText(nn.Module):
    """HF ``CLIPTextModel`` keys under ``text_model``; returns the last
    layer's output after the final LayerNorm."""

    def __init__(self, vocab: int = 49408, max_len: int = 77, width: int = 768, heads: int = 12,
                 layers: int = 12):
        super().__init__()
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(vocab, width)
        tm.embeddings.position_embedding = nn.Embedding(max_len, width)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(CLIPLayer(width, heads) for _ in range(layers))
        tm.final_layer_norm = nn.LayerNorm(width)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        emb = tm.embeddings
        x = emb.token_embedding(ids) + emb.position_embedding.weight[:ids.shape[1]]
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)


def hash_tokens(texts: Sequence[str], max_len: int = 77) -> torch.Tensor:
    """The configuration's tokenizer when no BPE assets are given: each
    lower-cased, whitespace-split word's md5 modulo 49406, between the
    start token 49406 and end tokens 49407."""
    import hashlib
    import re

    out = torch.full((len(texts), max_len), 49407, dtype=torch.long)
    for i, text in enumerate(texts):
        words = re.sub(r"\s+", " ", text).strip().lower().split()[:max_len - 2]
        row = [49406] + [int(hashlib.md5(w.encode()).hexdigest(), 16) % 49406 for w in words] + [
            49407]
        out[i, :len(row)] = torch.tensor(row)
    return out
