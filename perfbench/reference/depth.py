"""Plain PyTorch depth annotators: MiDaS DPT-Hybrid (the TV2V hint) and
ZoeDepth ZoeD_M12_N (the TVI2V hint), with their clip post-processes.

Written from the MiDaS (``dpt_depth.py``, ``vit.py``, timm's ResNetV2) and
HF ``ZoeDepthForDepthEstimation`` definitions, channels-first, with
nothing but ``torch`` operations.  Parameter names are the public
checkpoints': MiDaS's ``pretrained.*`` / ``scratch.*`` for DPT-Hybrid, HF's
for ZoeDepth (``query.bias`` / ``value.bias`` for BEiT's q and v biases).
Frames are (N, 3, H, W).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def bilinear(x: torch.Tensor, hw, align_corners: bool) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=align_corners)


def up2(x: torch.Tensor) -> torch.Tensor:
    return bilinear(x, (2 * x.shape[2], 2 * x.shape[3]), True)


def pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TensorFlow's SAME padding for a k x k window at stride s."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


# ---------------------------------------------------------------------------
# DPT-Hybrid
# ---------------------------------------------------------------------------

class StdConv(nn.Conv2d):
    """BiT's weight-standardised convolution, SAME padding, no bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, bias=False)

    def forward(self, x):
        w = self.weight
        w = (w - w.mean(dim=(1, 2, 3), keepdim=True)) / torch.sqrt(
            w.var(dim=(1, 2, 3), unbiased=False, keepdim=True) + 1e-8)
        return F.conv2d(pad_same(x, self.kernel_size[0], self.stride[0]), w, stride=self.stride)


class ConvNorm(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv, self.norm = StdConv(cin, cout, k, stride), nn.GroupNorm(32, cout, eps=1e-5)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, down: bool):
        super().__init__()
        mid = cout // 4
        if down:
            self.downsample = ConvNorm(cin, cout, 1, stride)
        self.conv1, self.norm1 = StdConv(cin, mid, 1), nn.GroupNorm(32, mid, eps=1e-5)
        self.conv2, self.norm2 = StdConv(mid, mid, 3, stride), nn.GroupNorm(32, mid, eps=1e-5)
        self.conv3, self.norm3 = StdConv(mid, cout, 1), nn.GroupNorm(32, cout, eps=1e-5)

    def forward(self, x):
        skip = x
        if hasattr(self, "downsample"):
            skip = self.downsample.norm(self.downsample.conv(x))
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + skip)


class ViTBlock(nn.Module):
    def __init__(self, d: int, heads: int, mlp: int):
        super().__init__()
        self.heads = heads
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=1e-12), nn.LayerNorm(d, eps=1e-12)
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = nn.Linear(d, mlp), nn.Linear(mlp, d)

    def forward(self, x):
        n, l, d = x.shape
        q, k, v = self.attn.qkv(self.norm1(x)).reshape(n, l, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        x = x + self.attn.proj(o.transpose(1, 2).reshape(n, l, d))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class Readout(nn.Module):
    """The "project" readout: each grid token with the cls token, Linear, GELU."""

    def __init__(self, d: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * d, d), nn.GELU())

    def forward(self, t):
        grid = t[:, 1:]
        return self.project(torch.cat([grid, t[:, :1].expand_as(grid)], dim=-1))


class RCU(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv2d(c, c, 3, padding=1), nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class Fusion(nn.Module):
    def __init__(self, c: int, lateral: bool):
        super().__init__()
        if lateral:
            self.resConfUnit1 = RCU(c)
        self.resConfUnit2 = RCU(c)
        self.out_conv = nn.Conv2d(c, c, 1)

    def forward(self, x, lateral=None):
        if lateral is not None:
            x = x + self.resConfUnit1(bilinear(lateral, x.shape[2:], False))
        return self.out_conv(up2(self.resConfUnit2(x)))


class DPTHybrid(nn.Module):
    """MiDaS ``dpt_hybrid``: ResNet-50 (BiT) stem and stages 1-3, ViT-B/16
    on the 1/16 map (taps after blocks 9 and 12), the DPT neck and head.
    (N, 3, H, W) in [-1, 1] -> (N, H, W) relative inverse depth."""

    def __init__(self, width: int = 64, hidden: Sequence[int] = (256, 512, 1024),
                 depths: Sequence[int] = (3, 4, 9), d: int = 768, layers: int = 12,
                 heads: int = 12, mlp: int = 3072, taps: Sequence[int] = (8, 11),
                 fusion: int = 256, grid: int = 24):
        super().__init__()
        self.taps, self.grid, self.d = tuple(taps), grid, d
        vit = nn.Module()
        pe = vit.patch_embed = nn.Module()
        bb = pe.backbone = nn.Module()
        bb.stem = nn.Module()
        bb.stem.conv, bb.stem.norm = StdConv(3, width, 7, 2), nn.GroupNorm(32, width, eps=1e-5)
        stages, cin = [], width
        for s, (c, n) in enumerate(zip(hidden, depths)):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                Bottleneck(cin if i == 0 else c, c, (1 if s == 0 else 2) if i == 0 else 1, i == 0)
                for i in range(n))
            stages.append(stage)
            cin = c
        bb.stages = nn.ModuleList(stages)
        pe.proj = nn.Conv2d(cin, d, 1)
        vit.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        vit.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, d))
        vit.blocks = nn.ModuleList(ViTBlock(d, heads, mlp) for _ in range(layers))
        pre = self.pretrained = nn.Module()
        pre.model = vit
        pre.act_postprocess3 = nn.Sequential(Readout(d), nn.Identity(), nn.Identity(),
                                             nn.Conv2d(d, d, 1))
        pre.act_postprocess4 = nn.Sequential(Readout(d), nn.Identity(), nn.Identity(),
                                             nn.Conv2d(d, d, 1), nn.Conv2d(d, d, 3, 2, 1))
        sc = self.scratch = nn.Module()
        for i, c in enumerate((hidden[0], hidden[1], d, d), start=1):
            setattr(sc, f"layer{i}_rn", nn.Conv2d(c, fusion, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(sc, f"refinenet{i}", Fusion(fusion, lateral=i != 4))
        sc.output_conv = nn.Sequential(
            nn.Conv2d(fusion, fusion // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(fusion // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())

    def forward(self, x):
        n = x.shape[0]
        vit = self.pretrained.model
        bb = vit.patch_embed.backbone
        h = F.relu(bb.stem.norm(bb.stem.conv(x)))
        h = F.max_pool2d(pad_same(h, 3, 2, float("-inf")), 3, stride=2)
        feats = []
        for stage in bb.stages:
            for blk in stage.blocks:
                h = blk(h)
            feats.append(h)
        gh, gw = feats[-1].shape[2:]
        tok = vit.patch_embed.proj(feats[-1]).flatten(2).transpose(1, 2)
        pos = vit.pos_embed
        grid = pos[:, 1:].reshape(1, self.grid, self.grid, -1).permute(0, 3, 1, 2)
        grid = bilinear(grid, (gh, gw), False).flatten(2).transpose(1, 2)
        tok = torch.cat([vit.cls_token.expand(n, -1, -1), tok], 1) + torch.cat([pos[:, :1], grid],
                                                                               1)
        taps = []
        for i, blk in enumerate(vit.blocks):
            tok = blk(tok)
            if i in self.taps:
                taps.append(tok)
        pre = self.pretrained
        maps = []
        for post, t in zip((pre.act_postprocess3, pre.act_postprocess4), taps):
            m = post[3](post[0](t).transpose(1, 2).reshape(n, self.d, gh, gw))
            maps.append(post[4](m) if len(post) > 4 else m)
        sc = self.scratch
        rn = [sc.layer1_rn(feats[0]), sc.layer2_rn(feats[1]), sc.layer3_rn(maps[0]),
              sc.layer4_rn(maps[1])]
        f = sc.refinenet4(rn[3])
        f = sc.refinenet3(f, rn[2])
        f = sc.refinenet2(f, rn[1])
        f = sc.refinenet1(f, rn[0])
        oc = sc.output_conv
        f = up2(oc[0](f))
        return oc[5](oc[4](oc[3](oc[2](f))))[:, 0]


def midas_hint(depth: torch.Tensor) -> torch.Tensor:
    """(N, H, W) depth of one clip -> (N, H, W, 3) hint in [-1, 1]: min-max
    over the clip, mapped to [1, -1]."""
    lo, hi = depth.min(), depth.max()
    d = ((depth - lo) / torch.clamp(hi - lo, min=1e-8)).clamp(0.0, 1.0)
    return (1.0 - 2.0 * d)[..., None].expand(-1, -1, -1, 3)


# ---------------------------------------------------------------------------
# ZoeDepth (ZoeD_M12_N)
# ---------------------------------------------------------------------------

def relative_index(h: int, w: int) -> torch.Tensor:
    """BEiT's relative-position index of an (h, w) window plus the cls token
    (the table's last three rows: cls to token, token to cls, cls to cls)."""
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ys, xs = ys.flatten(), xs.flatten()
    rel = (ys[:, None] - ys[None] + h - 1) * (2 * w - 1) + (xs[:, None] - xs[None] + w - 1)
    n = (2 * h - 1) * (2 * w - 1)
    index = torch.empty((h * w + 1, h * w + 1), dtype=torch.long)
    index[1:, 1:] = rel
    index[0, :] = n
    index[:, 0] = n + 1
    index[0, 0] = n + 2
    return index


def resize_table(table: torch.Tensor, old: Tuple[int, int], new: Tuple[int, int]) -> torch.Tensor:
    """A bias table of the ``old`` window resampled bilinearly to the ``new``
    one, the cls rows kept; the flat rows are read as (2w-1, 2h-1), HF's
    order."""
    oh, ow, nh, nw = 2 * old[0] - 1, 2 * old[1] - 1, 2 * new[0] - 1, 2 * new[1] - 1
    if (oh, ow) == (nh, nw):
        return table
    sub = table[:oh * ow].reshape(1, ow, oh, -1).permute(0, 3, 1, 2)
    sub = F.interpolate(sub, size=(nh, nw), mode="bilinear", align_corners=False)
    return torch.cat([sub.permute(0, 2, 3, 1).reshape(nh * nw, -1), table[oh * ow:]])


class Dense(nn.Module):
    def __init__(self, a: int, b: int):
        super().__init__()
        self.dense = nn.Linear(a, b)


class BeitLayer(nn.Module):
    def __init__(self, d: int, heads: int, n_rel: int):
        super().__init__()
        self.heads = heads
        att = nn.Module()
        att.query = nn.Linear(d, d)
        att.key = nn.Linear(d, d, bias=False)
        att.value = nn.Linear(d, d)
        att.relative_position_bias = nn.Module()
        att.relative_position_bias.relative_position_bias_table = nn.Parameter(
            torch.zeros(n_rel, heads))
        self.attention = nn.Module()
        self.attention.attention, self.attention.output = att, Dense(d, d)
        self.intermediate, self.output = Dense(d, 4 * d), Dense(4 * d, d)
        self.layernorm_before, self.layernorm_after = nn.LayerNorm(d, eps=1e-12), nn.LayerNorm(
            d, eps=1e-12)
        self.lambda_1, self.lambda_2 = nn.Parameter(torch.ones(d)), nn.Parameter(torch.ones(d))

    def forward(self, x, bias):
        n, l, d = x.shape
        att = self.attention.attention
        h = self.layernorm_before(x)
        split = lambda t: t.reshape(n, l, self.heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(split(att.query(h)), split(att.key(h)),
                                           split(att.value(h)), attn_mask=bias[None])
        x = x + self.lambda_1 * self.attention.output.dense(o.transpose(1, 2).reshape(n, l, d))
        return x + self.lambda_2 * self.output.dense(F.gelu(self.intermediate.dense(
            self.layernorm_after(x))))


class Reassemble(nn.Module):
    def __init__(self, d: int, c: int, factor: float):
        super().__init__()
        self.projection = nn.Conv2d(d, c, 1)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(c, c, int(factor), stride=int(factor))
        elif factor < 1:
            self.resize = nn.Conv2d(c, c, 3, stride=2, padding=1)


class PreAct(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(c, c, 3, padding=1)
        self.convolution2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class ZFusion(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.projection = nn.Conv2d(c, c, 1)
        self.residual_layer1, self.residual_layer2 = PreAct(c), PreAct(c)

    def forward(self, x, lateral=None):
        if lateral is not None:
            x = x + self.residual_layer1(bilinear(lateral, x.shape[2:], False))
        return self.projection(up2(self.residual_layer2(x)))


class TwoConv(nn.Module):
    def __init__(self, a: int, mid: int, b: int):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv2d(a, mid, 1), nn.Conv2d(mid, b, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class ZoeDepth(nn.Module):
    """ZoeD_M12_N: BEiT-L/16 with a relative-position bias, the DPT neck,
    the relative head and the metric-bins head (seed bins, 4 attractor
    stages, conditional log-binomial).  (N, 3, H, W) normalised -> (N, H', W')
    metric depth at the fused map's size."""

    def __init__(self, d: int = 1024, heads: int = 16, layers: int = 24, patch: int = 16,
                 taps: Sequence[int] = (5, 11, 17, 23),
                 neck: Sequence[int] = (256, 512, 1024, 1024),
                 factors: Sequence[float] = (4, 2, 1, 0.5), fusion: int = 256, bins: int = 64,
                 bin_dim: int = 128, attractors: Sequence[int] = (16, 8, 4, 1), rel: int = 32,
                 seed_mlp: int = 256, proj_mlp: int = 128, grid: Tuple[int, int] = (24, 24)):
        super().__init__()
        self.d, self.patch, self.taps, self.bins = d, patch, tuple(taps), bins
        self.attractor_counts, self.grid = tuple(attractors), tuple(grid)
        n_rel = (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3
        bb = self.backbone = nn.Module()
        bb.embeddings = nn.Module()
        bb.embeddings.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        bb.embeddings.patch_embeddings = nn.Module()
        bb.embeddings.patch_embeddings.projection = nn.Conv2d(3, d, patch, stride=patch)
        bb.encoder = nn.Module()
        bb.encoder.layer = nn.ModuleList(BeitLayer(d, heads, n_rel) for _ in range(layers))
        nk = self.neck = nn.Module()
        nk.reassemble_stage = nn.Module()
        nk.reassemble_stage.readout_projects = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * d, d), nn.GELU()) for _ in range(4))
        nk.reassemble_stage.layers = nn.ModuleList(Reassemble(d, c, f)
                                                   for c, f in zip(neck, factors))
        nk.convs = nn.ModuleList(nn.Conv2d(c, fusion, 3, padding=1, bias=False) for c in neck)
        nk.fusion_stage = nn.Module()
        nk.fusion_stage.layers = nn.ModuleList(ZFusion(fusion) for _ in range(4))
        rh = self.relative_head = nn.Module()
        rh.conv1 = nn.Conv2d(fusion, fusion // 2, 3, padding=1)
        rh.conv2 = nn.Conv2d(fusion // 2, rel, 3, padding=1)
        rh.conv3 = nn.Conv2d(rel, 1, 1)
        mh = self.metric_head = nn.Module()
        mh.conv2 = nn.Conv2d(fusion, fusion, 1)
        mh.seed_bin_regressor = TwoConv(fusion, seed_mlp, bins)
        mh.seed_projector = TwoConv(fusion, proj_mlp, bin_dim)
        mh.projectors = nn.ModuleList(TwoConv(fusion, proj_mlp, bin_dim) for _ in range(4))
        mh.attractors = nn.ModuleList(TwoConv(bin_dim, bin_dim, a) for a in attractors)
        mh.conditional_log_binomial = nn.Module()
        width = rel + 1 + bin_dim
        mh.conditional_log_binomial.mlp = nn.Sequential(nn.Conv2d(width, width // 2, 1),
                                                        nn.GELU(), nn.Conv2d(width // 2, 4, 1))

    def forward(self, x):
        n = x.shape[0]
        ph, pw = x.shape[2] // self.patch, x.shape[3] // self.patch
        emb = self.backbone.embeddings
        t = emb.patch_embeddings.projection(x).flatten(2).transpose(1, 2)
        t = torch.cat([emb.cls_token.expand(n, -1, -1), t], dim=1)
        index = relative_index(ph, pw).to(x.device)
        outs = []
        for i, layer in enumerate(self.backbone.encoder.layer):
            table = layer.attention.attention.relative_position_bias.relative_position_bias_table
            bias = resize_table(table, self.grid, (ph, pw))[index].permute(2, 0, 1)
            t = layer(t, bias)
            if i in self.taps:
                outs.append(t)
        rs = self.neck.reassemble_stage
        feats = []
        for i, tok in enumerate(outs):
            grid = tok[:, 1:]
            h = rs.readout_projects[i](torch.cat([grid, tok[:, :1].expand_as(grid)], dim=-1))
            h = rs.layers[i].projection(h.transpose(1, 2).reshape(n, self.d, ph, pw))
            if hasattr(rs.layers[i], "resize"):
                h = rs.layers[i].resize(h)
            feats.append(self.neck.convs[i](h))
        fused, state = [], None
        for layer, f in zip(self.neck.fusion_stage.layers, feats[::-1]):
            state = layer(f) if state is None else layer(state, f)
            fused.append(state)
        rh = self.relative_head
        rel_feat = F.relu(rh.conv2(up2(rh.conv1(fused[-1]))))
        rel_depth = F.relu(rh.conv3(rel_feat))
        mh = self.metric_head
        h = mh.conv2(feats[-1])
        prev_bin, prev_emb = F.softplus(mh.seed_bin_regressor(h)), mh.seed_projector(h)
        centers = prev_bin
        for i, f in enumerate(fused):
            e = mh.projectors[i](f)
            hw = e.shape[2:]
            a = F.softplus(mh.attractors[i](e + bilinear(prev_emb, hw, True)))
            c = bilinear(prev_bin, hw, True)
            dx = a[:, :, None] - c[:, None]
            centers = c + (dx / (1.0 + 300.0 * dx * dx)).sum(dim=1) / self.attractor_counts[i]
            prev_bin, prev_emb = centers, e
        hw = rel_feat.shape[2:]
        z = torch.cat([rel_feat, bilinear(rel_depth, hw, True), bilinear(prev_emb, hw, True)], 1)
        p = F.softplus(mh.conditional_log_binomial.mlp(z)) + 1e-4
        prob = p[:, 0] / (p[:, 0] + p[:, 1])
        temp = 0.0212 + (50.0 - 0.0212) * p[:, 2] / (p[:, 2] + p[:, 3])
        k = self.bins
        j = torch.arange(k, dtype=x.dtype, device=x.device)[None, :, None, None]
        log_binom = math.lgamma(k) - torch.lgamma(j + 1.0) - torch.lgamma(k - j)
        y = (log_binom + j * torch.log(prob.clamp(1e-4, 1.0))[:, None]
             + (k - 1 - j) * torch.log((1.0 - prob).clamp(1e-4, 1.0))[:, None])
        probs = torch.softmax(y / temp[:, None], dim=1)
        return (probs * bilinear(centers, probs.shape[2:], True)).sum(dim=1)


def zoe_pad(frames: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """(N, 3, H, W) frames in [-1, 1] (the [0, 1] frames normalised with
    mean and std 0.5) edge-padded to a multiple of two patches."""
    h, w = frames.shape[2:]
    m = 2 * patch
    return F.pad(frames, (0, (m - w % m) % m, 0, (m - h % m) % m), mode="replicate")


def zoe_resize_crop(depth: torch.Tensor, padded, hw) -> torch.Tensor:
    """The model's (N, h', w') depth resized to the padded size, cropped to
    the frames'."""
    d = bilinear(depth[:, None].float(), padded, False)[:, 0]
    return d[:, :hw[0], :hw[1]]


def zoe_depth(model: ZoeDepth, frames: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) frames in [-1, 1] -> (N, H, W) metric depth."""
    x = zoe_pad(frames, model.patch)
    return zoe_resize_crop(model(x), x.shape[2:], frames.shape[2:])


def zoe_hint(depth: torch.Tensor) -> torch.Tensor:
    """(N, H, W) depth of one clip -> (N, H, W, 3) hint: the 2 % and 85 %
    order statistics of the clip's values map to -1 and 1, the rest
    clamped."""
    flat = depth.flatten()
    n = flat.numel()
    lo = flat.kthvalue(max(int(0.02 * n), 1)).values
    hi = flat.kthvalue(max(int(0.85 * n), 1)).values
    d = ((depth - lo) / (hi - lo)).clamp(0.0, 1.0) * 2.0 - 1.0
    return d[..., None].expand(-1, -1, -1, 3)
