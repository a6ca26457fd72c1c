"""MiDaS DPT-Hybrid relative-depth backbone (port of
``ccedit_tpu/conditioning/annotators/dpt_midas.py``: ``DPTHybrid``,
``detect_depth_midas`` and the checkpoint loading of ``convert_dpt_midas``).

Architecture, as in the JAX package:

* BiT (ResNetV2) stem + 3 bottleneck stages with weight-standardised convs
  (biased variance, eps 1e-8) and GroupNorm (a bf16 input's statistics and
  affine map in fp32, as flax keeps them); the stem conv, the strided 3x3
  convs and the stem max-pool use TF-SAME padding, which is asymmetric
  (0, 1) for stride 2 on even sizes, not torch's symmetric padding;
* ViT-B/16 on the /16 feature map: cls token, position embeddings resized
  bilinearly (align_corners=False) from the 24x24 pretraining grid, taps
  after blocks 8 and 11 with no final LayerNorm.  Its attention is a plain
  matmul with an fp32 softmax, as in JAX, not the dispatch point's kernels;
* DPT neck: "project" readout, reassemble convs, RefineNet fusion with
  2x bilinear upsampling (align_corners=True), and the ReLU depth head.

Input (N, H, W, 3) in [-1, 1], H and W divisible by 32; output (N, H, W)
relative inverse depth.  Submodules carry the official MiDaS checkpoint's
names (``pretrained.model.*``, ``pretrained.act_postprocess{3,4}.*``,
``scratch.*``), so ``load_dpt_checkpoint`` loads
``dpt_hybrid-midas-501f0c75.pt`` (or an HF ``Intel/dpt-hybrid-midas`` state
dict, translated) with a strict ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME padding (before, after) of one spatial axis."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """NCHW tensor padded TF-SAME for a k x k window at stride s."""
    top, bottom = _same_pad(x.shape[2], k, s)
    left, right = _same_pad(x.shape[3], k, s)
    return F.pad(x, (left, right, top, bottom), value=value)


def _resize(x: torch.Tensor, hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=align_corners)


class WSConv2d(nn.Conv2d):
    """Weight-standardised conv (BiT), TF-SAME padded, no bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, eps: float = 1e-8):
        super().__init__(cin, cout, k, stride=stride, bias=False)
        self.eps = eps

    def forward(self, x):
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        return F.conv2d(_pad_same(x, self.kernel_size[0], self.stride[0]), w,
                        stride=self.stride)


class _GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` whose bf16 (or fp16) input keeps its statistics and
    affine map in fp32, the output rounded once to the input's dtype, as
    flax's ``nn.GroupNorm(dtype=...)`` does (torch's own keeps a bf16
    input's statistics in bf16)."""

    def forward(self, x):
        if x.dtype not in (torch.bfloat16, torch.float16):
            return super().forward(x)
        weight, bias = (None if t is None else t.float() for t in (self.weight, self.bias))
        return F.group_norm(x.float(), self.num_groups, weight, bias, self.eps).to(x.dtype)


class _Stem(nn.Module):
    def __init__(self, width: int, num_groups: int):
        super().__init__()
        self.conv = WSConv2d(3, width, 7, stride=2)
        self.norm = _GroupNorm(num_groups, width, eps=1e-5)

    def forward(self, x):
        x = F.relu(self.norm(self.conv(x)))
        return F.max_pool2d(_pad_same(x, 3, 2, value=float("-inf")), 3, stride=2)


class _Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, num_groups: int):
        super().__init__()
        self.conv = WSConv2d(cin, cout, 1, stride=stride)
        self.norm = _GroupNorm(num_groups, cout, eps=1e-5)

    def forward(self, x):
        return self.norm(self.conv(x))


class BitBottleneck(nn.Module):
    """Non-preactivation ResNetV2 bottleneck: conv1x1-GN-relu,
    conv3x3-GN-relu, conv1x1-GN, plus the (downsampled) shortcut, relu."""

    def __init__(self, cin: int, cout: int, mid: int, stride: int, has_down: bool,
                 num_groups: int):
        super().__init__()
        if has_down:
            self.downsample = _Downsample(cin, cout, stride, num_groups)
        self.conv1 = WSConv2d(cin, mid, 1)
        self.norm1 = _GroupNorm(num_groups, mid, eps=1e-5)
        self.conv2 = WSConv2d(mid, mid, 3, stride=stride)
        self.norm2 = _GroupNorm(num_groups, mid, eps=1e-5)
        self.conv3 = WSConv2d(mid, cout, 1)
        self.norm3 = _GroupNorm(num_groups, cout, eps=1e-5)

    def forward(self, x):
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


def _make_div(v: float, divisor: int = 8) -> int:
    out = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return out + divisor if out < 0.9 * v else out


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class _Backbone(nn.Module):
    def __init__(self, width, hidden, depths, num_groups):
        super().__init__()
        self.stem = _Stem(width, num_groups)
        stages, cin = [], width
        for s, (ch, depth) in enumerate(zip(hidden, depths)):
            stride = 1 if s == 0 else 2
            stages.append(_Stage([BitBottleneck(cin if i == 0 else ch, ch, _make_div(ch * 0.25),
                                                stride if i == 0 else 1, i == 0, num_groups)
                                  for i in range(depth)]))
            cin = ch
        self.stages = nn.ModuleList(stages)


class _PatchEmbed(nn.Module):
    def __init__(self, backbone: _Backbone, hidden_size: int):
        super().__init__()
        self.backbone = backbone
        self.proj = nn.Conv2d(backbone.stages[-1].blocks[-1].conv3.out_channels,
                              hidden_size, 1)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        n, l, d = x.shape
        q, k, v = self.qkv(x).view(n, l, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d // self.heads)
        p = torch.softmax(s.float(), dim=-1).to(x.dtype)
        return self.proj(torch.matmul(p, v).transpose(1, 2).reshape(n, l, d))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-LN ViT block, fused qkv (the MiDaS/timm layout)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, ln_eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = _Mlp(dim, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _ViT(nn.Module):
    def __init__(self, backbone, hidden_size, num_layers, num_heads, mlp_dim, pos_grid, ln_eps):
        super().__init__()
        self.patch_embed = _PatchEmbed(backbone, hidden_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, hidden_size))
        self.blocks = nn.ModuleList(ViTBlock(hidden_size, num_heads, mlp_dim, ln_eps)
                                    for _ in range(num_layers))


class _ProjectReadout(nn.Module):
    """Concatenate every grid token with the cls token, Linear, exact GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        cls, grid = tokens[:, :1], tokens[:, 1:]
        return self.project(torch.cat([grid, cls.expand_as(grid)], dim=-1))


class _Pretrained(nn.Module):
    """The ViT and the reassemble stages of taps 3 and 4 (indices 1 and 2
    of MiDaS's Sequentials are parameter-free reshapes)."""

    def __init__(self, vit: _ViT, d: int):
        super().__init__()
        self.model = vit
        self.act_postprocess3 = nn.Sequential(_ProjectReadout(d), nn.Identity(), nn.Identity(),
                                              nn.Conv2d(d, d, 1))
        self.act_postprocess4 = nn.Sequential(_ProjectReadout(d), nn.Identity(), nn.Identity(),
                                              nn.Conv2d(d, d, 1),
                                              nn.Conv2d(d, d, 3, stride=2, padding=1))


class ResidualConvUnit(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion: + residual unit of the lateral, residual unit,
    2x bilinear upsample (align_corners=True), 1x1 conv.  The deepest block
    has no lateral and so no ``resConfUnit1``."""

    def __init__(self, ch: int, lateral: bool = True):
        super().__init__()
        if lateral:
            self.resConfUnit1 = ResidualConvUnit(ch)
        self.resConfUnit2 = ResidualConvUnit(ch)
        self.out_conv = nn.Conv2d(ch, ch, 1)

    def forward(self, x, lateral=None):
        if lateral is not None:
            x = x + self.resConfUnit1(_resize(lateral, x.shape[2:], align_corners=False))
        x = self.resConfUnit2(x)
        x = _resize(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True)
        return self.out_conv(x)


class _Upsample2x(nn.Module):
    def forward(self, x):
        return _resize(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True)


class _Scratch(nn.Module):
    def __init__(self, in_chans: Sequence[int], fusion_hidden: int):
        super().__init__()
        for i, c in enumerate(in_chans, start=1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(c, fusion_hidden, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(fusion_hidden, lateral=i != 4))
        self.output_conv = nn.Sequential(
            nn.Conv2d(fusion_hidden, fusion_hidden // 2, 3, padding=1), _Upsample2x(),
            nn.Conv2d(fusion_hidden // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())


class DPTHybrid(nn.Module):
    """DPT-Hybrid (MiDaS dpt_hybrid).  Sizes default to the production
    model; every one is overridable, so tests run a tiny replica."""

    def __init__(self, embedding_size: int = 64, bit_hidden: Sequence[int] = (256, 512, 1024),
                 bit_depths: Sequence[int] = (3, 4, 9), num_groups: int = 32,
                 hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, vit_taps: Sequence[int] = (8, 11),
                 fusion_hidden: int = 256, pos_grid: int = 24, ln_eps: float = 1e-12):
        super().__init__()
        self.vit_taps, self.pos_grid, self.hidden_size = tuple(vit_taps), pos_grid, hidden_size
        backbone = _Backbone(embedding_size, bit_hidden, bit_depths, num_groups)
        self.pretrained = _Pretrained(
            _ViT(backbone, hidden_size, num_layers, num_heads, mlp_dim, pos_grid, ln_eps),
            hidden_size)
        self.scratch = _Scratch((bit_hidden[0], bit_hidden[1], hidden_size, hidden_size),
                                fusion_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        if h % 32 or w % 32:
            raise ValueError(f"DPT-Hybrid needs H and W divisible by 32, got {h}x{w}")
        vit = self.pretrained.model
        bb = vit.patch_embed.backbone
        dtype = vit.cls_token.dtype
        x = x.to(dtype).permute(0, 3, 1, 2)
        feats = []
        x = bb.stem(x)
        for stage in bb.stages:
            x = stage(x)
            feats.append(x)
        s1, s2, s3 = feats[0], feats[1], feats[-1]

        gh, gw = s3.shape[2], s3.shape[3]
        tokens = vit.patch_embed.proj(s3).flatten(2).transpose(1, 2)  # (N, gh*gw, D)
        pos = vit.pos_embed
        grid = pos[:, 1:].reshape(1, self.pos_grid, self.pos_grid, -1).permute(0, 3, 1, 2)
        grid = _resize(grid, (gh, gw), align_corners=False).flatten(2).transpose(1, 2)
        tokens = torch.cat([vit.cls_token.expand(n, -1, -1), tokens], dim=1)
        tokens = tokens + torch.cat([pos[:, :1], grid], dim=1)
        taps = []
        for i, blk in enumerate(vit.blocks):
            tokens = blk(tokens)
            if i in self.vit_taps:
                taps.append(tokens)
        t3, t4 = taps  # no final LayerNorm on the taps

        def reassemble(post, tok):
            grid_tok = post[0](tok)  # (N, gh*gw, D)
            return grid_tok.transpose(1, 2).reshape(n, self.hidden_size, gh, gw)

        post3, post4 = self.pretrained.act_postprocess3, self.pretrained.act_postprocess4
        l3 = post3[3](reassemble(post3, t3))
        l4 = post4[4](post4[3](reassemble(post4, t4)))
        sc = self.scratch
        rn = [sc.layer1_rn(s1), sc.layer2_rn(s2), sc.layer3_rn(l3), sc.layer4_rn(l4)]
        f = sc.refinenet4(rn[3])
        f = sc.refinenet3(f, rn[2])
        f = sc.refinenet2(f, rn[1])
        f = sc.refinenet1(f, rn[0])
        return sc.output_conv(f)[:, 0]


def detect_depth_midas(model: DPTHybrid, frames: torch.Tensor) -> torch.Tensor:
    """frames (N, H, W, 3) in [-1, 1] -> relative inverse depth (N, H, W)."""
    return model(frames)


# MiDaS checkpoint entries the network does not compute with: timm's ViT
# final norm and classifier head, and the deepest fusion block's lateral unit
_UNUSED = ("pretrained.model.norm.", "pretrained.model.head.",
           "scratch.refinenet4.resConfUnit1.")


def hf_to_midas_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ``Intel/dpt-hybrid-midas`` DPTForDepthEstimation state dict in
    the official MiDaS naming, q/k/v fused into qkv (``_hf_to_midas_names``)."""
    out: Dict[str, torch.Tensor] = {}
    pre = "pretrained.model."
    layers = sorted({int(k.split(".")[3]) for k in sd if k.startswith("dpt.encoder.layer.")})
    for i in layers:
        base = f"dpt.encoder.layer.{i}."
        for suff in ("weight", "bias"):
            out[f"{pre}blocks.{i}.attn.qkv.{suff}"] = torch.cat(
                [sd[f"{base}attention.attention.{n}.{suff}"] for n in ("query", "key", "value")])
        for src, dst in (("layernorm_before", "norm1"), ("layernorm_after", "norm2"),
                         ("attention.output.dense", "attn.proj"),
                         ("intermediate.dense", "mlp.fc1"), ("output.dense", "mlp.fc2")):
            for suff in ("weight", "bias"):
                out[f"{pre}blocks.{i}.{dst}.{suff}"] = sd[f"{base}{src}.{suff}"]
    direct = {"dpt.embeddings.cls_token": pre + "cls_token",
              "dpt.embeddings.position_embeddings": pre + "pos_embed",
              "dpt.embeddings.projection.weight": pre + "patch_embed.proj.weight",
              "dpt.embeddings.projection.bias": pre + "patch_embed.proj.bias"}
    for k, v in sd.items():
        if k in direct:
            out[direct[k]] = v
        elif k.startswith("dpt.embeddings.backbone.bit.embedder."):
            tail = k.split("embedder.")[1].replace("convolution.", "conv.")
            out[pre + "patch_embed.backbone.stem." + tail] = v
        elif k.startswith("dpt.embeddings.backbone.bit.encoder.stages."):
            parts = k.split("encoder.stages.")[1].split(".")  # s, layers, i, tail...
            tail = ".".join(parts[3:]).replace("convolution.", "conv.")
            out[f"{pre}patch_embed.backbone.stages.{parts[0]}.blocks.{parts[2]}.{tail}"] = v
        elif k.startswith("neck.reassemble_stage.readout_projects."):
            idx = int(k.split(".")[3])
            out[f"pretrained.act_postprocess{idx + 1}.0.project.0.{k.split('.')[-1]}"] = v
        elif k.startswith("neck.reassemble_stage.layers."):
            idx, suff = int(k.split(".")[3]), k.split(".")[-1]
            if ".projection." in k:
                out[f"pretrained.act_postprocess{idx + 1}.3.{suff}"] = v
            elif ".resize." in k:
                out[f"pretrained.act_postprocess{idx + 1}.4.{suff}"] = v
        elif k.startswith("neck.convs."):
            out[f"scratch.layer{int(k.split('.')[2]) + 1}_rn.weight"] = v
        elif k.startswith("neck.fusion_stage.layers."):
            idx = int(k.split(".")[3])  # 0..3 = refinenet4..1
            tail = (k.split(f"layers.{idx}.")[1].replace("residual_layer", "resConfUnit")
                    .replace("convolution", "conv").replace("projection", "out_conv"))
            out[f"scratch.refinenet{4 - idx}.{tail}"] = v
        elif k.startswith("head.head."):
            out["scratch.output_conv." + k[len("head.head."):]] = v
    return out


def load_dpt_checkpoint(model: DPTHybrid, sd: Dict[str, torch.Tensor]) -> None:
    """Strict load of a MiDaS ``dpt_hybrid`` checkpoint (bare, wrapped under
    ``model.`` as MiDaSInference saves it, or in the HF naming), minus the
    entries the network does not use."""
    if any(k.startswith("dpt.") for k in sd):
        sd = hf_to_midas_names(sd)
    if not any(k.startswith("pretrained.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    model.load_state_dict({k: v for k, v in sd.items() if not k.startswith(_UNUSED)},
                          strict=True)
