"""NormalBAE surface normals (port of ``ccedit_tpu/conditioning/annotators/
normalbae.py``): the NNET of ``scannet.pt``, ``model.``-prefixed geffnet
``tf_efficientnet_b5`` encoder keys (``encoder.original_model.*``) and the
decoder's (``decoder.*``), so the checkpoint loads without a converter.

Encoder: a stride-2 stem, seven stages of MBConv blocks (depthwise conv,
squeeze-excite at a quarter of the block's input width, swish,
inference BatchNorm at eps 1e-3, TF-SAME padding), the skip taps of
stages 0, 1, 2 and 4 and the conv head before its BatchNorm.  Decoder:
``UpSampleBN`` blocks (bilinear ``align_corners=True`` to the skip,
concatenate, two conv + BN + leaky ReLU) down to a 1/8 prediction of
(normal xyz, kappa), then three point refinements at 1/4, 1/2 and 1/1:
the previous prediction upsampled and re-normalised, the
``int(n * 0.4 * 0.7)`` pixels of lowest kappa (ties to the lower index,
as ``lax.top_k`` orders them) re-predicted by a per-point MLP and
scattered back.  The JAX package uses eps 1e-3 in the decoder's BatchNorms
too; the port keeps it.  ``normalbae_from_state_dict`` sizes the network to
the file (stage widths, repeats, kernels and expansions from the weights;
strides from B5's stage table).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .dpt_midas import _pad_same

# tf_efficientnet_b5 stage spec: (out_ch, repeats, kernel, stride, expand)
B5_STAGES = ((24, 3, 3, 1, 1), (40, 5, 3, 2, 6), (64, 5, 5, 2, 6), (128, 7, 3, 2, 6),
             (176, 7, 5, 1, 6), (304, 9, 5, 2, 6), (512, 3, 3, 1, 6))
B5_STEM, B5_HEAD = 48, 2048
UP_DIMS = (1024, 512, 256, 128)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class BN(nn.BatchNorm2d):
    """BatchNorm on its running statistics in every mode (eps 1e-3)."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-3)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class ConvSame(nn.Conv2d):
    """A conv with TF-SAME padding."""

    def forward(self, x):
        return F.conv2d(_pad_same(x, self.kernel_size[0], self.stride[0]), self.weight,
                        self.bias, self.stride, 0, self.dilation, self.groups)


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(ch, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, ch, 1)

    def forward(self, x):
        s = self.conv_expand(F.silu(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """geffnet's InvertedResidual (expand > 1) or DepthwiseSeparableConv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, expand: int):
        super().__init__()
        self.expand = expand
        self.skip = stride == 1 and cin == cout
        mid = cin * expand
        if expand != 1:
            self.conv_pw = ConvSame(cin, mid, 1, bias=False)
            self.bn1 = BN(mid)
            self.conv_dw = ConvSame(mid, mid, k, stride, groups=mid, bias=False)
            self.bn2 = BN(mid)
            self.se = SqueezeExcite(mid, max(1, cin // 4))
            self.conv_pwl = ConvSame(mid, cout, 1, bias=False)
            self.bn3 = BN(cout)
        else:
            self.conv_dw = ConvSame(mid, mid, k, stride, groups=mid, bias=False)
            self.bn1 = BN(mid)
            self.se = SqueezeExcite(mid, max(1, cin // 4))
            self.conv_pw = ConvSame(mid, cout, 1, bias=False)
            self.bn2 = BN(cout)

    def forward(self, x):
        inp = x
        if self.expand != 1:
            x = F.silu(self.bn1(self.conv_pw(x)))
            x = self.se(F.silu(self.bn2(self.conv_dw(x))))
            x = self.bn3(self.conv_pwl(x))
        else:
            x = self.se(F.silu(self.bn1(self.conv_dw(x))))
            x = self.bn2(self.conv_pw(x))
        return x + inp if self.skip else x


class EfficientNet(nn.Module):
    def __init__(self, stem: int, head: int, stages: Sequence[Tuple[int, int, int, int, int]]):
        super().__init__()
        self.conv_stem = ConvSame(3, stem, 3, 2, bias=False)
        self.bn1 = BN(stem)
        blocks, cin = [], stem
        for out_ch, reps, k, s, e in stages:
            stage = []
            for r in range(reps):
                stage.append(MBConv(cin, out_ch, k, s if r == 0 else 1, e))
                cin = out_ch
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*blocks)
        self.conv_head = ConvSame(cin, head, 1, bias=False)

    def forward(self, x) -> List[torch.Tensor]:
        x = F.silu(self.bn1(self.conv_stem(x)))
        taps = []
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si in (0, 1, 2, 4):
                taps.append(x)
        taps.append(self.conv_head(x))  # before the head's BatchNorm (NNET's tap)
        return taps


class _Encoder(nn.Module):
    def __init__(self, stem, head, stages):
        super().__init__()
        self.original_model = EfficientNet(stem, head, stages)


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class UpSampleBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self._net = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), BN(cout),
                                  nn.LeakyReLU(0.01), nn.Conv2d(cout, cout, 3, padding=1),
                                  BN(cout), nn.LeakyReLU(0.01))

    def forward(self, x, skip):
        return self._net(torch.cat([_resize(x, skip.shape[2:]), skip], dim=1))


def norm_normalize(out: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Unit xyz, kappa -> elu(kappa) + 1.01 (channels on ``dim``)."""
    xyz, kappa = out.narrow(dim, 0, 3), out.narrow(dim, 3, 1)
    norm = torch.sqrt((xyz * xyz).sum(dim=dim, keepdim=True) + 1e-10)
    return torch.cat([xyz / norm, F.elu(kappa) + 1.0 + 0.01], dim=dim)


def _mlp(cin: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(cin, 128, 1), nn.ReLU(), nn.Conv1d(128, 128, 1), nn.ReLU(),
                         nn.Conv1d(128, 128, 1), nn.ReLU(), nn.Conv1d(128, 4, 1))


class _Decoder(nn.Module):
    def __init__(self, head: int, skips: Sequence[int], up_dims: Sequence[int]):
        super().__init__()
        s0, s1, s2, s4 = skips
        self.conv2 = nn.Conv2d(head, head, 1)
        self.up1 = UpSampleBN(head + s4, up_dims[0])
        self.up2 = UpSampleBN(up_dims[0] + s2, up_dims[1])
        self.up3 = UpSampleBN(up_dims[1] + s1, up_dims[2])
        self.up4 = UpSampleBN(up_dims[2] + s0, up_dims[3])
        self.out_conv_res8 = nn.Conv2d(up_dims[1], 4, 3, padding=1)
        self.out_conv_res4 = _mlp(up_dims[2] + 4)
        self.out_conv_res2 = _mlp(up_dims[3] + 4)
        self.out_conv_res1 = _mlp(up_dims[3] + 4)


class NNET(nn.Module):
    """(B, 3, H, W) ImageNet-normalised, H and W multiples of 32 ->
    [res8, res4, res2, res1] predictions (B, 4, h, w).  The network stays
    in fp32 when its owner is cast (``.to(dtype)``, ``.bfloat16()``), as the
    JAX package keeps it: the refinements pick pixels by kappa order, which
    bf16 rounding reshuffles.  Device moves still apply."""

    def _apply(self, fn, recurse=True):
        def keep_dtype(t):
            out = fn(t)
            return out if out.dtype == t.dtype else t.to(out.device)

        return super()._apply(keep_dtype, recurse)

    def __init__(self, stem: int = B5_STEM, head: int = B5_HEAD,
                 stages: Sequence[Tuple[int, int, int, int, int]] = B5_STAGES,
                 up_dims: Sequence[int] = UP_DIMS, sampling_ratio: float = 0.4,
                 importance_ratio: float = 0.7):
        super().__init__()
        self.sampling_ratio, self.importance_ratio = sampling_ratio, importance_ratio
        self.encoder = _Encoder(stem, head, stages)
        skips = [stages[i][0] for i in (0, 1, 2, 4)]
        self.decoder = _Decoder(head, skips, up_dims)

    def forward(self, x) -> List[torch.Tensor]:
        s0, s1, s2, s4, head = self.encoder.original_model(x)
        d = self.decoder
        x_d2 = d.up2(d.up1(d.conv2(head), s4), s2)
        prev = norm_normalize(d.out_conv_res8(x_d2))
        outs = [prev]
        f4 = d.up3(x_d2, s1)
        f2 = d.up4(f4, s0)
        for stage, feat in (("res4", f4), ("res2", f2), ("res1", f2)):
            b, fc, fh, fw = feat.shape
            if stage == "res1":
                fh, fw = fh * 2, fw * 2
                feat = _resize(feat, (fh, fw))
            init = norm_normalize(_resize(prev, (fh, fw)))
            n_pix = fh * fw
            k = max(1, int(n_pix * self.sampling_ratio * self.importance_ratio))
            kappa = init[:, 3].reshape(b, n_pix)
            idx = torch.sort(-kappa, dim=1, descending=True, stable=True).indices[:, :k]
            flat = torch.cat([feat, init], dim=1).reshape(b, fc + 4, n_pix)
            sampled = flat.gather(2, idx[:, None].expand(b, fc + 4, k))
            pred = norm_normalize(getattr(d, f"out_conv_{stage}")(sampled))
            init = init.reshape(b, 4, n_pix).scatter(
                2, idx[:, None].expand(b, 4, k), pred).reshape(b, 4, fh, fw)
            prev = init
            outs.append(prev)
        return outs


def _stages_of(sd: Dict[str, torch.Tensor]) -> List[Tuple[int, int, int, int, int]]:
    enc = "encoder.original_model.blocks."
    reps: Dict[int, int] = {}
    for k in sd:
        m = re.match(re.escape(enc) + r"(\d+)\.(\d+)\.", k)
        if m:
            si, r = int(m.group(1)), int(m.group(2))
            reps[si] = max(reps.get(si, 0), r + 1)
    stages = []
    for si in range(len(reps)):
        src = f"{enc}{si}.0"
        dw = sd[f"{src}.conv_dw.weight"]
        if f"{src}.conv_pwl.weight" in sd:
            pw = sd[f"{src}.conv_pw.weight"]
            out_ch, expand = sd[f"{src}.conv_pwl.weight"].shape[0], pw.shape[0] // pw.shape[1]
        else:
            out_ch, expand = sd[f"{src}.conv_pw.weight"].shape[0], 1
        stages.append((out_ch, reps[si], dw.shape[-1], B5_STAGES[si][3], expand))
    return stages


def normalbae_from_state_dict(sd: Dict[str, torch.Tensor]) -> NNET:
    """``scannet.pt`` (a ``{"model": state_dict}`` file, its flat
    ``model.``-prefixed keys, or bare keys) as an ``NNET`` sized to it.  The encoder's
    unused entries (the head's BatchNorm, a classifier) are not read."""
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    sd = {(k[len("model."):] if k.startswith("model.") else k): v.float() for k, v in sd.items()}
    stages = _stages_of(sd)
    enc = "encoder.original_model."
    up_dims = tuple(sd[f"decoder.up{i}._net.0.weight"].shape[0] for i in range(1, 5))
    model = NNET(stem=sd[f"{enc}conv_stem.weight"].shape[0],
                 head=sd[f"{enc}conv_head.weight"].shape[0], stages=stages, up_dims=up_dims)
    wanted = model.state_dict()
    missing = [k for k in wanted if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"scannet.pt lacks {missing[:5]}")
    model.load_state_dict({k: v for k, v in sd.items() if k in wanted}, strict=False)
    return model.eval()


def detect_normalbae(model: NNET, frames01: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [0, 1] -> normals (N, H, W, 3) in [-1, 1], negated
    and clamped as the reference maps them; fp32."""
    dtype = next(model.parameters()).dtype
    mean = torch.tensor(IMAGENET_MEAN, device=frames01.device)
    std = torch.tensor(IMAGENET_STD, device=frames01.device)
    x = ((frames01.float() - mean) / std).permute(0, 3, 1, 2)
    n, _, h, w = x.shape
    ph, pw = (-h) % 32, (-w) % 32
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    out = model(x.to(dtype))[-1].float()
    return (-out[:, :3, :h, :w]).clamp(-1.0, 1.0).permute(0, 2, 3, 1)
