"""PiDiNet soft edges (port of ``ccedit_tpu/conditioning/annotators/
pidinet.py``): ``table5_pidinet`` = PiDiNet(60, carv4, dil=24, sa=True).

The pixel-difference convolutions are linear in their weights, so
``pidinet_from_state_dict`` folds each into a plain kernel when it loads
``table5_pidinet.pth`` (``convert_pdc_weight``): central difference
subtracts the kernel's sum at its centre, angular difference subtracts the
clockwise-rotated kernel, radial difference scatters the 3x3 ring into a
5x5 kernel (outer ring +, inner ring -, padding 2).  The network is then
plain convs: four stages of depthwise PDC blocks, per stage a CDCM
(1x1, then four dilated 3x3 summed), a CSAM gate and a 1x1 reduction to
one map, bilinearly upsampled (``align_corners=False``) to the input size,
and a 1x1 classifier over the four maps.  Every output passes a sigmoid;
the edge is the classifier's.  Input: (N, H, W, 3) BGR in [0, 1].
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CARV4 = ("cd", "ad", "rd", "cv") * 4
# clockwise rotation of a flattened 3x3 kernel (the 'ad' op)
_AD_ROT = [3, 0, 1, 6, 4, 2, 7, 8, 5]
# 5x5 flat positions of the outer ring / the inner ring (3x3 minus centre)
_RD_OUTER = [0, 2, 4, 10, 14, 20, 22, 24]
_RD_INNER = [6, 7, 8, 11, 13, 16, 17, 18]
BLOCKS = (["block1_1", "block1_2", "block1_3"] + [f"block{s}_{i}" for s in (2, 3, 4)
                                                  for i in range(1, 5)])


def convert_pdc_weight(op: str, w: torch.Tensor) -> torch.Tensor:
    """A PDC op's (O, I, 3, 3) weight as a plain conv kernel: (O, I, 3, 3)
    for cd/ad/cv, (O, I, 5, 5) for rd."""
    w = w.float()
    o, i = w.shape[:2]
    flat = w.reshape(o, i, 9)
    if op == "cv":
        return w
    if op == "cd":
        out = flat.clone()
        out[:, :, 4] -= w.sum(dim=(2, 3))
        return out.reshape(o, i, 3, 3)
    if op == "ad":
        return (flat - flat[:, :, _AD_ROT]).reshape(o, i, 3, 3)
    if op == "rd":
        buf = w.new_zeros(o, i, 25)
        buf[:, :, _RD_OUTER] = flat[:, :, 1:]
        buf[:, :, _RD_INNER] = -flat[:, :, 1:]
        return buf.reshape(o, i, 5, 5)
    raise ValueError(f"unknown pdc op {op!r}")


class PDCBlock(nn.Module):
    """Depthwise folded-PDC conv -> relu -> 1x1, residual; at stride 2 the
    input is max-pooled first and the shortcut is a 1x1 conv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cin, k, padding=k // 2, groups=cin, bias=False)
        self.conv2 = nn.Conv2d(cin, cout, 1, bias=False)
        if stride > 1:
            self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        if self.stride > 1:
            x = F.max_pool2d(x, 2, 2)
        y = self.conv2(F.relu(self.conv1(x)))
        if self.stride > 1:
            x = self.shortcut(x)
        return y + x


class CDCM(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1)
        for i, d in enumerate((5, 7, 9, 11)):
            setattr(self, f"conv2_{i + 1}", nn.Conv2d(cout, cout, 3, padding=d, dilation=d,
                                                      bias=False))

    def forward(self, x):
        x = self.conv1(F.relu(x))
        return sum(getattr(self, f"conv2_{i}")(x) for i in range(1, 5))


class CSAM(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, 4, 1)
        self.conv2 = nn.Conv2d(4, 1, 3, padding=1, bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.conv2(self.conv1(F.relu(x))))


class MapReduce(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, 1, 1)

    def forward(self, x):
        return self.conv(x)


class PiDiNet(nn.Module):
    """(N, 3, H, W) BGR in [0, 1] -> the four stage maps and the fused map,
    each through its sigmoid, (N, 1, H, W)."""

    def __init__(self, inplane: int = 60, dil: int = 24, pdcs: Sequence[str] = CARV4):
        super().__init__()
        self.pdcs = tuple(pdcs)

        def k(i):
            return 5 if self.pdcs[i] == "rd" else 3

        self.init_block = nn.Conv2d(3, inplane, k(0), padding=k(0) // 2, bias=False)
        c = inplane
        widths = [c] * 3 + [2 * c] * 4 + [4 * c] * 8
        cin = c
        for idx, (name, cout) in enumerate(zip(BLOCKS, widths)):
            stride = 2 if name.endswith("_1") and name != "block1_1" else 1
            setattr(self, name, PDCBlock(cin, cout, k(idx + 1), stride=stride))
            cin = cout
        chans = (c, 2 * c, 4 * c, 4 * c)
        self.dilations = nn.ModuleList(CDCM(ch, dil) for ch in chans)
        self.attentions = nn.ModuleList(CSAM(dil) for _ in chans)
        self.conv_reduces = nn.ModuleList(MapReduce(dil) for _ in chans)
        self.classifier = nn.Conv2d(4, 1, 1)

    def forward(self, x) -> List[torch.Tensor]:
        h, w = x.shape[2:]
        x = self.init_block(x)
        stages, names = [], iter(BLOCKS)
        for n_blocks in (3, 4, 4, 4):
            for _ in range(n_blocks):
                x = getattr(self, next(names))(x)
            stages.append(x)
        edges = []
        for i, xi in enumerate(stages):
            e = self.conv_reduces[i](self.attentions[i](self.dilations[i](xi)))
            edges.append(F.interpolate(e, size=(h, w), mode="bilinear", align_corners=False))
        fused = self.classifier(torch.cat(edges, dim=1))
        return [torch.sigmoid(e) for e in edges] + [torch.sigmoid(fused)]


def pidinet_from_state_dict(sd: Dict[str, torch.Tensor]) -> PiDiNet:
    """``table5_pidinet.pth`` (its ``state_dict``, ``module.`` prefixes
    dropped) as a ``PiDiNet`` with every PDC weight folded."""
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    sd = {k.replace("module.", ""): v.float() for k, v in sd.items()}
    model = PiDiNet(inplane=sd["init_block.weight"].shape[0],
                    dil=sd["dilations.0.conv1.weight"].shape[0])
    for i, name in enumerate(["init_block"] + [f"{b}.conv1" for b in BLOCKS]):
        key = f"{name}.weight"
        sd[key] = convert_pdc_weight(CARV4[i], sd[key])
    model.load_state_dict(sd)
    return model.eval()


def detect_pidinet(model: PiDiNet, frames_bgr01: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) BGR in [0, 1] -> the fused edge (N, H, W, 1) in [0, 1],
    fp32."""
    dtype = next(model.parameters()).dtype
    edge = model(frames_bgr01.permute(0, 3, 1, 2).to(dtype))[-1]
    return edge.float().permute(0, 2, 3, 1)


def safe_step(x: torch.Tensor, step: int = 2) -> torch.Tensor:
    """Quantise to ``step`` levels (ControlNet-1.1's ``safe_step``)."""
    return torch.floor(x.float() * float(step + 1)) / float(step)
