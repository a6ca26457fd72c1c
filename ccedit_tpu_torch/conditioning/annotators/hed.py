"""The HED soft-edge detector (port of ``ccedit_tpu/conditioning/annotators/
hed.py``): ControlNet-1.1's ``ControlNetHED_Apache2`` in its own key layout
(``norm``, ``block{i}.convs.{j}``, ``block{i}.projection``; a
``netNetwork.`` prefix is dropped), so ``ControlNetHED.pth`` loads as it
is.

Five VGG-style blocks, each emitting a 1-channel projection at its scale;
the input, in 0..255, is shifted by the learned ``norm``.  The fused edge
(``detect_hed``) is ControlNet-1.1's: every projection bilinearly upsampled
(half-pixel centres) to the input size, their MEAN, THEN the sigmoid.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

_BLOCKS = ((3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3))


class DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int):
        super().__init__()
        self.convs = nn.Sequential(*[nn.Conv2d(cin if i == 0 else cout, cout, 3, padding=1)
                                     for i in range(layers)])
        self.projection = nn.Conv2d(cout, 1, 1)

    def forward(self, x, down_sampling: bool = False):
        if down_sampling:
            x = F.max_pool2d(x, 2, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return x, self.projection(x)


class ControlNetHED(nn.Module):
    """(N, 3, H, W) in 0..255 -> the five projections."""

    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        for i, (cin, cout, layers) in enumerate(_BLOCKS):
            setattr(self, f"block{i + 1}", DoubleConvBlock(cin, cout, layers))

    def forward(self, x) -> List[torch.Tensor]:
        h = x - self.norm
        projs = []
        for i in range(len(_BLOCKS)):
            h, p = getattr(self, f"block{i + 1}")(h, down_sampling=i > 0)
            projs.append(p)
        return projs


def hed_from_state_dict(sd: Dict[str, torch.Tensor]) -> ControlNetHED:
    if any(k.startswith("netNetwork.") for k in sd):
        sd = {k[len("netNetwork."):]: v for k, v in sd.items() if k.startswith("netNetwork.")}
    model = ControlNetHED()
    model.load_state_dict({k: v.float() for k, v in sd.items()})
    return model.eval()


def detect_hed(model: ControlNetHED, frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> (N, H, W, 1) soft edge in [0, 1], fp32."""
    dtype = next(model.parameters()).dtype
    n, h, w, _ = frames.shape
    x = ((frames + 1.0) * 127.5).permute(0, 3, 1, 2).to(dtype)
    ups = []
    for p in model(x):
        p = p.float()
        if p.shape[2:] != (h, w):
            p = F.interpolate(p, size=(h, w), mode="bilinear", align_corners=False)
        ups.append(p)
    return torch.sigmoid(torch.stack(ups).mean(dim=0)).permute(0, 2, 3, 1)
