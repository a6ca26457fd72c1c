"""The learned lineart detector (port of ``ccedit_tpu/conditioning/
annotators/lineart_model.py``): informative-drawings' ``Generator(3, 1, 3)``
of ControlNet-1.1's ``LineartDetector``, in the layout of ``sk_model.pth``
(``model0`` .. ``model4`` Sequentials), so the checkpoint loads as it is.

Reflection padding, ``InstanceNorm2d`` without affine parameters, two
stride-2 convs down, residual blocks, two ``ConvTranspose2d`` (k 3, s 2, p 1,
output_padding 1) up, a 7x7 conv and the sigmoid.  The detector maps frames
in [-1, 1] to [0, 1], runs the network and maps its output back to [-1, 1].
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class ResidualBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(ch, ch, 3), nn.InstanceNorm2d(ch), nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(ch, ch, 3), nn.InstanceNorm2d(ch))

    def forward(self, x):
        return x + self.conv_block(x)


class LineartGenerator(nn.Module):
    """(N, 3, H, W) in [0, 1] -> (N, 1, H, W) line map in [0, 1]."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1, n_residual_blocks: int = 3):
        super().__init__()
        self.model0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(in_ch, 64, 7),
                                    nn.InstanceNorm2d(64), nn.ReLU())
        self.model1 = nn.Sequential(
            nn.Conv2d(64, 128, 3, stride=2, padding=1), nn.InstanceNorm2d(128), nn.ReLU(),
            nn.Conv2d(128, 256, 3, stride=2, padding=1), nn.InstanceNorm2d(256), nn.ReLU())
        self.model2 = nn.Sequential(*[ResidualBlock(256) for _ in range(n_residual_blocks)])
        self.model3 = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 3, stride=2, padding=1, output_padding=1),
            nn.InstanceNorm2d(128), nn.ReLU(),
            nn.ConvTranspose2d(128, 64, 3, stride=2, padding=1, output_padding=1),
            nn.InstanceNorm2d(64), nn.ReLU())
        self.model4 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(64, out_ch, 7), nn.Sigmoid())

    def forward(self, x):
        return self.model4(self.model3(self.model2(self.model1(self.model0(x)))))


def lineart_from_state_dict(sd: Dict[str, torch.Tensor]) -> LineartGenerator:
    """A ``LineartGenerator`` sized to ``sk_model.pth`` (its residual
    blocks counted), its weights loaded strictly."""
    n_res = len({k.split(".")[1] for k in sd if k.startswith("model2.")})
    model = LineartGenerator(n_residual_blocks=n_res)
    model.load_state_dict({k: v.float() for k, v in sd.items()})
    return model.eval()


def detect_lineart(model: LineartGenerator, frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [-1, 1] -> (N, H, W, 1) line map in [-1, 1], fp32."""
    dtype = next(model.parameters()).dtype
    x = ((frames + 1.0) / 2.0).permute(0, 3, 1, 2).to(dtype)
    line = model(x).float().permute(0, 2, 3, 1)
    return (line * 2.0 - 1.0).clamp(-1.0, 1.0)
