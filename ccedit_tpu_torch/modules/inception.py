"""InceptionV3, the FID feature extractor (port of
``ccedit_tpu/modules/inception.py``), in ``pytorch_fid``'s key layout.

torchvision's InceptionV3 with the FID quirks of ``pytorch_fid.inception``
(the reference's ``InceptionV3`` wrapper): the pool branches of the
InceptionA and InceptionC blocks and of the first InceptionE (Mixed_7b)
average with ``count_include_pad=False``; the second InceptionE (Mixed_7c)
max-pools; every ``BasicConv2d`` is a bias-free conv, BatchNorm with its
running statistics and eps 1e-3, and ReLU.  Input (B, H, W, 3) as the JAX
module takes it, optionally resized to 299 (``jax.image.resize``'s
bilinear, antialiased when shrinking) and mapped from [0, 1] to [-1, 1];
the taps after maxpool1 (64 channels), maxpool2 (192), Mixed_6e (768) come
out (B, H, W, C), the final average pool (2048) as (B, 2048).
``load_inception`` reads a ``pytorch_fid``/torchvision state dict (the
blocks' keys; ``fc`` and ``AuxLogits`` are not read).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..conditioning.embedders import antialiased_resize_matrix


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def avg_pool_nocount(x):
    """3x3 stride-1 average pool, ``count_include_pad=False``."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(avg_pool_nocount(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(avg_pool_nocount(x))],
                         dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool_mode`` "avg" (Mixed_7b) or "max" (FID's Mixed_7c)."""

    def __init__(self, cin: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool_mode == "max"
              else avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
    """The FID feature extractor; ``output_blocks`` picks the taps (3: the
    2048-d pool, the reference wrapper's)."""

    def __init__(self, output_blocks: Sequence[int] = (3,), resize_input: bool = True,
                 normalize_input: bool = False):
        super().__init__()
        self.output_blocks = tuple(sorted(set(output_blocks)))
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool_mode="max")

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) -> the taps of ``output_blocks``."""
        x = x.to(self.Conv2d_1a_3x3.conv.weight.dtype)
        if self.resize_input:
            my = torch.from_numpy(antialiased_resize_matrix(x.shape[1], 299, "linear"))
            mx = torch.from_numpy(antialiased_resize_matrix(x.shape[2], 299, "linear"))
            x = torch.einsum("ah,bhwc,dw->badc", my.to(x), x, mx.to(x))
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = x.permute(0, 3, 1, 2)
        outs: Dict[int, torch.Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        outs[0] = x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        outs[1] = x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e"):
            x = getattr(self, f"Mixed_{name}")(x)
        outs[2] = x
        for name in ("7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        outs[3] = x.mean(dim=(2, 3))
        return [outs[i] if i == 3 else outs[i].permute(0, 2, 3, 1) for i in self.output_blocks]


@torch.no_grad()
def randomize_inception_(model: InceptionV3, generator: torch.Generator) -> InceptionV3:
    """Seeded random weights that keep the activations' scale through the
    94 conv layers: He-normal convs, BatchNorm scale 1 + N(0, 0.1^2), bias
    and running mean N(0, 0.1^2), running variance U(0.5, 1.5)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, 0.1, generator=generator)
            m.bias.normal_(0.0, 0.1, generator=generator)
            m.running_mean.normal_(0.0, 0.1, generator=generator)
            m.running_var.uniform_(0.5, 1.5, generator=generator)
    return model


def load_inception(model: InceptionV3, sd: Dict[str, torch.Tensor]) -> None:
    """A ``pytorch_fid``/torchvision InceptionV3 state dict's block weights
    into ``model`` (keys the model does not have, ``fc`` and ``AuxLogits``
    among them, are not read), strictly otherwise."""
    own = model.state_dict()
    wanted = {k: v for k, v in sd.items() if k in own}
    missing = sorted(k for k in own if k not in wanted and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"InceptionV3 state dict: missing {missing[:5]}")
    model.load_state_dict(wanted, strict=False)
