"""LPIPS perceptual distance with a VGG16 backbone (port of
``ccedit_tpu/modules/lpips.py``: ``VGG16Features`` and ``LPIPS``).

Two (N, H, W, 3) images in [-1, 1] -> shift/scale -> VGG16 features at
relu{1_2, 2_2, 3_3, 4_3, 5_3} -> channels normalised to unit length ->
squared difference -> bias-free 1x1 reduction (``lin{k}``) -> spatial mean
-> sum over the five taps: (N, 1, 1, 1).

Modules follow taming's ``vgg.pth`` layout (``net.slice{1-5}.{torchvision
index}.weight/bias``, ``lin{k}.model.1.weight``), so a real ``vgg.pth``
loads with a strict ``load_state_dict``.  Inside, the images run as NCHW
views of their channels-last memory.  The module is frozen: no parameter
needs a grad and it stays in eval mode (its dropout off).
"""

from __future__ import annotations

import torch
from torch import nn

# torchvision vgg16.features: (out channels, max-pool before) of the 13 convs
_VGG16 = [(64, False), (64, False),
          (128, True), (128, False),
          (256, True), (256, False), (256, False),
          (512, True), (512, False), (512, False),
          (512, True), (512, False), (512, False)]
# the conv after whose relu each slice ends (relu1_2 ... relu5_3)
_TAPS = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16's conv layers as taming's five slices, each a ``Sequential``
    whose children keep their torchvision ``features`` index."""

    def __init__(self):
        super().__init__()
        slices, idx, cin, conv = [nn.Sequential() for _ in _TAPS], 0, 3, 0
        for s, tap in enumerate(_TAPS):
            while conv <= tap:
                cout, pool = _VGG16[conv]
                if pool:
                    slices[s].add_module(str(idx), nn.MaxPool2d(2, 2))
                    idx += 1
                slices[s].add_module(str(idx), nn.Conv2d(cin, cout, 3, padding=1))
                slices[s].add_module(str(idx + 1), nn.ReLU())
                idx, cin, conv = idx + 2, cout, conv + 1
        for s, seq in enumerate(slices):
            setattr(self, f"slice{s + 1}", seq)

    def forward(self, x):
        """(N, 3, H, W) -> the five taps, NCHW."""
        taps = []
        for s in range(len(_TAPS)):
            x = getattr(self, f"slice{s + 1}")(x)
            taps.append(x)
        return taps


class _NetLinLayer(nn.Module):
    """taming's NetLinLayer: dropout, then a bias-free 1x1 conv to one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """Call with two (N, H, W, 3) images in [-1, 1]; returns (N, 1, 1, 1)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)
        self.net = VGG16Features()
        for k, c in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{k}", _NetLinLayer(c))
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        return super().train(False)  # frozen: always eval

    @torch.no_grad()
    def randomize_(self, generator: torch.Generator) -> "LPIPS":
        """Seeded stand-in weights (no ``vgg.pth`` in the repository): convs
        He-normal, biases 0, the 1x1 reductions |N(0, 1/C)| (LPIPS's are
        non-negative)."""
        for name, p in self.named_parameters():
            if name.startswith("lin"):
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator).abs_()
            elif p.dim() > 1:
                p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5, generator=generator)
            else:
                p.zero_()
        return self

    def forward(self, in0, in1):
        f0 = self.net((in0.permute(0, 3, 1, 2) - self.shift) / self.scale)
        f1 = self.net((in1.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = 0.0
        for k, (a, b) in enumerate(zip(f0, f1)):
            a = a / torch.sqrt(a.square().sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(b.square().sum(1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{k}").model((a - b).square())
            total = total + lin.mean(dim=(2, 3), keepdim=True)
        return total.permute(0, 2, 3, 1)
