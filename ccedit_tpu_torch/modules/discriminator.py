"""PatchGAN discriminator and GAN losses for VAE training (port of
``ccedit_tpu/modules/discriminator.py``: ``NLayerDiscriminator``,
``discriminator_init``, ``hinge_d_loss``, ``vanilla_d_loss``).

taming's pix2pix PatchGAN: Conv(4, 2) + LeakyReLU(0.2), then ``n_layers - 1``
of Conv(4, 2, no bias) + BatchNorm + LeakyReLU with channels doubling (up to
8x), a stride-1 stage of the same, and a 1-channel Conv(4, 1) head.  Keys
follow taming's ``main.{i}`` ``Sequential``.  BatchNorm normalises with the
batch's own statistics on every call and keeps no running averages, as the
JAX ``_BatchStatsNorm`` does (taming never puts the discriminator in eval
mode during GAN training): ``BatchNorm2d(track_running_stats=False)``.
Channels-last at the interface: (N, H, W, C) in, (N, H', W', 1) logits out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        seq = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            seq += [nn.Conv2d(ndf * prev, ndf * mult, 4, 2 if n < n_layers else 1, 1, bias=False),
                    nn.BatchNorm2d(ndf * mult, track_running_stats=False),
                    nn.LeakyReLU(0.2)]
        seq.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1))
        self.main = nn.Sequential(*seq)

    def forward(self, x):
        return self.main(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@torch.no_grad()
def discriminator_init(model: NLayerDiscriminator, generator: torch.Generator):
    """taming's ``weights_init``, drawn from ``generator``: conv weights
    N(0, 0.02), norm scales N(1, 0.02), norm biases 0; conv biases at
    torch's default U(+-1/sqrt(fan_in))."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                bound = m.weight[0].numel() ** -0.5
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, 0.02, generator=generator)
            m.bias.zero_()
    return model


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())
