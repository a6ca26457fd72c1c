"""Denoiser preconditioning scalings (port of
``ccedit_tpu/diffusion/scaling.py``): sigma -> (c_skip, c_out, c_in,
c_noise) with ``denoised = net(x * c_in, c_noise, cond) * c_out + x * c_skip``."""

from __future__ import annotations

import torch


class EpsScaling:
    """SD-1.5: c_skip = 1, c_out = -sigma, c_in = 1/sqrt(sigma^2 + 1),
    c_noise = sigma."""

    def __call__(self, sigma: torch.Tensor):
        return (torch.ones_like(sigma), -sigma, 1.0 / torch.sqrt(sigma ** 2 + 1.0), sigma)


class EDMScaling:
    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = sigma_data

    def __call__(self, sigma: torch.Tensor):
        s2 = self.sigma_data ** 2
        return (s2 / (sigma ** 2 + s2), sigma * self.sigma_data / torch.sqrt(sigma ** 2 + s2),
                1.0 / torch.sqrt(sigma ** 2 + s2), 0.25 * torch.log(sigma))


class VScaling:
    """v-prediction: c_skip = 1/(sigma^2 + 1), c_out = -sigma/sqrt(sigma^2 + 1)."""

    def __call__(self, sigma: torch.Tensor):
        return (1.0 / (sigma ** 2 + 1.0), -sigma / torch.sqrt(sigma ** 2 + 1.0),
                1.0 / torch.sqrt(sigma ** 2 + 1.0), sigma)


SCALINGS = {"eps": EpsScaling, "edm": EDMScaling, "v": VScaling}
