"""Denoisers (port of ``ccedit_tpu/diffusion/denoiser.py``):
``denoised = network(x * c_in, c_noise, cond) * c_out + x * c_skip``.
``Denoiser`` is the continuous one (sigma and c_noise as they are);
``DiscreteDenoiser`` quantises sigma to the nearest entry of the 1000-step
DDPM table and passes the table index to the network as the timestep.
``w(sigma)`` is the training loss weighting (eps, CCEdit's default)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .discretization import Discretization, LegacyDDPMDiscretization
from .scaling import EpsScaling
from .weighting import EpsWeighting


def append_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


class Denoiser:
    def __init__(self, scaling=None, weighting=None):
        self.scaling = scaling or EpsScaling()
        self.weighting = weighting or EpsWeighting()

    def w(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.weighting(sigma)

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return c_noise

    def __call__(self, network: Callable, x: torch.Tensor, sigma: torch.Tensor, cond):
        """sigma: (B,) fp32.  Matches the JAX Denoiser/DiscreteDenoiser."""
        sigma = self.possibly_quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = self.scaling(append_dims(sigma, x.dim()))
        c_noise = self.possibly_quantize_c_noise(c_noise.reshape(sigma.shape))
        return network(x * c_in, c_noise, cond) * c_out + x * c_skip


class DiscreteDenoiser(Denoiser):
    def __init__(self, scaling=None, num_idx: int = 1000,
                 discretization: Optional[Discretization] = None,
                 weighting=None):
        super().__init__(scaling, weighting)
        disc = discretization or LegacyDDPMDiscretization()
        # ascending sigma table indexed by DDPM timestep, fp32 as in the JAX package
        self.sigmas_np = np.asarray(disc(num_idx, do_append_zero=False, flip=True), np.float32)
        self._sigmas = {}

    def sigmas(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._sigmas:
            self._sigmas[key] = torch.from_numpy(self.sigmas_np).to(device)
        return self._sigmas[key]

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        dists = sigma[None, :] - self.sigmas(sigma.device)[:, None]
        return dists.abs().argmin(dim=0)

    def possibly_quantize_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.sigmas(sigma.device)[self.sigma_to_idx(sigma)]

    def possibly_quantize_c_noise(self, c_noise: torch.Tensor) -> torch.Tensor:
        return self.sigma_to_idx(c_noise)
