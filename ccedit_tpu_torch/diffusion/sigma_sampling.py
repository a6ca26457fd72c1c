"""Training-time sigma samplers (port of
``ccedit_tpu/diffusion/sigma_sampling.py``).  Each draws from an explicit
``torch.Generator`` on the device it is given."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .discretization import LegacyDDPMDiscretization


class EDMSampling:
    """Lognormal sigmas: exp(p_mean + p_std * N(0, 1)); ``normals`` replaces
    the gaussian draw."""

    def __init__(self, p_mean: float = -1.2, p_std: float = 1.2):
        self.p_mean = p_mean
        self.p_std = p_std

    def __call__(self, n_samples: int, generator: Optional[torch.Generator] = None,
                 device=None, normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        if normals is None:
            normals = torch.randn((n_samples,), generator=generator, device=device)
        return torch.exp(self.p_mean + self.p_std * normals)


class DiscreteSampling:
    """A uniform index into a discretization's sigma table (the CCEdit
    default: the 1000-entry LegacyDDPM table, ascending with ``flip``)."""

    def __init__(self, discretization=None, num_idx: int = 1000,
                 do_append_zero: bool = False, flip: bool = True):
        discretization = discretization or LegacyDDPMDiscretization()
        self.num_idx = num_idx
        self.sigmas_np = np.asarray(
            discretization(num_idx, do_append_zero=do_append_zero, flip=flip), np.float32)

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(self.sigmas_np).to(idx.device)[idx]

    def __call__(self, n_samples: int, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
        idx = torch.randint(0, self.num_idx, (n_samples,), generator=generator, device=device)
        return self.idx_to_sigma(idx)
