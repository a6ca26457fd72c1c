"""Training-loss weightings w(sigma) (port of
``ccedit_tpu/diffusion/weighting.py``)."""

from __future__ import annotations

import torch


class UnitWeighting:
    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(sigma)


class EDMWeighting:
    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = sigma_data

    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return (sigma ** 2 + self.sigma_data ** 2) / (sigma * self.sigma_data) ** 2


class VWeighting(EDMWeighting):
    def __init__(self):
        super().__init__(sigma_data=1.0)


class EpsWeighting:
    """sigma^-2, the weighting CCEdit's configs ship."""

    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma ** -2.0


_WEIGHTINGS = {"unit": UnitWeighting, "edm": EDMWeighting, "v": VWeighting, "eps": EpsWeighting}


def make_weighting(name: str, **kwargs):
    return _WEIGHTINGS[name](**kwargs)
