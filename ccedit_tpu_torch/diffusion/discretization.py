"""Sigma discretizations (port of ``ccedit_tpu/diffusion/discretization.py``):
``LegacyDDPMDiscretization`` (the shipped CCEdit configs' schedule),
``EDMDiscretization`` (Karras rho-spaced sigmas) and
``Img2ImgDiscretizationWrapper`` (strength-based pruning, the sdedit
schedule).  Schedules are host-side float64 numpy, as in the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


def make_ddpm_alphas_cumprod(num_timesteps: int = 1000, linear_start: float = 0.00085,
                             linear_end: float = 0.0120) -> np.ndarray:
    """The LDM 'linear' beta schedule (betas linear in sqrt-space)."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, num_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas, axis=0)


class Discretization:
    """``__call__(n)`` returns n descending sigmas, with a trailing zero
    appended (the sampler convention) and ascending with ``flip``."""

    def get_sigmas(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> np.ndarray:
        sigmas = np.asarray(self.get_sigmas(n), dtype=np.float64)
        if do_append_zero:
            sigmas = np.concatenate([sigmas, np.zeros((1,), dtype=sigmas.dtype)])
        return sigmas[::-1].copy() if flip else sigmas


@dataclasses.dataclass
class EDMDiscretization(Discretization):
    """rho-spaced sigmas of Karras et al. (EDM)."""

    sigma_min: float = 0.02
    sigma_max: float = 80.0
    rho: float = 7.0

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0, 1, n, dtype=np.float64)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** self.rho


@dataclasses.dataclass
class LegacyDDPMDiscretization(Discretization):
    """DDPM alphas_cumprod -> sigma = sqrt((1 - abar) / abar), sub-sampled."""

    linear_start: float = 0.00085
    linear_end: float = 0.0120
    num_timesteps: int = 1000

    def __post_init__(self):
        self.alphas_cumprod = make_ddpm_alphas_cumprod(
            self.num_timesteps, self.linear_start, self.linear_end)

    def get_sigmas(self, n: int) -> np.ndarray:
        """n descending sigmas."""
        if n < self.num_timesteps:
            ac = self.alphas_cumprod[generate_roughly_equally_spaced_steps(n, self.num_timesteps)]
        elif n == self.num_timesteps:
            ac = self.alphas_cumprod
        else:
            raise ValueError(f"requested {n} sigmas from a {self.num_timesteps}-step schedule")
        return (((1 - ac) / ac) ** 0.5)[::-1]


@dataclasses.dataclass
class Img2ImgDiscretizationWrapper(Discretization):
    """Keep the lowest ``strength`` fraction of the wrapped schedule: the
    sigmas flipped ascending, the first max(int(strength * len), 1) kept,
    flipped back."""

    discretization: Discretization = None
    strength: float = 1.0

    def __call__(self, n: int, do_append_zero: bool = True, flip: bool = False) -> np.ndarray:
        if not 0.0 <= self.strength <= 1.0:
            raise ValueError(f"strength must be in [0,1], got {self.strength}")
        asc = self.discretization(n, do_append_zero=do_append_zero, flip=flip)[::-1]
        return asc[:max(int(self.strength * len(asc)), 1)][::-1].copy()


DISCRETIZATIONS = {"edm": EDMDiscretization, "legacy_ddpm": LegacyDDPMDiscretization}


def make_discretization(name: str, **kwargs) -> Discretization:
    """``name`` of ``DISCRETIZATIONS`` with its params; an
    ``img2img_strength`` below 1 wraps it in ``Img2ImgDiscretizationWrapper``."""
    strength: Optional[float] = kwargs.pop("img2img_strength", None)
    disc = DISCRETIZATIONS[name](**kwargs)
    if strength is not None and strength < 1.0:
        disc = Img2ImgDiscretizationWrapper(discretization=disc, strength=strength)
    return disc
