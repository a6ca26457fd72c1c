"""Diffusion math: the LegacyDDPM and EDM schedules (and img2img pruning),
the eps, EDM and v scalings, the continuous and discrete denoisers, CFG, the
six k-diffusion samplers with their sdedit / inpaint / blend modes; for
training the sigma samplers, loss weightings and ``StandardDiffusionLoss``."""

from .denoiser import Denoiser, DiscreteDenoiser
from .discretization import (EDMDiscretization, Img2ImgDiscretizationWrapper,
                             LegacyDDPMDiscretization, make_discretization)
from .guidance import IdentityGuider, VanillaCFG
from .loss import StandardDiffusionLoss
from .samplers import (DPMPP2MSampler, DPMPP2SAncestralSampler, EulerAncestralSampler,
                       EulerEDMSampler, HeunEDMSampler, LinearMultistepSampler,
                       get_ancestral_step, make_sampler)
from .scaling import EDMScaling, EpsScaling, VScaling
from .sigma_sampling import DiscreteSampling, EDMSampling
from .weighting import EDMWeighting, EpsWeighting, UnitWeighting, VWeighting

__all__ = [
    "Denoiser", "DiscreteDenoiser", "EDMDiscretization", "Img2ImgDiscretizationWrapper",
    "LegacyDDPMDiscretization", "make_discretization", "IdentityGuider", "VanillaCFG",
    "DPMPP2MSampler", "DPMPP2SAncestralSampler", "EulerAncestralSampler", "EulerEDMSampler",
    "HeunEDMSampler", "LinearMultistepSampler", "get_ancestral_step", "make_sampler",
    "EDMScaling", "EpsScaling", "VScaling", "StandardDiffusionLoss", "DiscreteSampling",
    "EDMSampling", "EDMWeighting", "EpsWeighting", "UnitWeighting", "VWeighting",
]
