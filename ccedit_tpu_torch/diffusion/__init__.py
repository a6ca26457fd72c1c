"""Diffusion math of the TV2V path: LegacyDDPM schedule, eps scaling,
discrete denoiser, CFG and the DPM++2S-ancestral sampler; for training the
sigma samplers, loss weightings and ``StandardDiffusionLoss``."""

from .denoiser import DiscreteDenoiser
from .discretization import LegacyDDPMDiscretization
from .guidance import IdentityGuider, VanillaCFG
from .loss import StandardDiffusionLoss
from .samplers import DPMPP2SAncestralSampler, get_ancestral_step
from .scaling import EpsScaling
from .sigma_sampling import DiscreteSampling, EDMSampling
from .weighting import EDMWeighting, EpsWeighting, UnitWeighting, VWeighting

__all__ = [
    "DiscreteDenoiser", "LegacyDDPMDiscretization", "IdentityGuider", "VanillaCFG",
    "DPMPP2SAncestralSampler", "get_ancestral_step", "EpsScaling",
    "StandardDiffusionLoss", "DiscreteSampling", "EDMSampling",
    "EDMWeighting", "EpsWeighting", "UnitWeighting", "VWeighting",
]
