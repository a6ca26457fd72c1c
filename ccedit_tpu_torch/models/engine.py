"""CCEditEngine: network, diffusion math, conditioner and VAE (port of
``ccedit_tpu/models/engine.py``: ``sample`` in mode "full" with
``init_noise``/``loop_noise`` and the x-prior mix, ``make_denoise_fn``,
``_hoist_control_hint``, ``encode_first_stage``, ``_wire_vae_embedders`` and
``decode_first_stage``; sdedit, inpainting and training are not ported).

The modules own their weights.  The network (and VAE, CLIP) may run in
bf16; the sampler state and the denoiser math stay fp32, with a cast at the
network call.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..conditioning.conditioner import Conditioner
from ..conditioning.embedders import VAEEmbedder, as_float_frames
from ..diffusion.denoiser import DiscreteDenoiser
from ..diffusion.guidance import IdentityGuider, VanillaCFG
from ..diffusion.samplers import DPMPP2SAncestralSampler
from ..modules.controlnet import CCEditNetwork
from ..modules.vae import AutoencoderKL, DiagonalGaussian


class CCEditEngine:
    def __init__(self, network: CCEditNetwork, denoiser: DiscreteDenoiser,
                 sampler: DPMPP2SAncestralSampler, conditioner: Conditioner,
                 vae: Optional[AutoencoderKL] = None, guider=None,
                 scale_factor: float = 0.18215):
        self.network = network
        self.denoiser = denoiser
        self.sampler = sampler
        self.conditioner = conditioner
        self.vae = vae
        self.guider = guider if guider is not None else VanillaCFG(scale=7.5)
        self.scale_factor = scale_factor
        self._wire_vae_embedders()

    def _wire_vae_embedders(self) -> None:
        """Give the conditioner's VAEEmbedders the shared first stage."""
        for spec in self.conditioner.specs:
            if isinstance(spec.embedder, VAEEmbedder):
                spec.embedder.encode = self.encode_first_stage

    @property
    def network_dtype(self) -> torch.dtype:
        return next(self.network.parameters()).dtype

    @property
    def latent_factor(self) -> int:
        """Pixel -> latent downsampling of the first stage (8 for SD's VAE)."""
        return 2 ** (len(self.vae.ch_mult) - 1) if self.vae is not None else 1

    def encode_first_stage(self, x: torch.Tensor,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Pixels in [-1, 1] (or uint8) -> scaled fp32 latents: the
        posterior mode, or a sample drawn from ``generator``."""
        x = as_float_frames(x)
        if self.vae is None:
            return x
        moments = self.vae.encode_moments(x.to(next(self.vae.parameters()).dtype)).float()
        post = DiagonalGaussian(moments)
        z = post.mode() if generator is None else post.sample(generator)
        return z * self.scale_factor

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        if self.vae is None:
            return z
        dtype = next(self.vae.parameters()).dtype
        return self.vae.decode((z / self.scale_factor).to(dtype))

    def _network_fn(self, x, c_noise, cond):
        return self.network(x.to(self.network_dtype), c_noise, cond).to(torch.float32)

    def _hoist_control_hint(self, cond_cat: Dict) -> Dict:
        """The ControlNet hint pyramid depends only on the hint: run it once
        per clip and pass ``control_hint_features`` instead of
        ``control_hint`` to every network call."""
        if "control_hint" not in cond_cat or self.network.controlnet is None:
            return cond_cat
        out = dict(cond_cat)
        out["control_hint_features"] = self.network.encode_control_hint(out.pop("control_hint"))
        return out

    def make_denoise_fn(self, cond: Dict, uc: Optional[Dict],
                        guider_scale: Optional[float] = None) -> Callable:
        """denoise_fn(x, sigma) with CFG folded in; the conditioning is
        doubled, cast to the network dtype and hint-encoded once here."""
        guider = self.guider if uc is not None else IdentityGuider()
        dtype = self.network_dtype
        cond_cat = {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in guider.prepare_cond(cond, uc).items()}
        cond_cat = self._hoist_control_hint(cond_cat)

        def denoise_fn(x, sigma: float):
            sigma_vec = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
            x2, s2 = guider.expand(x, sigma_vec)
            out = self.denoiser(self._network_fn, x2, s2, cond_cat)
            return guider.combine(out, scale=guider_scale)

        return denoise_fn

    @torch.no_grad()
    def sample(self, cond: Dict, uc: Optional[Dict], shape: Sequence[int],
               num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None,
               loop_noise: Optional[torch.Tensor] = None,
               guider_scale: Optional[float] = None,
               x_prior: Optional[torch.Tensor] = None, prior_coefficient: float = 0.0,
               prior_noise_coefficient: float = 1.0) -> torch.Tensor:
        """Draw latents (fp32) from noise (mode "full" of the JAX engine).
        ``init_noise`` replaces the start-of-chain gaussian and
        ``loop_noise`` (num_steps, *shape) the per-step ancestral draws;
        otherwise both come from ``generator``.  With ``x_prior`` and a
        nonzero ``prior_coefficient`` the start is
        ``prior_noise_coefficient * noise + prior_coefficient * x_prior``."""
        device = next(self.network.parameters()).device
        if init_noise is not None:
            x = init_noise.to(device=device, dtype=torch.float32)
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"init_noise shape {tuple(x.shape)} != {tuple(shape)}")
        else:
            x = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
        if x_prior is not None and prior_coefficient != 0:
            x = prior_noise_coefficient * x + prior_coefficient * x_prior.to(x)
        denoise_fn = self.make_denoise_fn(cond, uc, guider_scale=guider_scale)
        return self.sampler(denoise_fn, x, num_steps=num_steps,
                            noise_override=loop_noise, generator=generator)
