"""Training loss (port of ``ccedit_tpu/diffusion/loss.py``:
``StandardDiffusionLoss``): draw a sigma per batch element, add noise (plus
optional offset noise shared over the trailing dims past
``offset_noise_varying_dim``), denoise, and take the weighted l2 or l1
against the clean input.  The ``lpips`` loss is not ported yet (ROADMAP
queue 1, "the rest of training")."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .denoiser import append_dims


class StandardDiffusionLoss:
    def __init__(self, sigma_sampler, loss_type: str = "l2",
                 offset_noise_level: float = 0.0, offset_noise_varying_dim: int = 1):
        if loss_type == "lpips":
            raise NotImplementedError("the lpips diffusion loss is not ported yet "
                                      "(ROADMAP queue 1, 'the rest of training')")
        if loss_type not in ("l2", "l1"):
            raise ValueError(loss_type)
        self.sigma_sampler = sigma_sampler
        self.loss_type = loss_type
        self.offset_noise_level = offset_noise_level
        self.offset_noise_varying_dim = offset_noise_varying_dim

    def __call__(self, network: Callable, denoiser, cond, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 noise_override: Optional[torch.Tensor] = None,
                 sigma_override: Optional[torch.Tensor] = None,
                 offset_override: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: clean latents (B, ...).  Returns the per-sample losses (B,).
        The ``*_override`` tensors replace the draws from ``generator``."""
        sigmas = (sigma_override.to(device=x.device, dtype=torch.float32)
                  if sigma_override is not None
                  else self.sigma_sampler(x.shape[0], generator=generator, device=x.device))
        noise = (noise_override.to(x) if noise_override is not None
                 else torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype))
        if self.offset_noise_level > 0.0:
            vshape = self.offset_shape(x.shape)
            offs = (offset_override.to(x) if offset_override is not None
                    else torch.randn(vshape, generator=generator, device=x.device, dtype=x.dtype))
            if tuple(offs.shape) != vshape:
                raise ValueError(f"offset noise shape {tuple(offs.shape)} != {vshape}")
            noise = noise + self.offset_noise_level * offs
        noised = x + noise * append_dims(sigmas, x.dim())
        model_output = denoiser(network, noised, sigmas, cond)
        w = append_dims(denoiser.w(sigmas), x.dim())
        return self.get_loss(model_output, x, w)

    def offset_shape(self, xshape) -> tuple:
        """Broadcast shape of the offset-noise draw in the channels-last
        layout (B, *spatial, C) for a reference-order (channels-first)
        ``offset_noise_varying_dim``: reference dim 0 (B) -> 0, 1 (C) -> last,
        k >= 2 (spatial) -> k - 1."""
        d, n = self.offset_noise_varying_dim, len(xshape)
        if n <= d:
            raise ValueError(f"offset_noise_varying_dim {d} needs more than {d} dims, "
                             f"got {tuple(xshape)}")
        ref_to_ours = [0, n - 1] + list(range(1, n - 1))
        shape = [1] * n
        for ref_dim in range(d):
            shape[ref_to_ours[ref_dim]] = xshape[ref_to_ours[ref_dim]]
        return tuple(shape)

    def get_loss(self, model_output, target, w) -> torch.Tensor:
        b = target.shape[0]
        err = (model_output - target) ** 2 if self.loss_type == "l2" else (model_output - target).abs()
        return (w * err).reshape(b, -1).mean(dim=1)
