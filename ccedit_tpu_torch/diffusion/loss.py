"""Training loss (port of ``ccedit_tpu/diffusion/loss.py``:
``StandardDiffusionLoss``): draw a sigma per batch element, add noise (plus
optional offset noise shared over the trailing dims past
``offset_noise_varying_dim``), denoise, and take the weighted l2 or l1
against the clean input, or (``lpips``) an injected perceptual distance,
unweighted as in the JAX package; ``make_lpips_fn`` builds one over the
port's VGG16 LPIPS (``modules/lpips.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .denoiser import append_dims


class StandardDiffusionLoss:
    def __init__(self, sigma_sampler, loss_type: str = "l2",
                 offset_noise_level: float = 0.0, offset_noise_varying_dim: int = 1,
                 perceptual_fn: Optional[Callable] = None):
        if loss_type not in ("l2", "l1", "lpips"):
            raise ValueError(loss_type)
        if loss_type == "lpips" and perceptual_fn is None:
            raise ValueError("lpips loss requires a perceptual_fn")
        self.sigma_sampler = sigma_sampler
        self.loss_type = loss_type
        self.offset_noise_level = offset_noise_level
        self.offset_noise_varying_dim = offset_noise_varying_dim
        self.perceptual_fn = perceptual_fn

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

    @staticmethod
    def make_lpips_fn(lpips_module) -> Callable:
        """A ``perceptual_fn`` over an LPIPS module (``modules/lpips.py``):
        the leading dims of (B, ..., H, W, 3) inputs fold into the batch,
        and each sample's distances are averaged: (B,)."""

        def fn(a, b):
            bsz = a.shape[0]
            d = lpips_module(a.reshape((-1,) + tuple(a.shape[-3:])),
                             b.reshape((-1,) + tuple(b.shape[-3:])))
            return d.reshape(bsz, -1).mean(dim=1)

        return fn

    def get_loss(self, model_output, target, w) -> torch.Tensor:
        b = target.shape[0]
        if self.loss_type == "lpips":
            return self.perceptual_fn(model_output, target).reshape(-1)
        err = (model_output - target) ** 2 if self.loss_type == "l2" else (model_output - target).abs()
        return (w * err).reshape(b, -1).mean(dim=1)
