"""CCEditEngine: network, diffusion math, conditioner and VAE (port of
``ccedit_tpu/models/engine.py``: ``sample`` in modes "full" (with the
x-prior mix), "sdedit" and "skip_steps", with inpainting and
``init_noise``/``loop_noise``, ``make_denoise_fn``, ``_hoist_control_hint``,
``encode_first_stage``, ``_wire_vae_embedders``, ``decode_first_stage``, and
training: ``loss``, ``make_optimizer``, ``train_step``,
``ema_subset``/``merge_ema``).

The modules own their weights.  The network (and VAE, CLIP) may run in
bf16; the sampler state and the denoiser math stay fp32, with a cast at the
network call.  Training keeps fp32 master weights, optionally under
``torch.autocast`` (bf16 on the GPU, so the attention kernels get bf16);
only the network's parameters of the freeze policy train: the rest get
``requires_grad_(False)``, and the conditioner and the VAE run without
autograd.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..conditioning.conditioner import Conditioner
from ..conditioning.embedders import VAEEmbedder, as_float_frames
from ..diffusion.denoiser import Denoiser
from ..diffusion.guidance import IdentityGuider, VanillaCFG
from ..diffusion.samplers import BaseSampler
from ..modules.controlnet import CCEditNetwork
from ..modules.vae import AutoencoderKL, DiagonalGaussian
from ..parallel import mesh
from ..parallel.shard import clip_randn
from ..train.ema import Ema
from ..train.freeze import freeze_mask
from ..utils import trace


class CCEditEngine:
    def __init__(self, network: CCEditNetwork, denoiser: Denoiser,
                 sampler: BaseSampler, conditioner: Conditioner,
                 vae: Optional[AutoencoderKL] = None, guider=None,
                 scale_factor: float = 0.18215, loss_fn=None, input_key: str = "jpg",
                 freeze_policy: str = "none", use_ema: bool = False,
                 ema_decay: float = 0.9999):
        self.network = network
        self.denoiser = denoiser
        self.sampler = sampler
        self.conditioner = conditioner
        self.vae = vae
        self.guider = guider if guider is not None else VanillaCFG(scale=7.5)
        self.scale_factor = scale_factor
        self.loss_fn = loss_fn
        self.input_key = input_key
        self.freeze_policy = freeze_policy
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self._wire_vae_embedders()

    def _wire_vae_embedders(self) -> None:
        """Give the conditioner's VAEEmbedders the shared first stage."""
        for spec in self.conditioner.specs:
            if isinstance(spec.embedder, VAEEmbedder):
                spec.embedder.encode = self.encode_first_stage

    @property
    def modules(self) -> tuple:
        """The network, the VAE (when there is one) and the conditioner."""
        return tuple(m for m in (self.network, self.vae, self.conditioner) if m is not None)

    @property
    def network_dtype(self) -> torch.dtype:
        return next(self.network.parameters()).dtype

    @property
    def latent_factor(self) -> int:
        """Pixel -> latent downsampling of the first stage (8 for SD's VAE)."""
        return 2 ** (len(self.vae.ch_mult) - 1) if self.vae is not None else 1

    def encode_first_stage(self, x: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pixels in [-1, 1] (or uint8) -> scaled fp32 latents: the
        posterior mode, or a sample with ``noise`` or a draw from
        ``generator``."""
        x = as_float_frames(x)
        if self.vae is None:
            return x
        moments = self.vae.encode_moments(x.to(next(self.vae.parameters()).dtype)).float()
        post = DiagonalGaussian(moments)
        if generator is None and noise is None:
            z = post.mode()
        else:
            z = post.sample(generator, noise=None if noise is None else noise.to(post.mean))
        return z * self.scale_factor

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        if self.vae is None:
            return z
        dtype = next(self.vae.parameters()).dtype
        return self.vae.decode((z / self.scale_factor).to(dtype))

    def _network_fn(self, x, c_noise, cond):
        with trace.span(trace.NETWORK):
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
               init_noise: Optional[torch.Tensor] = None, loop_noise=None,
               guider_scale: Optional[float] = None,
               x_prior: Optional[torch.Tensor] = None, prior_coefficient: float = 0.0,
               prior_noise_coefficient: float = 1.0, mode: str = "full",
               sdedit_steps: int = 0, inpaint_x0: Optional[torch.Tensor] = None,
               inpaint_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Draw latents (fp32).

        * mode "full": from noise; with ``x_prior`` and a nonzero
          ``prior_coefficient`` the start is ``prior_noise_coefficient *
          noise + prior_coefficient * x_prior``.
        * mode "sdedit": ``x_prior`` is the clean video latent; the start is
          (x_prior + noise * sigma_0) / sqrt(1 + sigma_0^2) on the sampler's
          (img2img-pruned) schedule, which the sampler's own rescale turns
          back into x_prior + noise * sigma_0.
        * mode "skip_steps": only the last ``sdedit_steps`` steps of the
          full schedule, from ``x_prior``, which is already noised.
        * ``inpaint_x0`` / ``inpaint_mask``: before each step the latents
          keep their own values where the mask is 1 and take ``inpaint_x0``
          noised to the step's sigma where it is 0.

        ``init_noise`` replaces the start-of-chain gaussian and
        ``loop_noise`` the sampler's draws (rows of the executed steps, or
        ``{"loop": rows, "pre": rows}`` with inpainting's second stream);
        otherwise both come from ``generator``.  Under a clip shard
        (``parallel/sampling.py``) ``shape`` and every clip-shaped argument
        are this rank's block, and each draw is the whole clip's, of which
        the block is kept."""
        device = next(self.network.parameters()).device
        if init_noise is not None:
            noise = init_noise.to(device=device, dtype=torch.float32)
            if tuple(noise.shape) != tuple(shape):
                raise ValueError(f"init_noise shape {tuple(noise.shape)} != {tuple(shape)}")
        else:
            noise = clip_randn(shape, generator, device)
        if mode == "sdedit":
            if x_prior is None:
                raise ValueError("mode 'sdedit' needs the clean video latent (x_prior)")
            sigma0 = float(self.sampler.get_sigmas(num_steps)[0])
            x = (x_prior.to(noise) + noise * sigma0) / float(np.sqrt(1.0 + sigma0 ** 2))
        elif mode == "skip_steps":
            if x_prior is None:
                raise ValueError("mode 'skip_steps' needs the noised latent (x_prior)")
            x = x_prior.to(noise)
        elif mode == "full":
            x = noise
            if x_prior is not None and prior_coefficient != 0:
                x = prior_noise_coefficient * x + prior_coefficient * x_prior.to(x)
        else:
            raise ValueError(f"mode {mode!r} (one of full, sdedit, skip_steps)")
        denoise_fn = self.make_denoise_fn(cond, uc, guider_scale=guider_scale)
        kw = dict(num_steps=num_steps, noise_override=loop_noise, generator=generator)
        if mode == "skip_steps":
            return self.sampler.sdedit(sdedit_steps, denoise_fn, x, **kw)
        if inpaint_x0 is not None:
            if inpaint_mask is None:
                raise ValueError("inpainting needs inpaint_mask as well as inpaint_x0")
            return self.sampler.sample_inpainting(denoise_fn, x, inpaint_x0.to(x),
                                                  inpaint_mask.to(x), **kw)
        return self.sampler(denoise_fn, x, **kw)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def trainable_parameters(self) -> Dict[str, torch.nn.Parameter]:
        """The network's parameters that the freeze policy trains, by name."""
        mask = freeze_mask(self.network.named_parameters(), self.freeze_policy)
        return {n: p for n, p in self.network.named_parameters() if mask[n]}

    def make_optimizer(self, lr: float, zero: bool = False) -> torch.optim.Optimizer:
        """AdamW (weight decay 1e-2, as ``optax.adamw`` in the JAX engine)
        over the trainable parameters, its state sharded over the
        data-parallel ranks with ``zero`` (``parallel/zero.py``, ZeRO-1); every
        other parameter of the engine is frozen with ``requires_grad_(False)``."""
        trainable = self.trainable_parameters()
        for m in (self.network, self.conditioner, self.vae):
            if m is not None:
                m.requires_grad_(False)
        for p in trainable.values():
            p.requires_grad_(True)
        if zero:
            from ..parallel.zero import zero_adamw

            return zero_adamw(trainable.values(), lr=lr, weight_decay=1e-2)
        return torch.optim.AdamW(list(trainable.values()), lr=lr, weight_decay=1e-2)

    def ema_subset(self) -> Dict[str, torch.Tensor]:
        """The EMA shadows only the trainable subset: the EMA of a constant
        is the constant."""
        return self.trainable_parameters()

    def make_ema(self) -> Ema:
        return Ema(self.ema_subset(), self.ema_decay)

    @contextlib.contextmanager
    def merge_ema(self, shadow: Dict[str, torch.Tensor]):
        """Within the block the network carries the EMA values on its
        trainable parameters; they are restored on exit."""
        params = dict(self.network.named_parameters())
        saved = {n: params[n].detach().clone() for n in shadow}
        with torch.no_grad():
            for n, v in shadow.items():
                params[n].copy_(v)
        try:
            yield self.network
        finally:
            with torch.no_grad():
                for n, v in saved.items():
                    params[n].copy_(v)

    def loss(self, batch: Dict, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None, sigmas: Optional[torch.Tensor] = None,
             offset: Optional[torch.Tensor] = None,
             vae_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean diffusion loss of a raw batch (strings, arrays): conditioning
        with classifier-free dropout, the VAE posterior sample of
        ``batch[input_key]``, then ``loss_fn``.  ``noise``, ``sigmas``,
        ``offset`` and ``vae_noise`` replace the draws from ``generator``."""
        device = next(self.network.parameters()).device
        with torch.no_grad():  # the conditioner and the VAE are frozen
            prepared = self.conditioner.prepare(batch, apply_legacy_ucg=True, generator=generator)
            cond = self.conditioner.embed(prepared, apply_ucg=True, generator=generator)
            x = torch.as_tensor(batch[self.input_key], device=device)
            z = self.encode_first_stage(x, generator=generator, noise=vae_noise)
        losses = self.loss_fn(self._network_fn, self.denoiser, cond, z.float(), generator=generator,
                              noise_override=noise, sigma_override=sigmas, offset_override=offset)
        return losses.mean()

    def backward_step(self, batch: Dict, generator: Optional[torch.Generator] = None,
                      autocast_dtype: Optional[torch.dtype] = None, grad_scale: float = 1.0,
                      **overrides) -> torch.Tensor:
        """loss(batch) and its backward (grads accumulate into ``.grad``,
        scaled by ``grad_scale``); ``autocast_dtype`` runs the loss under
        ``torch.autocast``.  Returns the detached loss."""
        device = next(self.network.parameters()).device
        ctx = (torch.autocast(device.type, dtype=autocast_dtype) if autocast_dtype is not None
               else contextlib.nullcontext())
        with ctx:
            loss = self.loss(batch, generator, **overrides)
        (loss * grad_scale).backward()
        return loss.detach()

    def train_step(self, batch: Dict, optimizer: torch.optim.Optimizer,
                   generator: Optional[torch.Generator] = None, ema: Optional[Ema] = None,
                   lr_scheduler=None, autocast_dtype: Optional[torch.dtype] = None,
                   accumulate: int = 1, apply: bool = True,
                   reduce_grads: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None,
                   **overrides) -> torch.Tensor:
        """One batch of training: loss + backward, its grads scaled by
        1/``accumulate`` and added to ``.grad``; with ``apply`` (the last of
        ``accumulate`` batches) ``reduce_grads(trainable parameters)`` (data
        parallelism: ``parallel.mesh.all_reduce_grads``, the batch then a
        ``parallel.mesh.data_parallel`` step), the AdamW update, zeroed grads
        and an LR schedule step; then the EMA update.  Returns the detached
        loss."""
        with (mesh.data_parallel() if reduce_grads is not None else contextlib.nullcontext()):
            loss = self.backward_step(batch, generator, autocast_dtype,
                                      grad_scale=1.0 / accumulate, **overrides)
        if apply:
            if reduce_grads is not None:
                reduce_grads(self.trainable_parameters())
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            if lr_scheduler is not None:
                lr_scheduler.step()
        if ema is not None:
            ema.update(self.ema_subset())
        return loss
