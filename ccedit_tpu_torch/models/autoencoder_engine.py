"""VAE (autoencoder) GAN training (port of
``ccedit_tpu/models/autoencoder_engine.py``: ``LPIPSWithDiscriminatorConfig``,
``adopt_weight``, ``AutoencodingEngine``, ``LatentLPIPS``, ``VAETrainer``).

The SD KL-f8 autoencoder's fine-tune recipe (sgm's ``AutoencodingEngine``
with ``GeneralLPIPSWithDiscriminator``): a generator pass (encode, sample,
decode; L1 + LPIPS NLL over a log-variance; the KL regulariser; the
PatchGAN generator loss weighted by the adaptive last-layer gradient
ratio), then a discriminator pass on the updated autoencoder (hinge or
vanilla loss), two Adam optimisers.  Images are channels-last (N, H, W, 3)
in [-1, 1], as in the JAX package.

The adaptive weight ``||grad_last nll|| / (||grad_last g_loss|| + 1e-4)``
is taken with ``torch.autograd.grad`` on the generator pass's own graph, as
sgm's ``calculate_adaptive_weight`` does; the JAX package re-runs the
decoder twice for the same two gradients (their values are the same: the
last layer's gradient needs no pass back through the decoder).  The VAE's
mid-block attentions are d = 512: kernel 3 with its log-sum-exp in the
generator pass, kernel 4 at d = 512 in its backward, kernel 3 alone in the
discriminator pass (under ``torch.no_grad``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..io.checkpoint import randomize_weights_
from ..modules.discriminator import (
    NLayerDiscriminator,
    discriminator_init,
    hinge_d_loss,
    vanilla_d_loss,
)
from ..modules.lpips import LPIPS
from ..modules.vae import AutoencoderKL, DiagonalGaussian


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """``value`` before ``threshold`` steps, ``weight`` from then on."""
    return value if global_step < threshold else weight


@dataclasses.dataclass
class LPIPSWithDiscriminatorConfig:
    disc_start: int = 0
    logvar_init: float = 0.0
    pixelloss_weight: float = 1.0  # stored, never applied (as in JAX and sgm)
    disc_num_layers: int = 3
    disc_in_channels: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_loss: str = "hinge"  # or "vanilla"
    learn_logvar: bool = False
    regularization_weights: Optional[Dict[str, float]] = None


class AutoencodingEngine(nn.Module):
    """KL autoencoder (``ae``), log-variance (``logvar``, trained only with
    ``learn_logvar``), PatchGAN (``disc``) and frozen LPIPS (``lpips``)."""

    def __init__(self, ae: Optional[AutoencoderKL] = None,
                 loss_cfg: Optional[LPIPSWithDiscriminatorConfig] = None):
        super().__init__()
        self.ae = ae if ae is not None else AutoencoderKL()
        self.cfg = loss_cfg or LPIPSWithDiscriminatorConfig()
        self.logvar = nn.Parameter(torch.tensor(float(self.cfg.logvar_init)),
                                   requires_grad=self.cfg.learn_logvar)
        self.disc = NLayerDiscriminator(self.cfg.disc_in_channels,
                                        n_layers=self.cfg.disc_num_layers)
        self.lpips = LPIPS()
        self.d_loss = hinge_d_loss if self.cfg.disc_loss == "hinge" else vanilla_d_loss

    def generator_parameters(self) -> Dict[str, nn.Parameter]:
        """The generator optimiser's subset: ``ae``, and ``logvar`` with
        ``learn_logvar``."""
        out = {f"ae.{n}": p for n, p in self.ae.named_parameters()}
        if self.cfg.learn_logvar:
            out["logvar"] = self.logvar
        return out

    def randomize_(self, generator: torch.Generator) -> "AutoencodingEngine":
        """Seeded weights (no checkpoint is in the repository): the VAE as
        ``randomize_weights_`` draws it, LPIPS's stand-in weights, and the
        discriminator through taming's ``weights_init``."""
        randomize_weights_(self.ae, generator)
        self.lpips.randomize_(generator)
        discriminator_init(self.disc, generator)
        return self

    # -- forward ------------------------------------------------------------
    def encode(self, x, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """(z, {"kl_loss": mean KL}); ``noise`` replaces the posterior's
        N(0, 1) draw (the JAX ``noise_override``)."""
        posterior = DiagonalGaussian(self.ae.encode_moments(x))
        return posterior.sample(generator, noise), {"kl_loss": posterior.kl().mean()}

    def decode(self, z):
        return self.ae.decode(z)

    # -- losses -------------------------------------------------------------
    def _nll(self, x, xrec) -> Tuple[torch.Tensor, torch.Tensor]:
        # pixelloss_weight is stored but not applied, as in the JAX package
        # and the reference
        rec = (x - xrec).abs()
        if self.cfg.perceptual_weight > 0:
            rec = rec + self.cfg.perceptual_weight * self.lpips(x, xrec).float()
        nll = rec / torch.exp(self.logvar) + self.logvar
        return nll.sum() / x.shape[0], rec

    def _adaptive_weight(self, nll, g_loss) -> torch.Tensor:
        """||grad_last nll|| / (||grad_last g_loss|| + 1e-4), clipped to
        [0, 1e4], times ``disc_weight``; no gradient through it.  ``last``
        is the decoder's output conv weight (sgm's ``get_last_layer``)."""
        last = self.ae.decoder.conv_out.weight
        nll_g, = torch.autograd.grad(nll, last, retain_graph=True)
        g_g, = torch.autograd.grad(g_loss, last, retain_graph=True)
        d_w = nll_g.float().norm() / (g_g.float().norm() + 1e-4)
        return d_w.clamp(0.0, 1e4).detach() * self.cfg.disc_weight

    def generator_loss(self, x, global_step: int, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """The generator pass's loss and its log (``nll_loss``, ``rec_loss``,
        ``g_loss``, ``d_weight``, ``logvar``, ``kl_loss``, ``total_loss``)."""
        z, reg_log = self.encode(x, generator, noise)
        xrec = self.decode(z).float()
        nll, rec = self._nll(x, xrec)
        g_loss = -self.disc(xrec).float().mean()
        if self.cfg.disc_factor > 0:
            d_weight = self._adaptive_weight(nll, g_loss)
        else:
            d_weight = torch.zeros((), device=x.device)
        disc_factor = adopt_weight(self.cfg.disc_factor, global_step, self.cfg.disc_start)
        loss = nll + d_weight * disc_factor * g_loss
        log = {"nll_loss": nll, "rec_loss": rec.mean(), "g_loss": g_loss, "d_weight": d_weight,
               "logvar": self.logvar}
        for k, v in reg_log.items():
            w = (self.cfg.regularization_weights or {}).get(k)
            if w is not None:
                loss = loss + w * v
            log[k] = v
        log["total_loss"] = loss
        return loss, {k: v.detach() for k, v in log.items()}

    def discriminator_loss(self, x, global_step: int,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """The discriminator pass's loss on ``x`` and its reconstruction.
        No gradient reaches the autoencoder (the JAX package stops it at the
        reconstruction), so it is encoded and decoded under ``no_grad``:
        kernel 3 runs there without its lse."""
        with torch.no_grad():
            z, _ = self.encode(x, generator, noise)
            xrec = self.decode(z)
        logits_real = self.disc(x).float()
        logits_fake = self.disc(xrec).float()
        disc_factor = adopt_weight(self.cfg.disc_factor, global_step, self.cfg.disc_start)
        d_loss = disc_factor * self.d_loss(logits_real, logits_fake)
        return d_loss, {"disc_loss": d_loss.detach(), "logits_real": logits_real.mean().detach(),
                        "logits_fake": logits_fake.mean().detach()}


class LatentLPIPS(nn.Module):
    """Latent L2 plus LPIPS through a frozen decoder (sgm's
    ``LatentLPIPS``)."""

    def __init__(self, decoder: AutoencoderKL, perceptual_weight: float = 1.0,
                 latent_weight: float = 1.0, perceptual_weight_on_inputs: float = 0.0):
        super().__init__()
        self.decoder = decoder
        self.lpips = LPIPS()
        self.perceptual_weight = perceptual_weight
        self.latent_weight = latent_weight
        self.perceptual_weight_on_inputs = perceptual_weight_on_inputs

    def forward(self, latent_inputs, latent_predictions, image_inputs=None):
        log = {}
        l2 = (latent_inputs - latent_predictions).square().mean()
        log["latent_l2_loss"] = l2
        loss = l2
        recons = None
        if self.perceptual_weight > 0:
            recons = self.decoder.decode(latent_predictions)
            targets = self.decoder.decode(latent_inputs)
            p = self.lpips(targets, recons).mean()
            loss = self.latent_weight * l2 + self.perceptual_weight * p
            log["perceptual_loss"] = p
        if self.perceptual_weight_on_inputs > 0 and image_inputs is not None:
            if recons is None:
                recons = self.decoder.decode(latent_predictions)
            p2 = self.lpips(image_inputs, recons).mean()
            loss = loss + self.perceptual_weight_on_inputs * p2
            log["perceptual_loss_on_inputs"] = p2
        return loss, log


def build_vae_trainer(cfg: Dict, device: torch.device, seed: int, **loss_overrides):
    """The engine of an autoencoder training config (``VAE_TRAIN_CONFIG``'s
    layout) on ``device`` with seeded weights, fp32 masters, and its
    ``VAETrainer`` at the config's LR: bf16 autocast on a GPU, fp32 on the
    CPU.  ``loss_overrides`` replace ``loss_config`` params (``disc_start=0``
    puts the GAN term in from the first step)."""
    import copy

    from ..config import build_autoencoder_engine

    cfg = copy.deepcopy(cfg)
    cfg["model"]["params"]["loss_config"].setdefault("params", {}).update(loss_overrides)
    with device:
        engine = build_autoencoder_engine(cfg)
    engine.randomize_(torch.Generator(device=device).manual_seed(seed)).float()
    trainer = VAETrainer(engine, lr=cfg["model"].get("base_learning_rate", 4.5e-6),
                         autocast_dtype=torch.bfloat16 if device.type == "cuda" else None)
    return engine, trainer


class VAETrainer:
    """The two-optimiser step: the generator pass and its Adam update, then
    the discriminator pass on the updated autoencoder (re-encoded and
    re-decoded, as Lightning's second ``optimizer_idx`` does) and its Adam
    update.  Adam at optax's defaults
    (betas 0.9, 0.999, eps 1e-8); the generator's LR is ``lr * lr_g_factor``.
    ``autocast_dtype``: bf16 on the GPU over fp32 masters (the kernels take
    bf16), None (fp32) on the CPU."""

    def __init__(self, engine: AutoencodingEngine, lr: float = 4.5e-6,
                 lr_g_factor: float = 1.0, autocast_dtype: Optional[torch.dtype] = None):
        self.engine = engine
        self.g_params = engine.generator_parameters()
        self.opt_g = torch.optim.Adam(self.g_params.values(), lr=lr * lr_g_factor,
                                      betas=(0.9, 0.999), eps=1e-8)
        self.opt_d = torch.optim.Adam(engine.disc.parameters(), lr=lr, betas=(0.9, 0.999),
                                      eps=1e-8)
        self.autocast_dtype = autocast_dtype
        self.step = 0

    def _autocast(self, device: torch.device):
        if self.autocast_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.autocast_dtype)

    def train_step(self, x, generator: Optional[torch.Generator] = None,
                   noise_g: Optional[torch.Tensor] = None,
                   noise_d: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One step on the images ``x`` (N, H, W, 3); the two passes draw
        separate posterior noise from ``generator`` unless ``noise_g`` /
        ``noise_d`` inject it.  Returns the detached logs, ``train/{key}``."""
        eng = self.engine
        eng.train()
        self.opt_g.zero_grad(set_to_none=True)
        with self._autocast(x.device):
            g_loss, g_log = eng.generator_loss(x, self.step, generator, noise_g)
        g_loss.backward(inputs=list(self.g_params.values()))
        self.opt_g.step()

        self.opt_d.zero_grad(set_to_none=True)
        with self._autocast(x.device):
            d_loss, d_log = eng.discriminator_loss(x, self.step, generator, noise_d)
        d_loss.backward()
        self.opt_d.step()
        self.step += 1
        return {f"train/{k}": v for k, v in {**g_log, **d_log}.items()}
