"""The TV2V training step end to end, port against the JAX package, on the
CPU in fp32 at the tiny config (``__graft_entry__._TINY`` widths, 3 frames,
an 8x8 latent), with the same weights (through ``from_jax``), the same batch
and the same injected draws (VAE posterior noise, sigma, noise, offset
noise), under the TV2V recipe's ``spatial_tv2v`` freeze policy:

* the loss, at 1e-5 relative;
* the gradient of every trainable parameter, at 1e-4 of the largest
  gradient magnitude (the fp32 noise floor of this network is of that
  order: the port's gradients differ from those of the same step with the
  network in fp64 by up to 1.3e-4 of it, at the first temporal layers);
* the parameters after one AdamW step (``torch.optim.AdamW`` against
  ``optax.adamw(weight_decay=1e-2)``), at 1e-5.  Both optimizers take the
  same (JAX) gradients: Adam's first update is lr * g / (|g| + eps) per
  element, which turns fp32 noise into a full-size step wherever the true
  gradient is zero (here a temporal conv's bias in front of a GroupNorm of
  one channel a group, whose gradients are ~1e-8 on both sides);
* frozen parameters bit-identical after the step, and the gradient with
  ``use_checkpoint`` on equal to the one with it off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.traverse_util as trav

from __graft_entry__ import _TINY
from ccedit_tpu.conditioning.annotators.base import AnnotatorEmbedder as JaxAnnotator
from ccedit_tpu.conditioning.conditioner import Conditioner as JaxConditioner
from ccedit_tpu.conditioning.conditioner import EmbedderSpec as JaxSpec
from ccedit_tpu.conditioning.embedders import CLIPTextEmbedder as JaxCLIPEmbedder
from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
from ccedit_tpu.diffusion.loss import StandardDiffusionLoss as JaxLoss
from ccedit_tpu.diffusion.sigma_sampling import DiscreteSampling as JaxSampling
from ccedit_tpu.models.engine import CCEditEngine as JaxEngine
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu.train.freeze import freeze_mask as jax_freeze_mask
from ccedit_tpu_torch.conditioning.annotators.base import AnnotatorEmbedder
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder
from ccedit_tpu_torch.diffusion import (DiscreteDenoiser, DiscreteSampling,
                                        DPMPP2SAncestralSampler, LegacyDDPMDiscretization)
from ccedit_tpu_torch.diffusion.loss import StandardDiffusionLoss
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.models.engine import CCEditEngine
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae

torch.set_num_threads(1)
T, H, W = 3, 64, 64
CLIP = dict(width=16, heads=2, layers=1)
VAE = dict(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
LR = 1e-4
PROMPT = "masterpiece, a robot bear walking"
LOSS = dict(loss_type="l2", offset_noise_level=0.1, offset_noise_varying_dim=3)


def _random(shapes, rs):
    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if leaf == "scale" else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def _port_engine(params, use_checkpoint=False):
    unet = tun.UNetModel(unet_type="pseudo-3d", use_checkpoint=use_checkpoint, **_TINY)
    unet.load_state_dict(from_jax("unet", params["network"]["unet"]))
    controlnet = tcn.ControlNet2D(hint_channels=3, use_checkpoint=use_checkpoint, **_TINY)
    controlnet.load_state_dict(from_jax("controlnet", params["network"]["controlnet"]))
    vae = tvae.AutoencoderKL(**VAE)
    vae.load_reference_state_dict(from_jax("vae", params["vae"]))
    clip = tclip.CLIPTextModel(**CLIP)
    clip.load_state_dict(from_jax("clip", params["conditioner"]["embedder_0"]))
    return CCEditEngine(
        network=tcn.CCEditNetwork(unet, controlnet), denoiser=DiscreteDenoiser(),
        sampler=DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=2),
        conditioner=Conditioner([EmbedderSpec(CLIPTextEmbedder(clip), "txt"),
                                 EmbedderSpec(AnnotatorEmbedder("depth_midas", allow_fake=True),
                                              "control_hint")]),
        vae=vae, loss_fn=StandardDiffusionLoss(DiscreteSampling(), **LOSS),
        freeze_policy="spatial_tv2v")


@pytest.fixture(scope="module")
def step():
    """One training step on each side; returns both sides' results."""
    rs = np.random.RandomState(0)
    key = jax.random.PRNGKey(0)
    jnet = jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **_TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY))
    jvae_m = jvae.AutoencoderKL(resolution=H, **VAE)
    jclip_m = jclip.CLIPTextModel(**CLIP)
    z0 = jnp.zeros((1, T, H // 8, W // 8, 4))
    cond0 = {"crossattn": jnp.zeros((1, 77, 16)), "control_hint": jnp.zeros((1, T, H, W, 3))}
    params = {
        "network": _random(jax.eval_shape(jnet.init, key, z0, jnp.zeros((1,)), cond0), rs),
        "vae": _random(jax.eval_shape(
            lambda: jvae_m.init(key, jnp.zeros((1, H, W, 3)), None, False)), rs),
        "conditioner": {"embedder_0": _random(jax.eval_shape(
            jclip_m.init, key, jnp.zeros((1, 77), jnp.int32)), rs), "embedder_1": None},
    }
    jtext = JaxCLIPEmbedder()
    jtext.model = jclip_m
    jeng = JaxEngine(
        network=jnet, denoiser=JaxDenoiser(scaling="eps", weighting="eps"), sampler=None,
        conditioner=JaxConditioner([JaxSpec(jtext, "txt"),
                                    JaxSpec(JaxAnnotator("depth_midas", allow_fake=True),
                                            "control_hint")]),
        vae=jvae_m, loss_fn=JaxLoss(JaxSampling(), **LOSS), freeze_policy="spatial_tv2v")

    clip = rs.uniform(-1, 1, (1, T, H, W, 3)).astype(np.float32)
    batch = {"jpg": clip, "txt": [PROMPT], "control_hint": clip}
    zshape = (1, T, H // 8, W // 8, 4)
    draws = dict(vae_noise=rs.standard_normal(zshape).astype(np.float32),
                 noise=rs.standard_normal(zshape).astype(np.float32),
                 sigmas=DiscreteSampling().sigmas_np[[400]],
                 offset=rs.standard_normal((1, 4, T, 1, 1)).astype(np.float32)
                 .transpose(0, 2, 3, 4, 1).copy())

    # JAX: the pieces of CCEditEngine.loss with the draws injected
    cond = jeng.conditioner.embed(params["conditioner"], jeng.conditioner.prepare(batch))
    moments = jvae_m.apply({"params": params["vae"]}, jnp.asarray(clip),
                           method=jvae.AutoencoderKL.encode_moments)
    post = jvae.DiagonalGaussian(moments)
    z = (post.mean + post.std * draws["vae_noise"]) * jeng.scale_factor

    def loss_fn(net_params):
        return jnp.mean(jeng.loss_fn(
            key, jeng._network_fn(net_params), jeng.denoiser, cond, z,
            noise_override=draws["noise"], sigma_override=draws["sigmas"],
            offset_override=draws["offset"]))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params["network"])
    mask = trav.flatten_dict(jax_freeze_mask(params["network"], "spatial_tv2v"))
    flat = trav.flatten_dict(params["network"])
    trainable = {k: v for k, v in flat.items() if mask[k]}
    tx = optax.adamw(LR, weight_decay=1e-2)
    updates, _ = tx.update({k: v for k, v in trav.flatten_dict(jgrads).items() if mask[k]},
                           tx.init(trainable), trainable)
    new_net = trav.unflatten_dict({**flat, **optax.apply_updates(trainable, updates)})

    def as_port(tree):
        return {f"{b}.{n}": t for b in ("unet", "controlnet")
                for n, t in from_jax(b, tree[b]).items()}

    overrides = {k: torch.from_numpy(v) for k, v in draws.items()}
    teng = _port_engine(params)
    optimizer = teng.make_optimizer(LR)
    before = {n: p.detach().clone() for n, p in teng.network.named_parameters()}
    tloss = teng.backward_step(batch, **overrides)
    tgrads = {n: p.grad.clone() for n, p in teng.trainable_parameters().items()}
    jgrads = as_port(jgrads)
    for n, p in teng.trainable_parameters().items():
        p.grad = jgrads[n].clone()
    optimizer.step()

    ceng = _port_engine(params, use_checkpoint=True)
    ceng.make_optimizer(LR)
    ceng.backward_step(batch, **overrides)
    cgrads = {n: p.grad for n, p in ceng.trainable_parameters().items()}
    return dict(jloss=float(jloss), jgrads=jgrads, jnew=as_port(new_net), tloss=float(tloss),
                tgrads=tgrads, cgrads=cgrads, teng=teng, before=before, params=params,
                batch=batch, overrides=overrides)


def test_loss_matches_jax(step):
    assert np.isfinite(step["tloss"]) and step["tloss"] > 0
    np.testing.assert_allclose(step["tloss"], step["jloss"], rtol=1e-5, atol=0)


def test_trainable_set_is_the_temporal_layers(step):
    names = sorted(step["tgrads"])
    assert names and all(n.startswith("unet.") and "temporal" in n for n in names)
    frozen = [n for n, p in step["teng"].network.named_parameters() if not p.requires_grad]
    assert sorted(set(step["before"]) - set(frozen)) == names


def test_trainable_grads_match_jax(step):
    scale = max(float(g.abs().max()) for g in step["tgrads"].values())
    assert scale > 0
    for name, grad in step["tgrads"].items():
        np.testing.assert_allclose(grad.numpy(), step["jgrads"][name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_adamw_step_matches_optax(step):
    params = dict(step["teng"].network.named_parameters())
    for name in step["tgrads"]:
        np.testing.assert_allclose(params[name].detach().numpy(), step["jnew"][name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(params[name], step["before"][name]), name


def test_frozen_params_bit_identical(step):
    for name, p in step["teng"].network.named_parameters():
        if name not in step["tgrads"]:
            assert torch.equal(p, step["before"][name]), name
            assert p.grad is None, name


def test_train_step_accumulates_then_applies(step):
    """``train_step`` at accumulate=2: the first batch adds half its
    gradient and leaves the weights; the second adds the other half, steps
    AdamW once and clears the grads."""
    eng = _port_engine(step["params"])
    optimizer = eng.make_optimizer(LR)
    trainable = eng.trainable_parameters()
    eng.train_step(step["batch"], optimizer, accumulate=2, apply=False, **step["overrides"])
    for name, p in trainable.items():
        assert torch.equal(p, step["before"][name]), name
        torch.testing.assert_close(p.grad, step["tgrads"][name] / 2, rtol=0, atol=1e-7)
    eng.train_step(step["batch"], optimizer, accumulate=2, apply=True, **step["overrides"])
    for name, p in eng.network.named_parameters():
        assert p.grad is None, name
        assert torch.equal(p, step["before"][name]) != (name in trainable), name


def test_checkpointing_leaves_the_gradient_unchanged(step):
    assert sorted(step["cgrads"]) == sorted(step["tgrads"])
    for name, grad in step["tgrads"].items():
        torch.testing.assert_close(step["cgrads"][name], grad, rtol=0, atol=1e-7)
