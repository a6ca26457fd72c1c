"""The TVI2V training step, port against the JAX package, on the CPU in fp32
at the tiny config (``__graft_entry__._TINY`` widths, 3 frames, an 8x8
latent) with CFCA (``center_self``) and the appearance ControlNet
(``controlnet_img``), the same weights (through ``from_jax``), the same
batch (``cond_img`` the centre frame) and the same injected draws (VAE
posterior noise, sigma, noise, offset noise), under ``spatial_tv2v``, the
policy ``TVI2V_TRAIN_CONFIG``'s ``freeze_model: spatial`` maps to; the
port's three networks carry ``use_checkpoint`` as the recipe builds them:

* the loss, at 1e-5 relative;
* the gradient of every trainable parameter, at 1e-4 of the largest
  gradient magnitude against the same step with the port's network in
  fp64 (measured 7.0e-5, at ``unet.input_blocks_temporal.0.weight``), and
  at 5e-4 of it against the JAX gradient, which is itself 2.9e-4 of it
  from that fp64 gradient at the same tensor (flax's fast variance in the
  temporal GroupNorms, whose groups hold one channel x T values; the port
  and JAX differ by 2.7e-4 there);
* the port's trainable set equal to the JAX ``freeze_mask``, name for name:
  the UNet's temporal layers, the CFCA's ``*_temporal_ca`` and the whole
  ``controlnet_img``;
* after one AdamW step fed the JAX gradients, the trainable parameters at
  1e-5 of optax's and every frozen tensor bit-identical.

Without a training generator (the parity runs here) the reference frame's
latent is the posterior mode on both sides; with one, the port samples it
from that generator, as the JAX embedder samples it with its rng.
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
from ccedit_tpu.conditioning.embedders import VAEEmbedder as JaxVAEEmbedder
from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
from ccedit_tpu.diffusion.loss import StandardDiffusionLoss as JaxLoss
from ccedit_tpu.diffusion.sigma_sampling import DiscreteSampling as JaxSampling
from ccedit_tpu.models.engine import CCEditEngine as JaxEngine
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu.train.freeze import freeze_mask as jax_freeze_mask
from ccedit_tpu_torch import config
from ccedit_tpu_torch.conditioning.annotators.base import AnnotatorEmbedder
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder, VAEEmbedder
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
APPEARANCE = dict(hint_channels=4, input_hint_identity=True, no_add_x=True,
                  disable_text_ca=True)
CFCA = dict(enable_attention3d_crossframe=True, st3dca_ca_type="center_self")
LR = 1e-4
PROMPT = "masterpiece, a robot bear walking"
LOSS = dict(loss_type="l2", offset_noise_level=0.1, offset_noise_varying_dim=3)
POLICY = config.freeze_policy(config.TVI2V_TRAIN_CONFIG["model"]["params"])
NETWORKS = ("unet", "controlnet", "controlnet_img")


def _random(shapes, rs):
    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if leaf == "scale" else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def _port_engine(params):
    """The port's tiny TVI2V training engine, every network with
    ``use_checkpoint`` (the recipe's), on the JAX weights."""
    net = params["network"]
    unet = tun.UNetModel(unet_type="pseudo-3d", use_checkpoint=True, **CFCA, **_TINY)
    unet.load_state_dict(from_jax("unet", net["unet"]))
    controlnet = tcn.ControlNet2D(hint_channels=3, use_checkpoint=True, **_TINY)
    controlnet.load_state_dict(from_jax("controlnet", net["controlnet"]))
    controlnet_img = tcn.ControlNet2D(use_checkpoint=True, **APPEARANCE, **_TINY)
    controlnet_img.load_state_dict(from_jax("controlnet", net["controlnet_img"]))
    vae = tvae.AutoencoderKL(**VAE)
    vae.load_reference_state_dict(from_jax("vae", params["vae"]))
    clip = tclip.CLIPTextModel(**CLIP)
    clip.load_state_dict(from_jax("clip", params["conditioner"]["embedder_0"]))
    return CCEditEngine(
        network=tcn.CCEditNetwork(unet, controlnet, controlnet_img), denoiser=DiscreteDenoiser(),
        sampler=DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=2),
        conditioner=Conditioner([EmbedderSpec(CLIPTextEmbedder(clip), "txt"),
                                 EmbedderSpec(AnnotatorEmbedder("depth_midas", allow_fake=True),
                                              "control_hint"),
                                 EmbedderSpec(VAEEmbedder(), "cond_img")]),
        vae=vae, loss_fn=StandardDiffusionLoss(DiscreteSampling(), **LOSS), freeze_policy=POLICY)


def _as_port(tree):
    return {f"{b}.{n}": t for b in NETWORKS for n, t in from_jax(
        "unet" if b == "unet" else "controlnet", tree[b]).items()}


@pytest.fixture(scope="module")
def step():
    return _step()


def _step():
    """One TVI2V training step on each side; returns both sides' results."""
    rs = np.random.RandomState(12)
    key = jax.random.PRNGKey(0)
    jnet = jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **CFCA, **_TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY),
        controlnet_img=jcn.ControlNet2D(**APPEARANCE, **_TINY))
    jvae_m = jvae.AutoencoderKL(resolution=H, **VAE)
    jclip_m = jclip.CLIPTextModel(**CLIP)
    z0 = jnp.zeros((1, T, H // 8, W // 8, 4))
    cond0 = {"crossattn": jnp.zeros((1, 77, 16)), "control_hint": jnp.zeros((1, T, H, W, 3)),
             "cond_feat": jnp.zeros((1, H // 8, W // 8, 4))}
    params = {
        "network": _random(jax.eval_shape(jnet.init, key, z0, jnp.zeros((1,)), cond0), rs),
        "vae": _random(jax.eval_shape(
            lambda: jvae_m.init(key, jnp.zeros((1, H, W, 3)), None, False)), rs),
        "conditioner": {"embedder_0": _random(jax.eval_shape(
            jclip_m.init, key, jnp.zeros((1, 77), jnp.int32)), rs),
            "embedder_1": None, "embedder_2": None},
    }
    jtext = JaxCLIPEmbedder()
    jtext.model = jclip_m
    jeng = JaxEngine(
        network=jnet, denoiser=JaxDenoiser(scaling="eps", weighting="eps"), sampler=None,
        conditioner=JaxConditioner([JaxSpec(jtext, "txt"),
                                    JaxSpec(JaxAnnotator("depth_midas", allow_fake=True),
                                            "control_hint"),
                                    JaxSpec(JaxVAEEmbedder(), "cond_img")]),
        vae=jvae_m, loss_fn=JaxLoss(JaxSampling(), **LOSS), freeze_policy=POLICY)
    jeng._wire_vae_embedders(params["vae"])

    clip = rs.uniform(-1, 1, (1, T, H, W, 3)).astype(np.float32)
    batch = {"jpg": clip, "txt": [PROMPT], "control_hint": clip,
             "cond_img": clip[:, T // 2].copy()}
    zshape = (1, T, H // 8, W // 8, 4)
    draws = dict(vae_noise=rs.standard_normal(zshape).astype(np.float32),
                 noise=rs.standard_normal(zshape).astype(np.float32),
                 sigmas=DiscreteSampling().sigmas_np[[300]],
                 offset=rs.standard_normal((1, 4, T, 1, 1)).astype(np.float32)
                 .transpose(0, 2, 3, 4, 1).copy())

    # JAX: the pieces of CCEditEngine.loss with the draws injected (no rng:
    # the reference frame's latent is the posterior mode)
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
    mask = trav.flatten_dict(jax_freeze_mask(params["network"], POLICY))
    flat = trav.flatten_dict(params["network"])
    trainable = {k: v for k, v in flat.items() if mask[k]}
    tx = optax.adamw(LR, weight_decay=1e-2)
    updates, _ = tx.update({k: v for k, v in trav.flatten_dict(jgrads).items() if mask[k]},
                           tx.init(trainable), trainable)
    new_net = trav.unflatten_dict({**flat, **optax.apply_updates(trainable, updates)})
    jax_trainable = []
    for branch, tree in jax_freeze_mask(params["network"], POLICY).items():
        # carry the mask through the weight converter: 1.0 = trainable
        as_arrays = jax.tree_util.tree_map(lambda m, w: np.full(w.shape, float(m), np.float32),
                                           tree, params["network"][branch])
        kind = "unet" if branch == "unet" else "controlnet"
        jax_trainable += [f"{branch}.{n}" for n, v in from_jax(kind, as_arrays).items()
                          if bool(v.max())]

    overrides = {k: torch.from_numpy(v) for k, v in draws.items()}
    teng = _port_engine(params)
    optimizer = teng.make_optimizer(LR)
    before = {n: p.detach().clone() for n, p in teng.network.named_parameters()}
    tloss = teng.backward_step(batch, **overrides)
    tgrads = {n: p.grad.clone() for n, p in teng.trainable_parameters().items()}
    jgrads = _as_port(jgrads)
    for n, p in teng.trainable_parameters().items():
        p.grad = jgrads[n].clone()
    optimizer.step()
    return dict(jloss=float(jloss), jgrads=jgrads, jnew=_as_port(new_net), tloss=float(tloss),
                tgrads=tgrads, teng=teng, before=before, jax_trainable=sorted(jax_trainable),
                params=params, batch=batch, overrides=overrides)


def test_recipe_config():
    """``TVI2V_TRAIN_CONFIG``: TVI2V's network and conditioning with
    ``use_checkpoint`` on all three networks, the TV2V recipe's loss, ucg,
    schedule and freeze policy, batch 1 of 17 frames at 384x512, LR 5e-5."""
    p = config.TVI2V_TRAIN_CONFIG["model"]["params"]
    tv2v = config.TV2V_TRAIN_CONFIG["model"]["params"]
    net = p["network_config"]["params"]
    assert net["ST3DCA_ca_type"] == "center_self" and net["enable_attention3d_crossframe"]
    assert all(n["use_checkpoint"] for n in (net, net["controlnet_config"]["params"],
                                             net["controlnet_img_config"]["params"]))
    for k in ("loss_fn_config", "scheduler_config", "freeze_model"):
        assert p[k] == tv2v[k], k
    assert p["denoiser_config"]["params"]["weighting_config"]["target"].endswith("EpsWeighting")
    embs = p["conditioner_config"]["params"]["emb_models"]
    assert [e["input_key"] for e in embs] == ["txt", "control_hint", "cond_img"]
    assert embs[0]["ucg_rate"] == 0.1 and "ucg_rate" not in embs[2]
    assert p["base_learning_rate"] == 5e-5 and POLICY == "spatial_tv2v"
    data = config.TVI2V_TRAIN_CONFIG["data"]["params"]
    assert (data["batch_size"], data["train"]["params"]["video_length"],
            data["train"]["params"]["resolution"]) == (1, 17, [384, 512])
    # the ZoeDepth variant: one dotlist override, to TVI2V_ZOE_CONFIG's hint
    zoe = config.apply_dotlist(config.TVI2V_TRAIN_CONFIG, [
        "model.params.conditioner_config.params.emb_models.1.target="
        "sgm.modules.encoders.modules.DepthZoeEncoder"])
    zoe_embs = zoe["model"]["params"]["conditioner_config"]["params"]["emb_models"]
    assert zoe_embs[1:] == (config.TVI2V_ZOE_CONFIG["model"]["params"]["conditioner_config"]
                            ["params"]["emb_models"][1:])


def test_loss_matches_jax(step):
    assert np.isfinite(step["tloss"]) and step["tloss"] > 0
    np.testing.assert_allclose(step["tloss"], step["jloss"], rtol=1e-5, atol=0)


def test_trainable_set_is_the_jax_mask(step):
    names = sorted(step["tgrads"])
    assert names == step["jax_trainable"]
    assert any(n.startswith("controlnet_img.") for n in names)
    assert any("_temporal_ca" in n for n in names)
    assert not any(n.startswith("controlnet.") for n in names)
    unet = [n for n in names if n.startswith("unet.")]
    assert unet and all("temporal" in n for n in unet)


def _fp64_grads(step):
    """The trainable gradients of the same step with the port's network in
    fp64 (the conditioning and the latent from the fp32 VAE and text
    tower, as in the fp32 step)."""
    eng = _port_engine(step["params"])
    eng.network.double()
    eng.make_optimizer(LR)
    ov = step["overrides"]
    with torch.no_grad():
        cond = eng.conditioner.embed(eng.conditioner.prepare(step["batch"]))
        cond = {k: v.double() for k, v in cond.items()}
        z = eng.encode_first_stage(torch.from_numpy(step["batch"]["jpg"]),
                                   noise=ov["vae_noise"]).double()
    losses = eng.loss_fn(lambda x, c_noise, c: eng.network(x, c_noise, c), eng.denoiser, cond,
                         z, noise_override=ov["noise"].double(), sigma_override=ov["sigmas"],
                         offset_override=ov["offset"].double())
    losses.mean().backward()
    return {n: p.grad for n, p in eng.trainable_parameters().items()}


def test_trainable_grads_match_fp64_and_jax(step):
    scale = max(float(g.abs().max()) for g in step["tgrads"].values())
    assert scale > 0
    exact = _fp64_grads(step)
    assert sorted(exact) == sorted(step["tgrads"])
    for name, grad in step["tgrads"].items():
        np.testing.assert_allclose(grad.double().numpy(), exact[name].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
        np.testing.assert_allclose(grad.numpy(), step["jgrads"][name].numpy(), rtol=0,
                                   atol=5e-4 * scale, err_msg=name)
    for prefix in ("controlnet_img.", "unet."):  # both branches get a gradient
        assert any(float(g.abs().max()) > 0 for n, g in step["tgrads"].items()
                   if n.startswith(prefix) and "_temporal_ca" not in n), prefix
    assert any(float(g.abs().max()) > 0 for n, g in step["tgrads"].items()
               if "_temporal_ca" in n)


def test_adamw_step_matches_optax_and_frozen_stay(step):
    params = dict(step["teng"].network.named_parameters())
    for name, p in params.items():
        if name in step["tgrads"]:
            np.testing.assert_allclose(p.detach().numpy(), step["jnew"][name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
            assert not torch.equal(p, step["before"][name]), name
        else:
            assert torch.equal(p, step["before"][name]), name
            assert p.grad is None, name


def test_training_generator_samples_the_reference_latent(step):
    """With a generator the reference frame's latent is a posterior sample
    (the JAX embedder's rng path), drawn from that generator: reproducible
    from its seed, and not the mode."""
    eng = step["teng"]
    prepared = eng.conditioner.prepare({"cond_img": step["batch"]["cond_img"]})
    with torch.no_grad():
        mode = eng.conditioner.embed(prepared)["cond_feat"]
        draws = [eng.conditioner.embed(prepared, generator=torch.Generator().manual_seed(s))
                 ["cond_feat"] for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert not torch.allclose(draws[0], mode)
