"""Training the frame-interpolation network, port against the JAX package,
on the CPU in fp32: the tiny interpolation engine (the widths of
``test_torch_port_interp.py``, 4 frames of 64x64, ``use_checkpoint`` on its
three networks as the recipe builds them), the same weights (through
``from_jax``), the same batch (``interpolate_first_last`` the clip's first
and last frames, as ``data/dataset.py`` yields it) and the same injected
draws (VAE posterior noise, sigma, noise, offset noise), under
``spatial_tv2v``, the policy ``INTERP_TRAIN_CONFIG``'s ``freeze_model:
spatial`` maps to:

* the loss, at 1e-5 relative;
* the trainable gradients at 1e-4 of the largest gradient against the
  port's own fp64 step and at 5e-4 of it against the jitted JAX
  ``value_and_grad`` (the tolerances of the TVI2V step, whose JAX fp32
  gradient is itself 2.9e-4 of it from fp64);
* the trainable set equal to the JAX ``freeze_mask``: the UNet's temporal
  layers and the whole ``controlnet_img``;
* ``INTERP_TRAIN_CONFIG``'s fields;
* ``cli/train.py`` on ``INTERP_TRAIN_CONFIG`` narrowed by dotlist
  overrides: 3 steps with validation sampling, then ``-r`` to step 5, only
  the trainable set moving.

Without a training generator the first and last frames' latents are the
posterior mode on both sides; with one, the port samples them from it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

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
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu.train.freeze import freeze_mask as jax_freeze_mask
from ccedit_tpu_torch import config
from ccedit_tpu_torch.cli import train as train_cli
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
from ccedit_tpu_torch.modules.clip import CLIPTextModel
from test_torch_port_interp import APPEARANCE, CLIP, TINY, VAE, fill, jax_interp_network

torch.set_num_threads(1)
T, H, W = 4, 64, 64
LR = 1e-4
PROMPT = "masterpiece, a robot bear walking"
LOSS = dict(loss_type="l2", offset_noise_level=0.1, offset_noise_varying_dim=3)
POLICY = config.freeze_policy(config.INTERP_TRAIN_CONFIG["model"]["params"])
NETWORKS = ("unet", "controlnet", "controlnet_img")


def _port_engine(params):
    net = params["network"]
    unet = tun.UNetModel(unet_type="pseudo-3d", use_checkpoint=True, **TINY)
    unet.load_state_dict(from_jax("unet", net["unet"]))
    controlnet = tcn.ControlNet2D(hint_channels=3, use_checkpoint=True, **TINY)
    controlnet.load_state_dict(from_jax("controlnet", net["controlnet"]))
    controlnet_img = tcn.ControlNet2D(use_checkpoint=True, **APPEARANCE, **TINY)
    controlnet_img.load_state_dict(from_jax("controlnet", net["controlnet_img"]))
    vae = tvae.AutoencoderKL(**VAE)
    vae.load_reference_state_dict(from_jax("vae", params["vae"]))
    clip = tclip.CLIPTextModel(**CLIP)
    clip.load_state_dict(from_jax("clip", params["conditioner"]["embedder_0"]))
    return CCEditEngine(
        network=tcn.CCEditNetwork(unet, controlnet, controlnet_img, interpolate=True),
        denoiser=DiscreteDenoiser(),
        sampler=DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=2),
        conditioner=Conditioner([EmbedderSpec(CLIPTextEmbedder(clip), "txt"),
                                 EmbedderSpec(AnnotatorEmbedder("depth_midas", allow_fake=True),
                                              "control_hint"),
                                 EmbedderSpec(VAEEmbedder(), "interpolate_first_last")]),
        vae=vae, loss_fn=StandardDiffusionLoss(DiscreteSampling(), **LOSS), freeze_policy=POLICY)


def _as_port(tree):
    return {f"{b}.{n}": t for b in NETWORKS for n, t in from_jax(
        "unet" if b == "unet" else "controlnet", tree[b]).items()}


@pytest.fixture(scope="module")
def step():
    """One interpolation training step on each side."""
    rs = np.random.RandomState(30)
    key = jax.random.PRNGKey(0)
    jnet = jax_interp_network()
    jvae_m = jvae.AutoencoderKL(resolution=H, **VAE)
    jclip_m = jclip.CLIPTextModel(**CLIP)
    z0 = jnp.zeros((1, T, H // 8, W // 8, 4))
    cond0 = {"crossattn": jnp.zeros((1, 77, 16)), "control_hint": jnp.zeros((1, T, H, W, 3)),
             "interpolate_first_last": jnp.zeros((1, 2, H // 8, W // 8, 4))}
    params = {
        "network": fill(jax.eval_shape(jnet.init, key, z0, jnp.zeros((1,)), cond0), rs),
        "vae": fill(jax.eval_shape(
            lambda: jvae_m.init(key, jnp.zeros((1, H, W, 3)), None, False)), rs),
        "conditioner": {"embedder_0": fill(jax.eval_shape(
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
                                    JaxSpec(JaxVAEEmbedder(), "interpolate_first_last")]),
        vae=jvae_m, loss_fn=JaxLoss(JaxSampling(), **LOSS), freeze_policy=POLICY)
    jeng._wire_vae_embedders(params["vae"])

    clip = rs.uniform(-1, 1, (1, T, H, W, 3)).astype(np.float32)
    batch = {"jpg": clip, "txt": [PROMPT], "control_hint": clip,
             "interpolate_first_last": np.stack([clip[:, 0], clip[:, -1]], axis=1)}
    zshape = (1, T, H // 8, W // 8, 4)
    draws = dict(vae_noise=rs.standard_normal(zshape).astype(np.float32),
                 noise=rs.standard_normal(zshape).astype(np.float32),
                 sigmas=DiscreteSampling().sigmas_np[[300]],
                 offset=rs.standard_normal((1, 4, T, 1, 1)).astype(np.float32)
                 .transpose(0, 2, 3, 4, 1).copy())

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
    jax_trainable = []
    for branch, tree in jax_freeze_mask(params["network"], POLICY).items():
        as_arrays = jax.tree_util.tree_map(lambda m, w: np.full(w.shape, float(m), np.float32),
                                           tree, params["network"][branch])
        kind = "unet" if branch == "unet" else "controlnet"
        jax_trainable += [f"{branch}.{n}" for n, v in from_jax(kind, as_arrays).items()
                          if bool(v.max())]

    overrides = {k: torch.from_numpy(v) for k, v in draws.items()}
    teng = _port_engine(params)
    teng.make_optimizer(LR)
    tloss = teng.backward_step(batch, **overrides)
    tgrads = {n: p.grad.clone() for n, p in teng.trainable_parameters().items()}
    return dict(jloss=float(jloss), jgrads=_as_port(jgrads), tloss=float(tloss), tgrads=tgrads,
                teng=teng, jax_trainable=sorted(jax_trainable), params=params, batch=batch,
                overrides=overrides)


def test_recipe_config():
    """``INTERP_TRAIN_CONFIG``: the interpolation network and engine, no
    CFCA, TVI2V's appearance ControlNet as ``controlnet_img``, a
    ``VAEEmbedder`` on ``interpolate_first_last``, the TV2V recipe's
    settings, TVI2V's batch, geometry and LR."""
    cfg = config.INTERP_TRAIN_CONFIG
    p, tv2v = cfg["model"]["params"], config.TV2V_TRAIN_CONFIG["model"]["params"]
    assert cfg["model"]["target"].endswith("VideoDiffusionEngineTV2VInterpolate")
    net = p["network_config"]
    assert net["target"].endswith("ControlledUNetModel3DTV2VInterpolate")
    assert not net["params"].get("enable_attention3d_crossframe")
    appearance = dict(config.TVI2V_CONFIG["model"]["params"]["network_config"]["params"]
                      ["controlnet_img_config"]["params"], use_checkpoint=True)
    assert net["params"]["controlnet_img_config"]["params"] == appearance
    assert all(n["use_checkpoint"] for n in (net["params"], net["params"]["controlnet_config"]
                                             ["params"], appearance))
    for k in ("loss_fn_config", "scheduler_config", "freeze_model", "denoiser_config"):
        assert p[k] == tv2v[k], k
    embs = p["conditioner_config"]["params"]["emb_models"]
    assert [e["input_key"] for e in embs] == ["txt", "control_hint", "interpolate_first_last"]
    assert embs[2]["target"].endswith("VAEEmbedder") and embs[0]["ucg_rate"] == 0.1
    assert p["base_learning_rate"] == 5e-5 and POLICY == "spatial_tv2v"
    assert cfg["data"] == config.TVI2V_TRAIN_CONFIG["data"]
    with torch.device("meta"):
        engine = config.build_engine(cfg, fake_annotator=True)
    assert engine.network.interpolate and engine.freeze_policy == "spatial_tv2v"


def test_loss_matches_jax(step):
    assert np.isfinite(step["tloss"]) and step["tloss"] > 0
    np.testing.assert_allclose(step["tloss"], step["jloss"], rtol=1e-5, atol=0)


def test_trainable_set_is_the_jax_mask(step):
    names = sorted(step["tgrads"])
    assert names == step["jax_trainable"]
    assert any(n.startswith("controlnet_img.") for n in names)
    assert not any(n.startswith("controlnet.") for n in names)
    unet = [n for n in names if n.startswith("unet.")]
    assert unet and all("temporal" in n for n in unet)


def _fp64_grads(step):
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
                   if n.startswith(prefix)), prefix


def test_training_generator_samples_the_first_last_latents(step):
    """With a generator the first and last frames' latents are posterior
    samples, (B, 2, h, w, 4), drawn from that generator."""
    eng = step["teng"]
    prepared = eng.conditioner.prepare(
        {"interpolate_first_last": step["batch"]["interpolate_first_last"]})
    with torch.no_grad():
        mode = eng.conditioner.embed(prepared)["interpolate_first_last"]
        draws = [eng.conditioner.embed(prepared, generator=torch.Generator().manual_seed(s))
                 ["interpolate_first_last"] for s in (3, 3, 4)]
    assert tuple(mode.shape) == (1, 2, H // 8, W // 8, 4)
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert not torch.allclose(draws[0], mode)


SEED = 11
_NET = "model.params.network_config.params"
NARROW = [f"{prefix}.{k}={v}" for prefix in (_NET, f"{_NET}.controlnet_config.params",
                                             f"{_NET}.controlnet_img_config.params")
          for k, v in (("model_channels", 32), ("attention_resolutions", "[2,1]"),
                       ("num_res_blocks", 1), ("channel_mult", "[1,2]"), ("num_heads", 2),
                       ("context_dim", 16))] + [
    "model.params.first_stage_config.params.ddconfig.ch=32",
    "model.params.first_stage_config.params.ddconfig.num_res_blocks=1",
    "model.params.conditioner_config.params.emb_models.1.params.fake_annotator=true",
    "data.params.train.params.video_length=3", "data.params.train.params.resolution=[64,64]"]
COMMON = ["--device", "cpu", "--synthetic_data", "--ckpt_every", "1", "--log_every", "1",
          "--seed", str(SEED), "--sample_every", "2", "--sample_steps", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``INTERP_TRAIN_CONFIG`` narrowed by dotlist, 3 steps, then ``-r`` to 5."""
    root = tmp_path_factory.mktemp("interp_train_cli")
    base = root / "interp_train.yaml"
    base.write_text(yaml.safe_dump(config.INTERP_TRAIN_CONFIG))
    clip_model = config.CLIPTextModel
    config.CLIPTextModel = lambda: CLIPTextModel(width=16, heads=2, layers=1)
    try:
        _, first = train_cli.main(["-b", str(base), "--logdir", str(root / "logs"),
                                   "--max_steps", "3"] + COMMON + NARROW)
        logdir = next((root / "logs").glob("*_interp_train"))
        engine, second = train_cli.main(["-r", str(logdir), "--max_steps", "5"] + COMMON)
        merged = json.loads((logdir / "configs" / "merged.json").read_text())
        fresh = train_cli.build_train_engine(merged, torch.device("cpu"), SEED)
    finally:
        config.CLIPTextModel = clip_model
    return dict(logdir=logdir, first=first, second=second, engine=engine, fresh=fresh)


def test_cli_trains_samples_and_resumes(runs):
    assert runs["first"].step == 3 and runs["second"].step == 5
    assert runs["engine"].network.interpolate
    rows = [json.loads(r) for r in (runs["logdir"] / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5] and all(r["loss"] > 0 for r in rows)
    ckpts = sorted(p.name for p in (runs["logdir"] / "checkpoints").glob("*.pt"))
    assert ckpts == [f"step_00000000{n}.pt" for n in (3, 4, 5)]
    images = sorted(p.name for p in (runs["logdir"] / "images").iterdir())
    assert images == [f"step{s:08d}_{kind}" for s in (1, 2, 4)
                      for kind in ("input.gif", "panel.png", "sample.gif")]


def test_cli_moves_only_the_trainable_set(runs):
    trained, fresh = runs["engine"], runs["fresh"]
    trainable = set(trained.trainable_parameters())
    assert any(n.startswith("controlnet_img.") for n in trainable)
    assert not any(n.startswith("controlnet.") for n in trainable)
    moved = 0
    for module in ("network", "vae", "conditioner"):
        before = dict(getattr(fresh, module).named_parameters())
        for name, p in getattr(trained, module).named_parameters():
            same = torch.equal(p.detach(), before[name].detach())
            if module == "network" and name in trainable:
                moved += not same
            else:
                assert same, f"frozen {module} parameter changed: {name}"
    assert moved == len(trainable)
