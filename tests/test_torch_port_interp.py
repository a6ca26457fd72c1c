"""The frame-interpolation and RAIG networks, port against the JAX package,
on the CPU in fp32, and the routes that feed them:

* ``ControlledUNetModel3DTV2VInterpolate``: the pseudo-3D UNet, the
  structure ControlNet and the appearance ControlNet run on x's first and
  last frames (latent hint, identity hint block, ``no_add_x``,
  ``disable_text_ca``), its taps added onto the UNet's first and last
  frames; 1e-4 absolute;
* ``ControlledUNetModel2DRAIG``: a 2-D UNet whose every transformer
  attends to the appearance branch's bank by ``raig_ref_mapping``; 1e-4;
* ``build_network`` of both packages on inline configs of every target the
  JAX builder names: the same 2-D / pseudo-3D choice, flags and parameter
  count;
* the conditioner's routing of ``interpolate_*`` and CFG's doubling of
  them (and ``ref_context``), key for key;
* the interpolation engine end to end: conditioning (a ``VAEEmbedder`` on
  the first and last frames, (B, 2, H, W, 3) -> (B, 2, h, w, 4)), 2
  sampling steps (CFG 7, DPM++2S-ancestral, the same injected noise) and
  the decode, at 1e-4 of the largest value.

Weights: seeded fills of the JAX trees carried over with ``from_jax``;
T = 4 frames (the temporal GroupNorms' conditioning, see
``test_torch_port_variant_modules.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu import config as jax_config
from ccedit_tpu.conditioning.annotators.base import AnnotatorEmbedder as JaxAnnotator
from ccedit_tpu.conditioning.conditioner import Conditioner as JaxConditioner
from ccedit_tpu.conditioning.conditioner import EmbedderSpec as JaxSpec
from ccedit_tpu.conditioning.embedders import CLIPTextEmbedder as JaxCLIPEmbedder
from ccedit_tpu.conditioning.embedders import VAEEmbedder as JaxVAEEmbedder
from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
from ccedit_tpu.diffusion import LegacyDDPMDiscretization as JaxDisc
from ccedit_tpu.diffusion import guidance as jax_guidance
from ccedit_tpu.diffusion import make_sampler
from ccedit_tpu.models.engine import CCEditEngine as JaxEngine
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch import config
from ccedit_tpu_torch.conditioning.annotators.base import AnnotatorEmbedder
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder, VAEEmbedder
from ccedit_tpu_torch.diffusion import (DiscreteDenoiser, DPMPP2SAncestralSampler,
                                        LegacyDDPMDiscretization, VanillaCFG)
from ccedit_tpu_torch.diffusion import guidance
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.models.engine import CCEditEngine
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae

torch.set_num_threads(1)
TINY = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2, 1), channel_mult=(1, 2), num_heads=2,
            transformer_depth=1, context_dim=16)
APPEARANCE = dict(hint_channels=4, input_hint_identity=True, no_add_x=True,
                  disable_text_ca=True)
STEPS, T, H, W, CFG = 2, 4, 64, 64, 7.0
CLIP = dict(width=16, heads=2, layers=1)
VAE = dict(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
PROMPT, NEGATIVE = "a robot bear walking", "ugly, low quality"


def fill(shapes, rs):
    """Seeded values for a JAX parameter tree: kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2)."""
    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if leaf == "scale" else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close(out, ref, atol=1e-4):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def jax_interp_network():
    return jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **TINY),
        controlnet_img=jcn.ControlNet2D(**APPEARANCE, **TINY), interpolate=True)


def port_interp_network(params):
    unet = tun.UNetModel(unet_type="pseudo-3d", **TINY)
    unet.load_state_dict(from_jax("unet", params["unet"]))
    controlnet = tcn.ControlNet2D(hint_channels=3, **TINY)
    controlnet.load_state_dict(from_jax("controlnet", params["controlnet"]))
    controlnet_img = tcn.ControlNet2D(**APPEARANCE, **TINY)
    controlnet_img.load_state_dict(from_jax("controlnet", params["controlnet_img"]))
    return tcn.CCEditNetwork(unet, controlnet, controlnet_img, interpolate=True).eval()


def test_interpolation_network():
    rs = np.random.RandomState(20)
    x = rs.standard_normal((2, T, 8, 8, 4)).astype(np.float32)
    ts = np.array([10.0, 700.0], np.float32)
    cond = {"crossattn": rs.standard_normal((2, 7, 16)).astype(np.float32),
            "control_hint": rs.uniform(-1, 1, (2, T, 64, 64, 3)).astype(np.float32),
            "interpolate_first_last": rs.standard_normal((2, 2, 8, 8, 4)).astype(np.float32)}
    jn = jax_interp_network()
    params = fill(jax.eval_shape(jn.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(ts), _j(cond)), rs)
    tn = port_interp_network(params)
    # jitted: the whole network compiles in less time than its op-by-op run
    ref = jax.jit(jn.apply)({"params": params}, jnp.asarray(x), jnp.asarray(ts), _j(cond))
    with torch.no_grad():
        out = tn(torch.from_numpy(x), torch.from_numpy(ts), _t(cond))
        swapped = dict(cond, interpolate_first_last=cond["interpolate_first_last"][:, ::-1].copy())
        other = tn(torch.from_numpy(x), torch.from_numpy(ts), _t(swapped))
    _close(out, ref)
    # first and last frames take their own hint: swapping them moves those
    # frames most
    moved = (out - other).abs().amax(dim=(0, 2, 3, 4))
    assert moved[0] > 1e-3 and moved[-1] > 1e-3


def test_raig_network():
    rs = np.random.RandomState(21)
    x = rs.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ts = np.array([10.0, 700.0], np.float32)
    cond = {"crossattn": rs.standard_normal((2, 7, 16)).astype(np.float32),
            "cond_feat": rs.standard_normal((2, 8, 8, 4)).astype(np.float32)}
    jn = jcn.CCEditNetwork(unet=jun.UNetModel(unet_type="2d", enable_ref_attn=True, **TINY),
                           controlnet_img=jcn.ControlNet2D(**APPEARANCE, **TINY), raig=True)
    params = fill(jax.eval_shape(jn.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(ts), _j(cond)), rs)
    unet = tun.UNetModel(unet_type="2d", enable_ref_attn=True, **TINY)
    sd = from_jax("unet", params["unet"])
    assert any(k.endswith("transformer_blocks_ca.0.attn1.to_k.weight") for k in sd)
    unet.load_state_dict(sd)
    controlnet_img = tcn.ControlNet2D(**APPEARANCE, **TINY)
    controlnet_img.load_state_dict(from_jax("controlnet", params["controlnet_img"]))
    tn = tcn.CCEditNetwork(unet, None, controlnet_img, raig=True).eval()
    ref = jn.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), _j(cond))
    with torch.no_grad():
        out = tn(torch.from_numpy(x), torch.from_numpy(ts), _t(cond))
        no_bank = tn.unet(torch.from_numpy(x), torch.from_numpy(ts),
                          context=torch.from_numpy(cond["crossattn"]))
    _close(out, ref)
    assert (out - no_bank).abs().max() > 1e-2  # the reference attention counts


def _net_cfg(target, **params):
    return {"target": f"sgm.modules.diffusionmodules.openaimodel.{target}",
            "params": dict(TINY, **params)}


_CN = {"target": "sgm.modules.diffusionmodules.controlmodel.ControlNet2D",
       "params": dict(TINY, hint_channels=3)}
_CN_IMG = {"target": "sgm.modules.diffusionmodules.controlmodel.ControlNet2D",
           "params": dict(TINY, hint_channels=4, set_input_hint_block_as_identity=True,
                          no_add_x=True, disable_text_ca=True)}
NETWORKS = {
    "UNetModel": _net_cfg("UNetModel"),
    "UNetModel3D": _net_cfg("UNetModel3D", use_learnable_alpha=True),
    "ControlledUNetModel3DTV2V": _net_cfg("ControlledUNetModel3DTV2V", controlnet_config=_CN,
                                          enable_attention3d_crossframe=True,
                                          ST3DCA_ca_type="center_self",
                                          controlnet_img_config=_CN_IMG,
                                          crossframe_type="reference"),
    "ControlledUNetModel3DTV2VInterpolate": _net_cfg(
        "ControlledUNetModel3DTV2VInterpolate", controlnet_config=_CN,
        controlnet_img_config=_CN_IMG),
    "ControlNet3D": _net_cfg("ControlNet3D", disable_temporal_text_ca=False),
    "ControlledUNetModel2DRAIG": _net_cfg("ControlledUNetModel2DRAIG",
                                          controlnet_img_config=_CN_IMG,
                                          use_linear_in_transformer=True),
    "SDXLStyleUNet": _net_cfg("SDXLStyleUNet", num_res_blocks=[1, 2], transformer_depth=[1, 2],
                              adm_in_channels=12, use_scale_shift_norm=True, legacy=True),
}


@pytest.mark.parametrize("target", list(NETWORKS))
def test_build_network_takes_every_jax_target(target):
    cfg = NETWORKS[target]
    jn = jax_config.build_network(cfg)
    tn = config.build_network(cfg)
    video = jn.unet.unet_type == "pseudo-3d"
    assert tn.unet.is_video == video
    assert (tn.interpolate, tn.raig) == (jn.interpolate, jn.raig)
    assert (tn.controlnet is None, tn.controlnet_img is None) == (
        jn.controlnet is None, jn.controlnet_img is None)
    x = jnp.zeros((1, T, 8, 8, 4) if video else (1, 8, 8, 4))
    cond = {"crossattn": jnp.zeros((1, 7, 16))}
    if jn.controlnet is not None:
        cond["control_hint"] = jnp.zeros((1, T, 64, 64, 3))
    if jn.interpolate:
        cond["interpolate_first_last"] = jnp.zeros((1, 2, 8, 8, 4))
    elif jn.controlnet_img is not None:
        cond["cond_feat"] = jnp.zeros((1, 8, 8, 4))
    if cfg["params"].get("adm_in_channels"):
        cond["vector"] = jnp.zeros((1, 12))
    shapes = jax.eval_shape(jn.init, jax.random.PRNGKey(0), x, jnp.zeros((1,)), cond)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in tn.parameters()) == n_jax


@pytest.mark.parametrize("disable_temporal", [False, True])
def test_build_controlnet_builds_controlnet_3d(disable_temporal):
    """``build_controlnet`` of a ``ControlNet3D`` target: the pseudo-3D
    branch, with the JAX module's parameter count; composed networks take
    ``ControlNet2D`` branches only, as the JAX builder builds them."""
    cfg = {"target": "sgm.modules.diffusionmodules.controlmodel.ControlNet3D",
           "params": dict(TINY, disable_temporal=disable_temporal)}
    cn = config.build_controlnet(cfg)
    assert isinstance(cn, tcn.ControlNet3D) and cn.disable_temporal == disable_temporal
    jm = jcn.ControlNet3D(**TINY, disable_temporal=disable_temporal)
    x, hint = jnp.zeros((1, T, 8, 8, 4)), jnp.zeros((1, T, 8, 8, 4))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, hint, jnp.zeros((1,)),
                            jnp.zeros((1, 7, 16)))
    assert sum(p.numel() for p in cn.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with pytest.raises(KeyError, match="ControlNet3D"):
        config.build_network(_net_cfg("ControlledUNetModel3DTV2V", controlnet_config=cfg))


def test_remat_policy_is_refused_by_name():
    with pytest.raises(KeyError, match="remat_policy"):
        config.build_network(_net_cfg("UNetModel3D", remat_policy="dots_saveable"))


@pytest.mark.parametrize("ndim", [2, 3, 4, 5])
def test_conditioner_routes_the_interpolate_keys(ndim):
    for key in ("interpolate_first", "interpolate_last", "interpolate_first_last", "cond_img",
                "control_hint", "txt", "other"):
        assert (EmbedderSpec(None, key).output_key(ndim)
                == JaxSpec(None, key).output_key(ndim)), (key, ndim)


def test_cfg_doubles_the_interpolate_keys_and_the_bank():
    assert guidance.DOUBLED_KEYS == jax_guidance.DOUBLED_KEYS
    rs = np.random.RandomState(22)
    c = {k: rs.standard_normal((1, 2, 3)).astype(np.float32) for k in
         ("interpolate_first", "interpolate_last", "interpolate_first_last", "ref_context",
          "crossattn")}
    c["passthrough"] = rs.standard_normal((1, 2, 3)).astype(np.float32)
    uc = {k: v + 1 for k, v in c.items()}
    ours = VanillaCFG(7.0).prepare_cond(_t(c), _t(uc))
    theirs = jax_guidance.VanillaCFG(7.0).prepare_cond(_j(c), _j(uc))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    assert ours["interpolate_first_last"].shape[0] == 2 and ours["passthrough"].shape[0] == 1


@pytest.fixture(scope="module")
def engines():
    """The tiny interpolation engine on both sides: CLIP text, the stand-in
    depth hint and a ``VAEEmbedder`` on ``interpolate_first_last``."""
    rs = np.random.RandomState(23)
    key = jax.random.PRNGKey(0)
    jnet = jax_interp_network()
    jvae_m = jvae.AutoencoderKL(resolution=H, **VAE)
    jclip_m = jclip.CLIPTextModel(**CLIP)
    z = jnp.zeros((1, T, H // 8, W // 8, 4))
    cond = {"crossattn": jnp.zeros((1, 77, 16)), "control_hint": jnp.zeros((1, T, H, W, 3)),
            "interpolate_first_last": jnp.zeros((1, 2, H // 8, W // 8, 4))}
    params = {
        "network": fill(jax.eval_shape(jnet.init, key, z, jnp.zeros((1,)), cond), rs),
        "vae": fill(jax.eval_shape(
            lambda: jvae_m.init(key, jnp.zeros((1, H, W, 3)), None, False)), rs),
        "conditioner": {"embedder_0": fill(jax.eval_shape(
            jclip_m.init, key, jnp.zeros((1, 77), jnp.int32)), rs),
            "embedder_1": None, "embedder_2": None},
    }
    jtext = JaxCLIPEmbedder()
    jtext.model = jclip_m
    jeng = JaxEngine(
        network=jnet, denoiser=JaxDenoiser(scaling="eps", weighting="eps"),
        sampler=make_sampler("dpmpp_2s_ancestral", discretization=JaxDisc(), num_steps=STEPS),
        conditioner=JaxConditioner([JaxSpec(jtext, "txt"),
                                    JaxSpec(JaxAnnotator("depth_midas", allow_fake=True),
                                            "control_hint"),
                                    JaxSpec(JaxVAEEmbedder(), "interpolate_first_last")]),
        vae=jvae_m, guider=jax_guidance.VanillaCFG(scale=CFG))
    jeng._wire_vae_embedders(params["vae"])

    vae = tvae.AutoencoderKL(**VAE)
    vae.load_reference_state_dict(from_jax("vae", params["vae"]))
    clip = tclip.CLIPTextModel(**CLIP)
    clip.load_state_dict(from_jax("clip", params["conditioner"]["embedder_0"]))
    teng = CCEditEngine(
        network=port_interp_network(params["network"]), denoiser=DiscreteDenoiser(),
        sampler=DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=STEPS),
        conditioner=Conditioner([EmbedderSpec(CLIPTextEmbedder(clip), "txt"),
                                 EmbedderSpec(AnnotatorEmbedder("depth_midas", allow_fake=True),
                                              "control_hint"),
                                 EmbedderSpec(VAEEmbedder(), "interpolate_first_last")]),
        vae=vae.eval(), guider=VanillaCFG(scale=CFG))
    clip_px = rs.uniform(-1, 1, (1, T, H, W, 3)).astype(np.float32)
    shape = (1, T, H // 8, W // 8, 4)
    return dict(jeng=jeng, params=params, teng=teng, clip=clip_px, shape=shape,
                init_noise=rs.standard_normal(shape).astype(np.float32),
                loop_noise=rs.standard_normal((STEPS,) + shape).astype(np.float32))


def test_interpolation_engine_samples_as_jax(engines):
    """Conditioning (the first and last frames' latents), 2 sampling steps
    with CFG and the decode, with the same injected noise."""
    e = engines
    clip = e["clip"]
    fl = np.stack([clip[:, 0], clip[:, -1]], axis=1)
    batch = {"txt": [PROMPT], "control_hint": clip, "interpolate_first_last": fl}
    batch_uc = dict(batch, txt=[NEGATIVE])
    jc, juc = e["jeng"].conditioner.get_unconditional_conditioning(
        e["params"]["conditioner"], batch, batch_uc)
    out_ref = e["jeng"].sample(e["params"], jc, juc, e["shape"], jax.random.PRNGKey(1),
                               num_steps=STEPS, init_noise=jnp.asarray(e["init_noise"]),
                               loop_noise=jnp.asarray(e["loop_noise"]))
    pix_ref = e["jeng"].decode_first_stage(e["params"], out_ref)
    with torch.no_grad():
        tc, tuc = e["teng"].conditioner.get_unconditional_conditioning(
            {k: _t({0: v})[0] if isinstance(v, np.ndarray) else v for k, v in batch.items()},
            {k: _t({0: v})[0] if isinstance(v, np.ndarray) else v for k, v in batch_uc.items()})
        assert tuple(tc["interpolate_first_last"].shape) == (1, 2, H // 8, W // 8, 4)
        for key in ("crossattn", "control_hint", "interpolate_first_last"):
            _close(tc[key], jc[key])
            _close(tuc[key], juc[key])
        out = e["teng"].sample(tc, tuc, e["shape"], num_steps=STEPS,
                               init_noise=torch.from_numpy(e["init_noise"]),
                               loop_noise=torch.from_numpy(e["loop_noise"]))
        pix = e["teng"].decode_first_stage(out)
    for ours, theirs in ((out, out_ref), (pix, pix_ref)):
        theirs = np.asarray(theirs)
        scale = float(np.abs(theirs).max())
        assert scale > 0.1
        assert np.abs(ours.numpy() - theirs).max() <= 1e-4 * scale
