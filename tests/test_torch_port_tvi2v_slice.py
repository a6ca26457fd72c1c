"""The TVI2V slice end to end, port against the JAX package, on the CPU in
fp32: conditioning (CLIP text, pseudo-depth hint, the reference frame's VAE
latent through ``VAEEmbedder``), the x-prior of ``--prior_type ref`` (the
reference latent repeated over T), ``CCEditEngine.sample`` (CFG 7,
DPM++2S-ancestral, 2 steps, T = 3 at 64x64, the same ``init_noise`` and
``loop_noise``) and ``decode_first_stage``, with the same weights; and a
``sampling_tv2v_ref`` CLI smoke on the bundled bear clip with a PNG
reference.

Tolerance, as in ``test_torch_port_slice.py``: 1e-4 absolute on the
conditioning; max|port - jax| <= 1e-4 * max|jax| on the latents and pixels,
where fp32 rounding compounds over the chain in proportion to the values.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _TINY
from ccedit_tpu.conditioning.annotators.base import AnnotatorEmbedder as JaxAnnotator
from ccedit_tpu.conditioning.conditioner import Conditioner as JaxConditioner
from ccedit_tpu.conditioning.conditioner import EmbedderSpec as JaxSpec
from ccedit_tpu.conditioning.embedders import CLIPTextEmbedder as JaxCLIPEmbedder
from ccedit_tpu.conditioning.embedders import VAEEmbedder as JaxVAEEmbedder
from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
from ccedit_tpu.diffusion import LegacyDDPMDiscretization as JaxDisc
from ccedit_tpu.diffusion import make_sampler
from ccedit_tpu.diffusion.guidance import VanillaCFG as JaxCFG
from ccedit_tpu.models.engine import CCEditEngine as JaxEngine
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch import config
from ccedit_tpu_torch.cli import sampling_tv2v_ref
from ccedit_tpu_torch.conditioning.annotators.base import AnnotatorEmbedder
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder, VAEEmbedder
from ccedit_tpu_torch.data.video import load_video_keyframes
from ccedit_tpu_torch.diffusion import (DiscreteDenoiser, DPMPP2SAncestralSampler,
                                        LegacyDDPMDiscretization, VanillaCFG)
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.models.engine import CCEditEngine
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae
from ccedit_tpu_torch.modules.clip import CLIPTextModel

torch.set_num_threads(1)
STEPS, T, H, W, CFG = 2, 3, 64, 64, 7.0
PRIOR_X, PRIOR_NOISE = 0.3, 0.9
CLIP = dict(width=16, heads=2, layers=1)
VAE = dict(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
APPEARANCE = dict(hint_channels=4, input_hint_identity=True, no_add_x=True,
                  disable_text_ca=True)
PROMPT, NEGATIVE = "masterpiece, a robot bear walking", "ugly, low quality"
ROOT = Path(__file__).resolve().parents[1]
BEAR = ROOT / "docs" / "artifacts" / "bear_smoke" / "bear_original.mp4"


def _random(shapes, rs):
    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if leaf == "scale" else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


@pytest.fixture(scope="module")
def engines():
    rs = np.random.RandomState(40)
    key = jax.random.PRNGKey(0)
    jnet = jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True,
                           enable_attention3d_crossframe=True, st3dca_ca_type="center_self",
                           **_TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY),
        controlnet_img=jcn.ControlNet2D(**APPEARANCE, **_TINY))
    jvae_m = jvae.AutoencoderKL(resolution=H, **VAE)
    jclip_m = jclip.CLIPTextModel(**CLIP)
    z = jnp.zeros((1, T, H // 8, W // 8, 4))
    cond = {"crossattn": jnp.zeros((1, 77, 16)), "control_hint": jnp.zeros((1, T, H, W, 3)),
            "cond_feat": jnp.zeros((1, H // 8, W // 8, 4))}
    params = {
        "network": _random(jax.eval_shape(jnet.init, key, z, jnp.zeros((1,)), cond), rs),
        "vae": _random(jax.eval_shape(
            lambda: jvae_m.init(key, jnp.zeros((1, H, W, 3)), None, False)), rs),
        "conditioner": {"embedder_0": _random(jax.eval_shape(
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
                                    JaxSpec(JaxVAEEmbedder(), "cond_img")]),
        vae=jvae_m, guider=JaxCFG(scale=CFG))
    jeng._wire_vae_embedders(params["vae"])

    net = params["network"]
    unet = tun.UNetModel(unet_type="pseudo-3d", enable_attention3d_crossframe=True,
                         st3dca_ca_type="center_self", **_TINY)
    unet.load_state_dict(from_jax("unet", net["unet"]))
    controlnet = tcn.ControlNet2D(hint_channels=3, **_TINY)
    controlnet.load_state_dict(from_jax("controlnet", net["controlnet"]))
    controlnet_img = tcn.ControlNet2D(**APPEARANCE, **_TINY)
    controlnet_img.load_state_dict(from_jax("controlnet", net["controlnet_img"]))
    vae = tvae.AutoencoderKL(**VAE)
    vae.load_reference_state_dict(from_jax("vae", params["vae"]))
    clip = tclip.CLIPTextModel(**CLIP)
    clip.load_state_dict(from_jax("clip", params["conditioner"]["embedder_0"]))
    teng = CCEditEngine(
        network=tcn.CCEditNetwork(unet, controlnet, controlnet_img).eval(),
        denoiser=DiscreteDenoiser(),
        sampler=DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=STEPS),
        conditioner=Conditioner([EmbedderSpec(CLIPTextEmbedder(clip), "txt"),
                                 EmbedderSpec(AnnotatorEmbedder("depth_midas", allow_fake=True),
                                              "control_hint"),
                                 EmbedderSpec(VAEEmbedder(), "cond_img")]),
        vae=vae.eval(), guider=VanillaCFG(scale=CFG))

    frames = rs.randint(0, 256, size=(T, H, W, 3)).astype(np.uint8)
    # the edited reference: the centre frame with its colours shifted, in [-1, 1]
    reference = (np.roll(frames[T // 2], 1, axis=-1).astype(np.float32) / 127.5 - 1.0)
    shape = (1, T, H // 8, W // 8, 4)
    init_noise = rs.standard_normal(shape).astype(np.float32)
    loop_noise = rs.standard_normal((STEPS,) + shape).astype(np.float32)
    return dict(jeng=jeng, params=params, teng=teng, frames=frames, reference=reference,
                shape=shape, init_noise=init_noise, loop_noise=loop_noise)


def test_tvi2v_slice_matches_jax(engines):
    e = engines
    video, ref = e["frames"][None], e["reference"][None]
    batch = {"txt": [PROMPT], "control_hint": video, "cond_img": ref}
    batch_uc = {"txt": [NEGATIVE], "control_hint": video, "cond_img": ref}
    jc, juc = e["jeng"].conditioner.get_unconditional_conditioning(
        e["params"]["conditioner"], batch, batch_uc)
    z_ref = e["jeng"].encode_first_stage(e["params"], jnp.asarray(ref))
    x_prior = jnp.repeat(z_ref[:, None], T, axis=1)  # --prior_type ref
    out_ref = e["jeng"].sample(e["params"], jc, juc, e["shape"], jax.random.PRNGKey(1),
                               num_steps=STEPS, x_prior=x_prior, prior_coefficient=PRIOR_X,
                               prior_noise_coefficient=PRIOR_NOISE,
                               init_noise=jnp.asarray(e["init_noise"]),
                               loop_noise=jnp.asarray(e["loop_noise"]))
    pix_ref = e["jeng"].decode_first_stage(e["params"], out_ref)

    with torch.no_grad():
        as_t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in
                batch.items()}
        as_t_uc = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in
                   batch_uc.items()}
        tc, tuc = e["teng"].conditioner.get_unconditional_conditioning(as_t, as_t_uc)
        for key in ("crossattn", "control_hint", "cond_feat"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=1e-4, rtol=0)
            np.testing.assert_allclose(tuc[key].numpy(), np.asarray(juc[key]), atol=1e-4, rtol=0)
        prior = tc["cond_feat"][:, None].repeat(1, T, 1, 1, 1)
        out = e["teng"].sample(tc, tuc, e["shape"], num_steps=STEPS,
                               init_noise=torch.from_numpy(e["init_noise"]),
                               loop_noise=torch.from_numpy(e["loop_noise"]), x_prior=prior,
                               prior_coefficient=PRIOR_X, prior_noise_coefficient=PRIOR_NOISE)
        pix = e["teng"].decode_first_stage(out)

    assert out.dtype == torch.float32 and tuple(out.shape) == e["shape"]
    for ours, theirs in ((out, out_ref), (pix, pix_ref)):
        theirs = np.asarray(theirs)
        scale = float(np.abs(theirs).max())
        assert scale > 0.1  # the chain did real work
        assert np.abs(ours.numpy() - theirs).max() <= 1e-4 * scale


TINY_CLI = dict(in_channels=4, out_channels=4, model_channels=32, attention_resolutions=[2, 1],
                num_res_blocks=1, channel_mult=[1, 2], num_heads=2, transformer_depth=1,
                context_dim=16)


@pytest.fixture
def tiny_tvi2v_config(tmp_path, monkeypatch):
    """The built-in TVI2V config at tiny widths, as a YAML file; CLIP
    narrowed to the tiny context width."""
    cfg = json.loads(json.dumps(config.TVI2V_CONFIG))
    p = cfg["model"]["params"]
    net = p["network_config"]["params"]
    net.update(TINY_CLI)
    net["controlnet_config"]["params"] = dict(TINY_CLI, hint_channels=3)
    net["controlnet_img_config"]["params"].update(TINY_CLI)
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2],
                                                         num_res_blocks=1)
    path = tmp_path / "tiny_tvi2v.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(config, "CLIPTextModel",
                        lambda: CLIPTextModel(width=16, heads=2, layers=1))
    return str(path)


def test_sampling_tv2v_ref_cli_on_the_bear_clip(tiny_tvi2v_config, tmp_path):
    from PIL import Image

    centre = load_video_keyframes(str(BEAR), 3, 3, 3, (64, 64))[1]
    ref_path = tmp_path / "edited_centre.png"
    Image.fromarray(np.roll(centre, 1, axis=-1)).save(ref_path)
    out_dir = tmp_path / "out"
    sampling_tv2v_ref.main([
        "--device", "cpu", "--config_path", tiny_tvi2v_config, "--video_path", str(BEAR),
        "--reference_path", str(ref_path), "--prompt", "a brown bear walking",
        "--H", "64", "--W", "64", "--num_keyframes", "3", "--sample_steps", "2",
        "--cfg_scale", "7", "--prior_coefficient_x", "0.3", "--prior_type", "ref",
        "--fake_annotator", "--save_path", str(out_dir), "--seed", "0"])
    edited = out_dir / "bear_original_00.mp4"
    assert edited.exists() and (out_dir / "bear_original_original.mp4").exists()
    clip = load_video_keyframes(str(edited), 3, 3, 3, (64, 64))
    assert clip.shape == (3, 64, 64, 3) and clip.dtype == np.uint8
    ledger = json.loads((out_dir / "log_info.json").read_text())
    assert list(ledger) == ["bear_original::a brown bear walking"]
