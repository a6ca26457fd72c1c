"""The slice's new paths end to end, port against the JAX package, on the
CPU in fp32 with the same weights, inputs and injected noise:

* TVI2V as shipped (``TVI2V_ZOE_CONFIG``'s embedders): CLIP text, the
  ZoeDepth structure hint from an HF-layout file (the tiny width of
  ``test_torch_port_zoedepth.py``), the reference frame's VAE latent, the
  ``--prior_type ref`` x-prior, ``CCEditEngine.sample`` (CFG 7,
  DPM++2S-ancestral, 2 steps, T = 3 at 64x64) and ``decode_first_stage``;
* a TV2V sdedit (strength 0.5 of 4 steps, DPM++2M) and a TV2V inpaint
  (Euler-ancestral, 2 steps, both noise streams injected) through
  ``sample``;
* CLI smokes: ``sampling_tv2v`` with ``--sdedit_denoise_strength 0.5
  --sampler_name DPMPP2MSampler --lora_path`` and ``sampling_tv2v_ref`` with
  a tiny Zoe YAML, on the bundled bear clip;
* ``run_pipeline``'s base-model sweep (two files and a LoRA): the weights
  each edit sees, against the starting weights, that file and one merge.

Tolerance, as in ``test_torch_port_slice.py``: 1e-4 absolute on the
conditioning; max|port - jax| <= 1e-4 * max|jax| on the latents and pixels.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _TINY
from ccedit_tpu.conditioning.annotators import base as jbase
from ccedit_tpu.conditioning.annotators import zoedepth as jzd
from ccedit_tpu.conditioning.conditioner import Conditioner as JaxConditioner
from ccedit_tpu.conditioning.conditioner import EmbedderSpec as JaxSpec
from ccedit_tpu.conditioning.embedders import CLIPTextEmbedder as JaxCLIPEmbedder
from ccedit_tpu.conditioning.embedders import VAEEmbedder as JaxVAEEmbedder
from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
from ccedit_tpu.diffusion import make_discretization as jax_disc
from ccedit_tpu.diffusion import make_sampler as jax_sampler
from ccedit_tpu.diffusion.guidance import VanillaCFG as JaxCFG
from ccedit_tpu.models.engine import CCEditEngine as JaxEngine
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch import config
from ccedit_tpu_torch.cli import pipeline, sampling_tv2v, sampling_tv2v_ref
from ccedit_tpu_torch.conditioning.annotators import base as tbase
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder, VAEEmbedder
from ccedit_tpu_torch.data.video import load_video_keyframes
from ccedit_tpu_torch.diffusion import DiscreteDenoiser, VanillaCFG, make_discretization
from ccedit_tpu_torch.diffusion import make_sampler
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.io.lora import text_target, unet_target
from ccedit_tpu_torch.models.engine import CCEditEngine
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae
from ccedit_tpu_torch.modules.clip import CLIPTextModel
from test_torch_port_zoedepth import TINY as ZOE_TINY
from test_torch_port_zoedepth import hf_state_dict

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


def _zoe_file(tmp_dir: Path) -> str:
    path = tmp_dir / "zoe_tiny.pt"
    torch.save(hf_state_dict(0), path)
    return str(path)


def _engines(tvi2v: bool, zoe_path: str, seed: int):
    """The tiny engine in both packages with the same weights: TVI2V (CFCA,
    appearance ControlNet, ZoeDepth hint) or TV2V (luminance stand-in)."""
    rs = np.random.RandomState(seed)
    key = jax.random.PRNGKey(0)
    unet_kw = dict(enable_attention3d_crossframe=True) if tvi2v else {}
    jnet = jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True,
                           st3dca_ca_type="center_self", **unet_kw, **_TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY),
        controlnet_img=jcn.ControlNet2D(**APPEARANCE, **_TINY) if tvi2v else None)
    jvae_m = jvae.AutoencoderKL(resolution=H, **VAE)
    jclip_m = jclip.CLIPTextModel(**CLIP)
    cond = {"crossattn": jnp.zeros((1, 77, 16)), "control_hint": jnp.zeros((1, T, H, W, 3))}
    if tvi2v:
        cond["cond_feat"] = jnp.zeros((1, H // 8, W // 8, 4))
    params = {
        "network": _random(jax.eval_shape(jnet.init, key, jnp.zeros((1, T, H // 8, W // 8, 4)),
                                          jnp.zeros((1,)), cond), rs),
        "vae": _random(jax.eval_shape(
            lambda: jvae_m.init(key, jnp.zeros((1, H, W, 3)), None, False)), rs),
        "conditioner": {"embedder_0": _random(jax.eval_shape(
            jclip_m.init, key, jnp.zeros((1, 77), jnp.int32)), rs),
            "embedder_1": None, "embedder_2": None},
    }
    jtext = JaxCLIPEmbedder()
    jtext.model = jclip_m
    if tvi2v:
        with pytest.MonkeyPatch.context() as mp:  # the JAX builder's model, narrowed
            mp.setattr(jzd, "ZoeDepthN", functools.partial(jzd.ZoeDepthN, **ZOE_TINY))
            mp.setattr(jzd, "convert_zoedepth", functools.partial(jzd.convert_zoedepth, layers=4))
            jhint = jbase.build_annotator("DepthZoeEncoder", {"ckpt_path": zoe_path})
        thint = tbase.build_annotator("DepthZoeEncoder", {"ckpt_path": zoe_path})
    else:
        jhint = jbase.AnnotatorEmbedder("depth_midas", allow_fake=True)
        thint = tbase.AnnotatorEmbedder("depth_midas", allow_fake=True)
    jspecs = [JaxSpec(jtext, "txt"), JaxSpec(jhint, "control_hint")]
    jeng = JaxEngine(
        network=jnet, denoiser=JaxDenoiser(scaling="eps", weighting="eps"),
        sampler=jax_sampler("dpmpp_2s_ancestral", discretization=jax_disc("legacy_ddpm"),
                            num_steps=STEPS),
        conditioner=JaxConditioner(jspecs + ([JaxSpec(JaxVAEEmbedder(), "cond_img")]
                                             if tvi2v else [])),
        vae=jvae_m, guider=JaxCFG(scale=CFG))
    jeng._wire_vae_embedders(params["vae"])

    net = params["network"]
    unet = tun.UNetModel(unet_type="pseudo-3d", st3dca_ca_type="center_self", **unet_kw,
                         **_TINY)
    unet.load_state_dict(from_jax("unet", net["unet"]))
    controlnet = tcn.ControlNet2D(hint_channels=3, **_TINY)
    controlnet.load_state_dict(from_jax("controlnet", net["controlnet"]))
    controlnet_img = None
    if tvi2v:
        controlnet_img = tcn.ControlNet2D(**APPEARANCE, **_TINY)
        controlnet_img.load_state_dict(from_jax("controlnet", net["controlnet_img"]))
    vae = tvae.AutoencoderKL(**VAE)
    vae.load_reference_state_dict(from_jax("vae", params["vae"]))
    clip = tclip.CLIPTextModel(**CLIP)
    clip.load_state_dict(from_jax("clip", params["conditioner"]["embedder_0"]))
    tspecs = [EmbedderSpec(CLIPTextEmbedder(clip), "txt"), EmbedderSpec(thint, "control_hint")]
    teng = CCEditEngine(
        network=tcn.CCEditNetwork(unet, controlnet, controlnet_img).eval(),
        denoiser=DiscreteDenoiser(),
        sampler=make_sampler("dpmpp_2s_ancestral", num_steps=STEPS),
        conditioner=Conditioner(tspecs + ([EmbedderSpec(VAEEmbedder(), "cond_img")]
                                          if tvi2v else [])).eval(),
        vae=vae.eval(), guider=VanillaCFG(scale=CFG))

    frames = rs.randint(0, 256, size=(T, H, W, 3)).astype(np.uint8)
    if not tvi2v:
        frames[:, 16:40, 24:56] = 255  # a white box for the inpaint mask
    shape = (1, T, H // 8, W // 8, 4)
    noise = {k: rs.standard_normal((n,) + shape).astype(np.float32)
             for k, n in (("init", 1), ("loop", STEPS), ("pre", STEPS))}
    return dict(jeng=jeng, params=params, teng=teng, frames=frames, shape=shape, noise=noise)


def _conditioning(e, reference=None):
    video = e["frames"][None]
    batch = {"txt": [PROMPT], "control_hint": video}
    batch_uc = {"txt": [NEGATIVE], "control_hint": video}
    if reference is not None:
        batch["cond_img"] = batch_uc["cond_img"] = reference[None]
    jc, juc = e["jeng"].conditioner.get_unconditional_conditioning(
        e["params"]["conditioner"], batch, batch_uc)
    as_t = lambda b: {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                      for k, v in b.items()}
    with torch.no_grad():
        tc, tuc = e["teng"].conditioner.get_unconditional_conditioning(as_t(batch), as_t(batch_uc))
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=1e-4, rtol=0,
                                   err_msg=key)
        np.testing.assert_allclose(tuc[key].numpy(), np.asarray(juc[key]), atol=1e-4, rtol=0,
                                   err_msg=key)
    return (jc, juc), (tc, tuc)


def _close(out, ref, pix=None, ref_pix=None):
    assert out.dtype == torch.float32
    for ours, theirs in ((out, ref), (pix, ref_pix)):
        if ours is None:
            continue
        theirs = np.asarray(theirs)
        scale = float(np.abs(theirs).max())
        assert scale > 0.1  # the chain did real work
        assert np.abs(ours.numpy() - theirs).max() <= 1e-4 * scale


@pytest.fixture(scope="module")
def zoe_path(tmp_path_factory):
    return _zoe_file(tmp_path_factory.mktemp("zoe"))


def test_tvi2v_zoe_slice_matches_jax(zoe_path):
    e = _engines(True, zoe_path, 40)
    reference = np.roll(e["frames"][T // 2], 1, axis=-1).astype(np.float32) / 127.5 - 1.0
    (jc, juc), (tc, tuc) = _conditioning(e, reference)
    hint = tc["control_hint"][0, ..., 0]
    assert hint.min() == -1.0 and hint.max() == 1.0  # the 2 %/85 % normalisation
    z_ref = e["jeng"].encode_first_stage(e["params"], jnp.asarray(reference[None]))
    n = e["noise"]
    ref = e["jeng"].sample(e["params"], jc, juc, e["shape"], jax.random.PRNGKey(1),
                           num_steps=STEPS, x_prior=jnp.repeat(z_ref[:, None], T, axis=1),
                           prior_coefficient=PRIOR_X, prior_noise_coefficient=PRIOR_NOISE,
                           init_noise=jnp.asarray(n["init"][0]),
                           loop_noise=jnp.asarray(n["loop"]))
    ref_pix = e["jeng"].decode_first_stage(e["params"], ref)
    with torch.no_grad():
        prior = tc["cond_feat"][:, None].repeat(1, T, 1, 1, 1)
        out = e["teng"].sample(tc, tuc, e["shape"], num_steps=STEPS,
                               init_noise=torch.from_numpy(n["init"][0]),
                               loop_noise=torch.from_numpy(n["loop"]), x_prior=prior,
                               prior_coefficient=PRIOR_X, prior_noise_coefficient=PRIOR_NOISE)
        pix = e["teng"].decode_first_stage(out)
    _close(out, ref, pix, ref_pix)


@pytest.fixture(scope="module")
def tv2v_engines(zoe_path):
    return _engines(False, zoe_path, 41)


def _with_sampler(e, name, strength=None, steps=4):
    kw = {} if strength is None else {"img2img_strength": strength}
    e["jeng"].sampler = jax_sampler(name, discretization=jax_disc("legacy_ddpm", **kw),
                                    num_steps=steps)
    e["teng"].sampler = make_sampler(name, discretization=make_discretization("legacy_ddpm",
                                                                              **kw),
                                     num_steps=steps)


def test_tv2v_sdedit_dpmpp2m_matches_jax(tv2v_engines):
    """sdedit at strength 0.5: the clip's own latents noised to the first
    sigma of the img2img-pruned 4-step schedule, then DPM++2M."""
    e = tv2v_engines
    _with_sampler(e, "dpmpp_2m", 0.5)
    (jc, juc), (tc, tuc) = _conditioning(e)
    video = e["frames"][None]
    z = e["jeng"].encode_first_stage(e["params"], jnp.asarray(video))
    ref = e["jeng"].sample(e["params"], jc, juc, e["shape"], jax.random.PRNGKey(1), num_steps=4,
                           x_prior=z, mode="sdedit", init_noise=jnp.asarray(e["noise"]["init"][0]))
    with torch.no_grad():
        tz = e["teng"].encode_first_stage(torch.from_numpy(video))
        np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-4, rtol=0)
        out = e["teng"].sample(tc, tuc, e["shape"], num_steps=4, x_prior=tz, mode="sdedit",
                               init_noise=torch.from_numpy(e["noise"]["init"][0]))
    _close(out, ref)
    # the edit stays nearer the clip's own latents than a full chain does
    with torch.no_grad():
        full = e["teng"].sample(tc, tuc, e["shape"], num_steps=4, mode="full",
                                init_noise=torch.from_numpy(e["noise"]["init"][0]))
    cos = lambda a, b: float((a * b).sum() / (a.norm() * b.norm()))
    assert cos(out, tz) > cos(full, tz)


def test_tv2v_inpaint_euler_ancestral_matches_jax(tv2v_engines):
    """Inpainting: the white box (``make_inpaint_mask``) regenerated, the
    clip's latents noised to each step's sigma kept elsewhere; both noise
    streams injected (``{"loop": ..., "pre": ...}``), 2 steps as the other
    slice tests: at 4 steps this chain amplifies fp32 rounding past the
    tolerance, in a slightly perturbed copy of the port as much as between
    the packages."""
    e = tv2v_engines
    _with_sampler(e, "euler_ancestral", steps=STEPS)
    (jc, juc), (tc, tuc) = _conditioning(e)
    video = e["frames"][None]
    mask = pipeline.make_inpaint_mask(e["frames"], 8)
    z = e["jeng"].encode_first_stage(e["params"], jnp.asarray(video))
    n = e["noise"]
    rows = {k: n[k] for k in ("loop", "pre")}
    ref = e["jeng"].sample(e["params"], jc, juc, e["shape"], jax.random.PRNGKey(1),
                           num_steps=STEPS, x_prior=z, inpaint_x0=z,
                           inpaint_mask=jnp.asarray(mask), init_noise=jnp.asarray(n["init"][0]),
                           loop_noise={k: jnp.asarray(v) for k, v in rows.items()})
    with torch.no_grad():
        tz = e["teng"].encode_first_stage(torch.from_numpy(video))
        out = e["teng"].sample(tc, tuc, e["shape"], num_steps=STEPS, x_prior=tz, inpaint_x0=tz,
                               inpaint_mask=torch.from_numpy(mask),
                               init_noise=torch.from_numpy(n["init"][0]),
                               loop_noise={k: torch.from_numpy(v) for k, v in rows.items()})
    _close(out, ref)
    assert 0 < mask.mean() < 1


TINY_CLI = dict(in_channels=4, out_channels=4, model_channels=32, attention_resolutions=[2, 1],
                num_res_blocks=1, channel_mult=[1, 2], num_heads=2, transformer_depth=1,
                context_dim=16)


def _tiny_yaml(tmp_path, base, name, zoe_path=None):
    cfg = json.loads(json.dumps(base))
    p = cfg["model"]["params"]
    net = p["network_config"]["params"]
    net.update(TINY_CLI)
    net["controlnet_config"]["params"] = dict(TINY_CLI, hint_channels=3)
    if "controlnet_img_config" in net:
        net["controlnet_img_config"]["params"].update(TINY_CLI)
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2],
                                                         num_res_blocks=1)
    if zoe_path:
        for emb in p["conditioner_config"]["params"]["emb_models"]:
            if emb["target"].endswith("DepthZoeEncoder"):
                emb["params"] = {"ckpt_path": zoe_path}
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture
def tiny_clip(monkeypatch):
    monkeypatch.setattr(config, "CLIPTextModel", lambda: CLIPTextModel(width=16, heads=2, layers=1))


def _tiny_lora(path, rs, rank=2):
    """A kohya LoRA over the tiny CLI UNet's level-0 self-attention and the
    text encoder's first layer."""
    shapes = {"lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q": (32, 32),
              "lora_unet_mid_block_attentions_0_transformer_blocks_0_attn2_to_k": (64, 16),
              "lora_te_text_model_encoder_layers_0_self_attn_v_proj": (16, 16)}
    sd = {}
    for name, (out, cin) in shapes.items():
        sd[f"{name}.lora_down.weight"] = torch.from_numpy(rs.standard_normal((rank, cin))
                                                          .astype(np.float32))
        sd[f"{name}.lora_up.weight"] = torch.from_numpy(rs.standard_normal((out, rank))
                                                        .astype(np.float32))
    torch.save(sd, path)


def _check_outputs(out_dir, prompt):
    edited = out_dir / "bear_original_00.mp4"
    assert edited.exists() and (out_dir / "bear_original_original.mp4").exists()
    clip = load_video_keyframes(str(edited), 3, 3, 3, (64, 64))
    assert clip.shape == (3, 64, 64, 3) and clip.dtype == np.uint8
    assert list(json.loads((out_dir / "log_info.json").read_text())) == [
        f"bear_original::{prompt}"]


def test_sampling_tv2v_cli_sdedit_with_lora(tiny_clip, tmp_path, capsys):
    cfg = _tiny_yaml(tmp_path, config.TV2V_CONFIG, "tiny_tv2v.yaml")
    lora = tmp_path / "tiny_lora.pt"
    _tiny_lora(lora, np.random.RandomState(9))
    out_dir = tmp_path / "out"
    sampling_tv2v.main([
        "--device", "cpu", "--config_path", cfg, "--video_path", str(BEAR),
        "--prompt", "a brown bear walking", "--H", "64", "--W", "64", "--num_keyframes", "3",
        "--sample_steps", "4", "--sdedit_denoise_strength", "0.5",
        "--sampler_name", "DPMPP2MSampler", "--lora_path", str(lora), "--fake_annotator",
        "--save_path", str(out_dir), "--seed", "0"])
    assert "[lora] merged 3 pairs, skipped 0" in capsys.readouterr().out
    _check_outputs(out_dir, "a brown bear walking")


def test_sampling_tv2v_ref_cli_with_zoe(tiny_clip, zoe_path, tmp_path):
    from PIL import Image

    cfg = _tiny_yaml(tmp_path, config.TVI2V_ZOE_CONFIG, "tiny_zoe.yaml", zoe_path)
    centre = load_video_keyframes(str(BEAR), 3, 3, 3, (64, 64))[1]
    ref_path = tmp_path / "edited_centre.png"
    Image.fromarray(np.roll(centre, 1, axis=-1)).save(ref_path)
    out_dir = tmp_path / "out"
    sampling_tv2v_ref.main([
        "--device", "cpu", "--config_path", cfg, "--video_path", str(BEAR),
        "--reference_path", str(ref_path), "--prompt", "a brown bear walking",
        "--H", "64", "--W", "64", "--num_keyframes", "3", "--sample_steps", "2",
        "--cfg_scale", "7", "--prior_coefficient_x", "0.3", "--prior_type", "ref",
        "--save_path", str(out_dir), "--seed", "0"])
    _check_outputs(out_dir, "a brown bear walking")


def _basemodel_sd(rs, drop=()):
    """A tiny SD-layout base model (the CLI's 2-D UNet, VAE and CLIP) with
    seeded random values, less the file keys in ``drop``."""
    sd = {}
    for prefix, module in (("model.diffusion_model.", tun.UNetModel(unet_type="2d", **TINY_CLI)),
                           ("first_stage_model.", tvae.AutoencoderKL(
                               ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)),
                           ("cond_stage_model.transformer.", config.CLIPTextModel())):
        for k, v in module.state_dict().items():
            sd[prefix + k] = torch.from_numpy(
                (0.05 * rs.standard_normal(tuple(v.shape))).astype(np.float32))
    return {k: v for k, v in sd.items() if k not in drop}


def test_basemodel_sweep_restores_before_each_swap(tiny_clip, tmp_path, monkeypatch):
    """Two base models and a LoRA through ``run_pipeline``: before each base
    model's edit, its UNet, VAE and CLIP hold the engine's starting weights,
    overwritten by that file's keys, plus one LoRA merge.  The second file
    lacks keys that the first has (a LoRA target among them); those keep
    the starting weights, not the first file's."""
    cfg = _tiny_yaml(tmp_path, config.TV2V_CONFIG, "tiny_tv2v.yaml")
    lora = tmp_path / "tiny_lora.pt"
    _tiny_lora(lora, np.random.RandomState(9))
    rs = np.random.RandomState(11)
    lora_q = "input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"
    drop = ("model.diffusion_model.out.2.weight", f"model.diffusion_model.{lora_q}",
            "first_stage_model.decoder.conv_out.weight",
            "cond_stage_model.transformer.text_model.final_layer_norm.weight")
    files = []
    for i, sd in enumerate((_basemodel_sd(rs), _basemodel_sd(rs, drop))):
        files.append(tmp_path / f"base{i}.ckpt")
        torch.save({"state_dict": sd}, files[-1])
    listing = tmp_path / "models.txt"
    listing.write_text("".join(f"{f}\n" for f in files))

    def state(engine):
        mods = pipeline._swapped_modules(engine)
        return {name: {k: v.clone() for k, v in m.state_dict().items()}
                for name, m in mods.items()}

    seen, start = [], {}
    load_engine = pipeline.load_engine

    def loaded(*a, **kw):
        engine, cfg_ = load_engine(*a, **kw)
        start.update(state(engine))
        return engine, cfg_

    def edit(engine, frames, *a, **kw):
        seen.append(state(engine))
        return [frames] * kw["batch_size"], None

    monkeypatch.setattr(pipeline, "load_engine", loaded)
    monkeypatch.setattr(pipeline, "edit_clips", edit)
    out_dir = tmp_path / "out"
    pipeline.run_pipeline(pipeline.base_parser().parse_args([
        "--device", "cpu", "--config_path", cfg, "--video_path", str(BEAR),
        "--prompt", "a brown bear walking", "--H", "64", "--W", "64", "--num_keyframes", "3",
        "--sample_steps", "2", "--fake_annotator", "--basemodel_listpath", str(listing),
        "--lora_path", str(lora), "--lora_strength", "0.6", "--save_path", str(out_dir)]))
    assert len(seen) == 2
    for f in files:
        assert (out_dir / f.stem / "bear_original_00.mp4").exists()

    deltas = {}
    for name, (down, up) in _lora_factors(torch.load(lora)).items():
        if name.startswith("lora_te_"):
            deltas[("clip", text_target(name[len("lora_te_"):]) + ".weight")] = up @ down
        else:
            deltas[("unet", unet_target(name[len("lora_unet_"):], 1, 2) + ".weight")] = up @ down
    prefixes = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
                "clip": "cond_stage_model.transformer."}
    for f, got in zip(files, seen):
        sd = torch.load(f)["state_dict"]
        for name, prefix in prefixes.items():
            for k, v in got[name].items():
                want = sd.get(prefix + k, start[name][k])
                if (name, k) in deltas:
                    want = want.float() + 0.6 * deltas[(name, k)].reshape(want.shape)
                np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=1e-6, atol=1e-6,
                                           err_msg=f"{f.name} {name} {k}")
    # the keys the second file lacks are back at the starting weights
    assert torch.equal(seen[1]["unet"]["out.2.weight"], start["unet"]["out.2.weight"])
    assert not torch.equal(seen[0]["unet"]["out.2.weight"], start["unet"]["out.2.weight"])


def _lora_factors(sd):
    names = sorted({k.split(".")[0] for k in sd})
    return {n: (sd[f"{n}.lora_down.weight"].float(), sd[f"{n}.lora_up.weight"].float())
            for n in names}
