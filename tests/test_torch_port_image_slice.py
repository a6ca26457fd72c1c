"""Image sampling (``cli/sampling_image.py``) end to end, port against the
JAX package, on the CPU in fp32, with the same weights and injected noise:

* ``build_engine`` of both packages on a narrowed ``SD21_768_CONFIG`` (sgm's
  ``DiffusionEngine``, a 2-D UNet with 16-channel heads, v-prediction, the
  KL VAE, an OpenCLIP text tower of width 32): the same parts; the port
  once refused every engine but the video ones, and ``IdentityFirstStage``;
* txt2img (Euler-ancestral, 3 steps, CFG 7.5, start and step noise
  injected) and img2img (Euler, strength 0.75, sdedit on the pruned
  schedule, start noise injected) through the port's ``sample_images``
  against the JAX engine's ``sample`` + ``decode_first_stage`` as the JAX
  ``sample_images`` runs them: the uint8 images within 1, and the final
  latents at 1e-4 of the largest;
* video mode: a pseudo-3D ``UNetModel3D`` config sampled as a one-frame
  clip, likewise;
* ``TOY_MNIST_CONFIG`` through both ``build_engine``s (no VAE, the ``ClassEmbedder``
  and the label-embedding UNet) and one training step: the loss with the
  same sigma and noise at 1e-5 relative, the network's gradients at 1e-4 of
  the largest, then an AdamW step; the training CLI's toy branch for two
  steps;
* the session's sampler cache evicts its least recently used entry;
  ``load_image`` reads PNG only and matches PIL's bicubic resize;
  ``load_reference_checkpoint`` skips a missing VAE.

Tolerances as ``tests/test_torch_port_slice.py``: the chain feeds each
network output back, CFG multiplies the difference, so fp32 rounding grows
with the values.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ccedit_tpu import config as jconfig
from ccedit_tpu.cli import sampling_image as jsi
from ccedit_tpu.data.video import load_image as jax_load_image
from ccedit_tpu.modules import openclip as joc
from ccedit_tpu_torch import config
from ccedit_tpu_torch.cli import sampling_image as si
from ccedit_tpu_torch.conditioning import embedders as TE
from ccedit_tpu_torch.data.video import load_image
from ccedit_tpu_torch.io.checkpoint import load_reference_checkpoint, randomize_weights_
from ccedit_tpu_torch.io.jax_params import from_jax

torch.set_num_threads(1)
TEXT_W, SIZE, STEPS = 32, 64, 3


def _fill(shapes, rs):
    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if leaf == "scale" else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def narrow_sd21(video: bool = False):
    cfg = copy.deepcopy(config.SD21_768_CONFIG)
    p = cfg["model"]["params"]
    p["network_config"]["params"].update(
        model_channels=32, channel_mult=[1, 2], attention_resolutions=[2, 1], num_res_blocks=1,
        num_head_channels=16, context_dim=TEXT_W, use_checkpoint=False)
    if video:
        p["network_config"]["target"] = "sgm.modules.diffusionmodules.openaimodel.UNetModel3D"
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2],
                                                        num_res_blocks=1)
    return cfg


@pytest.fixture
def tiny_openclip(monkeypatch):
    monkeypatch.setitem(TE.OpenCLIPTextEmbedder.ARCHS, "ViT-H-14", (TEXT_W, 2, 2))


def _zero_temporal_outputs(tree):
    """The temporal branches' output layers at zero, as a fresh pseudo-3D
    UNet has them (sgm zero-initialises them): at T = 1 the temporal
    GroupNorms see groups of one or two values, where fp32's rounding of
    flax's fast variance (E[x^2] - E[x]^2), amplified by the 1e-5 epsilon,
    moves the outputs past the tolerance (``tests/test_torch_port_zoe_slice.py``
    and this file's T = 3 network check see the same)."""
    def zero(path, x):
        names = [getattr(p, "key", "") for p in path]
        if any(n in ("out_conv_temporal", "proj_out_temporal") for n in names):
            return np.zeros_like(x)
        return x
    return jax.tree_util.tree_map_with_path(zero, tree)


def build_pair(cfg, seed, video=False):
    """Both packages' engines of ``cfg`` with the same seeded weights; the
    text tower narrowed to width TEXT_W.  Returns (jax engine, jax params,
    port engine)."""
    jeng = jconfig.build_engine(cfg)
    jeng.conditioner.specs[0].embedder.model = joc.OpenCLIPTextModel(
        width=TEXT_W, heads=2, layers=2, max_len=77)
    with torch.device("cpu"):
        teng = config.build_engine(cfg)
    rs = np.random.RandomState(seed)
    batch = {"txt": ["x"], "jpg": np.zeros(((1, 1) if video else (1,)) + (SIZE, SIZE, 3),
                                           np.float32)}
    shapes = jax.eval_shape(lambda r: jeng._init_params_impl(r, batch), jax.random.PRNGKey(0))
    params = _fill(shapes, rs)
    if video:
        params["network"] = _zero_temporal_outputs(params["network"])
    text = teng.conditioner.embedders[0].model
    randomize_weights_(text, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        text.positional_embedding.normal_(0, 0.1, generator=torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in text.state_dict().items()}
    params["conditioner"]["embedder_0"] = joc.convert_openclip_text(sd, layers=2)
    teng.network.unet.load_state_dict(from_jax("unet", params["network"]["unet"]))
    teng.vae.load_reference_state_dict(from_jax("vae", params["vae"]))
    for m in teng.modules:
        m.eval()
    jeng._wire_vae_embedders(params["vae"])
    return jeng, params, teng


def image_args(**kw):
    argv = ["--config_path", "unused", "--device", "cpu", "--H", str(SIZE), "--W", str(SIZE),
            "--sample_steps", str(STEPS), "--prompt", "a red fox in the snow",
            "--negative_prompt", "ugly", "--cfg_scale", "7.5"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return si.add_image_args(argparse.ArgumentParser()).parse_args(argv)


def jax_image(jeng, params, args, video, init_noise, loop_noise=None):
    """The JAX ``sample_images`` body with the noise injected: (uint8
    image, latents)."""
    jsi.configure_sampler(jeng, args)
    batch, batch_uc = jsi._make_batches(jeng, args)
    c, uc = jeng.conditioner.get_unconditional_conditioning(params["conditioner"], batch,
                                                            batch_uc)
    f = jeng.latent_factor
    shape = ((1, 1) if video else (1,)) + (args.H // f, args.W // f, 4)
    kw = {}
    if args.init_image:
        img = jax_load_image(args.init_image, (args.H, args.W))[None]
        kw = dict(x_prior=jeng.encode_first_stage(params, jnp.asarray(img[None] if video
                                                                       else img)),
                  mode="sdedit")
    lat = jeng.sample(params, c, uc, shape, jax.random.PRNGKey(0),
                      init_noise=jnp.asarray(init_noise),
                      loop_noise=None if loop_noise is None else jnp.asarray(loop_noise),
                      guider_scale=args.cfg_scale, **kw)
    img = jeng.decode_first_stage(params, lat)
    if video:
        img = img[:, 0]
    img01 = np.asarray((jnp.clip(img, -1.0, 1.0) + 1.0) / 2.0)
    from ccedit_tpu.data.video import to_uint8

    return to_uint8(img01[0] * 2.0 - 1.0), np.asarray(lat)


def port_image(teng, args, video, init_noise, loop_noise=None):
    session = si.ImageSession(engine=teng, video_mode=video)
    captured, sample = [], teng.sample
    teng.sample = lambda *a, **k: captured.append(sample(*a, **k)) or captured[-1]
    try:
        noise = [{"init": torch.from_numpy(init_noise),
                  "loop": None if loop_noise is None else torch.from_numpy(loop_noise)}]
        out = si.sample_images(session, args, noise=noise)
    finally:
        teng.sample = sample
    return out[0], captured[0].numpy()


def _close_chain(ours, theirs):
    (img, lat), (jimg, jlat) = ours, theirs
    scale = float(np.abs(jlat).max())
    assert scale > 0.1
    assert np.abs(lat - jlat).max() <= 1e-4 * scale
    assert img.dtype == np.uint8 and img.shape == jimg.shape
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
    assert img.std() > 1.0  # not a flat image


@pytest.fixture(scope="module")
def sd21(request):
    mp = pytest.MonkeyPatch()
    mp.setitem(TE.OpenCLIPTextEmbedder.ARCHS, "ViT-H-14", (TEXT_W, 2, 2))
    try:
        yield build_pair(narrow_sd21(), seed=0)
    finally:
        mp.undo()


def test_both_build_engines_take_the_sd21_config(sd21):
    jeng, _, teng = sd21
    assert type(teng.network.unet).__name__ == "UNetModel" and not teng.network.unet.is_video
    assert jeng.network.unet.unet_type == "2d"
    assert teng.vae is not None and jeng.vae is not None
    assert type(teng.denoiser.scaling).__name__ == "VScaling"
    assert type(teng.conditioner.embedders[0]).__name__ == "OpenCLIPTextEmbedder"
    assert teng.conditioner.embedders[0].layer == "penultimate"
    assert teng.freeze_policy == jeng.freeze_policy == "none"
    assert teng.scale_factor == jeng.scale_factor == 0.18215


def test_txt2img_matches_jax(sd21):
    jeng, params, teng = sd21
    args = image_args(sampler_name="EulerAncestralSampler")
    rs = np.random.RandomState(1)
    shape = (1, SIZE // 8, SIZE // 8, 4)
    init = rs.standard_normal(shape).astype(np.float32)
    loop = rs.standard_normal((STEPS,) + shape).astype(np.float32)
    _close_chain(port_image(teng, args, False, init, loop),
                 jax_image(jeng, params, args, False, init, loop))


def test_img2img_matches_jax(sd21, tmp_path):
    jeng, params, teng = sd21
    rs = np.random.RandomState(2)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    src = np.stack([xx * 4, yy * 4, (xx + yy) * 2], -1).clip(0, 255).astype(np.uint8)
    Image.fromarray(src).save(tmp_path / "init.png")  # PIL's own PNG
    args = image_args(init_image=tmp_path / "init.png", img2img_strength=0.75)
    init = rs.standard_normal((1, SIZE // 8, SIZE // 8, 4)).astype(np.float32)
    _close_chain(port_image(teng, args, False, init), jax_image(jeng, params, args, False, init))


def test_video_mode_samples_a_one_frame_clip(tiny_openclip):
    """A one-frame clip through the pseudo-3D network.  Its one step is held
    as the 2-D chains are; over 3 steps its fp32 rounding grows past that
    in both packages alike (the temporal layers add depth; CFG 7.5 and the
    ancestral steps amplify), so the 3-step latents are held to the same
    chain with the network in fp64: the port at least as close to it as
    the JAX package is (first reading: port 1.6e-3, JAX 3.7e-3 off it, of
    latents up to 3.1)."""
    jeng, params, teng = build_pair(narrow_sd21(video=True), seed=3, video=True)
    assert teng.network.unet.is_video and jeng.network.unet.unet_type == "pseudo-3d"
    rs = np.random.RandomState(4)
    shape = (1, 1, SIZE // 8, SIZE // 8, 4)
    init = rs.standard_normal(shape).astype(np.float32)
    loop = rs.standard_normal((STEPS,) + shape).astype(np.float32)
    one = image_args(sampler_name="EulerAncestralSampler", sample_steps=1)
    _close_chain(port_image(teng, one, True, init, loop[:1]),
                 jax_image(jeng, params, one, True, init, loop[:1]))
    args = image_args(sampler_name="EulerAncestralSampler")
    img, lat = port_image(teng, args, True, init, loop)
    jimg, jlat = jax_image(jeng, params, args, True, init, loop)
    net32 = teng.network
    teng.network = copy.deepcopy(net32).double()
    teng._network_fn = lambda x, c, cond: teng.network(
        x.double(), c.double(), {k: v.double() for k, v in cond.items()}).float()
    try:
        _, exact = port_image(teng, args, True, init, loop)
    finally:
        teng.network = net32
        del teng._network_fn
    port_err, jax_err = np.abs(lat - exact).max(), np.abs(jlat - exact).max()
    assert port_err <= max(jax_err, 1e-4 * float(np.abs(exact).max())), (port_err, jax_err)
    assert img.shape == jimg.shape == (SIZE, SIZE, 3) and img.std() > 1.0


def test_sampler_cache_evicts_the_least_recently_used(sd21):
    _, _, teng = sd21
    cache = si.LRU(2)
    made = []
    for steps in (3, 4, 3, 5):
        si.configure_sampler(teng, image_args(sample_steps=steps), cache)
        made.append(teng.sampler)
    assert made[0] is made[2]  # a hit
    assert len(cache) == 2 and list(k[1] for k in cache) == [3, 5]  # 4 was evicted
    si.configure_sampler(teng, image_args(sample_steps=4), cache)
    assert teng.sampler is not made[1]  # rebuilt after eviction
    assert list(k[1] for k in cache) == [5, 4]


def test_load_image_matches_pil_and_reads_png_only(tmp_path):
    rs = np.random.RandomState(5)
    src = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    Image.fromarray(src).save(tmp_path / "a.png")
    Image.fromarray(src).convert("L").save(tmp_path / "g.png")
    Image.fromarray(src).convert("RGBA").save(tmp_path / "r.png")
    for name in ("a.png", "g.png", "r.png"):
        for size in ((64, 96), (16, 24), (37, 53)):
            np.testing.assert_array_equal(load_image(str(tmp_path / name), size),
                                          jax_load_image(str(tmp_path / name), size))
    Image.fromarray(src).save(tmp_path / "a.jpg")
    with pytest.raises(ValueError, match="PIL"):
        load_image(str(tmp_path / "a.jpg"), (37, 53))


# ---- the toy config ------------------------------------------------------

def test_toy_config_builds_in_both_packages():
    jeng = jconfig.build_engine(config.TOY_MNIST_CONFIG)
    with torch.device("cpu"):
        teng = config.build_engine(config.TOY_MNIST_CONFIG)
    assert jeng.vae is None and teng.vae is None
    assert teng.latent_factor == jeng.latent_factor == 1
    assert teng.network.unet.adm_in_channels == jeng.network.unet.adm_in_channels == 128
    assert type(teng.conditioner.embedders[0]).__name__ == "ClassEmbedder"
    assert type(teng.sampler).__name__ == type(jeng.sampler).__name__ == "EulerEDMSampler"
    assert teng.guider.scale == jeng.guider.scale == 3.0
    assert teng.modules == (teng.network, teng.conditioner)


def test_toy_train_step_matches_jax():
    from ccedit_tpu_torch.diffusion.sigma_sampling import EDMSampling

    jeng = jconfig.build_engine(config.TOY_MNIST_CONFIG)
    with torch.device("cpu"):
        teng = config.build_engine(config.TOY_MNIST_CONFIG)
    rs = np.random.RandomState(6)
    batch = {"jpg": rs.uniform(-1, 1, (2, 28, 28, 1)).astype(np.float32), "cls": np.array([3, 7])}
    shapes = jax.eval_shape(lambda r: jeng._init_params_impl(r, batch), jax.random.PRNGKey(0))
    params = _fill(shapes, rs)
    teng.network.unet.load_state_dict(from_jax("unet", params["network"]["unet"]))
    with torch.no_grad():
        teng.conditioner.embedders[0].embedding.weight.copy_(
            torch.from_numpy(np.asarray(params["conditioner"]["embedder_0"]["embedding"])))
    # the JAX build_denoiser drops the scaling and weighting configs' params
    # (EDM at its default sigma_data 0.5); the port keeps the config's 1.0:
    # the parity step runs the port at the JAX package's value
    assert teng.denoiser.scaling.sigma_data == teng.denoiser.weighting.sigma_data == 1.0
    assert jeng.denoiser.scaling.sigma_data == 0.5
    teng.denoiser.scaling.sigma_data = teng.denoiser.weighting.sigma_data = 0.5
    noise = rs.standard_normal((2, 28, 28, 1)).astype(np.float32)
    sigmas = np.exp(rs.normal(-1.2, 1.2, (2,))).astype(np.float32)

    cond = jeng.conditioner.embed(params["conditioner"], jeng.conditioner.prepare(batch))

    def loss_fn(net_params):
        return jnp.mean(jeng.loss_fn(jax.random.PRNGKey(0), jeng._network_fn(net_params),
                                     jeng.denoiser, cond, jnp.asarray(batch["jpg"]),
                                     noise_override=noise, sigma_override=sigmas))

    jloss, jgrads = jax.value_and_grad(loss_fn)(params["network"])
    tcond = teng.conditioner.embed(teng.conditioner.prepare(batch))
    optimizer = teng.make_optimizer(1e-4)
    losses = teng.loss_fn(teng._network_fn, teng.denoiser, tcond,
                          torch.from_numpy(batch["jpg"]), noise_override=torch.from_numpy(noise),
                          sigma_override=torch.from_numpy(sigmas))
    tloss = losses.mean()
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=0)
    ref = from_jax("unet", jgrads["unet"])
    grads = {n[len("unet."):]: p.grad for n, p in teng.network.named_parameters()}
    top = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for n, g in ref.items():
        assert grads[n] is not None, n
        assert (grads[n] - g).abs().max().item() <= 1e-4 * top, n
    before = {n: p.detach().clone() for n, p in teng.network.named_parameters()}
    optimizer.step()
    moved = [n for n, p in teng.network.named_parameters() if not torch.equal(p, before[n])]
    assert len(moved) == len(before)
    assert isinstance(EDMSampling(), object)


def test_train_cli_toy_branch(tmp_path):
    from ccedit_tpu_torch.cli import train

    _, result = train.main(["-b", "toy_mnist", "--max_steps", "2", "--device", "cpu",
                            "--batch_size", "4", "-l", str(tmp_path), "--log_every", "1",
                            "--ckpt_every", "100"])
    assert result.step == 2 and all(np.isfinite(result.losses))


def test_load_engine_takes_a_config_without_a_vae():
    """The edit CLIs' loader (seeded random weights, dtype and eval over the
    engine's modules) once called ``.to`` on the missing VAE."""
    from ccedit_tpu_torch.cli import pipeline

    args = pipeline.base_parser().parse_args(["--device", "cpu", "--config_path", "toy_mnist"])
    engine, cfg = pipeline.load_engine(args, 2)
    assert engine.vae is None and cfg["model"]["params"]["first_stage_config"]["target"].endswith(
        "IdentityFirstStage")
    assert all(not m.training for m in engine.modules)
    assert float(next(engine.network.parameters()).abs().sum()) > 0  # randomised


def test_reference_checkpoint_without_a_vae():
    with torch.device("cpu"):
        teng = config.build_engine(config.TOY_MNIST_CONFIG)
    sd = {f"model.diffusion_model.{k}": v for k, v in teng.network.unet.state_dict().items()}
    load_reference_checkpoint(teng, sd)  # no first_stage_model.* keys and no VAE: no error
