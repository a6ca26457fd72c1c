"""The port's modules against the JAX package's, on the CPU in fp32.

Weights: the JAX modules' own parameter trees (shapes from their ``init``),
filled with seeded random values so that no zero-initialised branch is
trivially zero, then carried into the port with ``from_jax`` and a strict
``load_state_dict``.  Inputs are made with numpy from a seed.  Tolerance
1e-4 absolute (docs/PARITY.md): fp32 on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from ccedit_tpu.conditioning import tokenizer as jax_tok
from ccedit_tpu.diffusion import LegacyDDPMDiscretization as JaxDisc
from ccedit_tpu.diffusion.denoiser import DiscreteDenoiser as JaxDenoiser
from ccedit_tpu.diffusion.samplers import DPMPP2SAncestralSampler as JaxSampler
from ccedit_tpu.diffusion.samplers import get_ancestral_step as jax_ancestral
from ccedit_tpu.modules import blocks as jb
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import transformer as jtr
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch.conditioning import native_tokenizer
from ccedit_tpu_torch.conditioning import tokenizer as port_tok
from ccedit_tpu_torch.diffusion import DiscreteDenoiser, DPMPP2SAncestralSampler, get_ancestral_step
from ccedit_tpu_torch.diffusion import LegacyDDPMDiscretization
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import blocks as tb
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import transformer as ttr
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae

torch.set_num_threads(1)
ATOL = 1e-4


def random_params(module, *args, seed=0, method=None):
    """The JAX module's parameter tree (shapes from its ``init``) with seeded
    values: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), everything
    else N(0, 0.1^2), so activations stay O(1) through the network."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, method=method))
    rs = np.random.RandomState(seed)

    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        else:
            x = x * 0.1 + (1.0 if leaf == "scale" else 0.0)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def port_copy(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port_out, jax_out):
    np.testing.assert_allclose(port_out.detach().numpy(), np.asarray(jax_out), atol=ATOL, rtol=0)


def test_resblock3d():
    rs = np.random.RandomState(1)
    x = rs.standard_normal((2, 3, 8, 8, 32)).astype(np.float32)
    emb = rs.standard_normal((2, 64)).astype(np.float32)
    jm = jb.ResBlock3D(channels=32, emb_channels=64, out_channels=64)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(emb))
    # from_jax("unet") maps a UNet's tree: wrap the block in a one-entry tree
    # named as in the UNet, then strip the prefix
    sd = {k[len("input_blocks.1.0."):]: v for k, v in
          from_jax("unet", {"in_0_0_res": params}).items()}
    tm = port_copy(tb.ResBlock3D(32, 64, 64), sd)
    with torch.no_grad():
        out = tm(_t(x), _t(emb))
    _close(out, jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(emb)))


def test_spatial_transformer3d():
    rs = np.random.RandomState(2)
    x = rs.standard_normal((2, 3, 4, 4, 64)).astype(np.float32)
    ctx = rs.standard_normal((2, 7, 16)).astype(np.float32)
    jm = jtr.SpatialTransformer3D(in_channels=64, n_heads=2, d_head=32, context_dim=16,
                                  disable_temporal_text_ca=True)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(ctx))
    sd = {k[len("middle_block.1."):]: v for k, v in from_jax("unet", {"mid_attn": params}).items()}
    tm = port_copy(ttr.SpatialTransformer3D(64, 2, 32, context_dim=16), sd)
    with torch.no_grad():
        out = tm(_t(x), context=_t(ctx))
    _close(out, jm.apply({"params": params}, jnp.asarray(x), context=jnp.asarray(ctx)))


@pytest.fixture(scope="module")
def tiny_network():
    """The tiny TV2V network (``__graft_entry__._TINY`` widths) on both sides."""
    rs = np.random.RandomState(3)
    b, t, h, w = 2, 3, 8, 8
    x = rs.standard_normal((b, t, h, w, 4)).astype(np.float32)
    ts = np.array([10.0, 700.0], np.float32)
    ctx = rs.standard_normal((b, 7, 16)).astype(np.float32)
    hint = rs.uniform(-1, 1, (b, t, 8 * h, 8 * w, 3)).astype(np.float32)
    jn = jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **_TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY))
    cond = {"crossattn": jnp.asarray(ctx), "control_hint": jnp.asarray(hint)}
    params = random_params(jn, jnp.asarray(x), jnp.asarray(ts), cond, seed=4)
    tn = tcn.CCEditNetwork(
        port_copy(tun.UNetModel(unet_type="pseudo-3d", **_TINY), from_jax("unet", params["unet"])),
        port_copy(tcn.ControlNet2D(hint_channels=3, **_TINY),
                  from_jax("controlnet", params["controlnet"])))
    return dict(jn=jn, params=params, tn=tn, x=x, ts=ts, ctx=ctx, hint=hint, cond=cond)


def test_unet(tiny_network):
    n = tiny_network
    ju = jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **_TINY)
    ref = ju.apply({"params": n["params"]["unet"]}, jnp.asarray(n["x"]), jnp.asarray(n["ts"]),
                   context=jnp.asarray(n["ctx"]))
    with torch.no_grad():
        out = n["tn"].unet(_t(n["x"]), _t(n["ts"]), context=_t(n["ctx"]))
    _close(out, ref)


def test_controlnet_hint_encoding(tiny_network):
    n = tiny_network
    ref = n["jn"].apply({"params": n["params"]}, jnp.asarray(n["hint"]),
                        method=jcn.CCEditNetwork.encode_control_hint)
    with torch.no_grad():
        out = n["tn"].encode_control_hint(_t(n["hint"]))
    _close(out, ref)


def test_controlnet_taps(tiny_network):
    n = tiny_network
    jc = jcn.ControlNet2D(hint_channels=3, **_TINY)
    feats = n["jn"].apply({"params": n["params"]}, jnp.asarray(n["hint"]),
                          method=jcn.CCEditNetwork.encode_control_hint)
    ref = jc.apply({"params": n["params"]["controlnet"]}, jnp.asarray(n["x"]), None,
                   jnp.asarray(n["ts"]), context=jnp.asarray(n["ctx"]), hint_features=feats)
    with torch.no_grad():
        out = n["tn"].controlnet(_t(n["x"]), _t(feats), _t(n["ts"]), context=_t(n["ctx"]))
    assert len(out) == len(ref) == 5  # conv_in, res, down, res + middle at _TINY
    for o, r in zip(out, ref):
        _close(o, r)


def test_cceditnetwork(tiny_network):
    n = tiny_network
    ref = n["jn"].apply({"params": n["params"]}, jnp.asarray(n["x"]), jnp.asarray(n["ts"]), n["cond"])
    with torch.no_grad():
        out = n["tn"](_t(n["x"]), _t(n["ts"]),
                      {"crossattn": _t(n["ctx"]), "control_hint": _t(n["hint"])})
    _close(out, ref)


def test_vae_decode():
    """The tiny f = 8 VAE of tests/test_cli_pipeline.py."""
    rs = np.random.RandomState(5)
    z = rs.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)
    kw = dict(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
    jm = jvae.AutoencoderKL(resolution=64, **kw)
    params = random_params(jm, jnp.zeros((1, 32, 32, 3)), None, False, seed=6)
    tm = tvae.AutoencoderKL(**kw)
    tm.load_reference_state_dict(from_jax("vae", params))
    with torch.no_grad():
        out = tm.eval().decode(_t(z))
    ref = jm.apply({"params": params}, jnp.asarray(z), method=jvae.AutoencoderKL.decode)
    assert out.shape == (1, 2, 32, 32, 3)
    _close(out, ref)


@pytest.mark.parametrize("output_layer,layer_idx", [("last", None), ("pooled", None),
                                                    ("hidden", -1)])
def test_clip_text_model(output_layer, layer_idx):
    kw = dict(width=32, heads=2, layers=2)
    tokens = port_tok.HashTokenizer()(["a robot bear", "ugly, low quality, blurry"])
    jm = jclip.CLIPTextModel(**kw)
    params = random_params(jm, jnp.asarray(tokens), seed=7)
    tm = port_copy(tclip.CLIPTextModel(**kw), from_jax("clip", params))
    with torch.no_grad():
        out = tm(torch.from_numpy(tokens).long(), output_layer, layer_idx)
    _close(out, jm.apply({"params": params}, jnp.asarray(tokens), output_layer, layer_idx))


def test_tokenizers_token_for_token(tmp_path):
    prompts = ["A robot BEAR walking,  in the snow!", "masterpiece, high quality", "", "x" * 300]
    assert np.array_equal(port_tok.HashTokenizer()(prompts), jax_tok.HashTokenizer()(prompts))
    # a small BPE vocabulary over the prompts' bytes, written as HF assets
    byte_chars = list(jax_tok.bytes_to_unicode().values())
    vocab = byte_chars + [c + "</w>" for c in byte_chars] + ["ro", "bo", "bot</w>", "wa",
                                                             "ea", "ar</w>", "bear</w>",
                                                             "<|startoftext|>", "<|endoftext|>"]
    merges = ["r o", "b o", "bo t</w>", "w a", "e a", "a r</w>", "b ear</w>"]
    (tmp_path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    ours = port_tok.load_tokenizer(str(tmp_path))
    theirs = jax_tok.ClipTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    assert isinstance(ours, native_tokenizer.NativeClipTokenizer)  # g++ builds it here
    python = port_tok.ClipTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    prompts = [p for p in prompts if "!" not in p] + ["a robot bear", "bear bot robot"]
    assert np.array_equal(ours(prompts), theirs(prompts))
    assert np.array_equal(python(prompts), theirs(prompts))


def test_schedule_and_sampler_multipliers():
    ours, theirs = LegacyDDPMDiscretization(), JaxDisc()
    for n in (2, 3, 30, 1000):
        np.testing.assert_array_equal(ours(n), theirs(n))
    sig = ours(30)
    for eta in (0.0, 1.0):
        for a, b in zip(get_ancestral_step(sig[:-1], sig[1:], eta),
                        jax_ancestral(sig[:-1], sig[1:], eta)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(DiscreteDenoiser().sigmas_np, np.asarray(JaxDenoiser("eps").sigmas))


@pytest.mark.parametrize("steps", [1, 2, 5])
def test_sampler_chain_with_injected_noise(steps):
    """DPM++2S-ancestral with an analytic denoiser and the same injected
    noise: exercises every per-step multiplier (midpoint and final Euler
    steps).  fp32 on both sides."""
    rs = np.random.RandomState(8)
    shape = (1, 2, 4, 4, 4)
    x0 = rs.standard_normal(shape).astype(np.float32)
    noise = rs.standard_normal((steps,) + shape).astype(np.float32)

    def denoise(x, sigma):  # works on jax arrays and torch tensors alike
        return 0.5 * x / (1.0 + sigma)

    ref = JaxSampler(discretization=JaxDisc(), num_steps=steps)(
        denoise, jnp.asarray(x0), jax.random.PRNGKey(0), noise_override=jnp.asarray(noise))
    out = DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=steps)(
        denoise, _t(x0), noise_override=_t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
