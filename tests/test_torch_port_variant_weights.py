"""The network variants' weights carried across: reference (sgm) state dicts
through ``ccedit_tpu.io.torch_convert`` and back through the port's
``from_jax`` give the same state dict key for key and bit for bit, and it is
exactly the port module's key set, so the networks loaded either way compute
the same outputs:

* the interpolation network (pseudo-3D UNet, structure ControlNet, the
  appearance ControlNet) through ``convert_sd_checkpoint``, and its
  reference checkpoint loading strictly into an engine with a
  ``VAEEmbedder`` on ``interpolate_first_last``;
* RAIG's 2-D UNet (the ``*_ca`` sub-layer, 1x1-conv or Linear
  projections);
* a pseudo-3D UNet with learnable alphas (``alpha_temporal1/2`` scalars,
  ``alpha_temporal`` (1,)), ``label_emb``, scale-shift norm, per-level res
  blocks and Linear temporal projections;
* ``ControlNet3D`` (latent hint pyramid, temporal zero convs).

Temporal text cross-attention's ``attn2`` is not in this list: the JAX
converter reads the temporal blocks as single blocks; ``from_jax`` maps it
(``test_torch_port_variant_modules.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ccedit_tpu.io import torch_convert as tc
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder, VAEEmbedder
from ccedit_tpu_torch.io.checkpoint import load_reference_checkpoint
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules.clip import CLIPTextModel
from ccedit_tpu_torch.modules.controlnet import CCEditNetwork, ControlNet2D, ControlNet3D
from ccedit_tpu_torch.modules.unet import UNetModel
from ccedit_tpu_torch.modules.vae import AutoencoderKL

torch.set_num_threads(1)
TINY = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2, 1), channel_mult=(1, 2), num_heads=2,
            transformer_depth=1, context_dim=16)
SD15_NARROW = dict(TINY, num_res_blocks=2, attention_resolutions=(4, 2, 1),
                   channel_mult=(1, 2, 4, 4), num_heads=8)
APPEARANCE = dict(hint_channels=4, input_hint_identity=True, no_add_x=True,
                  disable_text_ca=True)


def _random_like(sd, seed):
    """Seeded values shaped as ``sd``: N(0, 1/fan_in) matrices and kernels,
    N(0, 0.1^2) vectors and scalars."""
    rs = np.random.RandomState(seed)

    def draw(shape):
        x = rs.standard_normal(shape)
        return x / np.sqrt(np.prod(shape[1:])) if len(shape) >= 2 else 0.1 * x

    return {k: draw(tuple(v.shape)).astype(np.float32) for k, v in sd.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _convert_kwargs(layout):
    return dict(channel_mult=layout["channel_mult"], num_res_blocks=layout["num_res_blocks"],
                attention_resolutions=layout["attention_resolutions"],
                transformer_depth=layout["transformer_depth"],
                model_channels=layout["model_channels"])


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("layout", ["tiny", "sd15_narrow"])
def test_interpolation_network_round_trip(layout):
    kw = TINY if layout == "tiny" else SD15_NARROW
    parts = {"model.diffusion_model.": UNetModel(unet_type="pseudo-3d", **kw),
             "model.diffusion_model.controlnet.": ControlNet2D(hint_channels=3, **kw),
             "model.diffusion_model.controlnet_img.": ControlNet2D(**APPEARANCE, **kw)}
    sds = {prefix: _random_like(m.state_dict(), 40 + i)
           for i, (prefix, m) in enumerate(parts.items())}
    tree = tc.convert_sd_checkpoint({p + k: v for p, sd in sds.items() for k, v in sd.items()},
                                    video=True, has_controlnet=True, has_controlnet_img=True,
                                    **_convert_kwargs(kw))["network"]
    got = {"model.diffusion_model.": from_jax("unet", tree["unet"]),
           "model.diffusion_model.controlnet.": from_jax("controlnet", tree["controlnet"]),
           "model.diffusion_model.controlnet_img.": from_jax("controlnet",
                                                             tree["controlnet_img"])}
    for prefix in parts:
        _assert_same(got[prefix], sds[prefix])
    if layout != "tiny":
        return

    def network(src):
        return CCEditNetwork(
            _load(UNetModel(unet_type="pseudo-3d", **kw), src["model.diffusion_model."]),
            _load(ControlNet2D(hint_channels=3, **kw), src["model.diffusion_model.controlnet."]),
            _load(ControlNet2D(**APPEARANCE, **kw), src["model.diffusion_model.controlnet_img."]),
            interpolate=True).eval()

    nets = [network(sds), network(got)]
    rs = np.random.RandomState(41)
    x = torch.from_numpy(rs.standard_normal((1, 4, 8, 8, 4)).astype(np.float32))
    cond = {"crossattn": torch.from_numpy(rs.standard_normal((1, 7, 16)).astype(np.float32)),
            "control_hint": torch.from_numpy(rs.uniform(-1, 1, (1, 4, 64, 64, 3))
                                             .astype(np.float32)),
            "interpolate_first_last": torch.from_numpy(
                rs.standard_normal((1, 2, 8, 8, 4)).astype(np.float32))}
    with torch.no_grad():
        outs = [n(x, torch.tensor([500.0]), cond) for n in nets]
    assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("use_linear", [False, True])
def test_raig_unet_round_trip(use_linear):
    m = UNetModel(unet_type="2d", enable_ref_attn=True, use_linear_in_transformer=use_linear,
                  **SD15_NARROW)
    sd = _random_like(m.state_dict(), 42)
    assert any(".transformer_blocks_ca.0.attn1.to_k." in k for k in sd)
    assert (sd["input_blocks.1.1.proj_in_ca.weight"].ndim == 2) == use_linear
    tree = tc.convert_unet({"model.diffusion_model." + k: v for k, v in sd.items()},
                           use_linear=use_linear, **_convert_kwargs(SD15_NARROW))
    _assert_same(from_jax("unet", tree), sd)


def test_video_unet_options_round_trip():
    kw = dict(TINY, num_res_blocks=[1, 2])
    m = UNetModel(unet_type="pseudo-3d", use_learnable_alpha=True, adm_in_channels=12,
                  use_scale_shift_norm=True, use_linear_in_transformer=True, **kw)
    sd = _random_like(m.state_dict(), 43)
    assert sd["input_blocks.1.0.alpha_temporal1"].shape == ()
    assert sd["input_blocks.1.1.alpha_temporal"].shape == (1,)
    assert sd["label_emb.0.0.weight"].shape == (128, 12)
    assert sd["input_blocks.1.0.emb_layers.1.weight"].shape == (64, 128)
    tree = tc.convert_unet({"model.diffusion_model." + k: v for k, v in sd.items()},
                           video=True, use_linear=True, **_convert_kwargs(kw))
    _assert_same(from_jax("unet", tree), sd)


def test_controlnet_3d_round_trip():
    m = ControlNet3D(**TINY)
    sd = _random_like(m.state_dict(), 44)
    assert sd["zero_convs_temporal.0.0.weight"].shape == (32, 32, 1)
    assert sd["middle_block_out_temporal.0.weight"].shape == (64, 64, 1)
    prefix = "model.diffusion_model.controlnet."
    tree = tc.convert_controlnet({prefix + k: v for k, v in sd.items()}, prefix=prefix,
                                 video=True, **_convert_kwargs(TINY))
    _assert_same(from_jax("controlnet", tree), sd)


def test_interpolation_reference_checkpoint_loads_strictly():
    unet = UNetModel(unet_type="pseudo-3d", **TINY)
    controlnet = ControlNet2D(hint_channels=3, **TINY)
    controlnet_img = ControlNet2D(**APPEARANCE, **TINY)
    vae = AutoencoderKL(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
    clip = CLIPTextModel(vocab_size=100, width=16, heads=2, layers=1)
    engine = SimpleNamespace(
        network=CCEditNetwork(unet, controlnet, controlnet_img, interpolate=True), vae=vae,
        conditioner=Conditioner([EmbedderSpec(CLIPTextEmbedder(clip), "txt"),
                                 EmbedderSpec(VAEEmbedder(), "interpolate_first_last")]))
    parts = {"model.diffusion_model.": unet, "model.diffusion_model.controlnet.": controlnet,
             "model.diffusion_model.controlnet_img.": controlnet_img,
             "first_stage_model.": vae, "cond_stage_model.transformer.": clip}
    rs = np.random.RandomState(45)
    ckpt = {prefix + k: torch.from_numpy(rs.standard_normal(tuple(v.shape)).astype(np.float32))
            for prefix, m in parts.items() for k, v in m.state_dict().items()}
    load_reference_checkpoint(engine, ckpt)
    for prefix, m in parts.items():
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, ckpt[prefix + k], rtol=0, atol=0)
