"""Weights carried across: ``ccedit_tpu.io.torch_convert.convert_*`` and then
the port's ``from_jax`` give back the reference (sgm/LDM/HF) state dict,
key for key and bit for bit, and that state dict is exactly the port
module's own key set (so it loads with a strict ``load_state_dict``); a
reference-layout checkpoint loads into an engine's modules as it is."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from ccedit_tpu.io import torch_convert as tc
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder
from ccedit_tpu_torch.io.checkpoint import load_reference_checkpoint
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules.clip import CLIPTextModel
from ccedit_tpu_torch.modules.controlnet import CCEditNetwork, ControlNet2D
from ccedit_tpu_torch.modules.unet import UNetModel
from ccedit_tpu_torch.modules.vae import AutoencoderKL

torch.set_num_threads(1)

# the SD-1.5 block structure (4 levels, 2 res blocks, no attention at the
# last level) at a narrow width, and the tiny test layout
LAYOUTS = {
    "sd15_narrow": dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=2,
                        attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
                        num_heads=8, transformer_depth=1, context_dim=16),
    "tiny": _TINY,
}


def _random_like(sd, seed):
    rs = np.random.RandomState(seed)
    return {k: rs.standard_normal(tuple(v.shape)).astype(np.float32) for k, v in sd.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _convert_kwargs(layout):
    return dict(channel_mult=layout["channel_mult"], num_res_blocks=layout["num_res_blocks"],
                attention_resolutions=layout["attention_resolutions"],
                transformer_depth=layout["transformer_depth"],
                model_channels=layout["model_channels"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_unet_round_trip(layout):
    kw = LAYOUTS[layout]
    sd = _random_like(UNetModel(unet_type="pseudo-3d", **kw).state_dict(), 1)
    tree = tc.convert_unet({"model.diffusion_model." + k: v for k, v in sd.items()},
                           video=True, **_convert_kwargs(kw))
    _assert_same(from_jax("unet", tree), sd)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_controlnet_round_trip(layout):
    kw = LAYOUTS[layout]
    sd = _random_like(ControlNet2D(hint_channels=3, **kw).state_dict(), 2)
    prefix = "model.diffusion_model.controlnet."
    tree = tc.convert_controlnet({prefix + k: v for k, v in sd.items()}, prefix=prefix,
                                 **_convert_kwargs(kw))
    _assert_same(from_jax("controlnet", tree), sd)


@pytest.mark.parametrize("ch_mult,num_res_blocks", [((1, 2, 4, 4), 2), ((1, 2, 2, 2), 1)])
def test_vae_round_trip(ch_mult, num_res_blocks):
    """The LDM state dict, encoder included, from the JAX VAE's parameter
    shapes is exactly the port's AutoencoderKL's."""
    jm = jvae.AutoencoderKL(ch=32, ch_mult=ch_mult, num_res_blocks=num_res_blocks)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            None, False))["params"]
    rs = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(lambda s: rs.standard_normal(s.shape).astype(np.float32), shapes)
    sd = {k: v.numpy() for k, v in from_jax("vae", tree).items()}
    assert any(k.startswith("encoder.down.0.block.0") for k in sd)
    port = AutoencoderKL(ch=32, ch_mult=ch_mult, num_res_blocks=num_res_blocks)
    assert sorted(sd) == sorted(port.state_dict())
    back = tc.convert_vae({"first_stage_model." + k: v for k, v in sd.items()},
                          ch_mult=ch_mult, num_res_blocks=num_res_blocks)
    _assert_same(from_jax("vae", back), sd)


def test_clip_round_trip():
    sd = _random_like(CLIPTextModel(vocab_size=100, width=32, heads=2, layers=2).state_dict(), 4)
    assert all(k.startswith("text_model.") for k in sd)
    tree = tc.convert_clip({"cond_stage_model.transformer." + k: v for k, v in sd.items()},
                           layers=2)
    _assert_same(from_jax("clip", tree), sd)


def test_reference_checkpoint_loads_strictly():
    """``load_reference_checkpoint``: the UNet, ControlNet, VAE (encoder
    included) and CLIP (with HF's ``position_ids``) sub-dicts of a reference
    checkpoint load value for value."""
    unet = UNetModel(unet_type="pseudo-3d", **_TINY)
    controlnet = ControlNet2D(hint_channels=3, **_TINY)
    vae = AutoencoderKL(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
    clip = CLIPTextModel(vocab_size=100, width=16, heads=2, layers=1)
    engine = SimpleNamespace(
        network=CCEditNetwork(unet, controlnet), vae=vae,
        conditioner=Conditioner([EmbedderSpec(CLIPTextEmbedder(clip), "txt")]))
    parts = {"model.diffusion_model.": unet, "model.diffusion_model.controlnet.": controlnet,
             "first_stage_model.": vae, "cond_stage_model.transformer.": clip}
    rs = np.random.RandomState(5)
    ckpt = {prefix + k: torch.from_numpy(rs.standard_normal(tuple(v.shape)).astype(np.float32))
            for prefix, m in parts.items() for k, v in m.state_dict().items()}
    ckpt["first_stage_model.encoder.conv_in.weight"] = torch.zeros(32, 3, 3, 3)
    ckpt["cond_stage_model.transformer.text_model.embeddings.position_ids"] = torch.arange(77)[None]
    load_reference_checkpoint(engine, ckpt)
    for prefix, m in parts.items():
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, ckpt[prefix + k], rtol=0, atol=0)
