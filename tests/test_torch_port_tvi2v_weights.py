"""TVI2V weights carried across: the CFCA UNet and the appearance ControlNet
(identity hint, no text cross-attention) through
``ccedit_tpu.io.torch_convert`` and back through the port's ``from_jax`` give
the reference state dict key for key and bit for bit, and it is exactly the
port module's key set; a reference-layout TVI2V checkpoint (appearance
branch, VAE encoder included) loads into the engine's modules with strict
``load_state_dict`` calls.  The VAE encoder's and DPT-Hybrid's round trips
are in ``test_torch_port_weights.py`` and ``test_torch_port_tvi2v_dpt.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from ccedit_tpu.io import torch_convert as tc
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder, VAEEmbedder
from ccedit_tpu_torch.io.checkpoint import load_reference_checkpoint
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules.clip import CLIPTextModel
from ccedit_tpu_torch.modules.controlnet import CCEditNetwork, ControlNet2D
from ccedit_tpu_torch.modules.unet import UNetModel
from ccedit_tpu_torch.modules.vae import AutoencoderKL

torch.set_num_threads(1)

LAYOUTS = {
    "sd15_narrow": dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=2,
                        attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
                        num_heads=8, transformer_depth=1, context_dim=16),
    "tiny": _TINY,
}
CFCA = dict(enable_attention3d_crossframe=True, st3dca_ca_type="center_self")
APPEARANCE = dict(hint_channels=4, input_hint_identity=True, no_add_x=True,
                  disable_text_ca=True)


def _random_like(sd, seed):
    rs = np.random.RandomState(seed)
    return {k: rs.standard_normal(tuple(v.shape)).astype(np.float32) for k, v in sd.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _convert_kwargs(layout):
    return dict(channel_mult=layout["channel_mult"], num_res_blocks=layout["num_res_blocks"],
                attention_resolutions=layout["attention_resolutions"],
                transformer_depth=layout["transformer_depth"],
                model_channels=layout["model_channels"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cfca_unet_round_trip(layout):
    kw = LAYOUTS[layout]
    sd = _random_like(UNetModel(unet_type="pseudo-3d", **CFCA, **kw).state_dict(), 31)
    assert any(".transformer_blocks_temporal_ca.0.attn1.to_k." in k for k in sd)
    tree = tc.convert_unet({"model.diffusion_model." + k: v for k, v in sd.items()},
                           video=True, cfca=True, **_convert_kwargs(kw))
    _assert_same(from_jax("unet", tree), sd)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_appearance_controlnet_round_trip(layout):
    kw = LAYOUTS[layout]
    sd = _random_like(ControlNet2D(**APPEARANCE, **kw).state_dict(), 32)
    assert not any(k.startswith("input_hint_block.") or ".attn2." in k or ".norm3." in k
                   for k in sd)
    prefix = "model.diffusion_model.controlnet_img."
    tree = tc.convert_controlnet({prefix + k: v for k, v in sd.items()}, prefix=prefix,
                                 identity_hint=True, disable_text_ca=True,
                                 **_convert_kwargs(kw))
    _assert_same(from_jax("controlnet", tree), sd)


def test_tvi2v_reference_checkpoint_loads_strictly():
    unet = UNetModel(unet_type="pseudo-3d", **CFCA, **_TINY)
    controlnet = ControlNet2D(hint_channels=3, **_TINY)
    controlnet_img = ControlNet2D(**APPEARANCE, **_TINY)
    vae = AutoencoderKL(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
    clip = CLIPTextModel(vocab_size=100, width=16, heads=2, layers=1)
    engine = SimpleNamespace(
        network=CCEditNetwork(unet, controlnet, controlnet_img), vae=vae,
        conditioner=Conditioner([EmbedderSpec(CLIPTextEmbedder(clip), "txt"),
                                 EmbedderSpec(VAEEmbedder(), "cond_img")]))
    parts = {"model.diffusion_model.": unet, "model.diffusion_model.controlnet.": controlnet,
             "model.diffusion_model.controlnet_img.": controlnet_img,
             "first_stage_model.": vae, "cond_stage_model.transformer.": clip}
    rs = np.random.RandomState(33)
    ckpt = {prefix + k: torch.from_numpy(rs.standard_normal(tuple(v.shape)).astype(np.float32))
            for prefix, m in parts.items() for k, v in m.state_dict().items()}
    assert any(k.startswith("first_stage_model.encoder.") for k in ckpt)
    load_reference_checkpoint(engine, ckpt)
    for prefix, m in parts.items():
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, ckpt[prefix + k], rtol=0, atol=0)
