"""The edit CLIs' swaps in the port against the JAX package, on the CPU in
fp32, with the same starting weights (a tiny TV2V engine: ``_TINY`` UNet
and ControlNet, a narrow VAE and CLIP, carried across by ``from_jax``):

* ``merge_kohya_lora``: a seeded random kohya LoRA (linear and 1x1-conv
  pairs over UNet attention, projections and feed-forwards, and the text
  encoder; some names the tiny UNet does not have) merged by both packages;
  the merged weights agree to 1e-6 relative and both skip the same pairs;
* ``apply_basemodel`` and ``apply_vae`` from random SD-layout files written
  with ``torch.save``: the network's and the VAE's outputs after the swap
  agree with the JAX package's to 1e-4 * max|JAX|;
* the swap's report: every key of a state dict with unknown and mis-shaped
  keys is counted and printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from ccedit_tpu.cli import pipeline as jpipe
from ccedit_tpu.io import lora as jlora
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch.cli import pipeline
from ccedit_tpu_torch.io import lora as tlora
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae

torch.set_num_threads(1)
T, H, W = 3, 64, 64
CLIP = dict(width=16, heads=2, layers=1)
VAE = dict(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)


def _random(shapes, rs):
    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if leaf == "scale" else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def _random_sd(module, rs):
    """A module's state dict with seeded random values."""
    out = {}
    for k, v in module.state_dict().items():
        x = rs.standard_normal(tuple(v.shape))
        x = x / np.sqrt(np.prod(v.shape[1:])) if v.dim() >= 2 else 0.1 * x + (
            1.0 if k.endswith("norm.weight") or "norm" in k.split(".")[-2] else 0.0)
        out[k] = torch.from_numpy(x.astype(np.float32))
    return out


class _Engines:
    """The tiny network, VAE and CLIP in both packages with the same
    weights; ``jparams`` is the JAX engine tree, ``teng`` a stand-in with
    the port engine's attributes the swaps use."""

    def __init__(self, seed):
        rs = np.random.RandomState(seed)
        key = jax.random.PRNGKey(0)
        self.jnet = jcn.CCEditNetwork(
            unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **_TINY),
            controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY))
        self.jvae = jvae.AutoencoderKL(resolution=H, **VAE)
        jclip_m = jclip.CLIPTextModel(**CLIP)
        z = jnp.zeros((1, T, H // 8, W // 8, 4))
        cond = {"crossattn": jnp.zeros((1, 77, 16)), "control_hint": jnp.zeros((1, T, H, W, 3))}
        self.jparams = {
            "network": _random(jax.eval_shape(self.jnet.init, key, z, jnp.zeros((1,)), cond), rs),
            "vae": _random(jax.eval_shape(
                lambda: self.jvae.init(key, jnp.zeros((1, H, W, 3)), None, False)), rs),
            "conditioner": {"embedder_0": _random(jax.eval_shape(
                jclip_m.init, key, jnp.zeros((1, 77), jnp.int32)), rs)},
        }
        unet = tun.UNetModel(unet_type="pseudo-3d", **_TINY)
        unet.load_state_dict(from_jax("unet", self.jparams["network"]["unet"]))
        controlnet = tcn.ControlNet2D(hint_channels=3, **_TINY)
        controlnet.load_state_dict(from_jax("controlnet", self.jparams["network"]["controlnet"]))
        vae = tvae.AutoencoderKL(**VAE)
        vae.load_reference_state_dict(from_jax("vae", self.jparams["vae"]))
        clip = tclip.CLIPTextModel(**CLIP)
        clip.load_state_dict(from_jax("clip", self.jparams["conditioner"]["embedder_0"]))
        text = torch.nn.Module()
        text.transformer = clip
        self.teng = type("Engine", (), {})()
        self.teng.network = tcn.CCEditNetwork(unet, controlnet).eval()
        self.teng.vae = vae.eval()
        self.teng.conditioner = type("Cond", (), {"embedders": [text]})()
        self.jeng = type("Engine", (), {"network": self.jnet, "vae": self.jvae,
                                        "_wire_vae_embedders": lambda self, p: None})()


def _kohya_lora(unet, clip, rs, rank=4):
    """Kohya pairs over the tiny UNet's transformers and CLIP, shaped by
    the port module each name maps to; names the tiny UNet lacks get a
    made-up shape (both packages must skip them)."""
    names = []
    blocks = {"down_blocks_0_attentions_0": None, "down_blocks_1_attentions_0": None,
              "down_blocks_0_attentions_1": None, "up_blocks_2_attentions_1": None,
              "up_blocks_3_attentions_0": None, "up_blocks_1_attentions_0": None,
              "mid_block_attentions_0": None}
    for b in blocks:
        names += [f"lora_unet_{b}_transformer_blocks_0_{a}_to_{p}"
                  for a in ("attn1", "attn2") for p in ("q", "k", "v", "out_0")]
        names += [f"lora_unet_{b}_proj_in", f"lora_unet_{b}_transformer_blocks_0_ff_net_0_proj",
                  f"lora_unet_{b}_transformer_blocks_0_ff_net_2"]
    names += [f"lora_te_text_model_encoder_layers_{i}_{m}" for i in (0, 3)
              for m in ("self_attn_q_proj", "self_attn_out_proj", "mlp_fc1", "mlp_fc2")]
    names += ["lora_unet_something_else"]
    params = {**{f"lora_unet:{k}": v for k, v in unet.named_parameters()},
              **{f"lora_te:{k}": v for k, v in clip.named_parameters()}}
    sd = {}
    for name in names:
        try:
            target = (tlora.text_target(name[len("lora_te_"):]) if name.startswith("lora_te_")
                      else tlora.unet_target(name[len("lora_unet_"):], 1, 2))
            w = params[f"{name.split('_')[0]}_{name.split('_')[1]}:{target}.weight"]
            shape = tuple(w.shape)
        except KeyError:
            shape = (8, 8)
        out, cin = shape[0], shape[1]
        conv = len(shape) == 4
        down = rs.standard_normal((rank, cin) + ((1, 1) if conv else ())) / np.sqrt(cin)
        up = rs.standard_normal((out, rank) + ((1, 1) if conv else ())) * 0.5
        sd[f"{name}.lora_down.weight"] = torch.from_numpy(down.astype(np.float32))
        sd[f"{name}.lora_up.weight"] = torch.from_numpy(up.astype(np.float32))
        sd[f"{name}.alpha"] = torch.tensor(2.0)
    return sd


def test_merge_kohya_lora_matches_jax(capsys):
    e = _Engines(0)
    unet, clip = e.teng.network.unet, e.teng.conditioner.embedders[0].transformer
    sd = _kohya_lora(unet, clip, np.random.RandomState(1))
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    merged = jlora.merge_kohya_lora(e.jparams, {k: v.numpy() for k, v in sd.items()}, 0.7)
    jax_line = capsys.readouterr().out.splitlines()[0]
    report = tlora.merge_kohya_lora(unet, clip, sd, 0.7)
    assert capsys.readouterr().out.splitlines()[0] == jax_line
    assert len(report["merged"]) > 40 and "lora_unet_something_else" in report["skipped"]
    assert "lora_te_text_model_encoder_layers_3_mlp_fc1" in report["skipped"]
    for kind, module, tree in (("unet", unet, merged["network"]["unet"]),
                               ("clip", clip, merged["conditioner"]["embedder_0"])):
        ref = from_jax(kind, tree)
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    changed = [k for k, v in unet.state_dict().items() if not torch.equal(v, before[k])]
    assert any(".attn2.to_k." in k for k in changed) and any("proj_in" in k for k in changed)


def _outputs(e, rs_seed=5):
    """The network's and the VAE decoder's outputs in both packages."""
    rs = np.random.RandomState(rs_seed)
    x = rs.standard_normal((1, T, H // 8, W // 8, 4)).astype(np.float32)
    cond = {"crossattn": rs.standard_normal((1, 77, 16)).astype(np.float32),
            "control_hint": rs.uniform(-1, 1, (1, T, H, W, 3)).astype(np.float32)}
    ts = np.asarray([300.0], np.float32)
    ref_net = e.jnet.apply({"params": e.jparams["network"]}, jnp.asarray(x), jnp.asarray(ts),
                           {k: jnp.asarray(v) for k, v in cond.items()})
    ref_vae = e.jvae.apply({"params": e.jparams["vae"]}, jnp.asarray(x[:, 0]),
                           method=jvae.AutoencoderKL.decode)
    with torch.no_grad():
        net = e.teng.network(torch.from_numpy(x), torch.from_numpy(ts),
                             {k: torch.from_numpy(v) for k, v in cond.items()})
        dec = e.teng.vae.decode(torch.from_numpy(x[:, 0]))
    return (net, np.asarray(ref_net)), (dec, np.asarray(ref_vae))


def _basemodel_file(tmp_path, rs):
    unet2d = tun.UNetModel(unet_type="2d", **_TINY)
    vae = tvae.AutoencoderKL(**VAE)
    clip = tclip.CLIPTextModel(**CLIP)
    sd = {}
    for prefix, module in (("model.diffusion_model.", unet2d), ("first_stage_model.", vae),
                           ("cond_stage_model.transformer.", clip)):
        sd.update({prefix + k: v for k, v in _random_sd(module, rs).items()})
    sd["cond_stage_model.transformer.text_model.embeddings.position_ids"] = torch.arange(77)[None]
    sd["model_ema.decay"] = torch.tensor(0.9999)
    path = tmp_path / "basemodel.ckpt"
    torch.save({"state_dict": sd}, path)
    return path, sd


def test_apply_basemodel_and_vae_match_jax(tmp_path, capsys):
    e = _Engines(2)
    rs = np.random.RandomState(3)
    path, sd = _basemodel_file(tmp_path, rs)
    vae_path = tmp_path / "vae.pt"
    torch.save(_random_sd(tvae.AutoencoderKL(**VAE), rs), vae_path)

    before = _outputs(e)
    params = jpipe.apply_basemodel(e.jeng, e.jparams, str(path))
    e.jparams = params
    report = pipeline.apply_basemodel(e.teng, str(path))
    assert not any(r["skipped"] or r["mismatched"] for r in report.values())
    temporal = [k for k in report["unet"]["kept"] if "temporal" in k]
    assert temporal and not [k for k in report["unet"]["kept"] if "temporal" not in k]
    after_base = _outputs(e)
    e.jparams = jpipe.apply_vae(e.jeng, e.jparams, str(vae_path))
    vae_report = pipeline.apply_vae(e.teng, str(vae_path))
    assert not vae_report["kept"] and not vae_report["skipped"]
    after_vae = _outputs(e)
    for (ours, ref), (old, _) in zip(after_base + after_vae, before + before):
        scale = np.abs(ref).max()
        assert np.abs(ours.numpy() - ref).max() <= 1e-4 * scale
    # each swap changed what it swaps
    assert not np.allclose(after_base[0][0].numpy(), before[0][0].numpy(), atol=1e-3)
    assert not np.allclose(after_vae[1][0].numpy(), after_base[1][0].numpy(), atol=1e-3)
    assert "of the file's" in capsys.readouterr().out


def test_swap_reports_every_skipped_and_mis_shaped_key(tmp_path, capsys):
    e = _Engines(4)
    rs = np.random.RandomState(6)
    path, sd = _basemodel_file(tmp_path, rs)
    sd["model.diffusion_model.not_a_layer.weight"] = torch.zeros(3)
    sd["first_stage_model.loss.logvar"] = torch.zeros(())
    k = "model.diffusion_model.out.2.weight"
    sd[k] = torch.zeros(sd[k].shape[0] + 1, *sd[k].shape[1:])
    torch.save(sd, path)
    report = pipeline.apply_basemodel(e.teng, str(path))
    out = capsys.readouterr().out
    assert report["unet"]["skipped"] == ["not_a_layer.weight"]
    assert report["vae"]["skipped"] == ["loss.logvar"]
    assert [m[0] for m in report["unet"]["mismatched"]] == ["out.2.weight"]
    assert "skipped: not_a_layer.weight" in out and "skipped: loss.logvar" in out
    assert "shape mismatch: out.2.weight" in out
    assert "[basemodel unet] loaded" in out and "1 shape-mismatched" in out
    assert "2 of the file's" in out  # model_ema.decay and CLIP's position_ids are not read
    n_unet = sum(1 for key in sd if key.startswith("model.diffusion_model."))
    assert len(report["unet"]["loaded"]) == n_unet - 2


@pytest.mark.parametrize("argv,expected", [([], ["default"]),
                                           (["--basemodel_path", "a/b.ckpt"], ["a/b.ckpt"])])
def test_gather_basemodels(argv, expected, tmp_path):
    args = pipeline.base_parser().parse_args(argv)
    assert pipeline.gather_basemodels(args) == expected == jpipe.gather_basemodels(args)
    listing = tmp_path / "models.txt"
    listing.write_text("x.ckpt\n\n  y.safetensors \n")
    args = pipeline.base_parser().parse_args(["--basemodel_listpath", str(listing)])
    assert pipeline.gather_basemodels(args) == ["x.ckpt", "y.safetensors"] \
        == jpipe.gather_basemodels(args)


def test_make_inpaint_mask_matches_jax():
    rs = np.random.RandomState(7)
    frames = rs.randint(0, 256, (3, 32, 48, 3)).astype(np.uint8)
    frames[:, 8:24, 16:40] = 255
    ours = pipeline.make_inpaint_mask(frames, 8)
    np.testing.assert_array_equal(ours, jpipe.make_inpaint_mask(frames, 8))
    assert ours.shape == (1, 3, 4, 6, 1) and 0 < ours.sum() < ours.size
