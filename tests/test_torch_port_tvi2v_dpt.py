"""DPT-Hybrid (the MiDaS depth annotator), port against the JAX package, on
the CPU in fp32 at tiny widths through its overridable dims: the network,
the chunked depth hint (per-frame backbone in chunks of 5, one clip-global
MiDaS post-process), the weight round trip through ``convert_dpt_midas`` and
``from_jax``, and checkpoint loading in the MiDaS and HF namings.
Tolerance 1e-4 absolute (docs/PARITY.md): fp32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.conditioning.annotators import dpt_midas as jdpt
from ccedit_tpu.conditioning.annotators.base import AnnotatorEmbedder as JaxAnnotator
from ccedit_tpu_torch.conditioning.annotators import base as tbase
from ccedit_tpu_torch.conditioning.annotators import dpt_midas as tdpt
from ccedit_tpu_torch.io.jax_params import from_jax

torch.set_num_threads(1)
ATOL = 1e-4
TINY = dict(embedding_size=8, bit_hidden=(16, 32, 64), bit_depths=(1, 2, 1), num_groups=4,
            hidden_size=32, num_layers=3, num_heads=2, mlp_dim=64, vit_taps=(1, 2),
            fusion_hidden=16, pos_grid=4)
CONVERT = dict(bit_depths=TINY["bit_depths"], num_layers=TINY["num_layers"],
               vit_taps=TINY["vit_taps"])


def _jax_params(seed):
    """Seeded values in the JAX DPT's tree: kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: jdpt.DPTHybrid(**TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3))))
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


@pytest.fixture(scope="module")
def dpt():
    params = _jax_params(21)
    port = tdpt.DPTHybrid(**TINY)
    port.load_state_dict(from_jax("dpt", params), strict=True)
    return params, port.eval()


def test_dpt_hybrid_matches_jax(dpt):
    """64x96 frames: a 4x6 token grid, so the 4x4 position grid is resized;
    TF-SAME padding of the stem conv, max-pool and strided convs."""
    params, port = dpt
    x = np.random.RandomState(22).uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    ref = jdpt.detect_depth_midas(params, jnp.asarray(x), jdpt.DPTHybrid(**TINY))
    with torch.no_grad():
        out = tdpt.detect_depth_midas(port, torch.from_numpy(x))
    assert out.shape == (2, 64, 96) and float(np.abs(np.asarray(ref)).max()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_depth_hint_in_chunks(dpt):
    """7 frames run as chunks of 5 + 2; the min-max normalisation spans the
    whole clip, as the JAX embedder computes it in one piece."""
    params, port = dpt
    video = np.random.RandomState(23).randint(0, 256, (1, 7, 64, 64, 3)).astype(np.uint8)
    model = jdpt.DPTHybrid(**TINY)
    jemb = JaxAnnotator("depth_midas", backbone=lambda p, f: jdpt.detect_depth_midas(p, f, model),
                        backbone_params=params)
    ref = jemb.embed(None, jnp.asarray(video))
    with torch.no_grad():
        out = tbase.AnnotatorEmbedder("depth_midas", backbone=port)(torch.from_numpy(video))
    assert out.shape == (1, 7, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _midas_state_dict(seed):
    """A tiny MiDaS-layout checkpoint: the port's keys plus the entries the
    network does not use (ViT norm and head, refinenet4's lateral unit)."""
    rs = np.random.RandomState(seed)
    sd = {k: rs.standard_normal(tuple(v.shape)).astype(np.float32)
          for k, v in tdpt.DPTHybrid(**TINY).state_dict().items()}
    extra = {"pretrained.model.norm.weight": (32,), "pretrained.model.head.weight": (10, 32)}
    for ru in ("conv1", "conv2"):
        extra[f"scratch.refinenet4.resConfUnit1.{ru}.weight"] = (16, 16, 3, 3)
        extra[f"scratch.refinenet4.resConfUnit1.{ru}.bias"] = (16,)
    sd.update({k: rs.standard_normal(s).astype(np.float32) for k, s in extra.items()})
    return sd


def test_dpt_weight_round_trip():
    sd = _midas_state_dict(24)
    back = {k: v.numpy() for k, v in from_jax("dpt", jdpt.convert_dpt_midas(sd, **CONVERT)).items()}
    used = {k: v for k, v in sd.items() if not k.startswith(("pretrained.model.norm.",
                                                              "pretrained.model.head."))}
    assert sorted(back) == sorted(used)
    for k, v in used.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _midas_to_hf(sd):
    """The HF ``DPTForDepthEstimation`` naming of a MiDaS state dict."""
    out, pre = {}, "pretrained.model."
    vit = {"norm1": "layernorm_before", "norm2": "layernorm_after",
           "attn.proj": "attention.output.dense", "mlp.fc1": "intermediate.dense",
           "mlp.fc2": "output.dense"}
    for k, v in sd.items():
        if k.startswith(pre + "blocks."):
            i, rest = k[len(pre + "blocks."):].split(".", 1)
            mod, suff = rest.rsplit(".", 1)
            if mod == "attn.qkv":
                for name, part in zip(("query", "key", "value"), np.split(v, 3)):
                    out[f"dpt.encoder.layer.{i}.attention.attention.{name}.{suff}"] = part
            else:
                out[f"dpt.encoder.layer.{i}.{vit[mod]}.{suff}"] = v
        elif k in (pre + "cls_token", pre + "pos_embed"):
            out["dpt.embeddings." + {"cls_token": "cls_token",
                                     "pos_embed": "position_embeddings"}[k[len(pre):]]] = v
        elif k.startswith(pre + "patch_embed.proj."):
            out["dpt.embeddings.projection." + k.rsplit(".", 1)[1]] = v
        elif k.startswith(pre + "patch_embed.backbone.stem."):
            tail = k.split("stem.")[1].replace("conv.", "convolution.")
            out["dpt.embeddings.backbone.bit.embedder." + tail] = v
        elif k.startswith(pre + "patch_embed.backbone.stages."):
            s, _, i, tail = k.split("stages.")[1].split(".", 3)
            out[f"dpt.embeddings.backbone.bit.encoder.stages.{s}.layers.{i}.{tail}"] = v
        elif k.startswith("pretrained.act_postprocess"):
            j, rest = int(k[len("pretrained.act_postprocess")]), k.split(".", 2)[2]
            if rest.startswith("0.project.0."):
                suff = rest.rsplit(".", 1)[1]
                out[f"neck.reassemble_stage.readout_projects.{j - 1}.0.{suff}"] = v
            else:
                idx, suff = rest.split(".")
                name = {"3": "projection", "4": "resize"}[idx]
                out[f"neck.reassemble_stage.layers.{j - 1}.{name}.{suff}"] = v
        elif k.startswith("scratch.layer"):
            out[f"neck.convs.{int(k[len('scratch.layer')]) - 1}.weight"] = v
        elif k.startswith("scratch.refinenet"):
            r, tail = int(k[len("scratch.refinenet")]), k.split(".", 2)[2]
            tail = (tail.replace("out_conv", "projection").replace("resConfUnit", "residual_layer")
                    .replace(".conv", ".convolution"))
            out[f"neck.fusion_stage.layers.{4 - r}.{tail}"] = v
        elif k.startswith("scratch.output_conv."):
            out["head.head." + k[len("scratch.output_conv."):]] = v
    return out


def test_hf_naming_translates_as_in_jax():
    sd = _midas_state_dict(25)
    hf = _midas_to_hf(sd)
    ours = tdpt.hf_to_midas_names({k: torch.from_numpy(v) for k, v in hf.items()})
    theirs = jdpt._hf_to_midas_names(hf)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("naming", ["midas", "midas_wrapped", "hf"])
def test_checkpoint_path_loads_the_backbone(tmp_path, monkeypatch, naming):
    """``build_annotator`` with ``ckpt_path``: a MiDaS checkpoint (bare or
    under MiDaSInference's ``model.``) or an HF one loads strictly."""
    sd = _midas_state_dict(26)
    ckpt = {"midas": sd, "midas_wrapped": {"model." + k: v for k, v in sd.items()},
            "hf": _midas_to_hf(sd)}[naming]
    path = tmp_path / "dpt.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ckpt.items()}, path)
    monkeypatch.setattr(tbase, "DPTHybrid", lambda: tdpt.DPTHybrid(**TINY))
    emb = tbase.build_annotator("DepthMidasEncoder", {"ckpt_path": str(path)})
    assert emb.backbone_loaded
    for k, v in emb.backbone.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert tbase.build_annotator("DepthMidasEncoder", {"fake_annotator": True}).backbone is None
