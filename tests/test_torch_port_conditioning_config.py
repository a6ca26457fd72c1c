"""``config.build_conditioner`` of the port against the JAX package's on
inline reference-format dicts: every target of the JAX ``_build_embedder``
gives the same output keys and shapes.

Each target is one ``emb_models`` entry with its defaults (or the params
named).  The JAX side is shape-evaluated (``jax.eval_shape`` of
``init_params`` and ``embed``), the port built and run on the ``meta``
device, so the production sizes (T5-XXL, OpenCLIP ViT-H) cost no memory.
The structure annotators run for real on a (1, 1, 32, 32, 3) clip, with
the small checkpoints of ``test_torch_port_annotators.py`` (depth with the
stand-in).  Embedders whose output is a list or a tuple (``CLIPT5``,
OpenCLIP v2 with its pooled output, the image tower's token output) are
compared element by element, as the conditioner cannot route them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_annotators as ta
from ccedit_tpu import config as jconfig
from ccedit_tpu.conditioning.annotators import normalbae as jnb
from ccedit_tpu_torch import config as tconfig
from ccedit_tpu_torch.conditioning.annotators.base import AnnotatorEmbedder

torch.set_num_threads(1)
IMG = np.random.RandomState(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
VID = np.random.RandomState(1).uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
LAT = np.random.RandomState(2).standard_normal((2, 8, 8, 4)).astype(np.float32)
TXT = ["a robot bear walking", "snow"]
TOK = np.random.RandomState(3).randint(1, 30000, (2, 77))

# (target, params, input key, input value)
CASES = [
    ("FrozenCLIPEmbedder", {}, "txt", TXT),
    ("FrozenCLIPEmbedder", {"layer": "hidden", "layer_idx": -2}, "txt", TXT),
    ("VAEEmbedder", {}, "cond_img", IMG),
    ("IdentityEncoder", {}, "control_hint", VID),
    ("CustomIdentityEncoder", {"down_blur_factor": [2.0]}, "control_hint", VID),
    ("CustomIdentityDownCondEncoder", {"outdim": 16, "down_blur_factor": [2.0]}, "img", VID),
    ("ConcatTimestepEmbedderND", {"outdim": 64}, "orig", np.array([[512.0, 768.0]] * 2)),
    ("ClassEmbedder", {"embed_dim": 32, "n_classes": 10}, "cls", np.array([1, 9])),
    ("ClassEmbedder", {"embed_dim": 32, "add_sequence_dim": True}, "cls", np.array([1, 9])),
    ("LowScaleEncoder", {"output_size": 16}, "lowres", LAT),
    ("SpatialRescaler", {"multiplier": 0.5, "out_channels": 4, "kernel_size": 3}, "img", IMG),
    ("SpatialRescaler", {"n_stages": 2, "method": "nearest"}, "img", VID),
    ("InpaintingEncoder", {}, "masked", VID),
    ("OutpaintingEncoder", {}, "masked", VID),
    ("GaussianEncoder", {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "resolution": 32},
     "img", IMG),
    ("FrozenT5Embedder", {}, "txt", TOK),
    ("FrozenByT5Embedder", {}, "txt", TXT),
    ("FrozenOpenCLIPEmbedder", {"layer": "penultimate"}, "txt", TXT),
    ("FrozenOpenCLIPEmbedder2", {"layer": "penultimate", "legacy": False,
                                 "always_return_pooled": True, "arch": "ViT-bigG-14"}, "txt", TXT),
    ("FrozenOpenCLIPEmbedder2", {"layer": "last", "legacy": False}, "txt", TXT),
    ("FrozenOpenCLIPImageEmbedder", {}, "img", IMG),
    ("FrozenOpenCLIPImageEmbedder", {"output_tokens": True}, "img", IMG),
    ("FrozenOpenCLIPImageEmbedder", {"repeat_to_max_len": True, "unsqueeze_dim": True}, "img", IMG),
    ("FrozenCLIPT5Encoder", {}, "txt", TOK),
]
ANNOTATORS = [
    ("DepthMidasEncoder", {"fake_annotator": True}),
    ("DepthZoeEncoder", {"fake_annotator": True}),
    ("LineartEncoder", {}),
    ("LineartEncoder", {"lineart_standard": False, "ckpt": "sk_model.pth"}),
    ("SoftEdgeEncoder", {"safe": True, "ckpt": "table5_pidinet.pth"}),
    ("NormalBaeEncoder", {"ckpt": "scannet.pt"}),
    ("ScribbleHEDEncoder", {"ckpt": "ControlNetHED.pth"}),
    ("ScribblePidiNetEncoder", {"ckpt": "table5_pidinet.pth"}),
    ("OpenposeEncoder", {"ckpt": "body_pose_model.pth"}),
]


def _cfg(target, params, key):
    return {"target": "sgm.modules.GeneralConditioner", "params": {"emb_models": [
        {"target": f"sgm.modules.encoders.modules.{target}", "input_key": key,
         "params": params}]}}


def _shapes(x):
    if isinstance(x, (list, tuple)):
        return [_shapes(v) for v in x]
    return tuple(x.shape)


def _jax_output(cond, key, value):
    spec = cond.specs[0]
    if hasattr(spec.embedder, "vae_apply"):
        spec.embedder.vae_apply = lambda x: x[:, ::8, ::8, :4]
    prepared = cond.prepare({key: value})
    params = jax.eval_shape(lambda r: spec.embedder.init_params(r, prepared[key]),
                            jax.random.PRNGKey(0))
    out = jax.eval_shape(lambda p: spec.embedder.embed(p, prepared[key]), params)
    if isinstance(out, (list, tuple)):
        return None, _shapes(out)
    key_out = spec.output_key(len(out.shape))
    return {key_out: tuple(out.shape)}, None


def _port_output(cond, key, value):
    spec = cond.specs[0]
    if hasattr(spec.embedder, "encode"):
        spec.embedder.encode = lambda x, generator=None: x[:, ::8, ::8, :4]
    prepared = cond.prepare({key: value})
    with torch.no_grad():
        out = spec.embedder(prepared[key])
        if isinstance(out, (list, tuple)):
            return None, _shapes(out)
        routed = cond.embed(prepared)
    return {k: tuple(v.shape) for k, v in routed.items()}, None


@pytest.mark.parametrize("target,params,key,value", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_every_embedder_target_matches_the_jax_keys_and_shapes(target, params, key, value):
    cfg = _cfg(target, params, key)
    jcond = jconfig.build_conditioner(cfg)
    with torch.device("meta"):
        tcond = tconfig.build_conditioner(cfg)
    assert type(tcond.specs[0].embedder).__name__ == type(jcond.specs[0].embedder).__name__
    assert _port_output(tcond, key, value) == _jax_output(jcond, key, value)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return ta.ckpts.__wrapped__(tmp_path_factory)


@pytest.mark.parametrize("target,params", ANNOTATORS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ANNOTATORS)])
def test_every_annotator_target_matches_the_jax_keys_and_shapes(target, params, ckpts,
                                                                 monkeypatch):
    monkeypatch.setattr(jnb, "NNET", functools.partial(
        jnb.NNET, stem_ch=ta.NB_STEM, head_ch=ta.NB_HEAD, stages=ta.NB_STAGES, up_dims=ta.NB_UP))
    monkeypatch.setattr(jnb, "convert_normalbae",
                        functools.partial(jnb.convert_normalbae, stages=ta.NB_STAGES))
    params = dict(params)
    if "ckpt" in params:
        params["ckpt_path"] = ckpts[params.pop("ckpt")]
    cfg = _cfg(target, params, "control_hint")
    jcond, tcond = jconfig.build_conditioner(cfg), tconfig.build_conditioner(cfg)
    video = VID[:1, :1]
    ref = jcond.embed({}, jcond.prepare({"control_hint": video}))
    with torch.no_grad():
        ours = tcond.embed(tcond.prepare({"control_hint": video}))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()} == {"control_hint": video.shape}
    emb = tcond.specs[0].embedder
    assert isinstance(emb, AnnotatorEmbedder) and emb.kind == jcond.specs[0].embedder.kind
    assert emb.backbone_loaded == ("ckpt_path" in params)


def test_fake_annotator_keeps_the_jax_meaning(ckpts):
    """``--fake_annotator`` opts depth into the stand-in and leaves a
    weighted kind's checkpoint as it is."""
    cfg = {"params": {"emb_models": [
        {"target": "x.DepthMidasEncoder", "input_key": "control_hint", "params": {}},
        {"target": "x.SoftEdgeEncoder", "input_key": "control_hint",
         "params": {"ckpt_path": ckpts["table5_pidinet.pth"]}}]}}
    depth, edge = tconfig.build_conditioner(cfg, fake_annotator=True).embedders
    assert depth.backbone is None and depth.allow_fake
    assert edge.backbone_loaded and edge.backbone is not None


def test_unknown_target_raises_naming_it():
    with pytest.raises(KeyError, match="FrozenMysteryEmbedder"):
        tconfig.build_conditioner(_cfg("FrozenMysteryEmbedder", {}, "txt"))
    with pytest.raises(KeyError, match="FrozenMysteryEmbedder"):
        jconfig.build_conditioner(_cfg("FrozenMysteryEmbedder", {}, "txt"))
