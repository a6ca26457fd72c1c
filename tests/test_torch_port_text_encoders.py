"""OpenCLIP (text and vision), T5 / ByT5, ``CLIPT5Embedder`` and the native
BPE tokenizer of the port against the JAX package, on the CPU in fp32.

One seeded random state dict per tower, in the reference layout (open_clip's
keys, HF ``T5EncoderModel``'s), saved with ``torch.save`` and read back:
the port loads it with its own loaders, the JAX side through
``convert_openclip_text`` / ``convert_openclip_vision`` /
``convert_t5_encoder``.  Two layers at width 32.  Tolerance: 1e-4 of the
largest magnitude of each output; tokens id for id; the image
preprocessing (the antialiased bicubic resize to 224) within 1e-4 of its
range.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.conditioning import embedders as JE
from ccedit_tpu.conditioning.tokenizer import ClipTokenizer as JaxClipTokenizer
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import openclip as joc
from ccedit_tpu.modules import t5 as jt5
from ccedit_tpu_torch.conditioning import embedders as TE
from ccedit_tpu_torch.conditioning import native_tokenizer
from ccedit_tpu_torch.conditioning.tokenizer import ClipTokenizer, bytes_to_unicode
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import openclip as toc
from ccedit_tpu_torch.modules import t5 as tt5

torch.set_num_threads(1)
W, HEADS, LAYERS, VOCAB, L = 32, 4, 2, 120, 16


def _random(module, seed, skip=()):
    """Seeded N(0, 1/fan_in) matrices, norm scales near 1, small vectors."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        if k.startswith(skip):
            continue
        x = rs.standard_normal(tuple(v.shape))
        if v.dim() >= 2:
            x = x / np.sqrt(np.prod(v.shape[1:]))
        elif "ln" in k or "norm" in k:
            x = 1.0 + 0.1 * x if k.endswith("weight") else 0.1 * x
        else:
            x = 0.1 * x
        out[k] = torch.from_numpy(x.astype(np.float32))
    return out


def _saved(sd, tmp_path, name):
    path = tmp_path / name
    torch.save(sd, path)
    return torch.load(path)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _tokens(seed, b=2):
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, VOCAB - 1, (b, L))
    tok[0, 9] = VOCAB - 1  # the EOT (highest id) ...
    tok[0, 10:] = 0        # ... then padding
    tok[1, -1] = VOCAB - 1
    return tok


@pytest.fixture(scope="module")
def text_tower(tmp_path_factory):
    d = tmp_path_factory.mktemp("oc")
    model = toc.OpenCLIPTextModel(vocab_size=VOCAB, max_len=L, width=W, heads=HEADS, layers=LAYERS)
    sd = _random(model, 1)
    sd.update({f"visual.{k}": v for k, v in _random(toc.OpenCLIPVisionModel(
        image_size=28, width=W, heads=HEADS, layers=LAYERS, output_dim=16), 2).items()})
    sd["logit_scale"] = torch.tensor(4.6)
    sd = _saved(sd, d, "open_clip.bin")
    toc.load_openclip_text(model, sd)
    jm = joc.OpenCLIPTextModel(vocab_size=VOCAB, max_len=L, width=W, heads=HEADS, layers=LAYERS)
    return model.eval(), jm, joc.convert_openclip_text(_np(sd), layers=LAYERS), sd


def test_openclip_text_hidden_states(text_tower):
    model, jm, params, _ = text_tower
    tok = _tokens(3)
    ref = jm.apply({"params": params}, jnp.asarray(tok))
    ref_skip = jm.apply({"params": params}, jnp.asarray(tok), skip_last_layer=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(tok))
        ours_skip = model(torch.from_numpy(tok), skip_last_layer=True)
    assert set(ours) == set(ref) and set(ours_skip) == set(ref_skip)
    for k in ref:
        assert _rel(ours[k].numpy(), ref[k]) <= 1e-4, k
    for k in ref_skip:
        assert _rel(ours_skip[k].numpy(), ref_skip[k]) <= 1e-4, k


@pytest.mark.parametrize("layer,legacy,pooled", [
    ("last", True, False), ("penultimate", True, False), ("penultimate", False, True),
    ("last", False, False)])
def test_openclip_text_embedder_layers(text_tower, layer, legacy, pooled):
    model, jm, params, _ = text_tower
    j = JE.OpenCLIPTextEmbedder(layer=layer, legacy=legacy, always_return_pooled=pooled,
                                max_length=L)
    j.model = jm
    t = TE.OpenCLIPTextEmbedder(layer=layer, legacy=legacy, always_return_pooled=pooled,
                                max_length=L, model=model)
    tok = _tokens(4)
    ref = j.embed(params, jnp.asarray(tok))
    with torch.no_grad():
        ours = t(t.prepare(tok, "cpu"))
    if pooled:
        assert isinstance(ours, tuple) and len(ours) == 2
        for o, r in zip(ours, ref):
            assert _rel(o.numpy(), r) <= 1e-4
    else:
        assert _rel(ours.numpy(), ref) <= 1e-4
    # strings go through the same BPE as the JAX embedder's (the hash stand-in here)
    np.testing.assert_array_equal(t.prepare(["a red car", "snow"], "cpu").numpy(),
                                  np.asarray(j.prepare(["a red car", "snow"])))


@pytest.fixture(scope="module")
def vision_tower(text_tower):
    sd = {k: v for k, v in text_tower[3].items() if k.startswith("visual.")}
    model = toc.OpenCLIPVisionModel(image_size=224, width=W, heads=HEADS, layers=LAYERS,
                                    output_dim=16)
    sd = dict(sd, **{"visual.positional_embedding": torch.from_numpy(
        np.random.RandomState(5).standard_normal((257, W)).astype(np.float32) * 0.1)})
    toc.load_openclip_vision(model, sd)
    jm = joc.OpenCLIPVisionModel(image_size=224, width=W, heads=HEADS, layers=LAYERS,
                                 output_dim=16)
    return model.eval(), jm, joc.convert_openclip_vision(_np(sd), layers=LAYERS)


@pytest.mark.parametrize("flags", [{}, {"unsqueeze_dim": True}, {"repeat_to_max_len": True},
                                   {"output_tokens": True}])
def test_openclip_image_embedder(vision_tower, flags):
    model, jm, params = vision_tower
    j = JE.OpenCLIPImageEmbedder(max_length=L, **flags)
    j.model = jm
    t = TE.OpenCLIPImageEmbedder(max_length=L, model=model, **flags)
    img = np.random.RandomState(6).uniform(-1, 1, (2, 96, 80, 3)).astype(np.float32)
    jprep = np.asarray(j.prepare(img))
    tprep = t.prepare(img, "cpu")
    assert np.abs(tprep.permute(0, 2, 3, 1).numpy() - jprep).max() <= 1e-4 * np.ptp(jprep)
    ref = j.embed(params, jnp.asarray(jprep))
    with torch.no_grad():
        ours = t(torch.from_numpy(jprep).permute(0, 3, 1, 2))
    if isinstance(ref, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(ref)
        for o, r in zip(ours, ref):
            assert o.shape == r.shape and _rel(o.numpy(), r) <= 1e-4
    else:
        assert ours.shape == ref.shape and _rel(ours.numpy(), ref) <= 1e-4


T5_SIZE = dict(vocab_size=VOCAB, d_model=W, d_kv=8, d_ff=48, heads=HEADS, layers=LAYERS)


@pytest.fixture(scope="module")
def t5(tmp_path_factory):
    model = tt5.T5Encoder(**T5_SIZE)
    sd = _random(model, 7)
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] *= 10.0
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]  # HF saves the tied copy too
    sd = _saved(sd, tmp_path_factory.mktemp("t5"), "t5.bin")
    tt5.load_t5_encoder(model, sd)
    return model.eval(), jt5.T5Encoder(**T5_SIZE), jt5.convert_t5_encoder(_np(sd))


def test_t5_encoder_matches_jax(t5):
    model, jm, params = t5
    tok = _tokens(8)
    ref = jm.apply({"params": params}, jnp.asarray(tok))
    with torch.no_grad():
        ours = model(torch.from_numpy(tok))
    assert _rel(ours.numpy(), ref) <= 1e-4
    np.testing.assert_array_equal(tt5.relative_position_buckets(40, 40),
                                  jt5.relative_position_buckets(40, 40))


def test_t5_embedders_and_tokenizers(t5):
    model, jm, params = t5
    texts = ["a robot bear", "ünïcödé snow ❄", ""]
    byt5_t = TE.T5TextEmbedder(version="google/byt5-base", max_length=L, variant="byt5",
                               model=model)
    byt5_j = JE.T5TextEmbedder(version="google/byt5-base", max_length=L, variant="byt5")
    np.testing.assert_array_equal(byt5_t.prepare(texts, "cpu").numpy(),
                                  np.asarray(byt5_j.prepare(texts)))
    classic = TE.T5TextEmbedder(version="google/t5-v1_1-small", max_length=L, model=model)
    with pytest.raises(AssertionError, match="spm_path"):
        classic.prepare("a cat", "cpu")
    tok = _tokens(9)
    with torch.no_grad():
        ours = classic(classic.prepare(tok, "cpu"))
    assert _rel(ours.numpy(), jm.apply({"params": params}, jnp.asarray(tok))) <= 1e-4


def test_clip_t5_embedder_returns_the_pair(t5):
    t5_model, t5_jm, t5_params = t5
    jclip_model = jclip.CLIPTextModel(vocab_size=VOCAB, max_len=L, width=W, heads=HEADS,
                                      layers=LAYERS)
    tok = _tokens(10)
    clip_params = jclip_model.init(__import__("jax").random.PRNGKey(0), jnp.asarray(tok))["params"]
    port_clip = tclip.CLIPTextModel(vocab_size=VOCAB, max_len=L, width=W, heads=HEADS,
                                    layers=LAYERS)
    port_clip.load_state_dict(from_jax("clip", clip_params))
    j = JE.CLIPT5Embedder(clip_max_length=L, t5_max_length=L)
    j.clip.model, j.t5.model = jclip_model, t5_jm
    t = TE.CLIPT5Embedder(clip_max_length=L, t5_max_length=L, clip=port_clip, t5=t5_model)
    ref = j.embed({"clip": clip_params, "t5": t5_params},
                  {"clip": jnp.asarray(tok), "t5": jnp.asarray(tok)})
    with torch.no_grad():
        ours = t({"clip": torch.from_numpy(tok), "t5": torch.from_numpy(tok)})
    assert isinstance(ours, list) and len(ours) == 2
    for o, r in zip(ours, ref):
        assert _rel(o.numpy(), r) <= 1e-4
    prepared = t.prepare(np.asarray(tok), "cpu")
    assert set(prepared) == {"clip", "t5"}


@pytest.fixture(scope="module")
def bpe_assets(tmp_path_factory):
    """The synthetic vocab of ``tests/test_native_tokenizer.py``."""
    d = tmp_path_factory.mktemp("tok")
    base = list(bytes_to_unicode().values())
    vocab = {v: i for i, v in enumerate(base)}
    for v in base:
        vocab[v + "</w>"] = len(vocab)
    for extra in ["he", "lo</w>", "llo</w>", "ing</w>", "th", "in", "the</w>",
                  "<|startoftext|>", "<|endoftext|>"]:
        vocab[extra] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version\nh e\nl o</w>\nl lo</w>\nt h\ni n\nth e</w>\n")
    return str(d / "vocab.json"), str(d / "merges.txt")


def test_native_tokenizer_matches_python_id_for_id(bpe_assets):
    lib = native_tokenizer.build_library()
    assert lib.parent == native_tokenizer.BUILD_DIR and lib.exists()
    assert native_tokenizer.available()
    native = native_tokenizer.NativeClipTokenizer(*bpe_assets)
    py = ClipTokenizer(*bpe_assets)
    jax_py = JaxClipTokenizer(*bpe_assets)
    prompts = ["hello the world", "The    QUICK brown fox, it's 42!",
               "masterpiece, best quality, a robot bear walking", "",
               "punctuation... everywhere?! (yes)", "thing in the inn " * 20]
    np.testing.assert_array_equal(native(prompts), py(prompts))
    np.testing.assert_array_equal(py(prompts), jax_py(prompts))
    for text in prompts[:-1]:  # the last one is longer than max_len, which encode truncates to
        assert native.encode(text) == py.encode(text), text
