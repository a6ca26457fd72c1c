"""The network variants' modules, port against the JAX package, on the CPU in
fp32: every option of the residual and resampling blocks (scale-shift norm,
up / down, the 3x3 skip, no timestep embedding, learnable alphas, the SSN
mode with its inject point, ``use_conv=False``), of the transformers
(``use_linear``, ``disable_self_attn``, TokenFlow's k/v reuse, RAIG's
``SpatialTransformerCA``, temporal text cross-attention, the learnable
temporal alpha), of the UNet (per-level depths, legacy heads,
``conv_resample=False``, ``label_emb`` with ``y``, RAIG's reference bank,
``interpolate_control``, ``only_mid_control``), ``ControlNet3D`` in both
modes, ``raig_ref_mapping`` and ``unet_extras``.

Weights: the JAX module's own parameter tree filled with seeded values, the
zero-initialised layers included (learnable alphas drawn about 0.5, so both
branches count), carried into the port with ``from_jax`` and a strict
``load_state_dict``.  Tolerance 1e-4 absolute (docs/PARITY.md): fp32 on
both sides.  The pseudo-3D modules see T = 4 frames: their temporal
GroupNorms hold one channel x T values a group at these widths, and at T =
3 flax's fast variance (E[x^2] - E[x]^2) puts the JAX side 3.5e-4 (a
scale-shift ResBlock3D: 4.2e-4) from the fp64 result where the port stays
within 1.7e-5; at T = 4 both are within 5e-6 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.modules import blocks as jbl
from ccedit_tpu.modules import transformer as jtr
from ccedit_tpu.modules import unet_extras as jux
from ccedit_tpu.ops import video as jvideo
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import blocks as tbl
from ccedit_tpu_torch.modules import transformer as ttr
from ccedit_tpu_torch.modules import unet_extras as tux
from ccedit_tpu_torch.ops import video as tvideo

torch.set_num_threads(1)
ATOL = 1e-4
TINY = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2, 1), channel_mult=(1, 2), num_heads=2,
            transformer_depth=1, context_dim=16)


def random_params(module, *args, seed=0, **kwargs):
    """The JAX module's parameter tree with seeded values: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), learnable alphas
    0.5 + N(0, 0.1^2), the rest N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rs = np.random.RandomState(seed)

    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        else:
            base = 1.0 if leaf == "scale" else 0.5 if leaf.startswith("alpha") else 0.0
            x = x * 0.1 + base
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(port_out, jax_out):
    np.testing.assert_allclose(port_out.detach().numpy(), np.asarray(jax_out), atol=ATOL, rtol=0)


def _sub(params, head, prefix):
    """A sub-module's tree through ``from_jax`` under a UNet head name, its
    keys stripped of the head's sgm prefix."""
    sd = from_jax("unet", {head: params})
    return {k[len(prefix):]: v for k, v in sd.items()}


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _randn(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# residual and resampling blocks
# ---------------------------------------------------------------------------

RES_OPTIONS = [
    dict(use_scale_shift_norm=True),
    dict(up=True),
    dict(down=True),
    dict(use_conv_skip=True, out_channels=64),
    dict(out_channels=64),
    dict(skip_t_emb=True),
    dict(use_scale_shift_norm=True, down=True, out_channels=64),
]


@pytest.mark.parametrize("opts", RES_OPTIONS, ids=lambda o: "-".join(o))
def test_resblock_2d(opts):
    rs = np.random.RandomState(1)
    x, emb = _randn(rs, 2, 8, 8, 32), _randn(rs, 2, 48)
    jm = jbl.ResBlock(channels=32, emb_channels=48, **opts)
    params = random_params(jm, _j(x), _j(emb))
    tm = _load(tbl.ResBlock(32, 48, **opts), _sub(params, "mid_res1", "middle_block.0."))
    with torch.no_grad():
        _close(tm(_t(x), _t(emb)), jm.apply({"params": params}, _j(x), _j(emb)))


RES3D_OPTIONS = RES_OPTIONS + [
    dict(use_learnable_alpha=True),
    dict(use_learnable_alpha=True, use_scale_shift_norm=True, up=True, out_channels=64),
    dict(use_conv_skip=True, out_channels=64, use_learnable_alpha=True),
    dict(ssn=True),
    dict(ssn=True, use_scale_shift_norm=True),
]


@pytest.mark.parametrize("opts", RES3D_OPTIONS, ids=lambda o: "-".join(o))
def test_resblock_3d(opts):
    rs = np.random.RandomState(2)
    x, emb = _randn(rs, 2, 4, 8, 8, 32), _randn(rs, 2, 48)
    ssn = opts.get("ssn", False)
    img_emb = _randn(rs, 2, 2 * opts.get("out_channels", 32)) * 0.3 if ssn else None
    jm = jbl.ResBlock3D(channels=32, emb_channels=48, **opts)
    params = random_params(jm, _j(x), _j(emb), _j(img_emb))
    tm = _load(tbl.ResBlock3D(32, 48, **opts), _sub(params, "mid_res1", "middle_block.0."))
    ref = jm.apply({"params": params}, _j(x), _j(emb), _j(img_emb), return_inject=ssn)
    with torch.no_grad():
        out = tm(_t(x), _t(emb), _t(img_emb), return_inject=ssn)
    if ssn:
        _close(out[1], ref[1])
        out, ref = out[0], ref[0]
    _close(out, ref)


@pytest.mark.parametrize("name", ["Downsample", "Upsample", "Downsample3D", "Upsample3D"])
def test_resampling_without_conv(name):
    rs = np.random.RandomState(3)
    x = _randn(rs, 2, 3, 8, 8, 32) if name.endswith("3D") else _randn(rs, 2, 8, 8, 32)
    jm = getattr(jbl, name)(channels=32, use_conv=False)
    tm = getattr(tbl, name)(32, use_conv=False)
    assert not list(tm.parameters())
    _close(tm(_t(x)), jm.apply({}, _j(x)))


# ---------------------------------------------------------------------------
# transformers
# ---------------------------------------------------------------------------

def test_repeat_ctx_temporal_is_the_h_major_order():
    """The temporal text context in the temporal tokens' own (H*B*W) order:
    row r of ``tokens_to_temporal`` holds batch element (r // W) % B."""
    rs = np.random.RandomState(4)
    b, t, h, w, l = 2, 3, 4, 5, 7
    ctx = _randn(rs, b, l, 16)
    out = tvideo.repeat_ctx_temporal(_t(ctx), h, w)
    _close(out, jvideo.repeat_ctx_temporal(_j(ctx), h, w))
    tokens = np.arange(b * t * h * w, dtype=np.float32).reshape(b * t, h, w, 1)
    rows = tvideo.tokens_to_temporal(_t(tokens), b)[:, 0, 0].long()  # frame 0's token ids
    owner = rows // (t * h * w)
    assert torch.equal(out, _t(ctx)[owner])


def test_cross_attention_kv_reuse():
    rs = np.random.RandomState(5)
    x = _randn(rs, 4, 6, 16)
    jm = jtr.CrossAttention(query_dim=16, heads=2, dim_head=8)
    params = random_params(jm, _j(x))
    sd = _sub({"blocks_0": {"attn1": params}}, "mid_attn", "middle_block.1.transformer_blocks.0.attn1.")
    tm = _load(ttr.CrossAttention(16, 2, 8), sd)
    with torch.no_grad():
        out = tm(_t(x), kv_reuse_every=2)
        _close(out, jm.apply({"params": params}, _j(x), kv_reuse_every=2))
        _close(out[1:2], tm(_t(x[1:2]), context=_t(x[0:1])))  # frame 1 reads frame 0's k/v


ST_OPTIONS = [
    dict(use_linear=True),
    dict(disable_self_attn=True),
    dict(kv_reuse_every=2),
    dict(use_linear=True, disable_text_ca=True),
    dict(use_linear=True, disable_self_attn=True, kv_reuse_every=2),
]


@pytest.mark.parametrize("opts", ST_OPTIONS, ids=lambda o: "-".join(o))
def test_spatial_transformer(opts):
    rs = np.random.RandomState(6)
    opts = dict(opts)
    reuse = opts.pop("kv_reuse_every", 0)
    x, ctx = _randn(rs, 4, 4, 6, 64), _randn(rs, 4, 7, 16)
    jm = jtr.SpatialTransformer(in_channels=64, n_heads=2, d_head=32, context_dim=16, **opts)
    params = random_params(jm, _j(x), _j(ctx), kv_reuse_every=reuse)
    sd = _sub(params, "mid_attn", "middle_block.1.")
    if opts.get("use_linear"):
        assert sd["proj_in.weight"].dim() == 2 and sd["proj_out.weight"].dim() == 2
    tm = _load(ttr.SpatialTransformer(64, 2, 32, context_dim=16, **opts), sd)
    with torch.no_grad():
        out = tm(_t(x), context=_t(ctx), kv_reuse_every=reuse)
    _close(out, jm.apply({"params": params}, _j(x), _j(ctx), kv_reuse_every=reuse))


@pytest.mark.parametrize("use_linear", [False, True])
@pytest.mark.parametrize("with_ref", [False, True])
def test_spatial_transformer_ca(use_linear, with_ref):
    """RAIG's reference sub-layer, its K/V the un-normalised bank tokens;
    without a bank the module is the ``SpatialTransformer``."""
    rs = np.random.RandomState(7)
    x, ctx, ref = _randn(rs, 2, 4, 6, 64), _randn(rs, 2, 7, 16), _randn(rs, 2, 20, 64) * 3
    jm = jtr.SpatialTransformerCA(in_channels=64, n_heads=2, d_head=32, context_dim=16,
                                  use_linear=use_linear)
    params = random_params(jm, _j(x), _j(ctx), _j(ref))
    sd = _sub(params, "mid_attn", "middle_block.1.")
    assert "transformer_blocks_ca.0.attn1.to_k.weight" in sd and "norm_ca.weight" in sd
    tm = _load(ttr.SpatialTransformerCA(64, 2, 32, context_dim=16, use_linear=use_linear), sd)
    jref = _j(ref) if with_ref else None
    with torch.no_grad():
        out = tm(_t(x), context=_t(ctx), ref_context=_t(ref) if with_ref else None)
    _close(out, jm.apply({"params": params}, _j(x), _j(ctx), ref_context=jref))
    if not with_ref:
        plain = _load(ttr.SpatialTransformer(64, 2, 32, context_dim=16, use_linear=use_linear),
                      {k: v for k, v in sd.items() if "_ca" not in k})
        with torch.no_grad():
            assert torch.equal(out, plain(_t(x), context=_t(ctx)))


ST3D_OPTIONS = [
    dict(disable_temporal_text_ca=False),
    dict(use_linear=True),
    dict(use_learnable_alpha=True),
    dict(disable_self_attn=True),
    dict(disable_temporal_text_ca=False, use_linear=True, use_learnable_alpha=True,
         disable_self_attn=True),
]


@pytest.mark.parametrize("opts", ST3D_OPTIONS, ids=lambda o: "-".join(o))
@pytest.mark.parametrize("cfca", [False, True])
def test_spatial_transformer_3d(opts, cfca):
    """Temporal text cross-attention (the text context repeated per (h, w)
    row), Linear projections (spatial, temporal, CFCA), the temporal alpha
    and ``disable_self_attn``, on the 3-D transformer and its CFCA form."""
    rs = np.random.RandomState(8)
    x, ctx = _randn(rs, 2, 3, 4, 5, 64), _randn(rs, 2, 7, 16)
    kw = dict(in_channels=64, n_heads=2, d_head=32, context_dim=16, **opts)
    if cfca:
        jm = jtr.SpatialTransformer3DCA(ca_type="center_self", **kw)
        port = ttr.SpatialTransformer3DCA
    else:
        jm, port = jtr.SpatialTransformer3D(**kw), ttr.SpatialTransformer3D
    params = random_params(jm, _j(x), _j(ctx))
    sd = _sub(params, "mid_attn", "middle_block.1.")
    if not opts.get("disable_temporal_text_ca", True):
        assert sd["transformer_blocks_temporal.0.attn2.to_k.weight"].shape == (64, 16)
    if opts.get("use_learnable_alpha"):
        assert sd["alpha_temporal"].shape == (1,)
    if opts.get("use_linear"):
        assert sd["proj_in_temporal.weight"].dim() == 2
    tm = port(64, 2, 32, context_dim=16, **({"ca_type": "center_self"} if cfca else {}), **opts)
    _load(tm, sd)
    with torch.no_grad():
        out = tm(_t(x), context=_t(ctx))
    _close(out, jm.apply({"params": params}, _j(x), _j(ctx)))


# ---------------------------------------------------------------------------
# unet_extras
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [(1, -1), (4, -1), (1, 8)])
def test_attention_block(heads):
    rs = np.random.RandomState(16)
    x = _randn(rs, 2, 4, 6, 32)
    jm = jux.AttentionBlock(channels=32, num_heads=heads[0], num_head_channels=heads[1])
    params = random_params(jm, _j(x))
    sd = from_jax("encoder_unet", {"mid_attn": params})
    sd = {k[len("middle_block.1."):]: v for k, v in sd.items()}
    assert sd["qkv.weight"].shape == (96, 32, 1)
    tm = _load(tux.AttentionBlock(32, *heads), sd)
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply({"params": params}, _j(x)))


def test_attention_pool_2d():
    rs = np.random.RandomState(17)
    x = _randn(rs, 2, 4, 4, 32)
    jm = jux.AttentionPool2d(spacial_dim=4, embed_dim=32, num_heads_channels=8, output_dim=10)
    params = random_params(jm, _j(x))
    sd = from_jax("encoder_unet", {"out_pool": params})
    sd = {k[len("out.2."):]: v for k, v in sd.items()}
    assert sd["positional_embedding"].shape == (32, 17)
    tm = _load(tux.AttentionPool2d(4, 32, 8, 10), sd)
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply({"params": params}, _j(x)))


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
@pytest.mark.parametrize("resblock_updown", [False, True])
def test_encoder_unet(pool, resblock_updown):
    rs = np.random.RandomState(18)
    x, ts = _randn(rs, 2, 16, 16, 3), np.array([3.0, 500.0], np.float32)
    kw = dict(image_size=16, in_channels=3, model_channels=32, out_channels=10,
              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
              num_head_channels=16, use_scale_shift_norm=True,
              resblock_updown=resblock_updown, pool=pool)
    jm = jux.EncoderUNetModel(**kw)
    params = random_params(jm, _j(x), _j(ts))
    tm = _load(tux.EncoderUNetModel(**kw), from_jax("encoder_unet", params))
    with torch.no_grad():
        out = tm(_t(x), _t(ts))
    assert tuple(out.shape) == (2, 10)
    _close(out, jm.apply({"params": params}, _j(x), _j(ts)))
