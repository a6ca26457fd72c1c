"""The TVI2V slice's modules, port against the JAX package, on the CPU in
fp32: the 2-D ``disable_text_ca`` transformer, the CFCA transformer (every
``ca_type``, and the reference bank), the UNet with the appearance branch's
``img_control`` / ``ref_contexts``, the appearance ``ControlNet2D``
(identity hint, ``no_add_x``, 2-D input), the whole TVI2V ``CCEditNetwork``
and the VAE encoder with its posterior.

Weights: the JAX modules' own parameter trees filled with seeded values,
carried into the port with ``from_jax`` and a strict ``load_state_dict``.
Tolerance 1e-4 absolute (docs/PARITY.md): fp32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import transformer as jtr
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import transformer as ttr
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae

torch.set_num_threads(1)
ATOL = 1e-4
APPEARANCE = dict(hint_channels=4, input_hint_identity=True, no_add_x=True,
                  disable_text_ca=True)


def random_params(module, *args, seed=0, method=None):
    """The JAX module's parameter tree with seeded values: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2)."""
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


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()}


def test_spatial_transformer_disable_text_ca():
    rs = np.random.RandomState(11)
    x = rs.standard_normal((2, 4, 6, 64)).astype(np.float32)
    ctx = rs.standard_normal((2, 7, 16)).astype(np.float32)
    jm = jtr.SpatialTransformer(in_channels=64, n_heads=2, d_head=32, context_dim=16,
                                disable_text_ca=True)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(ctx))
    sd = _strip(from_jax("unet", {"mid_attn": params}), "middle_block.1.")
    assert not any("attn2" in k or "norm3" in k for k in sd)
    tm = port_copy(ttr.SpatialTransformer(64, 2, 32, context_dim=16, disable_text_ca=True), sd)
    with torch.no_grad():
        out = tm(_t(x), context=_t(ctx))
    _close(out, jm.apply({"params": params}, jnp.asarray(x), context=jnp.asarray(ctx)))


@pytest.mark.parametrize("ca_type", ["center", "self", "center_self"])
@pytest.mark.parametrize("with_ref", [False, True])
def test_cfca_transformer(ca_type, with_ref):
    rs = np.random.RandomState(12)
    b, t, h, w, c = 2, 3, 4, 4, 64
    x = rs.standard_normal((b, t, h, w, c)).astype(np.float32)
    ctx = rs.standard_normal((b, 7, 16)).astype(np.float32)
    ref = rs.standard_normal((b, h * w, c)).astype(np.float32) if with_ref else None
    jm = jtr.SpatialTransformer3DCA(in_channels=c, n_heads=2, d_head=32, context_dim=16,
                                    disable_temporal_text_ca=True, ca_type=ca_type)
    jref = None if ref is None else jnp.asarray(ref)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(ctx), jref)
    sd = _strip(from_jax("unet", {"mid_attn": params}), "middle_block.1.")
    assert "transformer_blocks_temporal_ca.0.attn1.to_k.weight" in sd
    tm = port_copy(ttr.SpatialTransformer3DCA(c, 2, 32, context_dim=16, ca_type=ca_type), sd)
    with torch.no_grad():
        out = tm(_t(x), context=_t(ctx), ref_context=None if ref is None else _t(ref))
    _close(out, jm.apply({"params": params}, jnp.asarray(x), context=jnp.asarray(ctx),
                         ref_context=jref))


def _jax_network(crossframe_type):
    return jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True,
                           enable_attention3d_crossframe=True, st3dca_ca_type="center_self",
                           **_TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY),
        controlnet_img=jcn.ControlNet2D(**APPEARANCE, **_TINY),
        crossframe_type=crossframe_type)


def port_network(params, crossframe_type):
    """The port's TVI2V network carrying the JAX parameter tree."""
    return tcn.CCEditNetwork(
        port_copy(tun.UNetModel(unet_type="pseudo-3d", enable_attention3d_crossframe=True,
                                st3dca_ca_type="center_self", **_TINY),
                  from_jax("unet", params["unet"])),
        port_copy(tcn.ControlNet2D(hint_channels=3, **_TINY),
                  from_jax("controlnet", params["controlnet"])),
        port_copy(tcn.ControlNet2D(**APPEARANCE, **_TINY),
                  from_jax("controlnet", params["controlnet_img"])),
        crossframe_type=crossframe_type).eval()


@pytest.fixture(scope="module", params=[None, "reference"])
def tvi2v_network(request):
    """The tiny TVI2V network (CFCA centre+self, structure and appearance
    ControlNets) on both sides; "reference" is ``__graft_entry__``'s
    flagship, whose CFCA takes the appearance branch's bank."""
    rs = np.random.RandomState(13)
    b, t, h, w = 2, 3, 8, 8
    x = rs.standard_normal((b, t, h, w, 4)).astype(np.float32)
    ts = np.array([10.0, 700.0], np.float32)
    ctx = rs.standard_normal((b, 7, 16)).astype(np.float32)
    hint = rs.uniform(-1, 1, (b, t, 8 * h, 8 * w, 3)).astype(np.float32)
    feat = rs.standard_normal((b, h, w, 4)).astype(np.float32)
    jn = _jax_network(request.param)
    cond = {"crossattn": jnp.asarray(ctx), "control_hint": jnp.asarray(hint),
            "cond_feat": jnp.asarray(feat)}
    params = random_params(jn, jnp.asarray(x), jnp.asarray(ts), cond, seed=14)
    return dict(jn=jn, params=params, tn=port_network(params, request.param), x=x, ts=ts,
                ctx=ctx, hint=hint, feat=feat, cond=cond, crossframe_type=request.param)


def test_appearance_controlnet_taps(tvi2v_network):
    """The appearance branch on the centre frame, 2-D input: identity hint
    through the stem conv, which replaces h at block 0 (no_add_x), and the
    zero convs on all its taps."""
    n = tvi2v_network
    jc = jcn.ControlNet2D(**APPEARANCE, **_TINY)
    xc = n["x"][:, n["x"].shape[1] // 2]
    ref = jc.apply({"params": n["params"]["controlnet_img"]}, jnp.asarray(xc),
                   jnp.asarray(n["feat"]), jnp.asarray(n["ts"]), context=jnp.asarray(n["ctx"]),
                   return_attn_bank=True)
    cn = n["tn"].controlnet_img
    bank = []
    with torch.no_grad():
        out = cn(_t(xc), cn.encode_hint(_t(n["feat"])), _t(n["ts"]), context=_t(n["ctx"]),
                 bank=bank)
    assert len(out) == len(ref[0]) == 5 and len(bank) == len(ref[1]) == 3
    for o, r in zip(out + tuple(bank), ref[0] + ref[1]):
        _close(o, r)


def test_unet_with_appearance_inputs(tvi2v_network):
    n = tvi2v_network
    rs = np.random.RandomState(15)
    ju = n["jn"].unet
    img_control = [rs.standard_normal((2,) + s).astype(np.float32) * 0.3 for s in
                   [(8, 8, 32), (8, 8, 32), (4, 4, 32), (4, 4, 64), (4, 4, 64)]]
    refs = [rs.standard_normal((2, hw, c)).astype(np.float32)
            for hw, c in ((64, 32), (16, 64), (16, 64))]
    ref = ju.apply({"params": n["params"]["unet"]}, jnp.asarray(n["x"]), jnp.asarray(n["ts"]),
                   context=jnp.asarray(n["ctx"]),
                   img_control=tuple(map(jnp.asarray, img_control)),
                   ref_contexts=tuple(map(jnp.asarray, refs)))
    with torch.no_grad():
        out = n["tn"].unet(_t(n["x"]), _t(n["ts"]), context=_t(n["ctx"]),
                           img_control=[_t(c) for c in img_control],
                           ref_contexts=[_t(r) for r in refs])
    _close(out, ref)


def test_tvi2v_network(tvi2v_network):
    n = tvi2v_network
    ref = n["jn"].apply({"params": n["params"]}, jnp.asarray(n["x"]), jnp.asarray(n["ts"]),
                        n["cond"])
    with torch.no_grad():
        out = n["tn"](_t(n["x"]), _t(n["ts"]), {"crossattn": _t(n["ctx"]),
                                                "control_hint": _t(n["hint"]),
                                                "cond_feat": _t(n["feat"])})
    _close(out, ref)


def test_vae_encoder_and_posterior():
    """encode_moments on video (folded per frame) and on single frames; the
    posterior's mode, and its sample with the same noise."""
    rs = np.random.RandomState(16)
    kw = dict(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
    jm = jvae.AutoencoderKL(resolution=64, **kw)
    params = random_params(jm, jnp.zeros((1, 32, 32, 3)), None, False, seed=17)
    tm = tvae.AutoencoderKL(**kw)
    tm.load_reference_state_dict(from_jax("vae", params))
    tm.eval()
    for shape in ((1, 2, 32, 48, 3), (2, 32, 32, 3)):
        x = rs.uniform(-1, 1, shape).astype(np.float32)
        ref = jm.apply({"params": params}, jnp.asarray(x), method=jvae.AutoencoderKL.encode_moments)
        with torch.no_grad():
            out = tm.encode_moments(_t(x))
        assert out.shape == ref.shape == shape[:-3] + (shape[-3] // 8, shape[-2] // 8, 8)
        _close(out, ref)
        post, jpost = tvae.DiagonalGaussian(out), jvae.DiagonalGaussian(ref)
        _close(post.mode(), jpost.mode())
        noise = rs.standard_normal(post.mean.shape).astype(np.float32)
        _close(post.sample(noise=_t(noise)), jpost.mean + jpost.std * noise)
