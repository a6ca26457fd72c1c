"""The network variants' UNet and ControlNet options, port against the JAX
package, on the CPU in fp32: per-level ``num_res_blocks`` and
``transformer_depth``, legacy heads, ``conv_resample=False``,
``use_scale_shift_norm``, ``label_emb`` with ``y``, Linear projections,
temporal text cross-attention and learnable alphas through the whole UNet,
2-D and pseudo-3D; RAIG's reference bank (every transformer takes the next
entry), ``interpolate_control`` (at T = 1 too), ``only_mid_control``,
``ControlNet3D`` in both modes, ``ControlNet2D`` with ``y``,
``raig_ref_mapping`` and ``NoTimeUNetModel``.

Weights and tolerance as in ``test_torch_port_variant_modules.py`` (whose
helpers this file uses): seeded JAX trees through ``from_jax``, 1e-4
absolute, T = 4 frames.
"""

import jax
import numpy as np
import pytest
import torch

from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import unet_extras as jux
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import unet_extras as tux
from test_torch_port_variant_modules import TINY, _close, _j, _load, _randn, _t, random_params

torch.set_num_threads(1)



UNET_OPTIONS = [
    ("2d", dict(num_res_blocks=(1, 2), transformer_depth=(1, 2), legacy=True,
                num_head_channels=8, conv_resample=False)),
    ("2d", dict(adm_in_channels=12, use_linear_in_transformer=True, use_scale_shift_norm=True)),
    ("pseudo-3d", dict(num_res_blocks=(2, 1), transformer_depth=(1, 2), conv_resample=False,
                       adm_in_channels=12)),
    ("pseudo-3d", dict(disable_temporal_text_ca=False, use_linear_in_transformer=True,
                       use_learnable_alpha=True, use_scale_shift_norm=True)),
    ("pseudo-3d", dict(enable_attention3d_crossframe=True, st3dca_ca_type="center",
                       use_linear_in_transformer=True, use_learnable_alpha=True)),
]


def _unet_inputs(unet_type, rs, b=2, t=4):
    shape = (b, t, 8, 8, 4) if unet_type == "pseudo-3d" else (b, 8, 8, 4)
    return _randn(rs, *shape), np.array([10.0, 700.0][:b], np.float32), _randn(rs, b, 7, 16)


@pytest.mark.parametrize("unet_type,opts", UNET_OPTIONS,
                         ids=lambda o: o if isinstance(o, str) else "-".join(o))
def test_unet_options(unet_type, opts):
    rs = np.random.RandomState(9)
    x, ts, ctx = _unet_inputs(unet_type, rs)
    kw = dict(TINY, **opts)
    y = _randn(rs, 2, 12) if opts.get("adm_in_channels") else None
    jm = jun.UNetModel(unet_type=unet_type, **kw)
    params = random_params(jm, _j(x), _j(ts), _j(ctx), _j(y))
    sd = from_jax("unet", params)
    if y is not None:
        assert sd["label_emb.0.0.weight"].shape == (128, 12)
    tm = _load(tun.UNetModel(unet_type=unet_type, **kw), sd)
    with torch.no_grad():
        out = tm(_t(x), _t(ts), context=_t(ctx), y=_t(y))
    _close(out, jm.apply({"params": params}, _j(x), _j(ts), _j(ctx), _j(y)))


def test_unet_legacy_heads_match_jax():
    for ch, nh, nhc in ((320, 8, -1), (640, 8, 64), (1280, 5, 64), (96, 4, 32)):
        for legacy in (False, True):
            j = jun.UNetModel(num_heads=nh, num_head_channels=nhc, legacy=legacy)._heads_dims(ch)
            assert tun.heads_dims(ch, nh, nhc, legacy) == j


def test_unet_2d_reference_attention():
    """The 2-D UNet with ``enable_ref_attn``: every transformer takes the
    next bank entry in application order."""
    rs = np.random.RandomState(10)
    x, ts, ctx = _unet_inputs("2d", rs)
    kw = dict(TINY, enable_ref_attn=True)
    refs = [_randn(rs, 2, n, c) for n, c in ((64, 32), (16, 64), (16, 64), (16, 64),
                                             (16, 64), (64, 32), (64, 32))]
    jm = jun.UNetModel(unet_type="2d", **kw)
    params = random_params(jm, _j(x), _j(ts), _j(ctx), ref_contexts=tuple(map(_j, refs)))
    tm = _load(tun.UNetModel(unet_type="2d", **kw), from_jax("unet", params))
    ref = jm.apply({"params": params}, _j(x), _j(ts), _j(ctx), ref_contexts=tuple(map(_j, refs)))
    with torch.no_grad():
        out = tm(_t(x), _t(ts), context=_t(ctx), ref_contexts=[_t(r) for r in refs])
        plain = tm(_t(x), _t(ts), context=_t(ctx))
    _close(out, ref)
    assert (out - plain).abs().max() > 1e-2  # the bank moved the output


_TAPS = [(8, 8, 32), (8, 8, 32), (4, 4, 32), (4, 4, 64), (4, 4, 64)]


def _zero_temporal(params):
    """The temporal layers at their initial zeros (a fresh pseudo-3D UNet)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * 0 if any("temporal" in str(getattr(k, "key", "")) for k in path)
        else v, params)


def test_unet_interpolate_control():
    """First- and last-frame maps after every input block and the middle
    one.  At T = 1 both land on the one frame: (first, last) gives what
    (first + last, 0) gives.  There the temporal GroupNorms see one value a
    group, which turns fp32 rounding into noise (the plain UNet at T = 1 is
    1e-2 from its fp64 self on both sides), so the T = 1 check runs on the
    port alone with the temporal layers at their initial zeros."""
    rs = np.random.RandomState(11)
    x, ts, ctx = _unet_inputs("pseudo-3d", rs)
    firsts = [_randn(rs, 2, *s) * 0.3 for s in _TAPS]
    lasts = [_randn(rs, 2, *s) * 0.3 for s in _TAPS]
    jm = jun.UNetModel(unet_type="pseudo-3d", **TINY)
    params = random_params(jm, _j(x), _j(ts), _j(ctx))
    tm = _load(tun.UNetModel(unet_type="pseudo-3d", **TINY), from_jax("unet", params))
    ref = jm.apply({"params": params}, _j(x), _j(ts), _j(ctx),
                   interpolate_control=(tuple(map(_j, firsts)), tuple(map(_j, lasts))))
    f, l = [_t(a) for a in firsts], [_t(a) for a in lasts]
    with torch.no_grad():
        out = tm(_t(x), _t(ts), context=_t(ctx), interpolate_control=(f, l))
        first_only = tm(_t(x), _t(ts), context=_t(ctx),
                        interpolate_control=(f, [a * 0 for a in l]))
        _close(out, ref)
        assert (out - first_only).abs().max() > 1e-2  # the last frame's maps count
        _load(tm, from_jax("unet", _zero_temporal(params)))
        x1 = _t(x[:, :1])
        both = tm(x1, _t(ts), context=_t(ctx), interpolate_control=(f, l))
        summed = tm(x1, _t(ts), context=_t(ctx),
                    interpolate_control=([a + b for a, b in zip(f, l)], [a * 0 for a in l]))
        assert (both - tm(x1, _t(ts), context=_t(ctx))).abs().max() > 1e-2
    np.testing.assert_allclose(both.numpy(), summed.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("only_mid", [False, True])
def test_unet_only_mid_control(only_mid):
    """``only_mid_control``: the middle block's control add stays, the
    decoder's go."""
    rs = np.random.RandomState(12)
    x, ts, ctx = _unet_inputs("pseudo-3d", rs)
    control = [_randn(rs, 2, 4, *s) * 0.3 for s in _TAPS]
    jm = jun.UNetModel(unet_type="pseudo-3d", **TINY)
    params = random_params(jm, _j(x), _j(ts), _j(ctx))
    tm = _load(tun.UNetModel(unet_type="pseudo-3d", **TINY), from_jax("unet", params))
    ref = jm.apply({"params": params}, _j(x), _j(ts), _j(ctx), control=tuple(map(_j, control)),
                   only_mid_control=only_mid)
    with torch.no_grad():
        out = tm(_t(x), _t(ts), context=_t(ctx), control=[_t(c) for c in control],
                 only_mid_control=only_mid)
    _close(out, ref)


# ---------------------------------------------------------------------------
# ControlNets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("disable_temporal", [False, True])
def test_controlnet_3d(disable_temporal):
    """The pseudo-3D trunk with its latent hint pyramid and pseudo-3D zero
    taps; ``disable_temporal`` runs the centre frame alone, (B, h, w, C)
    maps out, for the 2-D-initialised checkpoints whose temporal layers are
    zero (at T = 1 random ones would only amplify rounding)."""
    rs = np.random.RandomState(13)
    x, ts, ctx = _unet_inputs("pseudo-3d", rs)
    hint = _randn(rs, 2, 4, 8, 8, 4)
    kw = dict(TINY, disable_temporal=disable_temporal)
    jm = jcn.ControlNet3D(**kw)
    params = random_params(jm, _j(x), _j(hint), _j(ts), _j(ctx))
    if disable_temporal:
        params = _zero_temporal(params)
    sd = from_jax("controlnet", params)
    assert sd["zero_convs_temporal.0.0.weight"].shape == (32, 32, 1)
    assert sd["input_hint_block.14.weight"].shape == (32, 256, 3, 3)
    tm = _load(tcn.ControlNet3D(**kw), sd)
    ref = jm.apply({"params": params}, _j(x), _j(hint), _j(ts), _j(ctx))
    with torch.no_grad():
        out = tm(_t(x), _t(hint), _t(ts), context=_t(ctx))
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        assert o.dim() == (4 if disable_temporal else 5)
        _close(o, r)


def test_controlnet_2d_with_vector_conditioning():
    """ControlNet2D with ``adm_in_channels`` on video: y repeated per frame."""
    rs = np.random.RandomState(14)
    x, ts, ctx = _unet_inputs("pseudo-3d", rs)
    hint, y = rs.uniform(-1, 1, (2, 4, 64, 64, 3)).astype(np.float32), _randn(rs, 2, 12)
    kw = dict(TINY, hint_channels=3, adm_in_channels=12)
    jm = jcn.ControlNet2D(**kw)
    params = random_params(jm, _j(x), _j(hint), _j(ts), _j(ctx), _j(y))
    tm = _load(tcn.ControlNet2D(**kw), from_jax("controlnet", params))
    ref = jm.apply({"params": params}, _j(x), _j(hint), _j(ts), _j(ctx), _j(y))
    with torch.no_grad():
        out = tm(_t(x), tm.encode_hint(_t(hint)), _t(ts), context=_t(ctx), y=_t(y))
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("layout", [
    ((1, 2, 4, 4), 2, (4, 2, 1)), ((1, 2, 4), (1, 2, 3), (2, 4)), ((1, 2), 1, (2, 1))])
def test_raig_ref_mapping(layout):
    assert tcn.raig_ref_mapping(*layout) == jcn.raig_ref_mapping(*layout)
    if layout[0] == (1, 2, 4, 4):
        assert tcn.raig_ref_mapping(*layout) == (0, 1, 2, 3, 4, 5, 6, 5, 5, 4, 3, 3, 2, 1, 1, 0)


def test_no_time_unet():
    rs = np.random.RandomState(15)
    x, ts, ctx = _unet_inputs("2d", rs)
    jm = jux.NoTimeUNetModel(unet_type="2d", **TINY)
    params = random_params(jm, _j(x), _j(ts), _j(ctx))
    tm = _load(tux.NoTimeUNetModel(unet_type="2d", **TINY), from_jax("unet", params))
    with torch.no_grad():
        out = tm(_t(x), _t(ts), context=_t(ctx))
        assert torch.equal(out, tm(_t(x), _t(ts) * 0 + 3.0, context=_t(ctx)))
    _close(out, jm.apply({"params": params}, _j(x), _j(ts), _j(ctx)))
