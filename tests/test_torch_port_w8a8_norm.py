"""Kernel 8's fused norm form and the weight cache (``ops/quant.py``) on the
CPU.

- The fused form's plain version (``plain_norm_silu_quantize``, which a CPU
  tensor takes) is bit for bit the unfused chain (GroupNorm module, SiLU,
  ``quantize_int8`` per tensor) for image and temporal GroupNorms, with and
  without the embedding addend, and a ``NormActConv`` under W8A8 is bit for
  bit the conv on the chain's output.
- The blocks whose GroupNorm -> SiLU -> QConv chains take the fused form
  (``ResBlock3D``, ``ResBlock``, ``VAEResnetBlock``, and the chains that
  stay on the old route: the resampling and scale-shift ResBlocks) with
  W8A8 on in both packages, against the JAX blocks within BLOCK_TOL of
  max|JAX| in fp64 (at fp32 the packages' pooling and SiLU round an ulp
  apart, enough to flip an int8 step); each fused site counted.
- ``mirror_norm_amax``, a test-only mirror of the CUDA kernel's pass
  structure (the group statistics, each (sample, channel)'s extremes, the
  amax from them, the third pass where SiLU's minimum may set it), gives
  the plain chain's amax bit for bit: random data, channels
  all negative, a negative gamma, an all-zero tensor (scale 1), and data
  whose amax SiLU's minimum sets (the mirror takes its third pass); with
  the statistics' sums split another way its amax is again the chain's.
  The statistics stay in fp32, as the kernel keeps them (the port's
  GroupNorm keeps a bf16 input's in fp32, as flax does).
- The kernel's SiLU table: outside it bf16(silu(u)) is u / 2 or u.
- The weight cache: ``quantize_weight`` equals ``plain_quantize_weight`` bit
  for bit, hits on a second call and quantizes again after ``copy_``,
  ``load_state_dict``, the port's LoRA merge, an in-place update and a
  dtype change (its counts say so); an inference tensor is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ccedit_tpu.modules import blocks as jb
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch.io import lora as tlora
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import blocks as tb
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import layers as tl
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae
from ccedit_tpu_torch.ops import quant
from ccedit_tpu_torch.scripts import roofline
from test_torch_port_modules import port_copy, random_params
from test_torch_port_swaps import CLIP, _kohya_lora
from test_torch_port_w8a8 import BLOCK_TOL, state_dict, w8a8  # noqa: F401 (fixture)
from __graft_entry__ import _TINY

torch.set_num_threads(1)
SILU_WINDOW = (-1.5, -1.0)  # csrc/quantize_int8.cu kSiluWindowLo/Hi
SILU_PEAK = 0.28  # kSiluPeak


def _norm(c, eps, rs, dtype, gamma=None, beta=None):
    norm = tl.GroupNorm(32, c, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(1 + 0.1 * rs.standard_normal(c)) if gamma is None
                          else torch.as_tensor(gamma, dtype=torch.float64).expand(c))
        norm.bias.copy_(torch.from_numpy(0.1 * rs.standard_normal(c)) if beta is None
                        else torch.as_tensor(beta, dtype=torch.float64).expand(c))
    return norm.to(dtype)


def _x(shape, rs, dtype, scale=1.0, shift=0.0):
    return torch.from_numpy(scale * rs.standard_normal(shape) + shift).to(dtype)


# ---- the plain version is the unfused chain ----

CHAINS = [("image", (2, 6, 8, 64)), ("temporal", (24, 5, 64))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("add", [False, True], ids=["no_add", "add"])
@pytest.mark.parametrize("kind,shape", CHAINS, ids=[k for k, _ in CHAINS])
def test_plain_form_is_the_unfused_chain(kind, shape, add, dtype, w8a8):
    rs = np.random.RandomState(len(shape) + add)
    c = shape[-1]
    x = _x(shape, rs, dtype)
    norm = _norm(c, 1e-5, rs, dtype)
    a = _x((shape[0], c), rs, dtype, 0.5) if add else None
    counts = {k: w.launches for k, w in quant.COUNTED.items()}
    with torch.no_grad():
        qa = quant.norm_silu_quantize(x, norm, a)
        xa = x if a is None else x + a.reshape((shape[0],) + (1,) * (x.dim() - 2) + (c,))
        y = nn.SiLU()(norm(xa))
        q, scale = quant.quantize_int8(y.reshape(-1, c), per_row=False)
    assert {k: w.launches for k, w in quant.COUNTED.items()} == counts  # the CPU launches nothing
    assert qa.shape == tuple(shape) and qa.dtype == dtype
    assert torch.equal(qa.q, q) and torch.equal(qa.scale, scale)
    # through the layers: NormActConv under W8A8 equals the conv on the chain's output
    conv = (tl.conv2d(c, 16, quant=True) if kind == "image"
            else tl.temporal_conv(c, 16, 3, zero=False, quant=True)).to(dtype)
    chain = tl.NormActConv(norm, nn.SiLU(), nn.Identity(), conv)
    with torch.no_grad():
        assert torch.equal(chain(x, add=a), conv(y))


# ---- the blocks against the JAX package ----

def _sub(params, head, prefix):
    sd = from_jax("unet", {head: params})
    return {k[len(prefix):]: v for k, v in sd.items()}


def _held64(tm, jm64, params, args):
    """The port block in fp64 against the JAX block in fp64 (x64) within
    BLOCK_TOL of max|JAX|: at fp32 the packages round a pooling or a SiLU an
    ulp apart, enough to flip an int8 step; in fp64 nothing rounds apart
    before a quantizer's fp32 cast."""
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        ref = np.asarray(jm64.apply({"params": p64}, *(jnp.asarray(a, jnp.float64)
                                                        for a in args)))
    assert ref.dtype == np.float64
    with torch.no_grad():
        out = tm.double()(*(torch.from_numpy(np.asarray(a, np.float64)) for a in args))
    assert out.shape == ref.shape
    assert float(np.abs(out.numpy() - ref).max() / np.abs(ref).max()) <= BLOCK_TOL


def _fused_calls(monkeypatch):
    calls = []
    sound = quant.norm_silu_quantize

    def counting(x, norm, add=None):
        calls.append(tuple(x.shape))
        return sound(x, norm, add)

    monkeypatch.setattr(quant, "norm_silu_quantize", counting)
    return calls


RES_OPTIONS = [  # (options, fused chains a call: in and out; the out alone where the in chain
    # resamples between its SiLU and its conv; the in alone where the out norm is modulated)
    (dict(), 2), (dict(out_channels=64), 2), (dict(skip_t_emb=True), 2),
    (dict(use_scale_shift_norm=True), 1), (dict(down=True), 1), (dict(up=True, out_channels=64), 1),
]


@pytest.mark.parametrize("opts,chains", RES_OPTIONS, ids=lambda o: "-".join(o) or "plain"
                         if isinstance(o, dict) else str(o))
def test_resblock_2d(opts, chains, w8a8, monkeypatch):
    rs = np.random.RandomState(31)
    x, emb = (rs.standard_normal(s).astype(np.float32) for s in ((2, 8, 8, 32), (2, 48)))
    jm = jb.ResBlock(channels=32, emb_channels=48, **opts)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(emb), seed=32)
    tm = port_copy(tb.ResBlock(32, 48, **opts), _sub(params, "mid_res1", "middle_block.0."))
    calls = _fused_calls(monkeypatch)
    _held64(tm, jb.ResBlock(channels=32, emb_channels=48, dtype=jnp.float64, **opts), params,
            (x, emb))
    assert len(calls) == chains


@pytest.mark.parametrize("opts,chains", [(o, n + 2) for o, n in RES_OPTIONS],
                         ids=lambda o: "-".join(o) or "plain" if isinstance(o, dict) else str(o))
def test_resblock_3d(opts, chains, w8a8, monkeypatch):
    """The 2-D block's chains plus the two temporal ones (in and out)."""
    rs = np.random.RandomState(33)
    x, emb = (rs.standard_normal(s).astype(np.float32) for s in ((2, 3, 8, 8, 32), (2, 48)))
    jm = jb.ResBlock3D(channels=32, emb_channels=48, **opts)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(emb), seed=34)
    tm = port_copy(tb.ResBlock3D(32, 48, **opts), _sub(params, "mid_res1", "middle_block.0."))
    calls = _fused_calls(monkeypatch)
    _held64(tm, jb.ResBlock3D(channels=32, emb_channels=48, dtype=jnp.float64, **opts), params,
            (x, emb))
    assert len(calls) == chains
    assert sum(len(s) == 3 for s in calls) == 2  # the temporal norms' (H*B*W, T, C) rows


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_vae_resnet_block(cin, cout, w8a8, monkeypatch):
    rs = np.random.RandomState(35 + cout)
    x = rs.standard_normal((2, 8, 8, cin)).astype(np.float32)
    jm = jvae.VAEResnetBlock(cin, cout)
    params = random_params(jm, jnp.asarray(x), seed=36)
    calls = _fused_calls(monkeypatch)
    _held64(port_copy(tvae.VAEResnetBlock(cin, cout), state_dict(params)),
            jvae.VAEResnetBlock(cin, cout, dtype=jnp.float64), params, (x,))
    assert calls == [(2, 8, 8, cin), (2, 8, 8, cout)]


def test_vae_decoder_norm_out(w8a8, monkeypatch):
    """The decoder (its blocks and norm_out -> conv_out) with W8A8 in both
    packages, in fp64 (x64 on the JAX side), where nothing rounds apart
    before a quantizer's fp32 cast: every fused site counted."""
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=())
    jm = jvae.AutoencoderKL(resolution=16, **kw)
    tm = tvae.AutoencoderKL(resolution=16, **kw)
    params = random_params(jm, jnp.zeros((1, 16, 16, 3)), None, False, seed=37)
    tm.load_reference_state_dict(from_jax("vae", params))
    z = np.random.RandomState(38).standard_normal((2, 4, 4, 4))
    calls = _fused_calls(monkeypatch)
    with jax.enable_x64():
        jm64 = jvae.AutoencoderKL(resolution=16, dtype=jnp.float64, **kw)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        ref = jm64.apply({"params": p64}, jnp.asarray(z), method=jvae.AutoencoderKL.decode)
    with torch.no_grad():
        out = tm.double().decode(torch.from_numpy(z))
    rel = float(np.abs(out.numpy() - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())
    assert rel <= BLOCK_TOL
    # mid: 2 blocks x 2; up: 2 levels x 2 blocks x 2; norm_out
    assert len(calls) == 4 + 8 + 1 and calls[-1][-1] == 32


# ---- the kernel's pass structure ----

def _fma32(a, b, c):
    """fp32 fma(a, b, c): the product exact in fp64, one rounding to fp32
    (through fp64)."""
    return (a.double() * b.double() + c.double()).float()


def mirror_norm_amax(x, norm, add=None, splits=3):
    """The pass structure of ``norm_silu_quantize`` (``csrc/quantize_int8.cu``):
    v = bf16(x + add); each (sample, group)'s mean and rstd in fp32 (here
    from ``splits`` sums of v - its group's first value, combined in fp64:
    the kernel reproduces torch's CUDA Welford order instead, which only the
    card can check); k = rstd * gamma, b =
    fma(-k, mean, beta); each (sample, channel)'s min and max of v; the amax
    the largest |bf16(silu(bf16(fma(k, v, b))))| at them, unless it is
    below SILU_PEAK while some channel's u-interval reaches SILU_WINDOW:
    then the third pass, the largest over every value.  Returns (amax,
    third pass taken, the largest over every value)."""
    s, c, g = x.shape[0], x.shape[-1], norm.num_groups
    cg = c // g
    v = x.reshape(s, -1, c)
    if add is not None:
        v = v + add[:, None, :]
    v = v.float()
    p = v.shape[1]
    vg = v.reshape(s, p, g, cg)
    shift = vg[:, 0, :, :1]
    per = -(-p // splits)
    d1 = torch.zeros((s, g), dtype=torch.float64)
    d2 = torch.zeros((s, g), dtype=torch.float64)
    for sp in range(splits):
        dv = vg[:, sp * per:(sp + 1) * per] - shift[:, None]
        d1 += dv.sum((1, 3)).double()
        d2 += (dv * dv).sum((1, 3)).double()
    m1 = d1 / (p * cg)
    var = (d2 / (p * cg) - m1 * m1).clamp_min(0)
    mean = (shift[..., 0].double() + m1).float()
    rstd = (1.0 / (var + norm.eps).sqrt()).float()
    mean, rstd = (t.repeat_interleave(cg, 1) for t in (mean, rstd))
    k = rstd * norm.weight.float()
    b = _fma32(-k, mean, norm.bias.float().expand(s, c))

    def chain(vals):  # (s, n, c)
        u = _fma32(k[:, None], vals, b[:, None].expand_as(vals)).to(torch.bfloat16)
        return u, F.silu(u).float().abs()

    ends = torch.stack([v.amin(1), v.amax(1)], 1)
    u, y = chain(ends)
    amax = y.max()
    lo, hi = u.float().amin(1), u.float().amax(1)
    cross = bool(((lo <= SILU_WINDOW[1]) & (hi >= SILU_WINDOW[0])).any())
    every = chain(v)[1].max()
    if cross and amax < SILU_PEAK:
        return every, True, every
    return amax, False, every


def _amax_case(case, rs):
    """bf16 x (4, 12, 10, 64), a bf16 GroupNorm, the addend and whether the
    third pass is wanted."""
    shape, c = (4, 12, 10, 64), 64
    if case == "random":
        return _x(shape, rs, torch.bfloat16, 1.5, 0.3), _norm(c, 1e-5, rs, torch.bfloat16), \
            _x((4, c), rs, torch.bfloat16, 0.5), False
    if case == "all negative":
        return -_x(shape, rs, torch.float64).abs().to(torch.bfloat16) - 1, \
            _norm(c, 1e-5, rs, torch.bfloat16), None, False
    if case == "negative gamma":
        return _x(shape, rs, torch.bfloat16), _norm(c, 1e-6, rs, torch.bfloat16, gamma=-1.2), \
            None, False
    if case == "all zero":
        return torch.zeros(shape, dtype=torch.bfloat16), \
            _norm(c, 1e-5, rs, torch.bfloat16, beta=0.0), None, False
    # u ~ N(-1.3, 0.3^2): every |silu(u)| below 0.28, SiLU's minimum inside
    return _x(shape, rs, torch.bfloat16), _norm(c, 1e-5, rs, torch.bfloat16, 0.3, -1.3), None, True


@pytest.mark.parametrize("case", ["random", "all negative", "negative gamma", "all zero",
                                  "silu minimum"])
def test_mirror_amax_is_the_chains(case):
    rs = np.random.RandomState(41)
    x, norm, add, third = _amax_case(case, rs)
    with torch.no_grad():
        amax, took, every = mirror_norm_amax(x, norm, add)
        other = mirror_norm_amax(x, norm, add, splits=1)
        ref = quant.plain_norm_silu_quantize(x, norm, add)
        xa = x if add is None else x + add[:, None, None, :]
        plain_amax = F.silu(norm(xa)).float().abs().max()
    assert took == third and other[1] == third
    assert torch.equal(amax, every) and torch.equal(other[0], other[2])
    assert torch.equal(other[0], amax)
    assert torch.equal(amax, plain_amax), (amax.item(), plain_amax.item())
    want = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    assert torch.equal(ref.scale.reshape(()), want)
    if case == "all zero":
        assert ref.scale.item() == 1.0 and not ref.q.any()
    if case == "silu minimum":  # the extremes alone would miss it
        assert amax.item() > 0.277


def test_silu_outside_the_kernels_table():
    """Every bf16 u outside the kernel's SiLU table (2^-10 <= |u| < 2^5):
    bf16(silu(u)) is bf16(u / 2) below it and u above it, as the kernel
    takes them (csrc/quantize_int8.cu ``silu_bits``)."""
    bits = torch.arange(1 << 16, dtype=torch.int32)
    u = (bits << 16).view(torch.float32).to(torch.bfloat16)
    e = (bits >> 7) & 0xFF
    finite = torch.isfinite(u.float())
    y = F.silu(u)
    small = finite & (e < 117)
    assert torch.equal(y[small], (u[small].float() * 0.5).to(torch.bfloat16))
    large = finite & (e >= 117 + 15) & (bits < 0x8000)
    assert large.sum() > 0 and torch.equal(y[large], u[large])


def test_norm_bound():
    b = roofline.norm_quantize_bound((34, 64, 96, 320), add=True)
    n = 34 * 64 * 96 * 320
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx((3 * n + 2 * 34 * 320 + 4 + 4 * 320) / 3.35e12 * 1e3)


# ---- the weight cache ----

def _counts():
    return dict(quant.WEIGHT_CACHE)


def _delta(before):
    now = _counts()
    return {k: now.get(k, 0) - before.get(k, 0) for k in ("hits", "misses")}


def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("shape", [(24, 40), (24, 40, 3, 3), (24, 40, 3), (16, 4, 3, 3)],
                         ids=["linear", "conv3x3", "temporal", "conv_in"])
def test_weight_cache_is_the_quantizer(shape):
    rs = np.random.RandomState(len(shape))
    w = nn.Parameter(torch.from_numpy(rs.standard_normal(shape).astype(np.float32)))
    before = _counts()
    first = quant.quantize_weight(w)
    second = quant.quantize_weight(w)
    assert _delta(before) == {"hits": 1, "misses": 1}
    assert second[0] is first[0]
    assert _same(first, quant.plain_quantize_weight(w))
    # the uncached path as qconv/qlinear ran it before the cache
    taps = int(np.prod(shape[2:]))
    rows = w.detach().permute(0, *range(2, w.dim()), 1).reshape(shape[0], -1)
    assert _same(first, quant.quantize_int8(rows, per_row=True, groups=taps))
    # the activation's dtype is part of the key
    before = _counts()
    bf = quant.quantize_weight(w, torch.bfloat16)
    assert _delta(before) == {"hits": 0, "misses": 1}
    assert _same(bf, quant.plain_quantize_weight(w.to(torch.bfloat16)))


def test_weight_cache_requantizes_a_changed_weight():
    conv = tl.conv2d(8, 16, quant=True)
    before = _counts()
    quant.quantize_weight(conv.weight)
    with torch.no_grad():  # copy_
        conv.weight.copy_(conv.weight * 2)
    again = quant.quantize_weight(conv.weight)
    assert _delta(before) == {"hits": 0, "misses": 2}
    assert _same(again, quant.plain_quantize_weight(conv.weight))
    sd = {k: v * 3 for k, v in conv.state_dict().items()}  # load_state_dict
    before = _counts()
    conv.load_state_dict(sd)
    assert _same(quant.quantize_weight(conv.weight), quant.plain_quantize_weight(conv.weight))
    with torch.no_grad():  # an in-place update
        conv.weight.add_(1.0)
    assert _same(quant.quantize_weight(conv.weight), quant.plain_quantize_weight(conv.weight))
    quant.quantize_weight(conv.weight)
    assert _delta(before) == {"hits": 1, "misses": 2}
    conv.to(torch.bfloat16)  # a dtype change: new storage under the same Parameter
    before = _counts()
    assert _same(quant.quantize_weight(conv.weight), quant.plain_quantize_weight(conv.weight))
    assert _delta(before) == {"hits": 0, "misses": 1}


def test_weight_cache_after_a_lora_merge():
    rs = np.random.RandomState(43)
    unet = tun.UNetModel(unet_type="pseudo-3d", **_TINY)
    clip = tclip.CLIPTextModel(**CLIP)
    sd = _kohya_lora(unet, clip, rs)
    params = dict(unet.named_parameters())
    quant_sites = {f"{n}.weight" for n, m in unet.named_modules() if getattr(m, "quant", False)}
    before = {k: quant.quantize_weight(p) for k, p in params.items() if k in quant_sites}
    counts = _counts()
    tlora.merge_kohya_lora(unet, clip, sd, 0.7)
    changed = [k for k in before if not _same(quant.plain_quantize_weight(params[k]), before[k])]
    assert len(changed) > 10  # the transformers' projections
    after = {k: quant.quantize_weight(params[k]) for k in before}
    delta = _delta(counts)
    assert delta["misses"] >= len(changed)
    assert delta["hits"] + delta["misses"] == len(before)
    for k in before:
        assert _same(after[k], quant.plain_quantize_weight(params[k])), k


def test_weight_cache_refuses_inference_tensors():
    with torch.inference_mode():
        w = torch.ones((4, 8))
    with pytest.raises(RuntimeError, match="inference"):
        quant.quantize_weight(w)


def test_layers_quantize_each_weight_once(w8a8):
    """A W8A8 conv and Linear called twice quantize each weight once; the
    outputs are those of the uncached quantizer."""
    rs = np.random.RandomState(45)
    conv, lin = tl.conv2d(16, 24, quant=True), tl.QLinear(16, 8)
    x = torch.from_numpy(rs.standard_normal((2, 5, 6, 16)).astype(np.float32))
    before = _counts()
    with torch.no_grad():
        outs = [(conv(x), lin(x)) for _ in range(2)]
    assert _delta(before) == {"hits": 2, "misses": 2}
    assert all(torch.equal(a, outs[0][0]) and torch.equal(b, outs[0][1]) for a, b in outs)
    sound = quant.quantize_weight
    try:
        quant.quantize_weight = quant.plain_quantize_weight
        with torch.no_grad():
            assert torch.equal(conv(x), outs[0][0]) and torch.equal(lin(x), outs[0][1])
    finally:
        quant.quantize_weight = sound
