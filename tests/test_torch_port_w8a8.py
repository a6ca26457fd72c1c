"""The W8A8 path (``ops/quant.py``) on the CPU against the JAX package's
``ccedit_tpu/ops/quant.py``, with ``set_quantized_matmul(True)`` on both
sides (no Pallas kernel is reached: the JAX package leaves these products
to XLA).

- ``symmetric_q``, ``int8_matmul`` and ``int8_conv`` in fp32 at every
  window the kernels take (2-D k 1/3, stride 1/2, the VAE downsample's (0, 1)
  pad, 1-D k 1/3, K = 36, a zero weight): int8 values and scales equal; the
  layers (``Conv2d``/``Conv1d``/``QLinear`` built with ``quant=True``, through
  the kernels' plain versions and their padded layouts) within 1e-6 of
  max|JAX|.
- One test a block type at fp32 (``tests/test_quant.py``'s tiny widths):
  within 1e-5 of max|JAX| (the 8-conv hint pyramid conv by conv at fp32
  and whole in fp64).
- A census: the ``QConv``/``QDense`` calls of one JAX forward
  (``flax.linen.intercept_methods``), per parameter path, against the port
  modules built with ``quant=True`` that one forward hits, for the tiny
  ``CCEditNetwork``, the VAE and an SD-2.1-style 2-D UNet.
- The slice: a 2-step TV2V sample with the umbrella on, every network row
  held to the JAX network on the same inputs (fp64 on both sides).
- The switches: the trainer refuses W8A8, ``CCEDIT_QUANT_MATMUL`` alone
  turns on W8A8 and not the int8 QK^T, the flag off restores the exact path
  bit for bit.  W8A8 under a clip shard: ``test_torch_port_w8a8_clip_shard.py``.
"""

import collections

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from __graft_entry__ import _TINY
from ccedit_tpu.modules import blocks as jb
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import layers as jlayers
from ccedit_tpu.modules import transformer as jtr
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu.ops import attention as jatt
from ccedit_tpu.ops import quant as jquant
from ccedit_tpu_torch.io.jax_params import _leaf, from_jax
from ccedit_tpu_torch.modules import blocks as tb
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import layers as tl
from ccedit_tpu_torch.modules import transformer as ttr
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae
from ccedit_tpu_torch.ops import attention as att
from ccedit_tpu_torch.ops import quant
from test_torch_port_modules import _t, port_copy, random_params
from test_torch_port_slice import NEGATIVE, PROMPT, STEPS, engines  # noqa: F401 (fixture)

torch.set_num_threads(1)
FN_TOL = 1e-6  # functions and layers: max|port - jax| / max|jax|
BLOCK_TOL = 1e-5  # blocks


@pytest.fixture
def w8a8():
    """W8A8 on in both packages for one test."""
    saved = quant._STATE["matmul"], jquant._STATE["matmul"]
    quant.set_quantized_matmul(True)
    jquant.set_quantized_matmul(True)
    yield
    quant._STATE["matmul"], jquant._STATE["matmul"] = saved


def _rel(port, ref) -> float:
    ref = np.asarray(ref, np.float64)
    port = port.detach().double().numpy() if torch.is_tensor(port) else np.asarray(port)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def state_dict(params, rename=()):
    """A flax tree's leaves under torch names and layouts (``_leaf``), module
    prefixes renamed by ``rename`` ((flax prefix, torch prefix), ...)."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    out = {}
    for path, value in flat.items():
        for a, b in rename:
            if path.startswith(a + "/"):
                path = (b + "/" if b else "") + path[len(a) + 1:]
                break
        name, val = _leaf(path, value)
        out[name.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(val))
    return out


# ---- functions and layers ----

# (label, x shape (N, *spatial, C), out channels, kernel, stride, padding)
WINDOWS = (
    ("2d k3 s1", (2, 9, 11, 24), 16, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("2d k1 s1", (2, 9, 11, 24), 16, (1, 1), (1, 1), ((0, 0), (0, 0))),
    ("2d k3 s2", (2, 10, 12, 24), 16, (3, 3), (2, 2), ((1, 1), (1, 1))),
    ("2d k3 s2 pad (0, 1)", (2, 10, 12, 24), 16, (3, 3), (2, 2), ((0, 1), (0, 1))),
    ("1d k3", (6, 5, 24), 16, (3,), (1,), ((1, 1),)),
    ("1d k1", (6, 5, 24), 16, (1,), (1,), ((0, 0),)),
    ("2d k3 K = 36", (2, 8, 8, 4), 16, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("2d k3 zero weight", (2, 8, 8, 24), 16, (3, 3), (1, 1), ((1, 1), (1, 1))),
)


def _window_inputs(x_shape, o, kernel, seed, zero=False):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal(x_shape).astype(np.float32)
    w = rs.standard_normal((o, x_shape[-1]) + kernel).astype(np.float32)
    w = np.zeros_like(w) if zero else w / np.sqrt(w[0].size)
    bias = (0.1 * rs.standard_normal(o)).astype(np.float32)
    # JAX's (*k, I, O) kernel
    kernel_jax = np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))
    return x, w, bias, kernel_jax


@pytest.mark.parametrize("label,x_shape,o,kernel,stride,padding", WINDOWS,
                         ids=[w[0] for w in WINDOWS])
def test_conv_functions_match_jax(label, x_shape, o, kernel, stride, padding, w8a8):
    x, w, bias, kj = _window_inputs(x_shape, o, kernel, seed=len(label),
                                    zero="zero" in label)
    axes = tuple(range(x.ndim))
    jq, js = jquant._symmetric_q(jnp.asarray(x), axes)
    tq, ts = quant.symmetric_q(torch.from_numpy(x), axes)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jwq, jws = jquant._symmetric_q(jnp.asarray(kj), tuple(range(kj.ndim - 1)))
    twq, tws = quant.symmetric_q(torch.from_numpy(w), tuple(range(1, w.ndim)))
    np.testing.assert_array_equal(np.transpose(twq.numpy(), tuple(range(2, w.ndim)) + (1, 0)),
                                  np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy().reshape(-1), np.asarray(jws).reshape(-1))
    if "zero" in label:
        assert (tws == 1).all()  # amax 0: scale 1, not 0/0

    # the padded layouts the kernels read hold the same values
    x8, sx = quant.plain_quantize_int8(torch.from_numpy(x).reshape(-1, x.shape[-1]), False)
    cp = quant.padded(x.shape[-1])
    assert x8.shape[1] == cp and (x8[:, x.shape[-1]:] == 0).all()
    np.testing.assert_array_equal(x8[:, :x.shape[-1]].numpy(), tq.numpy().reshape(-1, x.shape[-1]))
    assert sx.item() == ts.item()

    dn = lax.conv_dimension_numbers(x.shape, kj.shape, jquant._conv_dim_numbers(x.ndim))
    ref = jquant.int8_conv(jnp.asarray(x), jnp.asarray(kj), stride, padding, dn)
    out = quant.int8_conv(torch.from_numpy(x), torch.from_numpy(w), stride, padding)
    if "zero" in label:
        assert not out.any() and not np.asarray(ref).any()
    else:
        assert _rel(out, ref) <= FN_TOL

    # the layer: JAX's QConv against the port's conv built with quant=True
    jconv = jquant.QConv(o, kernel, strides=stride, padding=padding)
    ref = jconv.apply({"params": {"kernel": kj, "bias": bias}}, jnp.asarray(x))
    if len(kernel) == 1:
        layer = tl.Conv1d(x.shape[-1], o, kernel[0], stride=stride[0], padding=padding[0][0],
                          quant=True)
    elif padding[0][0] != padding[0][1]:
        layer = tl.Conv2d(x.shape[-1], o, kernel, stride=stride, quant=True,
                          explicit_pad=padding)
    else:
        layer = tl.Conv2d(x.shape[-1], o, kernel, stride=stride, padding=padding[0][0],
                          quant=True)
    layer.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
    assert out.shape == ref.shape
    assert _rel(out, ref) <= FN_TOL


@pytest.mark.parametrize("c,zero", [(24, False), (36, False), (320, False), (24, True)])
def test_dense_functions_match_jax(c, zero, w8a8):
    rs = np.random.RandomState(c)
    x = rs.standard_normal((3, 7, c)).astype(np.float32)
    x[1, 2] = 0.0  # a zero token: its scale is 1
    w = np.zeros((20, c), np.float32) if zero else \
        (rs.standard_normal((20, c)) / np.sqrt(c)).astype(np.float32)
    bias = (0.1 * rs.standard_normal(20)).astype(np.float32)
    jq, js = jquant._symmetric_q(jnp.asarray(x), (-1,))
    tq, ts = quant.symmetric_q(torch.from_numpy(x), (-1,))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 2, 0] == 1.0
    x8, sx = quant.plain_quantize_int8(torch.from_numpy(x).reshape(-1, c), True)
    np.testing.assert_array_equal(x8[:, :c].numpy(), tq.numpy().reshape(-1, c))
    np.testing.assert_array_equal(sx.numpy(), ts.numpy().reshape(-1))
    ref = jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w.T))
    out = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    if zero:
        assert not out.any()
    else:
        assert _rel(out, ref) <= FN_TOL
    ref = jquant.QDense(20).apply({"params": {"kernel": w.T, "bias": bias}}, jnp.asarray(x))
    layer = tl.QLinear(c, 20)
    layer.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        assert _rel(layer(torch.from_numpy(x)), ref) <= FN_TOL


def test_kernel_wrappers_plain_on_the_cpu():
    """The three wrappers take their plain versions on CPU tensors and
    launch nothing; ``dtype`` None gives the exact int32 accumulators."""
    rs = np.random.RandomState(0)
    counts = {k: w.launches for k, w in quant.COUNTED.items()}
    x = torch.from_numpy(rs.standard_normal((2, 6, 7, 20)).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal((12, 20, 3, 3)).astype(np.float32))
    x8, sx = quant.quantize_int8(x.reshape(-1, 20), per_row=False)
    w8, sw = quant.quantize_weight(w)
    geom = quant.ConvGeometry(3, 3, 1, 1, 1, 1, 1, 1)
    acc = quant.conv_dequant(x8.view(2, 6, 7, -1), sx, w8, sw, None, geom, dtype=None)
    ref = torch.nn.functional.conv2d(
        x8[:, :20].view(2, 6, 7, 20).permute(0, 3, 1, 2).double(),
        w8.view(12, 3, 3, -1)[..., :20].permute(0, 3, 1, 2).double(), padding=1)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 3, 1, 2).numpy(), ref.numpy().astype(np.int32))
    acc = quant.gemm_dequant(x8, sx.expand(x8.shape[0]), w8[:, :x8.shape[1]], sw, None,
                             dtype=None)
    np.testing.assert_array_equal(acc.numpy(), (x8.double() @ w8[:, :x8.shape[1]].double().t())
                                  .numpy().astype(np.int32))
    assert {k: w.launches for k, w in quant.COUNTED.items()} == counts


# ---- blocks ----

def _held(tm, jm, params, args, kwargs=None, jargs=None):
    kwargs = kwargs or {}
    with torch.no_grad():
        out = tm(*[_t(a) for a in args], **{k: _t(v) for k, v in kwargs.items()})
    ref = jm.apply({"params": params}, *[jnp.asarray(a) for a in (jargs or args)],
                   **{k: jnp.asarray(v) for k, v in kwargs.items()})
    assert out.shape == ref.shape
    assert _rel(out, ref) <= BLOCK_TOL
    return out


def test_resblock3d(w8a8):
    rs = np.random.RandomState(11)
    x = rs.standard_normal((2, 3, 8, 8, 32)).astype(np.float32)
    emb = rs.standard_normal((2, 64)).astype(np.float32)
    jm = jb.ResBlock3D(channels=32, emb_channels=64, out_channels=64)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(emb), seed=12)
    sd = {k[len("input_blocks.1.0."):]: v for k, v in
          from_jax("unet", {"in_0_0_res": params}).items()}
    _held(port_copy(tb.ResBlock3D(32, 64, 64), sd), jm, params, (x, emb))


@pytest.mark.parametrize("use_linear", [False, True])
def test_spatial_transformer3d(use_linear, w8a8):
    rs = np.random.RandomState(13)
    x = rs.standard_normal((2, 3, 4, 4, 64)).astype(np.float32)
    ctx = rs.standard_normal((2, 7, 16)).astype(np.float32)
    jm = jtr.SpatialTransformer3D(in_channels=64, n_heads=2, d_head=32, context_dim=16,
                                  use_linear=use_linear, disable_temporal_text_ca=True)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(ctx), seed=14)
    sd = {k[len("middle_block.1."):]: v for k, v in
          from_jax("unet", {"mid_attn": params}).items()}
    tm = port_copy(ttr.SpatialTransformer3D(64, 2, 32, context_dim=16, use_linear=use_linear), sd)
    _held(tm, jm, params, (x,), {"context": ctx})


def test_hint_pyramid(w8a8):
    """At fp32 each of the eight convs is held on the JAX pyramid's own
    input to that conv (the SiLU between them rounds one ulp apart in the
    two packages, enough to flip an int8 step downstream); the whole
    pyramid is held in fp64 (x64 on the JAX side), where nothing rounds
    apart before a quantizer's fp32 cast."""
    rs = np.random.RandomState(15)
    hint = rs.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    jm = jcn.HintPyramid(model_channels=32)
    params = random_params(jm, jnp.asarray(hint), seed=16)
    rename = [(f"conv_{i}", str(2 * i)) for i in range(7)] + [("conv_out", "14")]
    tm = port_copy(tcn.HintPyramid(3, 32), state_dict(params, rename))
    h = hint
    for i, (ch, s) in enumerate(zip(jcn._HINT_CHANNELS + (32,), jcn._HINT_STRIDES + (1,))):
        name = f"conv_{i}" if i < 7 else "conv_out"
        pad = "SAME" if s == 1 else ((1, 1), (1, 1))
        ref = jquant.QConv(ch, (3, 3), strides=(s, s), padding=pad).apply(
            {"params": params[name]}, jnp.asarray(h))
        with torch.no_grad():
            out = tm[2 * i](torch.from_numpy(np.array(h)))
        assert _rel(out, ref) <= FN_TOL, name
        h = np.asarray(jax.nn.silu(ref))
    with jax.enable_x64():
        jm64 = jcn.HintPyramid(model_channels=32, dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        ref = jm64.apply({"params": p64}, jnp.asarray(hint, jnp.float64))
        assert ref.dtype == jnp.float64
    with torch.no_grad():
        out = tm.double()(torch.from_numpy(hint).double())
    assert _rel(out, ref) <= BLOCK_TOL


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_vae_resnet_block(cin, cout, w8a8):
    rs = np.random.RandomState(17 + cout)
    x = rs.standard_normal((2, 8, 8, cin)).astype(np.float32)
    jm = jvae.VAEResnetBlock(cin, cout)
    params = random_params(jm, jnp.asarray(x), seed=18)
    _held(port_copy(tvae.VAEResnetBlock(cin, cout), state_dict(params)), jm, params, (x,))


def test_vae_attn_block(w8a8):
    rs = np.random.RandomState(19)
    x = rs.standard_normal((2, 8, 8, 32)).astype(np.float32)
    jm = jvae.VAEAttnBlock(32)
    params = random_params(jm, jnp.asarray(x), seed=20)
    _held(port_copy(tvae.VAEAttnBlock(32), state_dict(params)), jm, params, (x,))


@pytest.mark.parametrize("kind", ["up", "down", "up3d", "down3d", "vae_up", "vae_down"])
def test_resampling(kind, w8a8):
    rs = np.random.RandomState(21)
    shape = (2, 3, 8, 8, 32) if kind.endswith("3d") else (2, 8, 8, 32)
    x = rs.standard_normal(shape).astype(np.float32)
    jm, tm, rename = {
        "up": (jb.Upsample(32), tb.Upsample(32), ()),
        "down": (jb.Downsample(32), tb.Downsample(32), ()),
        "up3d": (jb.Upsample3D(32), tb.Upsample3D(32), (("conv_temporal/conv", "conv_temporal"),)),
        "down3d": (jb.Downsample3D(32), tb.Downsample3D(32),
                   (("conv_temporal/conv", "conv_temporal"),)),
        "vae_up": (jvae.VAEUpsample(32), tvae.VAEUpsample(32), ()),
        "vae_down": (jvae.VAEDownsample(32), tvae.VAEDownsample(32), ()),
    }[kind]
    params = random_params(jm, jnp.asarray(x), seed=22)
    _held(port_copy(tm, state_dict(params, rename)), jm, params, (x,))


@pytest.mark.parametrize("k", [1, 3])
def test_temporal_conv(k, w8a8):
    rs = np.random.RandomState(23 + k)
    x = rs.standard_normal((24, 5, 32)).astype(np.float32)
    jm = jb.TemporalConv(32, kernel_size=k)
    params = random_params(jm, jnp.asarray(x), seed=24)
    tm = port_copy(tl.temporal_conv(32, 32, k, quant=True), state_dict(params, (("conv", ""),)))
    _held(tm, jm, params, (x,))


# ---- the census ----

def _jax_calls(module, params, *args, method=None):
    """{parameter path of a QConv/QDense kernel: calls} in one forward."""
    calls = collections.Counter()

    def interceptor(next_fun, args_, kwargs_, context):
        if isinstance(context.module, (jquant.QConv, jquant.QDense)) \
                and context.method_name == "__call__":
            calls["/".join(context.module.scope.path) + "/kernel"] += 1
        return next_fun(*args_, **kwargs_)

    with fnn.intercept_methods(interceptor):
        module.apply({"params": params}, *args, method=method)
    return calls


def _port_calls(module, fn):
    """{state-dict weight key of a module built with quant=True: calls} in
    ``fn()``."""
    calls, hooks = collections.Counter(), []
    for name, m in module.named_modules():
        if getattr(m, "quant", False):
            hooks.append(m.register_forward_hook(
                lambda mod, a, out, name=name: calls.update([f"{name}.weight"])))
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return calls


def _key_map(params, convert):
    """flax kernel path -> the port's weight key, by converting a tree whose
    kernels hold their own index."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in flat]
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(v.shape, float(i), np.float32) for i, (_, v) in enumerate(flat)])
    out = {}
    for key, value in convert(tagged).items():
        if key.endswith(".weight") and value.numel():
            path = paths[int(value.flatten()[0])]
            if path.endswith("/kernel"):
                out[path] = key
    return out


def _census(jax_calls, port_calls, key_map):
    assert jax_calls, "the JAX forward ran no QConv/QDense"
    mapped = collections.Counter({key_map[p]: n for p, n in jax_calls.items()})
    assert mapped == port_calls
    return sum(mapped.values())


def test_census_tiny_network(w8a8):
    rs = np.random.RandomState(25)
    b, t, h, w = 1, 3, 8, 8
    x = rs.standard_normal((b, t, h, w, 4)).astype(np.float32)
    ts = np.array([500.0], np.float32)
    ctx = rs.standard_normal((b, 7, 16)).astype(np.float32)
    hint = rs.uniform(-1, 1, (b, t, 8 * h, 8 * w, 3)).astype(np.float32)
    jn = jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **_TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY))
    cond = {"crossattn": jnp.asarray(ctx), "control_hint": jnp.asarray(hint)}
    params = random_params(jn, jnp.asarray(x), jnp.asarray(ts), cond, seed=26)
    tn = tcn.CCEditNetwork(
        port_copy(tun.UNetModel(unet_type="pseudo-3d", **_TINY), from_jax("unet", params["unet"])),
        port_copy(tcn.ControlNet2D(hint_channels=3, **_TINY),
                  from_jax("controlnet", params["controlnet"])))

    def convert(p):
        return {**{f"unet.{k}": v for k, v in from_jax("unet", p["unet"]).items()},
                **{f"controlnet.{k}": v for k, v in from_jax("controlnet", p["controlnet"]).items()}}

    tcond = {"crossattn": _t(ctx), "control_hint": _t(hint)}
    n = _census(_jax_calls(jn, params, jnp.asarray(x), jnp.asarray(ts), cond),
                _port_calls(tn, lambda: tn(_t(x), _t(ts), tcond)), _key_map(params, convert))
    assert n > 50


def test_census_vae(w8a8):
    rs = np.random.RandomState(27)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,))
    jm = jvae.AutoencoderKL(resolution=32, **kw)
    tm = tvae.AutoencoderKL(resolution=32, **kw)
    params = random_params(jm, jnp.zeros((1, 32, 32, 3)), None, False, seed=28)
    tm.load_reference_state_dict(from_jax("vae", params))
    x = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key_map = _key_map(params, lambda p: from_jax("vae", p))
    jcalls = _jax_calls(jm, params, jnp.asarray(x), method=jvae.AutoencoderKL.encode_moments)
    z = jm.apply({"params": params}, jnp.asarray(x), method=jvae.AutoencoderKL.encode_moments)
    z = np.asarray(z)[..., :4]
    jcalls += _jax_calls(jm, params, jnp.asarray(z), method=jvae.AutoencoderKL.decode)
    tcalls = _port_calls(tm, lambda: (tm.encode_moments(_t(x)), tm.decode(_t(z))))
    assert _census(jcalls, tcalls, key_map) > 20


def test_census_sd21_unet(w8a8):
    """An SD-2.1-style 2-D UNet: head channels 64-wide heads narrowed,
    linear projections, the 2-D resampling blocks."""
    rs = np.random.RandomState(29)
    kw = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
              attention_resolutions=(2, 1), channel_mult=(1, 2), num_head_channels=16,
              transformer_depth=1, context_dim=16, use_linear_in_transformer=True)
    x = rs.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ts = np.array([10.0, 700.0], np.float32)
    ctx = rs.standard_normal((2, 7, 16)).astype(np.float32)
    jm = jun.UNetModel(unet_type="2d", **kw)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), seed=30)
    tm = port_copy(tun.UNetModel(unet_type="2d", **kw), from_jax("unet", params))
    n = _census(_jax_calls(jm, params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx)),
                _port_calls(tm, lambda: tm(_t(x), _t(ts), context=_t(ctx))),
                _key_map(params, lambda p: from_jax("unet", p)))
    assert n > 20
    # the W8A8 forward itself, in fp64 on both sides (at fp32 one-ulp
    # differences upstream flip int8 steps)
    with jax.enable_x64():
        jm64 = jun.UNetModel(unet_type="2d", dtype=jnp.float64, **kw)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        ref = jm64.apply({"params": p64}, *(jnp.asarray(a, jnp.float64) for a in (x, ts, ctx)))
    with torch.no_grad():
        out = tm.double()(*(torch.from_numpy(a).double() for a in (x, ts, ctx)))
    assert _rel(out, ref) <= BLOCK_TOL


# ---- the slice ----

def test_slice_w8a8_matches_jax(engines, monkeypatch):
    """A 2-step TV2V sample (CFG 7.5, DPM++2S-ancestral, T = 3) with the
    umbrella on, same weights and noise: the W8A8 latents move off the
    exact chain's, and every network row of the port's chain, its network
    in fp64, equals the JAX network's (fp64, x64) on the same inputs within
    1e-6 of max|JAX|.  For that both take the JAX package's fp32 sinusoidal
    timestep embedding, and both plain attentions run in the inputs' fp64
    (each package's computes its softmax in fp32 by design, and the two
    round an ulp apart, as do torch's and XLA's fp32 cos and sin: enough to
    flip an int8 step in the next quantizer).

    The two free-running chains are not held to each other: the
    denoiser's fp32 input scaling and the text and hint conditioning round
    an ulp apart in the two packages, and a one-ulp difference flips int8
    steps, which CFG 7.5 amplifies through the chain (at fp32, latents
    2.9e-1 of max|JAX| apart, cosine 0.960; fp64 networks, 2.4e-1 and 0.977,
    where the JAX package's own jitted and eager chains land 2.3e-1 apart,
    cosine 0.978).  The sampler's arithmetic is held to JAX's by the exact
    slice test."""
    e = engines
    video = e["frames"][None]
    teng = e["teng"]
    monkeypatch.setattr(tun, "timestep_embedding", lambda t, dim: torch.from_numpy(np.asarray(
        jlayers.timestep_embedding(jnp.asarray(t.numpy()), dim))))
    monkeypatch.setitem(att._ROUTES, "plain", lambda q, k, v, scale: torch.matmul(
        torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1), v))
    monkeypatch.setattr(jatt, "_xla_attention", lambda q, k, v, scale: jnp.einsum(
        "bhqk,bhkd->bhqd", jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale, axis=-1),
        v))
    with torch.no_grad():
        tc, tuc = teng.conditioner.get_unconditional_conditioning(
            {"txt": [PROMPT], "control_hint": torch.from_numpy(video)},
            {"txt": [NEGATIVE], "control_hint": torch.from_numpy(video)})

    def port_sample():
        with torch.no_grad():
            return teng.sample(tc, tuc, e["shape"], num_steps=STEPS,
                               init_noise=torch.from_numpy(e["init_noise"]),
                               loop_noise=torch.from_numpy(e["loop_noise"]))

    exact = port_sample()
    rows = []
    hook = teng.network.register_forward_hook(
        lambda m, args, out: rows.append(([a.clone() if torch.is_tensor(a) else
                                           {k: v.clone() for k, v in a.items()} for a in args],
                                          out.clone())))
    saved = quant._STATE["matmul"], jquant._STATE["matmul"], att._QUANT["qk"]
    try:
        quant.set_quantized_matmul(True)
        jquant.set_quantized_matmul(True)
        att.set_quantized_qk(True)
        quantized = port_sample()
        teng.network.double()
        rows.clear()
        port_sample()
        with jax.enable_x64():
            jnet = jcn.CCEditNetwork(
                unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True,
                                   dtype=jnp.float64, **_TINY),
                controlnet=jcn.ControlNet2D(hint_channels=3, dtype=jnp.float64, **_TINY))
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                         e["params"]["network"])
            refs = [np.asarray(jnet.apply(
                {"params": p64}, jnp.asarray(x.numpy()), jnp.asarray(t.numpy()),
                {k: jnp.asarray(v.numpy()) for k, v in c.items()})) for (x, t, c), _ in rows]
    finally:
        hook.remove()
        teng.network.float()
        quant._STATE["matmul"], jquant._STATE["matmul"], att._QUANT["qk"] = saved
    assert np.abs((quantized - exact).numpy()).max() > 1e-3 * np.abs(exact.numpy()).max()
    assert len(rows) == 2 * STEPS - 1
    for ((x, _, _), out), ref in zip(rows, refs):
        assert x.dtype == torch.float64 and out.dtype == torch.float64
        assert _rel(out, ref) <= FN_TOL


# ---- the switches ----

def test_trainer_refuses_w8a8():
    from ccedit_tpu_torch.train.trainer import assert_exact_arithmetic

    saved = quant._STATE["matmul"], att._QUANT["qk"]
    try:
        att.set_quantized_qk(False)
        quant.set_quantized_matmul(True)
        with pytest.raises(RuntimeError, match="CCEDIT_QUANT_MATMUL"):
            assert_exact_arithmetic()
        quant.set_quantized_matmul(False)
        assert_exact_arithmetic()
    finally:
        quant._STATE["matmul"], att._QUANT["qk"] = saved


def test_quant_matmul_switch_alone(monkeypatch):
    """``CCEDIT_QUANT_MATMUL`` turns on W8A8 and not the int8 QK^T; read
    once, lazily."""
    saved = quant._STATE["matmul"], att._QUANT["qk"]
    try:
        for name in ("CCEDIT_QUANT_QK", "CCEDIT_INT8", "CCEDIT_QUANT_MATMUL"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.setenv("CCEDIT_QUANT_MATMUL", "1")
        quant._STATE["matmul"] = att._QUANT["qk"] = None
        assert quant.quantized_matmul_enabled() and not att.quantized_qk_enabled()
        monkeypatch.setenv("CCEDIT_QUANT_MATMUL", "0")
        assert quant.quantized_matmul_enabled()  # not read again
    finally:
        quant._STATE["matmul"], att._QUANT["qk"] = saved


def test_switch_off_restores_the_exact_path():
    """Off, every quant=True layer computes the exact op bit for bit; on,
    the block's output moves; off again, it is back bit for bit."""
    rs = np.random.RandomState(31)
    x = torch.from_numpy(rs.standard_normal((2, 3, 8, 8, 32)).astype(np.float32))
    emb = torch.from_numpy(rs.standard_normal((2, 64)).astype(np.float32))
    torch.manual_seed(0)
    block = tb.ResBlock3D(32, 64, 64).eval()
    for p in block.parameters():  # no zero-initialised branch
        torch.nn.init.normal_(p, std=0.1)
    saved = quant._STATE["matmul"]
    try:
        quant.set_quantized_matmul(False)
        with torch.no_grad():
            exact = block(x, emb)
            conv = block.in_layers[2]
            h = torch.randn((2, 8, 8, 32))
            ref = torch.nn.functional.conv2d(h.permute(0, 3, 1, 2), conv.weight, conv.bias,
                                             padding=1).permute(0, 2, 3, 1)
            assert torch.equal(conv(h), ref)
            quant.set_quantized_matmul(True)
            quantized = block(x, emb)
            quant.set_quantized_matmul(False)
            again = block(x, emb)
    finally:
        quant._STATE["matmul"] = saved
    assert not torch.equal(quantized, exact)
    assert cosine(quantized.numpy(), exact.numpy()) > 0.99
    assert torch.equal(again, exact)

