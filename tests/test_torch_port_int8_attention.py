"""Kernel 1c, the int8 QK^T attention, on the CPU against the JAX package.

- The pre-pass (``quantize_qk``) is bit-identical to the one inside the JAX
  ``kv_resident_attention(quantized_qk=True)``, captured at its ``_run``
  call, rounding ties included.
- ``plain_spatial_attention_int8`` matches the JAX function run through its
  Pallas kernel in interpret mode: fp32 within 1e-5 abs (the integer scores
  are exact on both sides; exp vs exp2 and summation order differ), bf16
  within 2e-2 (as the bf16 kernels are held).
- The switch quantizes exactly the shapes JAX's gate admits, over every
  attention shape of the full-width networks and the VAE at the bucket
  corners (d = 160 and off-gate n_q stay exact), at bf16 and fp32 k.
- A narrow TVI2V ``CCEditNetwork`` (level-0 head_dim 40 over 512 tokens,
  CFCA over 1024 keys) matches the JAX network with the switch on in both
  packages, and differs from the exact network with cosine > 0.99.
- The trainer's guard; a quantized call that needs a grad takes kernel
  1c's forward and the exact attention's gradient (its parity with the
  JAX VJP is in ``test_torch_port_int8_grad.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.ops import attention as jatt
from ccedit_tpu.ops import spatial_attention as jsa
from ccedit_tpu_torch.ops import attention as att
from ccedit_tpu_torch.ops import spatial_attention as sa
from test_torch_port_tvi2v_kernels import GEOMETRIES, recorded_shapes  # noqa: F401 (fixture)
from test_torch_port_tvi2v_modules import APPEARANCE, port_copy, random_params
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import unet as tun

torch.set_num_threads(1)
_JAX_KV_RESIDENT = jsa.kv_resident_attention
_PLAIN_INT8 = sa.plain_spatial_attention_int8


@pytest.fixture
def quantized():
    """The int8 switch on in both packages for one test."""
    saved = (att._QUANT["qk"], jatt._QUANT["qk"])
    att.set_quantized_qk(True)
    jatt.set_quantized_qk(True)
    yield
    att._QUANT["qk"], jatt._QUANT["qk"] = saved


def _qkv(q_shape, n_k, seed):
    rs = np.random.RandomState(seed)
    kv_shape = q_shape[:2] + (n_k, q_shape[3])
    return (rs.standard_normal(q_shape).astype(np.float32),
            rs.standard_normal(kv_shape).astype(np.float32),
            rs.standard_normal(kv_shape).astype(np.float32))


def _jax_prepass(q, k, scale, monkeypatch):
    """The (scales, q8, k8) the JAX function hands its Pallas kernel,
    folded back to (B, H, N, D) int8 and (B * H,) fp32."""
    seen = {}

    def record(scales, qt, kt, vt, qb, interpret):
        seen.update(scales=np.asarray(scales), qt=np.asarray(qt), kt=np.asarray(kt))
        return jnp.zeros(vt.shape[:2] + (qt.shape[2],), vt.dtype)

    monkeypatch.setattr(jsa, "_run", record)
    jsa.kv_resident_attention(q, k, k, scale, quantized_qk=True)
    unfold = lambda x, like: np.swapaxes(x, 1, 2).reshape(like.shape[:3] + (like.shape[3],))
    return seen["scales"].reshape(-1), unfold(seen["qt"], q), unfold(seen["kt"], k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepass_is_bit_identical_to_jax(dtype, monkeypatch):
    """Random q and k, plus a head whose amax is 127 (so x * 127 / amax is x
    itself) holding exact half-integers: round-half-even decides those."""
    q, k, _ = _qkv((2, 3, 512, 40), 512, seed=3)
    q[0, 0] = np.round(q[0, 0] * 20) / 2  # multiples of 0.5, many ties
    q[0, 0, 0, 0] = 127.0
    k[1, 2, :, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    k[1, 2, 0, 8] = 127.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scale = 40 ** -0.5
    scales_j, q8_j, k8_j = _jax_prepass(jnp.asarray(q, jdt), jnp.asarray(k, jdt), scale,
                                        monkeypatch)
    q8, k8, scales = sa.quantize_qk(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                                    scale)
    assert q8.dtype == k8.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(q8.numpy(), q8_j)
    np.testing.assert_array_equal(k8.numpy(), k8_j)
    np.testing.assert_array_equal(scales.numpy(), scales_j)
    ties = q8.numpy()[0, 0][np.abs(q[0, 0] - np.trunc(q[0, 0])) == 0.5]
    assert ties.size > 100 and np.any(ties % 2 == 0)  # half-even, not half-up


@pytest.mark.parametrize("q_shape,n_k", [((2, 4, 512, 40), 512), ((1, 2, 512, 80), 512),
                                         ((1, 2, 512, 40), 12288)])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_int8_matches_pallas(q_shape, n_k, dtype, atol):
    q, k, v = _qkv(q_shape, n_k, seed=q_shape[-1] + n_k)
    scale = q_shape[-1] ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jsa.kv_resident_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale,
                                    quantized_qk=True, interpret=True)
    out = sa.plain_spatial_attention_int8(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                          scale)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=atol,
                               rtol=0)
    exact = sa.plain_spatial_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert (exact - out.float()).abs().max() > 10 * atol or dtype == "bfloat16"


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_decision_matches_jax_gate(recorded_shapes, geometry, dtype, quantized,
                                            monkeypatch):
    """At every recorded attention shape the port quantizes iff the JAX
    dispatch (on a TPU, with the switch on) would run its Pallas kernel."""
    monkeypatch.setattr(jatt, "_is_tpu", lambda: True)
    decisions = []
    for _, q_shape, k_shape in recorded_shapes[geometry]:
        q, k = (torch.empty(s, device="meta", dtype=dtype) for s in (q_shape, k_shape))
        jq, jk = (jax.ShapeDtypeStruct(s, jnp.bfloat16 if dtype == torch.bfloat16 else
                                       jnp.float32) for s in (q_shape, k_shape))
        want = jatt._kv_resident_ok(jq, jk)
        assert att.quantizes(q, k) == want, (q_shape, k_shape)
        decisions.append((att.attention_route(q, k), q_shape[-1], want))
    # the gate admits level 0 (d 40) at every corner but the largest at fp32,
    # and never the port's d = 160 extension of kernel 1's route
    assert any(want for _, _, want in decisions) or (dtype == torch.float32
                                                     and geometry[0] * geometry[1] > 512 * 768)
    assert not any(want for route, d, want in decisions if d == 160 or route != "spatial")


def test_quantizes_nothing_with_the_switch_off():
    q = torch.empty((34, 8, 6144, 40), device="meta", dtype=torch.bfloat16)
    saved = att._QUANT["qk"]
    try:
        att.set_quantized_qk(False)
        assert not att.quantizes(q, q)
    finally:
        att._QUANT["qk"] = saved


def test_environment_switch(monkeypatch):
    """Read once, lazily: CCEDIT_QUANT_QK, or the umbrella CCEDIT_INT8,
    which warns that the port has no W8A8 path."""
    saved = att._QUANT["qk"]
    try:
        for env, value, want in (("CCEDIT_QUANT_QK", "1", True), ("CCEDIT_QUANT_QK", "0", False),
                                 ("CCEDIT_INT8", "1", True)):
            monkeypatch.delenv("CCEDIT_QUANT_QK", raising=False)
            monkeypatch.delenv("CCEDIT_INT8", raising=False)
            monkeypatch.setenv(env, value)
            att._QUANT["qk"] = None
            if env == "CCEDIT_INT8":
                with pytest.warns(UserWarning, match="W8A8"):
                    assert att.quantized_qk_enabled() is want
            else:
                assert att.quantized_qk_enabled() is want
            monkeypatch.setenv(env, "1" if value == "0" else "0")
            assert att.quantized_qk_enabled() is want  # not read again
    finally:
        att._QUANT["qk"] = saved


NARROW = dict(_TINY, model_channels=160, num_heads=4)  # head_dim 40 at level 0, 80 at level 1


@pytest.fixture(scope="module")
def narrow_network():
    """A narrow TVI2V network (CFCA centre+self, both ControlNets) in both
    packages: 2 frames of 16x32 latents, so level 0 attends 512 tokens at
    head_dim 40 and its CFCA 512 queries to 1024 keys."""
    rs = np.random.RandomState(21)
    b, t, h, w = 2, 2, 16, 32
    x = rs.standard_normal((b, t, h, w, 4)).astype(np.float32)
    ts = np.array([10.0, 700.0], np.float32)
    ctx = rs.standard_normal((b, 7, 16)).astype(np.float32)
    hint = rs.uniform(-1, 1, (b, t, 8 * h, 8 * w, 3)).astype(np.float32)
    feat = rs.standard_normal((b, h, w, 4)).astype(np.float32)
    jn = jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True,
                           enable_attention3d_crossframe=True, st3dca_ca_type="center_self",
                           **NARROW),
        controlnet=jcn.ControlNet2D(hint_channels=3, **NARROW),
        controlnet_img=jcn.ControlNet2D(**APPEARANCE, **NARROW))
    cond = {"crossattn": jnp.asarray(ctx), "control_hint": jnp.asarray(hint),
            "cond_feat": jnp.asarray(feat)}
    params = random_params(jn, jnp.asarray(x), jnp.asarray(ts), cond, seed=22)
    tn = tcn.CCEditNetwork(
        port_copy(tun.UNetModel(unet_type="pseudo-3d", enable_attention3d_crossframe=True,
                                st3dca_ca_type="center_self", **NARROW),
                  from_jax("unet", params["unet"])),
        port_copy(tcn.ControlNet2D(hint_channels=3, **NARROW),
                  from_jax("controlnet", params["controlnet"])),
        port_copy(tcn.ControlNet2D(**APPEARANCE, **NARROW),
                  from_jax("controlnet", params["controlnet_img"]))).eval()
    tcond = {"crossattn": torch.from_numpy(ctx), "control_hint": torch.from_numpy(hint),
             "cond_feat": torch.from_numpy(feat)}
    return dict(jn=jn, params=params, tn=tn, x=x, ts=ts, cond=cond, tcond=tcond)


def _jax_out(n, monkeypatch, quant: bool):
    """The JAX network as it runs on a TPU (its Pallas kernels in interpret
    mode, the stock flash kernel kept out), with the switch as given."""
    monkeypatch.setattr(jatt, "_is_tpu", lambda: True)
    monkeypatch.setattr(jatt, "_flash_ok", lambda q, k: False)
    monkeypatch.setattr(jsa, "kv_resident_attention",
                        functools.partial(_JAX_KV_RESIDENT, interpret=True))
    saved = jatt._QUANT["qk"]
    try:
        jatt.set_quantized_qk(quant)
        fn = jax.jit(lambda p, x, t, c: n["jn"].apply({"params": p}, x, t, c))
        return np.asarray(fn(n["params"], jnp.asarray(n["x"]), jnp.asarray(n["ts"]), n["cond"]))
    finally:
        jatt._QUANT["qk"] = saved


def _port_out(n, quant: bool, monkeypatch):
    calls = []
    monkeypatch.setattr(sa, "plain_spatial_attention_int8",
                        lambda *a: calls.append(a[0].shape) or _PLAIN_INT8(*a))
    saved = att._QUANT["qk"]
    try:
        att.set_quantized_qk(quant)
        with torch.no_grad():
            out = n["tn"](torch.from_numpy(n["x"]), torch.from_numpy(n["ts"]), n["tcond"])
    finally:
        att._QUANT["qk"] = saved
    return out.numpy(), calls


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


QUANT_ATOL = 1e-3


def test_narrow_network_matches_jax_with_the_switch_on(narrow_network, monkeypatch):
    """Exact: within 1e-4 (the port's module tolerance).  Quantized: within
    QUANT_ATOL of the JAX network.  Both packages quantize the same fp32
    values, but their projections differ in the last bits, and a value
    within that of a rounding tie lands in the next int8 quantum, which
    moves its logits by one quantum (scale * aq * ak / 127^2 times the other
    operand's int8 value); a few such flips pass through the network."""
    n = narrow_network
    exact_j = _jax_out(n, monkeypatch, quant=False)
    quant_j = _jax_out(n, monkeypatch, quant=True)
    exact_p, calls_exact = _port_out(n, False, monkeypatch)
    quant_p, calls = _port_out(n, True, monkeypatch)
    assert not calls_exact
    # level 0 of the UNet (input 1, output 3 and 4 ... blocks), both ControlNets:
    # self-attention (512 keys) and CFCA (1024 keys), all at head_dim 40
    assert calls and all(s[-1] == 40 and s[-2] == 512 for s in calls)
    np.testing.assert_allclose(exact_p, exact_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(quant_p, quant_j, atol=QUANT_ATOL, rtol=0)
    # the int8 path is taken and changes the output, boundedly
    shift = np.abs(quant_j - exact_j).max()
    assert shift > 10 * np.abs(quant_p - quant_j).max()
    assert _cosine(quant_j, exact_j) > 0.99 and _cosine(quant_p, exact_p) > 0.99



def test_trainer_refuses_the_switch(quantized, tmp_path):
    from types import SimpleNamespace

    from ccedit_tpu_torch.train.trainer import Trainer, TrainerConfig, assert_exact_arithmetic

    with pytest.raises(RuntimeError, match="exact arithmetic"):
        assert_exact_arithmetic()
    trainer = Trainer(SimpleNamespace(network=torch.nn.Linear(1, 1)),
                      TrainerConfig(logdir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="exact arithmetic"):
        trainer.fit(loader=None, batch_size=1)
    att.set_quantized_qk(False)
    assert_exact_arithmetic()


def test_a_quantized_call_that_needs_a_grad_raises(quantized):
    """A quantized call that needs a grad does not raise: through the
    dispatch and directly, it returns kernel 1c's plain forward and
    differentiates the exact attention, as the JAX package's
    ``_kv_resident_diff`` does."""
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 512, 40), 512, seed=4))
    do = torch.from_numpy(_qkv((1, 2, 512, 40), 512, seed=5)[0])
    scale = 40 ** -0.5
    with torch.no_grad():
        att.dot_product_attention(q.requires_grad_(True), k, v)
    want = sa.plain_spatial_attention_bwd(q.detach(), k, v, do, scale)
    for call in (lambda: att.dot_product_attention(q, k, v),
                 lambda: sa.kv_resident_attention(q, k, v, scale, quantized_qk=True)):
        q.grad = None
        out = call()
        assert out.grad_fn is not None
        torch.testing.assert_close(out.detach(), _PLAIN_INT8(q.detach(), k, v, scale),
                                   rtol=0, atol=0)
        out.backward(do)
        torch.testing.assert_close(q.grad, want[0], rtol=0, atol=1e-6)
