"""Kernels 1, 1c and 4 at head_dim 64 (SD-2.x's heads) on the CPU, against
the JAX package, and the route of the SD-2.1-768 network.

* Kernel 1's plain version (the CPU path of ``kv_resident_attention``) and
  kernel 1c's CPU mirror (``test_torch_port_kernel_mirrors.py``'s
  order-of-work mirror: padded int8 rows, 128-key tiles, online exp2
  softmax) against the Pallas kernel in interpret mode, at one single-chunk
  n_k and at a multi-chunk one (9216 keys: the JAX kernel's 3 x 3072-key
  branch, SD-2.1-768's level 0); 3e-5 and 1e-5 absolute, as those files.
* Kernel 4's plain backward at d = 64 against ``jax.vjp`` of the JAX
  package's XLA attention, 1e-4 absolute (fp32 both sides).
* ``quantizes`` at d = 64 against the JAX gate ``supported`` at
  SD-2.1-768's shapes, bf16 and fp32.
* The route: every attention of the full-width SD-2.1-768 network (CFG
  batch 2 at 768x768) and of its VAE decoder, recorded on the ``meta``
  device, goes to a kernel with that head dim from 512 tokens on (15
  self-attentions a row at d = 64, the decoder's at d = 512); where the JAX
  dispatch on a TPU runs a kernel the port does too, and the port adds
  level 2's ragged 576 tokens, which the JAX gate sends to XLA.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_kernel_mirrors as km
from ccedit_tpu.ops import attention as jatt
from ccedit_tpu.ops import spatial_attention as jsa
from ccedit_tpu_torch import config
from ccedit_tpu_torch.ops import attention as att
from ccedit_tpu_torch.ops import flash_attention as fa
from ccedit_tpu_torch.ops import spatial_attention as sa

torch.set_num_threads(1)
D = 64


def _qkv(shape, n_k, seed):
    rs = np.random.RandomState(seed)
    kshape = shape[:2] + (n_k, shape[3])
    return (rs.standard_normal(shape).astype(np.float32),
            rs.standard_normal(kshape).astype(np.float32),
            rs.standard_normal(kshape).astype(np.float32))


@pytest.mark.parametrize("n_k", [512, 9216])
def test_d64_kernel1_plain_matches_pallas(n_k):
    assert jsa._n_chunks(n_k) == (1 if n_k == 512 else 3)
    q, k, v = _qkv((1, 2, 512, D), n_k, seed=n_k)
    scale = D ** -0.5
    ref = jsa.kv_resident_attention(*map(jnp.asarray, (q, k, v)), scale, interpret=True)
    out = sa.kv_resident_attention(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=0)


@pytest.mark.parametrize("n_k", [512, 9216])
def test_d64_kernel1c_mirror_matches_pallas(n_k):
    q, k, v = _qkv((1, 2, 512, D), n_k, seed=n_k + 1)
    scale = D ** -0.5
    assert sa.int8_width(D) == D  # 64-byte rows: no zero columns
    ref = jsa.kv_resident_attention(*map(jnp.asarray, (q, k, v)), scale, quantized_qk=True,
                                    interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = km._mirror_int8_forward(tq, tk, tv, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=km.ATOL, rtol=0)
    plain = sa.kv_resident_attention(tq, tk, tv, scale, quantized_qk=True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=km.ATOL, rtol=0)
    assert (sa.plain_spatial_attention(tq, tk, tv, scale) - out).abs().max() > 10 * km.ATOL


@pytest.mark.parametrize("shape,n_k", [((1, 2, 512, D), 512), ((1, 2, 300, D), 600)])
def test_d64_kernel4_plain_matches_jax_vjp(shape, n_k):
    q, k, v = _qkv(shape, n_k, seed=shape[2] + n_k)
    do = np.random.RandomState(7).standard_normal(shape).astype(np.float32)
    scale = D ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: jatt._xla_attention(a, b, c, scale),
                     *map(jnp.asarray, (q, k, v)))
    refs = vjp(jnp.asarray(do))
    grads = sa.plain_spatial_attention_bwd(*map(torch.from_numpy, (q, k, v, do)), scale)
    for g, r in zip(grads, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)
    # through the autograd Function of kernel 1 (its CPU path)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    sa.kv_resident_attention(tq, tk, tv, scale).backward(torch.from_numpy(do))
    for g, r in zip((tq.grad, tk.grad, tv.grad), refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_q", [9216, 2304, 576])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_d64_quantizes_where_the_jax_gate_holds(n_q, dtype):
    heads = {9216: 5, 2304: 10, 576: 20}[n_q]
    q = k = torch.empty((2, heads, n_q, D), dtype=dtype, device="meta")
    itemsize = torch.empty((), dtype=dtype).element_size()
    att.set_quantized_qk(True)
    try:
        assert att.attention_route(q, k) == "spatial"
        assert att.quantizes(q, k) == jsa.supported(n_q, n_q, D, itemsize=itemsize)
    finally:
        att.set_quantized_qk(False)
    assert att.quantizes(q, k) is False
    assert (n_q % 128 == 0) == jsa.supported(n_q, n_q, D, itemsize=2)


def _jax_route(q_shape, k_shape):
    q, k = (jax.ShapeDtypeStruct(s, jnp.bfloat16) for s in (q_shape, k_shape))
    saved = jatt._is_tpu
    jatt._is_tpu = lambda: True
    try:
        ok = jatt._kv_resident_ok(q, k) or jatt._flash_ok(q, k) or jatt._small_seq_ok(q, k)
    finally:
        jatt._is_tpu = saved
    return "kernel" if ok else "plain"


@pytest.fixture(scope="module")
def sd21_calls():
    """(route, q shape, k shape) of every attention of SD-2.1-768's network
    at 768x768 (CFG batch 2) and of its VAE decoder, on the meta device."""
    calls = []

    def recorder(route):
        def record(q, k, v, scale):
            calls.append((route, tuple(q.shape), tuple(k.shape)))
            return torch.empty_like(q)
        return record

    p = copy.deepcopy(config.SD21_768_CONFIG)["model"]["params"]
    with torch.device("meta"):
        net = config.build_network(p["network_config"])
        vae = config.build_vae(p["first_stage_config"])
    saved = dict(att._ROUTES)
    att._ROUTES.update({name: recorder(name) for name in saved})
    try:
        with torch.no_grad(), torch.device("meta"):
            net(torch.empty(2, 96, 96, 4), torch.empty(2),
                {"crossattn": torch.empty(2, 77, 1024)})
            vae.decode(torch.empty(1, 96, 96, 4))
    finally:
        att._ROUTES.update(saved)
    return calls


def test_sd21_network_routes_every_long_attention_to_a_kernel(sd21_calls):
    kernels = {"spatial": sa.HEAD_DIMS, "flash": fa.HEAD_DIMS}
    for route, q_shape, k_shape in sd21_calls:
        if q_shape[2] >= 512 and k_shape[2] >= 512:
            assert route in kernels and q_shape[-1] in kernels[route], (route, q_shape)
        else:
            assert route == "plain", (route, q_shape, k_shape)
        if _jax_route(q_shape, k_shape) == "kernel":
            assert route != "plain", (q_shape, k_shape)
    spatial = [(q, k) for r, q, k in sd21_calls if r == "spatial"]
    assert len(spatial) == 15
    assert sorted(set(spatial)) == [((2, 5, 9216, 64), (2, 5, 9216, 64)),
                                    ((2, 10, 2304, 64), (2, 10, 2304, 64)),
                                    ((2, 20, 576, 64), (2, 20, 576, 64))]
    assert [q for r, q, _ in sd21_calls if r == "flash"] == [(1, 1, 9216, 512)]
    # the port's addition to the JAX route: level 2's ragged 576 tokens
    assert _jax_route((2, 20, 576, 64), (2, 20, 576, 64)) == "plain"
    # the middle block's 144 tokens and the 77-token text attention stay plain
    assert ("plain", (2, 20, 144, 64), (2, 20, 144, 64)) in sd21_calls
    assert any(r == "plain" and k[2] == 77 for r, _, k in sd21_calls)
