"""The attention gradients of the training slice on the CPU, port against the
JAX package in fp32.

* Kernel 4's plain version (``plain_spatial_attention_bwd``) and the
  ``SpatialAttention`` autograd Function's CPU path against
  ``jax.vjp(ccedit_tpu.ops.attention._xla_attention)``, the recompute the
  JAX backward differentiates, at head dims 40, 80, 160, n_k = 2 * n_q and
  ragged n_q and n_k; and, at the same shapes, ``_mirror_backward``, a
  test-only torch mirror of the CUDA kernel's order of work
  (``csrc/spatial_attention_bwd.cu``): 128-key blocks outer and 64-query
  tiles inner from a per-block first tile, P from the log2-domain lse of a
  mirrored online-softmax forward, delta from dO and O, dQ summed in fp32
  across key blocks, tail rows and columns masked.
* The ``TemporalAttention`` Function against ``jax.vjp`` of the JAX
  temporal dispatch (``_small_seq_diff``: the Pallas kernel interpreted
  forward, its einsum-recompute backward).

Tolerance 1e-4 absolute: fp32 on both sides, the closed form against
autodiff, summation order.  The CUDA kernel itself runs only on a GPU
(``chip_smoke.py`` phase 3, ``tests/test_torch_port_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.ops import attention as jatt
from ccedit_tpu_torch.ops import attention as port_attention
from ccedit_tpu_torch.ops import spatial_attention as sa
from ccedit_tpu_torch.ops import temporal_attention as ta

torch.set_num_threads(1)
ATOL = 1e-4


def _inputs(shape, n_k, seed):
    rs = np.random.RandomState(seed)
    kshape = shape[:2] + (n_k, shape[3])
    return tuple(rs.standard_normal(s).astype(np.float32) for s in (shape, kshape, kshape, shape))


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _function_grads(fn, q, k, v, do, scale):
    """dq, dk, dv of ``fn`` through autograd, on fresh leaf tensors."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    fn(*leaves, scale).backward(torch.from_numpy(do))
    return [x.grad.numpy() for x in leaves]


_LOG2E = 1.0 / np.log(2.0)
BN, BM = 128, 64  # the kernel's key block and query tile


def _mirror_forward(q, k, v, scale):
    """Kernel 1's online softmax in the log2 domain over 128-key tiles:
    O and each row's lse = m + log2(l) over s * scale * log2(e)."""
    n_k = k.shape[-2]
    m = torch.full(q.shape[:-1], -float("inf"), dtype=q.dtype)
    l = torch.zeros(q.shape[:-1], dtype=q.dtype)
    acc = torch.zeros_like(q)
    for k0 in range(0, n_k, BN):
        s2 = q @ k[..., k0:k0 + BN, :].transpose(-1, -2) * (scale * _LOG2E)
        m_new = torch.maximum(m, s2.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s2 - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ v[..., k0:k0 + BN, :]
        m = m_new
    return acc / l[..., None], m + torch.log2(l)


def _mirror_backward(q, k, v, do, scale):
    """dq, dk, dv in the CUDA kernel's order of work, in fp32."""
    b, h, n_q, d = q.shape
    n_k = k.shape[-2]
    out, lse = _mirror_forward(q, k, v, scale)
    delta = (do * out).sum(-1)
    n_qt = -(-n_q // BM)
    pad_q = n_qt * BM - n_q
    pad_k = -(-n_k // BN) * BN - n_k
    # tail rows: queries past n_q are zeros with lse = +inf (P = 0) and
    # delta = 0; keys past n_k are zeros, their P masked to 0
    qp, dop = (torch.nn.functional.pad(x, (0, 0, 0, pad_q)) for x in (q, do))
    lsep = torch.nn.functional.pad(lse, (0, pad_q), value=float("inf"))
    deltap = torch.nn.functional.pad(delta, (0, pad_q))
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, pad_k)) for x in (k, v))
    dq_acc = torch.zeros_like(qp)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for blk, k0 in enumerate(range(0, n_k, BN)):
        kt, vt = kp[..., k0:k0 + BN, :], vp[..., k0:k0 + BN, :]
        valid = (torch.arange(k0, k0 + BN) < n_k)[:, None]
        dk_t, dv_t = torch.zeros_like(kt), torch.zeros_like(vt)
        for i in range(n_qt):
            q0 = ((blk + i) % n_qt) * BM
            qt, dot = qp[..., q0:q0 + BM, :], dop[..., q0:q0 + BM, :]
            l_t, dl_t = lsep[..., None, q0:q0 + BM], deltap[..., None, q0:q0 + BM]
            st = kt @ qt.transpose(-1, -2)  # S^T, keys x queries
            pt = torch.where(valid, torch.exp2(st * (scale * _LOG2E) - l_t), 0.0)
            dst = pt * (vt @ dot.transpose(-1, -2) - dl_t)  # dS^T
            dv_t += pt @ dot
            dk_t += dst @ qt
            dq_acc[..., q0:q0 + BM, :] += dst.transpose(-1, -2) @ kt
        dk[..., k0:k0 + BN, :], dv[..., k0:k0 + BN, :] = dk_t * scale, dv_t
    return dq_acc[..., :n_q, :] * scale, dk[..., :n_k, :], dv[..., :n_k, :]


_SHAPES = [
    ((1, 2, 512, 40), 512),
    ((1, 2, 512, 80), 512),
    ((1, 2, 512, 160), 512),
    ((1, 2, 512, 40), 1024),  # the CFCA's n_k = 2 * n_q
]
_RAGGED = [((1, 2, 200, 40), 141), ((1, 2, 300, 160), 250)]


@pytest.mark.parametrize("shape,n_k,impl", [
    *(pytest.param(s, n, "plain", id=f"shape{i}-{n}") for i, (s, n) in enumerate(_SHAPES)),
    *(pytest.param(s, n, "plain", id=f"ragged{i}-{n}") for i, (s, n) in enumerate(_RAGGED)),
    *(pytest.param(s, n, "mirror", id=f"mirror-{s[2]}x{n}-d{s[3]}")
      for s, n in _SHAPES + _RAGGED),
])
def test_spatial_backward_matches_jax_vjp(shape, n_k, impl):
    """``impl`` "plain": kernel 4's plain version and the autograd
    Function's CPU path; "mirror": the kernel's order of work."""
    q, k, v, do = _inputs(shape, n_k, seed=shape[-1] + n_k)
    scale = shape[-1] ** -0.5
    ref = _jax_grads(lambda a, b, c: jatt._xla_attention(a, b, c, scale), q, k, v, do)
    if impl == "mirror":
        got = [[g.numpy() for g in _mirror_backward(*map(torch.from_numpy, (q, k, v, do)), scale)]]
    else:
        plain = sa.plain_spatial_attention_bwd(*map(torch.from_numpy, (q, k, v, do)), scale)
        got = [[g.numpy() for g in plain], _function_grads(sa.SpatialAttention.apply, q, k, v,
                                                           do, scale)]
    for grads in got:
        for ours, theirs in zip(grads, ref):
            np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)


def test_temporal_backward_matches_jax_dispatch():
    shape = (64, 2, 12, 40)
    q, k, v, do = _inputs(shape, 12, seed=9)
    scale = 40 ** -0.5
    ref = _jax_grads(lambda a, b, c: jatt._small_seq_diff(a, b, c, scale), q, k, v, do)
    ours = _function_grads(ta.TemporalAttention.apply, q, k, v, do, scale)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,route", [
    ((1, 2, 512, 40), "spatial"),
    ((2048, 1, 12, 40), "temporal"),
])
def test_dispatch_differentiates_through_the_function(shape, route):
    """With autograd on, the dispatch point routes a kernel shape through
    its autograd Function, launches nothing on the CPU, and gives the
    gradient of plain attention."""
    q, k, v, do = _inputs(shape, shape[2], seed=3)
    assert port_attention.attention_route(torch.from_numpy(q), torch.from_numpy(k)) == route
    before = port_attention.launch_counts()
    got = _function_grads(lambda a, b, c, s: port_attention.dot_product_attention(a, b, c, s),
                          q, k, v, do, shape[-1] ** -0.5)
    assert port_attention.launch_counts() == before
    want = _function_grads(port_attention.plain_attention, q, k, v, do, shape[-1] ** -0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
