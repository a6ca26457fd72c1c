"""The attention gradients of the training slice on the CPU, port against the
JAX package in fp32.

* Kernel 4's plain version (``plain_spatial_attention_bwd``) and the
  ``SpatialAttention`` autograd Function's CPU path against
  ``jax.vjp(ccedit_tpu.ops.attention._xla_attention)``, the recompute the
  JAX backward differentiates, at head dims 40, 80, 160 and n_k = 2 * n_q.
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


@pytest.mark.parametrize("shape,n_k", [
    ((1, 2, 512, 40), 512),
    ((1, 2, 512, 80), 512),
    ((1, 2, 512, 160), 512),
    ((1, 2, 512, 40), 1024),  # the CFCA's n_k = 2 * n_q
])
def test_spatial_backward_matches_jax_vjp(shape, n_k):
    q, k, v, do = _inputs(shape, n_k, seed=shape[-1] + n_k)
    scale = shape[-1] ** -0.5
    ref = _jax_grads(lambda a, b, c: jatt._xla_attention(a, b, c, scale), q, k, v, do)
    plain = sa.plain_spatial_attention_bwd(*map(torch.from_numpy, (q, k, v, do)), scale)
    through_function = _function_grads(sa.SpatialAttention.apply, q, k, v, do, scale)
    for ours, theirs in zip(plain, ref):
        np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL, rtol=0)
    for ours, theirs in zip(through_function, ref):
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
