"""The gradient of the port's int8 QK^T attention on the CPU against the JAX
package's, in fp32.

The JAX package differentiates its quantized attention through a custom VJP
(``ccedit_tpu/ops/attention.py::_kv_resident_diff``) whose backward is
``_xla_attention_bwd``, the exact attention's gradient by recompute.  The
port's ``QuantizedSpatialAttention`` does the same (on the card: kernel 1
recomputes the exact output and lse, kernel 4 differentiates; here: the
plain versions).  With the int8 switch on, dq, dk and dv through
``dot_product_attention`` match ``_xla_attention_bwd(scale, (q, k, v), do)``
within 1e-4 absolute (fp32 on both sides; the closed form against autodiff,
summation order), at head dims 40 and 80 and the CFCA's n_k = 2 * n_q.
Both trainers still refuse the int8 mode (``test_torch_port_int8_attention
::test_trainer_refuses_the_switch``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.ops import attention as jatt
from ccedit_tpu_torch.ops import attention as att
from ccedit_tpu_torch.ops import spatial_attention as sa

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture
def quantized():
    saved = att._QUANT["qk"]
    att.set_quantized_qk(True)
    yield
    att._QUANT["qk"] = saved


@pytest.mark.parametrize("shape,n_k", [
    ((1, 2, 512, 40), 512),
    ((1, 2, 512, 80), 512),
    ((1, 2, 512, 40), 1024),  # the CFCA's n_k = 2 * n_q
])
def test_int8_gradient_is_the_jax_exact_recompute(quantized, shape, n_k):
    rs = np.random.RandomState(shape[-1] + n_k)
    kshape = shape[:2] + (n_k, shape[3])
    q, k, v, do = (rs.standard_normal(s).astype(np.float32) for s in (shape, kshape, kshape, shape))
    scale = shape[-1] ** -0.5
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    assert att.quantizes(leaves[0], leaves[1])
    counts = att.launch_counts()
    out = att.dot_product_attention(*leaves, scale)
    assert type(out.grad_fn).__name__ == "QuantizedSpatialAttentionBackward"
    out.backward(torch.from_numpy(do))
    assert att.launch_counts() == counts  # plain versions on the CPU: no launch
    want = jatt._xla_attention_bwd(scale, tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(do))
    for got, ref in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # the forward stays the quantized one
    exact = sa.plain_spatial_attention(*(x.detach() for x in leaves), scale)
    assert not torch.allclose(out.detach(), exact, atol=1e-4)
