"""The port's attention kernels: each plain PyTorch version against the JAX
package's kernel on the CPU (fp32), and the dispatch routes.

The CUDA kernels themselves run only on a GPU (``chip_smoke.py`` phase 3 and
``tests/test_torch_port_gpu.py``).  Tolerance 2e-5 absolute: fp32 on both
sides, the only difference being summation order and exp vs exp2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.ops.attention import _xla_attention
from ccedit_tpu.ops.spatial_attention import kv_resident_attention, supported
from ccedit_tpu.ops.temporal_attention import small_seq_attention
from ccedit_tpu_torch.ops import attention as port_attention
from ccedit_tpu_torch.ops import flash_attention as fa
from ccedit_tpu_torch.ops import spatial_attention as sa
from ccedit_tpu_torch.ops import temporal_attention as ta

torch.set_num_threads(1)
ATOL = 2e-5


def _qkv(shape, seed, n_k=None):
    rs = np.random.RandomState(seed)
    kshape = shape if n_k is None else shape[:2] + (n_k, shape[3])
    return (rs.standard_normal(shape).astype(np.float32),
            rs.standard_normal(kshape).astype(np.float32),
            rs.standard_normal(kshape).astype(np.float32))


def _close(port_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), atol=atol, rtol=0)


@pytest.mark.parametrize("d", [40, 80])
def test_spatial_plain_matches_pallas_kernel(d):
    shape = (1, 2, 512, d)
    assert supported(512, 512, d, itemsize=4)
    q, k, v = _qkv(shape, d)
    scale = d ** -0.5
    ref = kv_resident_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                interpret=True)
    out = sa.plain_spatial_attention(*map(torch.from_numpy, (q, k, v)), scale)
    _close(out, ref)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_temporal_plain_matches_pallas_kernel(d):
    shape = (6, 2, 17, d)
    q, k, v = _qkv(shape, 100 + d)
    scale = d ** -0.5
    ref = small_seq_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    out = ta.plain_temporal_attention(*map(torch.from_numpy, (q, k, v)), scale)
    _close(out, ref)


def test_flash_plain_matches_xla_stand_in():
    """d = 512, one head: the VAE mid-block shape family.  The stock Pallas
    flash kernel has no CPU interpreter path here, so, as
    tests/test_spatial_attention.py does, its stand-in is _xla_attention."""
    shape = (2, 1, 256, 512)
    q, k, v = _qkv(shape, 7)
    scale = 512 ** -0.5
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    out = fa.plain_flash_attention(*map(torch.from_numpy, (q, k, v)), scale)
    _close(out, ref)


@pytest.mark.parametrize("q_shape,n_k,route", [
    ((34, 8, 6144, 40), 6144, "spatial"),      # UNet/ControlNet level 0
    ((34, 8, 1536, 80), 1536, "spatial"),      # level 1
    ((34, 8, 384, 160), 384, "plain"),         # level 2 (384 tokens)
    ((34, 8, 96, 160), 96, "plain"),           # middle
    ((34, 8, 6144, 40), 77, "plain"),          # text cross-attention
    ((12288, 8, 17, 40), 17, "temporal"),      # temporal level 0
    ((3072, 8, 17, 80), 17, "temporal"),       # temporal level 1
    ((768, 8, 17, 160), 17, "temporal"),       # temporal level 2
    ((192, 8, 17, 160), 17, "plain"),          # temporal middle (B*H < 2048)
    ((17, 1, 6144, 512), 6144, "flash"),       # VAE mid-block attention
])
def test_routes_at_main_path_shapes(q_shape, n_k, route):
    q = torch.empty(q_shape, device="meta")
    k = torch.empty(q_shape[:2] + (n_k, q_shape[3]), device="meta")
    assert port_attention.attention_route(q, k) == route


@pytest.mark.parametrize("shape,route", [
    ((1, 2, 512, 40), "spatial"),
    ((256, 8, 17, 16), "temporal"),
    ((1, 1, 512, 136), "plain"),  # no kernel has head_dim 136
])
def test_cpu_tensors_take_the_plain_version(shape, route):
    """A CPU tensor on a kernel route is computed by that kernel's plain
    version and launches nothing."""
    q, k, v = map(torch.from_numpy, _qkv(shape, 3))
    assert port_attention.attention_route(q, k) == route
    wrappers = (sa.kv_resident_attention, ta.small_seq_attention, fa.flash_attention)
    before = [w.launches for w in wrappers]
    out = port_attention.dot_product_attention(q, k, v)
    assert [w.launches for w in wrappers] == before
    ref = port_attention.plain_attention(q, k, v, shape[-1] ** -0.5)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_kernel_wrappers_are_forward_only():
    """Only kernel 3 (d = 512) is forward-only, and only on the GPU: on the
    CPU every wrapper differentiates through its plain version (kernels 1
    and 2 through their autograd Functions) and launches nothing."""
    for wrapper, shape in ((sa.kv_resident_attention, (1, 1, 512, 40)),
                           (ta.small_seq_attention, (2048, 1, 12, 40)),
                           (fa.flash_attention, (1, 1, 512, 512))):
        q, k, v = map(torch.from_numpy, _qkv(shape, 5))
        q.requires_grad_(True)
        before = port_attention.launch_counts()
        wrapper(q, k, v, 0.1).square().sum().backward()
        assert port_attention.launch_counts() == before
        want = torch.autograd.grad(port_attention.plain_attention(q, k, v, 0.1).square().sum(), q)[0]
        torch.testing.assert_close(q.grad, want, atol=ATOL, rtol=0)
