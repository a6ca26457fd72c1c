"""Card-only checks of the CUDA kernels (they have no CPU or interpreter
path).  Marked ``gpu``; they skip where no CUDA device is present.  On a
machine with a GPU and without JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

Tolerance 2e-2 absolute in bf16, as in ``chip_smoke.py`` phase 3.
"""

import pytest
import torch

from ccedit_tpu_torch.ops import attention as att
from ccedit_tpu_torch.ops import flash_attention as fa
from ccedit_tpu_torch.ops import spatial_attention as sa
from ccedit_tpu_torch.ops import temporal_attention as ta

pytestmark = pytest.mark.gpu
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU path")
    return torch.device("cuda")


def _qkv(shape, n_k, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    b, h, n, d = shape
    mk = lambda n_: torch.randn((b, n_, h, d), generator=g, device=device).to(
        torch.bfloat16).permute(0, 2, 1, 3)
    return mk(n), mk(n_k), mk(n_k)


@pytest.mark.parametrize("kernel,plain,shape,n_k", [
    (sa.kv_resident_attention, sa.plain_spatial_attention, (2, 8, 1536, 80), 1536),
    (sa.kv_resident_attention, sa.plain_spatial_attention, (1, 8, 6144, 40), 6144),
    (sa.kv_resident_attention, sa.plain_spatial_attention, (2, 3, 1000, 40), 777),
    (ta.small_seq_attention, ta.plain_temporal_attention, (4096, 8, 17, 40), 17),
    (ta.small_seq_attention, ta.plain_temporal_attention, (768, 8, 17, 160), 17),
    (ta.small_seq_attention, ta.plain_temporal_attention, (7, 2, 32, 256), 32),
    (fa.flash_attention, fa.plain_flash_attention, (2, 1, 6144, 512), 6144),
    (fa.flash_attention, fa.plain_flash_attention, (2, 1, 100, 512), 70),
    # kernel 1 at n_k = 2 * n_q (the CFCA centre+self attention) and at d = 160
    (sa.kv_resident_attention, sa.plain_spatial_attention, (1, 8, 6144, 40), 12288),
    (sa.kv_resident_attention, sa.plain_spatial_attention, (2, 8, 1536, 80), 3072),
    (sa.kv_resident_attention, sa.plain_spatial_attention, (2, 8, 1024, 160), 1024),
    (sa.kv_resident_attention, sa.plain_spatial_attention, (2, 3, 1000, 160), 777),
    # kernel 3 at the VAE encoder's reference-frame shape
    (fa.flash_attention, fa.plain_flash_attention, (1, 1, 6144, 512), 6144),
])
def test_kernel_matches_plain(cuda, kernel, plain, shape, n_k):
    q, k, v = _qkv(shape, n_k, cuda, seed=sum(shape))
    scale = shape[-1] ** -0.5
    before = kernel.launches
    out = kernel(q, k, v, scale)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    err = (out.float() - plain(q, k, v, scale).float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= TOL


def test_dispatch_launches_the_routed_kernel(cuda):
    q, k, v = _qkv((1, 8, 1024, 40), 1024, cuda, seed=1)
    before = sa.kv_resident_attention.launches
    att.dot_product_attention(q, k, v)
    assert sa.kv_resident_attention.launches == before + 1


@pytest.mark.parametrize("shape,n_k,variant", [
    ((1, 8, 1024, 40), 2048, "d40 n_k!=n_q"),
    ((1, 8, 512, 160), 512, "d160 n_k=n_q"),
])
def test_variant_counts(cuda, shape, n_k, variant):
    q, k, v = _qkv(shape, n_k, cuda, seed=3)
    before = att.launch_counts().get(f"spatial_attention[{variant}]", 0)
    att.dot_product_attention(q, k, v)
    assert att.launch_counts()[f"spatial_attention[{variant}]"] == before + 1


@pytest.mark.parametrize("bad", ["fp32", "head_dim", "strides"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bad):
    q, k, v = _qkv((1, 2, 512, 40), 512, cuda, seed=2)
    if bad == "fp32":
        q, k, v = q.float(), k.float(), v.float()
    elif bad == "head_dim":
        q, k, v = (x[..., :32] for x in (q, k, v))
    else:
        q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError):
        sa.kv_resident_attention(q, k, v, 0.1)
