"""Card-only checks of the CUDA kernels (they have no CPU or interpreter
path).  Marked ``gpu``; they skip where no CUDA device is present.  On a
machine with a GPU and without JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

Tolerance 2e-2 absolute in bf16, as in ``chip_smoke.py`` phase 3; the
backward kernel is held to 2e-2 of max|plain| on dq, dk and dv.
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


@pytest.mark.parametrize("shape,n_k", [
    ((1, 2, 128, 40), 128),
    ((2, 3, 200, 40), 141),   # ragged n_q and n_k
    ((1, 2, 512, 80), 512),
    ((1, 2, 300, 160), 250),
    ((1, 2, 256, 40), 512),   # n_k = 2 * n_q
])
def test_backward_kernel_matches_plain(cuda, shape, n_k):
    q, k, v = _qkv(shape, n_k, cuda, seed=sum(shape) + n_k)
    do = _qkv(shape, shape[2], cuda, seed=7)[0]
    scale = shape[-1] ** -0.5
    b, h, n_q, _ = shape
    lse = torch.empty((b * h, n_q), device=cuda, dtype=torch.float32)
    out = sa._forward(q, k, v, scale, lse)
    before = sa.spatial_attention_bwd.launches
    grads = sa.spatial_attention_bwd(q, k, v, out, do, lse, scale)
    torch.cuda.synchronize()
    assert sa.spatial_attention_bwd.launches == before + 1
    for got, ref in zip(grads, sa.plain_spatial_attention_bwd(q, k, v, do, scale)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        assert torch.isfinite(got.float()).all() and rel <= TOL


def test_autograd_through_the_dispatch_launches_kernels_1_and_4(cuda):
    q, k, v = (x.detach().requires_grad_(True) for x in _qkv((1, 8, 1024, 40), 1024, cuda, 5))
    counts = att.launch_counts()
    out = att.dot_product_attention(q, k, v)
    out.float().square().sum().backward()
    after = att.launch_counts()
    assert after["spatial_attention"] == counts["spatial_attention"] + 1
    assert after["spatial_attention_bwd"] == counts["spatial_attention_bwd"] + 1
    assert all(x.grad is not None and x.grad.dtype == torch.bfloat16 for x in (q, k, v))


def test_flash_kernel_raises_for_a_tensor_that_needs_a_grad(cuda):
    q, k, v = _qkv((1, 1, 512, 512), 512, cuda, seed=4)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention(q, k, v, 512 ** -0.5)
    with torch.no_grad():
        fa.flash_attention(q, k, v, 512 ** -0.5)


def test_one_bf16_train_step(cuda):
    """A narrow TV2V training engine (model_channels 160, 4 heads: d 40 and
    80) takes one bf16-autocast step on 2 frames of 256x512: finite loss,
    kernel 4 launched, only trainable tensors move."""
    import copy

    from ccedit_tpu_torch.cli.train import build_train_engine
    from ccedit_tpu_torch.config import TV2V_TRAIN_CONFIG

    cfg = copy.deepcopy(TV2V_TRAIN_CONFIG)
    p = cfg["model"]["params"]
    for net in (p["network_config"]["params"], p["network_config"]["params"]["controlnet_config"]["params"]):
        net.update(model_channels=160, num_res_blocks=1, num_heads=4, channel_mult=[1, 2],
                   attention_resolutions=[2, 1])
    p["conditioner_config"]["params"]["emb_models"][1]["params"]["fake_annotator"] = True
    engine = build_train_engine(cfg, cuda, seed=0)
    optimizer = engine.make_optimizer(1e-4)
    before = {n: t.detach().clone() for n, t in engine.network.named_parameters()}
    trainable = engine.trainable_parameters()
    clip = torch.rand((1, 2, 256, 512, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    batch = {"jpg": clip.numpy(), "txt": ["a bear"], "control_hint": clip.numpy()}
    counts = att.launch_counts()
    loss = engine.train_step(batch, optimizer, torch.Generator(device=cuda).manual_seed(1),
                             autocast_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert att.launch_counts()["spatial_attention_bwd"] > counts["spatial_attention_bwd"]
    for n, t in engine.network.named_parameters():
        assert torch.equal(t, before[n]) != (n in trainable), n
