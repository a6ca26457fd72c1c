"""Card-only checks of the CUDA kernels (they have no CPU or interpreter
path).  Marked ``gpu``; they skip where no CUDA device is present.  On a
machine with a GPU and without JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

Tolerances as in ``chip_smoke.py`` phase 3: a forward kernel's output is
held to max|err| / max|plain| <= 2e-2 and cosine >= 0.9999 (the outputs of
random attention have a max of ~0.1, so an absolute limit would pass a
wrong kernel); the backward kernels (kernel 4 at d 40/80/160 and at
d = 512) to 2e-2 of max|plain| on dq, dk and dv.  ZoeDepth (the TVI2V
hint) in bf16 is held to itself in fp32 as ``chip_smoke.py`` phase 5b holds
it; a narrow TVI2V training step's gradients through the CFCA backward to
plain attention, and the world-1 NCCL step to the plain one, as phase 6b
holds them.  The W8A8 kernels (8-10) are held to their plain versions bit
for bit, as ``chip_smoke.py`` phase 12 (a) holds them: the quantizer's int8
values and scales, the raw int32 accumulators and the dequantized outputs;
under a clip shard its staged forms too.  Kernel 8's norm form (the
GroupNorm module on the card) is held to the plain fp32 form at phase 3's
gate and to fp64 statistics in 99 % of its outputs.
"""

import copy
import math

import pytest
import torch

from ccedit_tpu_torch.ops import attention as att
from ccedit_tpu_torch.ops import flash_attention as fa
from ccedit_tpu_torch.ops import quant
from ccedit_tpu_torch.ops import spatial_attention as sa
from ccedit_tpu_torch.ops import temporal_attention as ta
from ccedit_tpu_torch.scripts import profile_blocks as pb

pytestmark = pytest.mark.gpu
TOL = 2e-2
COSINE = 0.9999


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


def _agrees(out, ref) -> bool:
    """A forward kernel's bf16 output against its plain version: finite,
    max|err| / max|plain| <= TOL and cosine >= COSINE."""
    out, ref = out.double(), ref.double()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    cos = (out.flatten() @ ref.flatten() / (out.norm() * ref.norm())).item()
    return bool(torch.isfinite(out).all()) and rel <= TOL and cos >= COSINE


@pytest.mark.parametrize("kernel,plain,shape,n_k", [
    (sa.kv_resident_attention, sa.plain_spatial_attention, (2, 8, 1536, 80), 1536),
    (sa.kv_resident_attention, sa.plain_spatial_attention, (1, 8, 6144, 40), 6144),
    (sa.kv_resident_attention, sa.plain_spatial_attention, (2, 3, 1000, 40), 777),
    (ta.small_seq_attention, ta.plain_temporal_attention, (4096, 8, 17, 40), 17),
    (ta.small_seq_attention, ta.plain_temporal_attention, (768, 8, 17, 160), 17),
    (ta.small_seq_attention, ta.plain_temporal_attention, (7, 2, 32, 256), 32),
    # kernel 2's padded key loops (T 5 -> 8, 20 -> 24) and split columns (d 256)
    (ta.small_seq_attention, ta.plain_temporal_attention, (300, 8, 5, 8), 5),
    (ta.small_seq_attention, ta.plain_temporal_attention, (301, 5, 20, 256), 20),
    (ta.small_seq_attention, ta.plain_temporal_attention, (3072, 8, 12, 80), 12),
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
    assert _agrees(out, plain(q, k, v, scale))


@pytest.mark.parametrize("layout", ["head_split", "contiguous"])
@pytest.mark.parametrize("kernel,shape,n_k", [
    ("spatial", (2, 8, 600, 40), 600),
    ("spatial", (2, 8, 600, 40), 1200),
    ("spatial", (2, 8, 600, 80), 600),
    ("flash", (2, 1, 600, 512), 600),
])
def test_ragged_rows_and_lse_on_both_layouts(cuda, kernel, shape, n_k, layout):
    """Kernels 1 and 3 at ragged n_q and n_k (the last query and key tiles
    part empty: TMA's zero fill, the -inf key mask), on the head-split view
    of a (B, N, H*D) projection and on a contiguous (B, H, N, D) tensor
    (their tensor maps order the token and head dimensions apart): the
    output on the first and the last batch row, and the log-sum-exp that
    kernel 4 reads, within 1e-3 of log2 of the plain logsumexp."""
    forward, plain = {"spatial": (sa._forward, sa.plain_spatial_attention),
                      "flash": (fa._forward, fa.plain_flash_attention)}[kernel]
    q, k, v = _qkv(shape, n_k, cuda, seed=sum(shape) + n_k)
    if layout == "contiguous":
        q, k, v = (x.contiguous() for x in (q, k, v))
    b, h, n_q, d = shape
    scale = d ** -0.5
    lse = torch.empty((b * h, n_q), device=cuda, dtype=torch.float32)
    out = forward(q, k, v, scale, lse)
    ref = plain(q, k, v, scale)
    torch.cuda.synchronize()
    for row in (0, b - 1):
        assert _agrees(out[row], ref[row])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    want = (torch.logsumexp(s, dim=-1) / math.log(2.0)).reshape(b * h, n_q)
    assert (lse - want).abs().max().item() <= 1e-3


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
    ((2, 8, 600, 40), 1200),  # ragged, n_k = 2 * n_q
    ((2, 8, 600, 80), 600),
    ((1, 2, 700, 160), 1000),  # ragged, several query tiles of the d = 160 halves
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


def test_backward_check_refuses_delta_left_out(cuda):
    """Kernel 4 handed a zero output computes delta = rowsum(dO * O) = 0,
    so dS = P * dP: the tolerance above must refuse it."""
    shape = (1, 8, 768, 80)
    q, k, v = _qkv(shape, 768, cuda, seed=11)
    do = _qkv(shape, 768, cuda, seed=12)[0]
    scale = 80 ** -0.5
    lse = torch.empty((8, 768), device=cuda, dtype=torch.float32)
    out = sa._forward(q, k, v, scale, lse)
    grads = sa.spatial_attention_bwd(q, k, v, torch.zeros_like(out), do, lse, scale)
    refs = sa.plain_spatial_attention_bwd(q, k, v, do, scale)
    rels = [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
            for g, r in zip(grads, refs)]
    assert max(rels) > TOL


def test_autograd_through_the_dispatch_launches_kernels_1_and_4(cuda):
    q, k, v = (x.detach().requires_grad_(True) for x in _qkv((1, 8, 1024, 40), 1024, cuda, 5))
    counts = att.launch_counts()
    out = att.dot_product_attention(q, k, v)
    out.float().square().sum().backward()
    after = att.launch_counts()
    assert after["spatial_attention"] == counts["spatial_attention"] + 1
    assert after["spatial_attention_bwd"] == counts["spatial_attention_bwd"] + 1
    assert all(x.grad is not None and x.grad.dtype == torch.bfloat16 for x in (q, k, v))


def test_flash_kernel_differentiates_through_kernel_4(cuda):
    """A d = 512 attention that needs a grad runs kernel 3 with its lse and
    kernel 4 at d = 512; under no_grad, kernel 3 alone, without the lse."""
    q, k, v = (x.detach().requires_grad_(True) for x in _qkv((1, 1, 512, 512), 512, cuda, seed=4))
    counts = att.launch_counts()
    fa.flash_attention(q, k, v, 512 ** -0.5).float().square().sum().backward()
    torch.cuda.synchronize()
    after = att.launch_counts()
    assert after["flash_attention"] == counts["flash_attention"] + 1
    assert after["flash_attention[lse]"] == counts.get("flash_attention[lse]", 0) + 1
    assert after["flash_attention_bwd"] == counts["flash_attention_bwd"] + 1
    assert all(x.grad is not None and x.grad.dtype == torch.bfloat16 for x in (q, k, v))
    with torch.no_grad():
        fa.flash_attention(q, k, v, 512 ** -0.5)
    assert att.launch_counts()["flash_attention"] == after["flash_attention"] + 1
    assert att.launch_counts()["flash_attention[lse]"] == after["flash_attention[lse]"]


@pytest.mark.parametrize("shape,n_k", [
    ((12, 1, 1024, 512), 1024),   # VAE training at 256x256, 12 images
    ((4, 1, 4096, 512), 4096),    # the fine-tune at 512x512
    ((2, 1, 600, 512), 600),      # ragged
    ((1, 1, 100, 512), 70),       # ragged n_q and n_k, under one tile
    ((1, 1, 70, 512), 300),       # n_k > n_q: the dK and dV passes have more row blocks
])
def test_flash_backward_kernel_matches_plain(cuda, shape, n_k):
    """Kernel 4 at d = 512 against its plain version,
    ``plain_spatial_attention_bwd``, within 2e-2 of max|plain| on dq, dk
    and dv (``chip_smoke.py``'s BWD_TOLERANCE)."""
    q, k, v = _qkv(shape, n_k, cuda, seed=sum(shape) + n_k)
    do = _qkv(shape, shape[2], cuda, seed=8)[0]
    scale = 512 ** -0.5
    b, h, n_q, _ = shape
    lse = torch.empty((b * h, n_q), device=cuda, dtype=torch.float32)
    out = fa._forward(q, k, v, scale, lse)
    before = fa.flash_attention_bwd.launches
    grads = fa.flash_attention_bwd(q, k, v, out, do, lse, scale)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    for got, ref in zip(grads, sa.plain_spatial_attention_bwd(q, k, v, do, scale)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        assert torch.isfinite(got.float()).all() and rel <= TOL


def test_flash_backward_check_refuses_delta_left_out(cuda):
    """Kernel 4 at d = 512 agrees with its plain version at the ragged
    (2, 1, 600, 512); handed a zero output, whose delta = rowsum(dO * O) is
    0 (dS = P * dP), it must not."""
    shape = (2, 1, 600, 512)
    q, k, v = _qkv(shape, 600, cuda, seed=13)
    do = _qkv(shape, 600, cuda, seed=14)[0]
    scale = 512 ** -0.5
    lse = torch.empty((2, 600), device=cuda, dtype=torch.float32)
    out = fa._forward(q, k, v, scale, lse)
    refs = sa.plain_spatial_attention_bwd(q, k, v, do, scale)

    def rels(o):
        grads = fa.flash_attention_bwd(q, k, v, o, do, lse, scale)
        return [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                for g, r in zip(grads, refs)]

    assert max(rels(out)) <= TOL
    assert max(rels(torch.zeros_like(out))) > TOL


@pytest.mark.parametrize("shape,n_k", [((12, 1, 1024, 512), 1024), ((2, 1, 100, 512), 70)])
def test_flash_kernel_writes_the_log2_lse(cuda, shape, n_k):
    """Kernel 3's lse is log2 of each row's sum of exp(scale q.k), within
    1e-3 (fp32 sums in another order)."""
    q, k, v = _qkv(shape, n_k, cuda, seed=n_k)
    scale = 512 ** -0.5
    b, h, n_q, _ = shape
    lse = torch.full((b * h, n_q), float("nan"), device=cuda, dtype=torch.float32)
    out = fa._forward(q, k, v, scale, lse)
    torch.cuda.synchronize()
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    ref = (torch.logsumexp(s, dim=-1) / math.log(2.0)).reshape(b * h, n_q)
    assert (lse - ref).abs().max().item() <= 1e-3
    assert _agrees(out, fa.plain_flash_attention(q, k, v, scale))


@pytest.mark.parametrize("bm,bn", pb.TILES)
def test_tile_sweep_matches_plain(cuda, bm, bn):
    """Kernel 7: each kept tile pair of kernel 1's template at head_dim 40,
    at a ragged shape, agrees with the plain version; with log2 e left out
    of its exp2 scale (a softmax temperature off by ln 2) it does not."""
    q, k, v = _qkv((2, 3, 1000, 40), 777, cuda, seed=bm + bn)
    before = pb.tiles.launches
    out = pb.tiles(q, k, v, pb.SCALE, bm, bn)
    torch.cuda.synchronize()
    assert pb.tiles.launches == before + 1
    ref = fa.plain_flash_attention(q, k, v, pb.SCALE)
    assert _agrees(out, ref)
    log2e, pb._LOG2E = pb._LOG2E, 1.0
    try:
        assert not _agrees(pb.tiles(q, k, v, pb.SCALE, bm, bn), ref)
    finally:
        pb._LOG2E = log2e


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


def _narrow_tvi2v_train_engine(device):
    """``TVI2V_TRAIN_CONFIG`` narrowed (model_channels 160, 4 heads: d 40 at
    level 0, d 80 at level 1, for the UNet and both ControlNets; the
    luminance depth stand-in) on the card, fp32 masters."""
    import copy

    from ccedit_tpu_torch.cli.train import build_train_engine
    from ccedit_tpu_torch.config import TVI2V_TRAIN_CONFIG

    cfg = copy.deepcopy(TVI2V_TRAIN_CONFIG)
    p = cfg["model"]["params"]
    net = p["network_config"]["params"]
    for params in (net, net["controlnet_config"]["params"], net["controlnet_img_config"]["params"]):
        params.update(model_channels=160, num_res_blocks=1, num_heads=4, channel_mult=[1, 2],
                      attention_resolutions=[2, 1])
    p["conditioner_config"]["params"]["emb_models"][1]["params"]["fake_annotator"] = True
    engine = build_train_engine(cfg, device, seed=0)
    engine.make_optimizer(1e-4)
    return engine


def test_tvi2v_train_grads_through_the_cfca_backward(cuda):
    """A narrow TVI2V training step (3 frames of 256x512: 2048-token level 0
    and its 4096-key CFCA) in bf16 autocast: the trainable gradients
    through kernels 1, 1b and 4 (n_k = n_q and n_k = 2 n_q) against plain
    attention, tensor by tensor within ``chip_smoke.GRAD_TOLERANCE``; kernel
    4's dq and dk zeroed only on the CFCA's calls must leave it."""
    import chip_smoke as cs

    engine = _narrow_tvi2v_train_engine(cuda)
    batch = cs.tvi2v_batch(3, 256, 512, seed=0)
    gen = torch.Generator(device=cuda)
    zshape = (1, 3, 32, 64, 4)
    overrides = dict(sigmas=torch.tensor([engine.denoiser.sigmas_np[500]], device=cuda),
                     noise=torch.randn(zshape, generator=gen.manual_seed(0), device=cuda),
                     vae_noise=torch.randn(zshape, generator=gen, device=cuda))

    def backward():
        engine.backward_step(batch, gen.manual_seed(1), torch.bfloat16, **overrides)

    g_kernels, g_plain, g_faults, counts = cs.grads_three_ways(
        engine.trainable_parameters(), backward, sa.SpatialAttention,
        (("cfca", cs.on_cfca),))
    for variant in ("d40 n_k=n_q", "d80 n_k=n_q", "d40 n_k!=n_q", "d80 n_k!=n_q"):
        assert counts.get(f"spatial_attention_bwd[{variant}]", 0) > 0, counts
    assert cs.grad_errors(g_kernels, g_plain)["worst_leaf"] <= cs.GRAD_TOLERANCE
    assert cs.grad_errors(g_faults["cfca"], g_plain)["worst_leaf"] > cs.GRAD_TOLERANCE


def test_world_one_nccl_step_equals_the_plain_step(cuda):
    """The data-parallel path at world size 1 over NCCL: all-reduced
    gradients under AdamW and under ZeRO leave the trainable tensors bit
    for bit where the plain update leaves them; a whole step runs through
    it (``chip_smoke.check_distributed_step``)."""
    import chip_smoke as cs

    engine = _narrow_tvi2v_train_engine(cuda)
    cs.check_distributed_step(engine, cs.tvi2v_batch(3, 256, 512, seed=0), cuda, 0)


def test_one_bf16_vae_train_step(cuda):
    """A narrow VAE of ``VAE_TRAIN_CONFIG`` (ch 128, ch_mult 1,2,4: a 512-wide
    mid block) takes one bf16-autocast ``VAETrainer`` step on 2 images of
    128x128 (1024-token mid attention): finite logs, kernel 3 four times
    (twice with its lse) and kernel 4 at d = 512 twice, LPIPS unchanged, the
    autoencoder and the discriminator moved."""
    import copy

    from ccedit_tpu_torch.config import VAE_TRAIN_CONFIG
    from ccedit_tpu_torch.models.autoencoder_engine import build_vae_trainer

    cfg = copy.deepcopy(VAE_TRAIN_CONFIG)
    cfg["model"]["params"]["encoder_config"]["params"].update(ch_mult=[1, 2, 4], num_res_blocks=1)
    engine, trainer = build_vae_trainer(cfg, cuda, seed=0, disc_start=0)
    before = {n: p.detach().clone() for n, p in engine.named_parameters()}
    x = torch.rand((2, 128, 128, 3), generator=torch.Generator(device=cuda).manual_seed(1),
                   device=cuda) * 2 - 1
    counts = att.launch_counts()
    logs = trainer.train_step(x, torch.Generator(device=cuda).manual_seed(2))
    torch.cuda.synchronize()
    after = att.launch_counts()
    assert all(torch.isfinite(v) for v in logs.values())
    assert after["flash_attention"] - counts["flash_attention"] == 4
    assert after["flash_attention[lse]"] - counts.get("flash_attention[lse]", 0) == 2
    assert after["flash_attention_bwd"] - counts["flash_attention_bwd"] == 2
    for n, p in engine.named_parameters():
        assert torch.equal(p, before[n]) == n.startswith(("lpips.", "logvar")), n


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


@pytest.mark.parametrize("shape,n_k", [
    ((1, 8, 6144, 40), 6144),
    ((2, 8, 1536, 80), 1536),
    ((1, 8, 6144, 40), 12288),   # CFCA, n_k = 2 * n_q
    ((2, 8, 1536, 80), 3072),
    ((2, 3, 1000, 40), 777),     # ragged n_q and n_k
    ((2, 8, 600, 40), 600),      # chip_smoke.py's ragged rows
    ((2, 8, 600, 40), 1200),
    ((2, 8, 600, 80), 600),
    ((1, 2, 100, 80), 70),       # one partial query tile, one partial key tile
])
def test_int8_kernel_matches_plain(cuda, shape, n_k):
    """Kernel 1c against its plain version (2e-2 abs in bf16) and against
    exact attention (cosine > 0.9995, tests/test_spatial_attention.py's
    bound for the JAX int8 path)."""
    q, k, v = _qkv(shape, n_k, cuda, seed=sum(shape) + n_k)
    scale = shape[-1] ** -0.5
    before = att.launch_counts()
    out = sa.kv_resident_attention(q, k, v, scale, quantized_qk=True)
    torch.cuda.synchronize()
    variant = "int8 " + sa.variant(q, k)
    assert att.launch_counts().get(f"spatial_attention[{variant}]", 0) == \
        before.get(f"spatial_attention[{variant}]", 0) + 1
    err = (out.float() - sa.plain_spatial_attention_int8(q, k, v, scale).float()).abs().max().item()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all() and err <= TOL
    assert _cosine(out, sa.plain_spatial_attention(q, k, v, scale)) > 0.9995


@pytest.mark.parametrize("d", [40, 80])
def test_int8_prepass_on_the_card_equals_the_cpu_one(cuda, d):
    """``quantize_qk`` on the card is bit-identical to the CPU pre-pass,
    which the CPU tests hold bit for bit to the JAX one (true divisions on
    both devices, round-half-even)."""
    q, k, _ = _qkv((2, 8, 1024, d), 2048, cuda, seed=d)
    q[0, 0] = torch.round(q[0, 0] * 20) / 2  # one head of halves with amax 127: ties
    q[0, 0, 0, 0] = 127.0
    scale = d ** -0.5
    for got, want in zip(sa.quantize_qk(q, k, scale), sa.quantize_qk(q.cpu(), k.cpu(), scale)):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape,n_k", [((2, 8, 1536, 80), 3072), ((2, 8, 6144, 40), 6144),
                                         ((2, 3, 1000, 40), 777)])
def test_int8_prepass_kernel_equals_its_plain_version(cuda, shape, n_k):
    """The CUDA pre-pass (``csrc/quantize_qk.cu``) bit for bit against
    ``plain_prepass`` (``quantize_qk``, padded), on the model's layout and
    on contiguous tensors, with exact .5 ties planted (a head of halves
    whose amax is 127 in q and in k); one launch a call."""
    q, k, _ = _qkv(shape, n_k, cuda, seed=sum(shape))
    for x, (b, h) in ((q, (0, 0)), (k, (-1, -1))):
        x[b, h] = torch.round(x[b, h].float() * 20).div(2).to(x.dtype)
        x[b, h, 0, 0] = 127.0
    scale = shape[-1] ** -0.5
    for qq, kk in ((q, k), (q.contiguous(), k.contiguous())):
        before = sa.prepass.launches
        got = sa.prepass(qq, kk, scale)
        assert sa.prepass.launches == before + 1
        want = sa.plain_prepass(qq, kk, scale)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert int(((q[0, 0].float() - q[0, 0].float().trunc()).abs() == 0.5).sum()) > 100


def test_int8_switch_routes_to_kernel_1c(cuda):
    """With the switch on, a gated shape launches the int8 variant; d = 160
    and n_q not a multiple of 128 stay exact; a tensor needing a grad still
    takes kernel 1c forward (its gradient is the exact one, below)."""
    shapes = (((1, 8, 1024, 40), 2048, "int8 d40 n_k!=n_q"),
              ((1, 8, 1024, 160), 1024, "d160 n_k=n_q"),
              ((1, 8, 1000, 40), 1000, "d40 n_k=n_q"))
    try:
        att.set_quantized_qk(True)
        for shape, n_k, variant in shapes:
            q, k, v = _qkv(shape, n_k, cuda, seed=6)
            before = att.launch_counts().get(f"spatial_attention[{variant}]", 0)
            att.dot_product_attention(q, k, v)
            assert att.launch_counts()[f"spatial_attention[{variant}]"] == before + 1
        q, k, v = _qkv((1, 8, 1024, 40), 1024, cuda, seed=7)
        before = att.launch_counts().get("spatial_attention[int8 d40 n_k=n_q]", 0)
        att.dot_product_attention(q.requires_grad_(True), k, v)
        assert att.launch_counts()["spatial_attention[int8 d40 n_k=n_q]"] == before + 1
    finally:
        att.set_quantized_qk(False)


@pytest.mark.parametrize("shape,n_k", [((1, 8, 1024, 40), 1024), ((2, 8, 512, 80), 1024)])
def test_int8_gradient_is_the_exact_paths(cuda, shape, n_k):
    """With the switch on, the gradient through the int8 QK^T attention is
    the exact attention's (the JAX package's ``_kv_resident_diff``): within
    2e-2 of max|exact| on dq, dk and dv, from one launch of kernel 1c, one
    of kernel 1 (the exact recompute) and one of kernel 4."""
    q, k, v = _qkv(shape, n_k, cuda, seed=13)
    do = _qkv(shape, shape[2], cuda, seed=14)[0]
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    exact = torch.autograd.grad(att.dot_product_attention(*leaves), leaves, do)
    try:
        att.set_quantized_qk(True)
        counts = att.launch_counts()
        out = att.dot_product_attention(*leaves)
        quant = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        after = att.launch_counts()
    finally:
        att.set_quantized_qk(False)
    variant = sa.variant(q, k)
    assert after[f"spatial_attention[int8 {variant}]"] == counts.get(f"spatial_attention[int8 {variant}]", 0) + 1
    assert after[f"spatial_attention[{variant}]"] == counts.get(f"spatial_attention[{variant}]", 0) + 1
    assert after["spatial_attention_bwd"] == counts["spatial_attention_bwd"] + 1
    for got, want in zip(quant, exact):
        rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        assert torch.isfinite(got.float()).all() and rel <= TOL


@pytest.mark.parametrize("n", [1024, 960])  # 960: the last 128-key tile half past N
@pytest.mark.parametrize("stage,transposed,int8", [
    ("qkt", False, False), ("softmax", False, False), ("full", False, False),
    ("qkt", True, False), ("full", True, False), ("qkt", True, True), ("full", True, True)])
def test_probe_matches_plain(cuda, stage, transposed, int8, n):
    """Kernel 5 at (8, n, 40) within ``kv_resident_attn.compare``'s
    limits: row sums within 1e-3 of max|plain| (fp32 sums of n terms;
    bf16 products exact in fp32), full within 2e-2 of max|plain| and at
    cosine >= 0.9999."""
    from ccedit_tpu_torch.scripts import kv_resident_attn as kr

    x = kr.inputs(cuda, seed=1, b=8, n=n)
    q, k, v, scale, tr = kr.call_args(x, stage, transposed, int8)
    before = kr.probe.launches
    out = kr.probe(stage, q, k, v, scale, tr)
    torch.cuda.synchronize()
    assert kr.probe.launches == before + 1
    ref = kr.plain_probe(stage, q, k, v, scale, tr)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    checked = kr.compare(stage, out, ref)
    assert checked["ok"], checked


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("mkn", [(256, 128, 384), (1024, 512, 1024), (384, 192, 640)])
def test_gemm_matches_plain(cuda, int8, mkn):
    """Kernel 6: int8 -> int32 exactly equal to the float64 product; bf16 ->
    fp32 within 1e-5 of max|plain| (fp32 sums in another order).  N 384 and
    640 end in half a 256-column tile; K 192 ends in part of a k-tile."""
    from ccedit_tpu_torch.scripts import int8_probe as ip

    m, k, n = mkn
    a, b = ip.operands(m, k, n, int8, cuda, seed=2)
    before = ip.gemm.launches
    c = ip.gemm(a, b)
    torch.cuda.synchronize()
    assert ip.gemm.launches == before + 1
    ref = ip.plain_gemm(a, b)
    if int8:
        assert c.dtype == torch.int32 and torch.equal(c, ref)
    else:
        assert ((c - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("call", ["probe n % 64", "probe head_dim", "probe int8 plain layout",
                                  "gemm m % 128", "gemm k % 64 int8", "transpose cols % 16"])
def test_probe_wrappers_raise_outside_their_contract(cuda, call):
    """Kernels 5 and 6 and the int8 transposition raise on a shape their
    kernels do not take, and launch nothing."""
    from ccedit_tpu_torch.scripts import int8_probe as ip
    from ccedit_tpu_torch.scripts import kv_resident_attn as kr

    gen = torch.Generator(device=cuda).manual_seed(0)
    bf = lambda *s: torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)  # noqa: E731
    i8 = lambda *s: torch.randint(-127, 127, s, generator=gen, device=cuda,  # noqa: E731
                                  dtype=torch.int8)
    calls = {
        "probe n % 64": lambda: kr.probe("qkt", bf(2, 96, 40), bf(2, 96, 40)),
        "probe head_dim": lambda: kr.probe("qkt", bf(2, 128, 48), bf(2, 128, 48)),
        "probe int8 plain layout": lambda: kr.probe("qkt", i8(2, 128, 40), i8(2, 128, 40)),
        "gemm m % 128": lambda: ip.gemm(bf(100, 64), bf(64, 128)),
        "gemm k % 64 int8": lambda: ip.gemm(i8(128, 96), i8(96, 128)),
        "transpose cols % 16": lambda: ip.transpose_int8(i8(40, 40), 48),
    }
    before = (kr.probe.launches, ip.gemm.launches, ip.transpose_int8.launches)
    with pytest.raises(ValueError):
        calls[call]()
    assert (kr.probe.launches, ip.gemm.launches, ip.transpose_int8.launches) == before


@pytest.fixture(scope="module")
def zoe_on_card():
    """A seeded random full-size ZoeD_M12_N in bf16 and its fp32 copy, on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ZoeDepth check compares bf16 and fp32 on the card")
    from ccedit_tpu_torch.conditioning.annotators import zoedepth as zd

    model = zd.randomize_zoedepth_(zd.ZoeDepthN(), torch.Generator().manual_seed(0))
    fp32 = model.to("cuda").eval()
    return copy.deepcopy(fp32).to(torch.bfloat16), zd, fp32


@pytest.mark.parametrize("frames", [5, 2])
def test_zoe_bf16_matches_fp32(zoe_on_card, frames):
    """The Zoe depth of a chunk of the edit's 512x768 clip in bf16 against
    fp32, by the cosine of the mean-centred maps (``chip_smoke.ZOE_COSINE``);
    the bf16 run without the relative-position bias must fall below it."""
    from chip_smoke import ZOE_COSINE, centred_cosine
    from ccedit_tpu_torch.data.video import moving_gradient_clip

    bf16, zd, fp32 = zoe_on_card
    clip = torch.from_numpy(moving_gradient_clip(frames, 512, 768)).cuda().float() / 255.0
    with torch.no_grad():
        ref = zd.detect_depth_zoe(fp32, clip)
        out = zd.detect_depth_zoe(bf16, clip).float()
        fault = zd.detect_depth_zoe(bf16, clip, rel_bias=False).float()
    assert out.shape == ref.shape == (frames, 512, 768) and bool(torch.isfinite(out).all())
    assert centred_cosine(out, ref) >= ZOE_COSINE > centred_cosine(fault, ref)


@pytest.mark.parametrize("hw,ch", [(64, 320), (32, 640)])
def test_raig_reference_attention_through_kernel_1(cuda, hw, ch):
    """RAIG's ``SpatialTransformerCA`` at 512x512 doubled for CFG (levels 0
    and 1: (2, 8, 4096, 40) and (2, 8, 1024, 80)), seeded random weights in
    bf16, its reference cross-attention's K/V from a bank: kernel 1 runs the
    self- and the reference attention, and the output is held to the same
    module on plain attention as ``chip_smoke.py`` phase 8 (b) holds the
    network (5e-2 of max|plain|); the query's own tokens as the bank give
    another contribution of the reference sub-layer."""
    from ccedit_tpu_torch.io.checkpoint import randomize_weights_
    from ccedit_tpu_torch.modules.transformer import SpatialTransformerCA

    g = torch.Generator(device=cuda).manual_seed(hw)
    with cuda:
        st = SpatialTransformerCA(ch, 8, ch // 8, context_dim=768)
    randomize_weights_(st, g)
    st = st.to(torch.bfloat16).eval()
    x = torch.randn((2, hw, hw, ch), generator=g, device=cuda).to(torch.bfloat16)
    ctx = torch.randn((2, 77, 768), generator=g, device=cuda).to(torch.bfloat16)
    # a bank whose tokens are not the query's own kind (mean 2, not 0): under
    # random weights the softmax is near uniform and reads the mean value
    bank = (torch.randn((2, hw * hw, ch), generator=g, device=cuda) + 2).to(torch.bfloat16)
    att.reset_launch_counts()
    with torch.no_grad():
        out = st(x, context=ctx, ref_context=bank).float()
        counts = att.launch_counts()
        saved = dict(att._ROUTES)
        att._ROUTES.update({k: att.plain_attention for k in saved})
        try:
            ref = st(x, context=ctx, ref_context=bank).float()
        finally:
            att._ROUTES.update(saved)
        own = st(x, context=ctx, ref_context=x.reshape(2, hw * hw, ch)).float()
        body = st(x, context=ctx).float()
    variant = f"spatial_attention[d{ch // 8} n_k=n_q]"
    assert counts.get(variant, 0) == 2, counts  # the self- and the reference attention
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert torch.isfinite(out).all() and rel <= 5e-2, rel
    # the reference sub-layer's own contribution moves with its bank
    assert ((own - out).abs().max() / (out - body).abs().max()).item() > 0.2


# the structure hints (phase 9): each kind's hint on the card against the same
# module on the CPU, both fp32 (TF32 off), on a 2-frame 128x192 clip with
# edges and colour, by centred cosine; the scribbles by the intersection
# over union of their stroke pixels; openpose by its network's maps (its
# host assembly is discrete, and held by phase 9 to a planted person)
HINT_KINDS = (("LineartEncoder", {}, None), ("LineartEncoder", {"lineart_standard": False},
                                             "lineart_model"),
              ("softedge_hed", {}, "hed"), ("SoftEdgeEncoder", {"safe": True}, "pidinet"),
              ("ScribbleHEDEncoder", {}, "hed"), ("ScribblePidiNetEncoder", {}, "pidinet"),
              ("NormalBaeEncoder", {}, "normal_bae"), ("OpenposeEncoder", {}, "openpose"))


@pytest.mark.parametrize("target,params,family", HINT_KINDS,
                         ids=[f"{t}-{i}" for i, (t, _, _) in enumerate(HINT_KINDS)])
def test_hint_on_the_card_equals_the_cpu_one(cuda, tmp_path, target, params, family):
    from chip_smoke import structured_clip
    from ccedit_tpu_torch.conditioning.annotators.base import AnnotatorEmbedder, build_annotator
    from ccedit_tpu_torch.conditioning.annotators.random_weights import random_checkpoint

    if family is not None:
        params = dict(params, ckpt_path=str(tmp_path / f"{family}.pt"))
        torch.save(random_checkpoint(family, torch.Generator().manual_seed(1)),
                   params["ckpt_path"])
    if target == "softedge_hed":  # no reference target of its own
        emb = AnnotatorEmbedder("softedge_hed", backbone=build_annotator(
            "ScribbleHEDEncoder", params).backbone)
    else:
        emb = build_annotator(target, params)
    clip = torch.from_numpy(structured_clip(2, 128, 192))[None]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = emb.eval()(clip).double()
            card = copy.deepcopy(emb).to(cuda)
            out = card(clip.to(cuda)).double().cpu()
            if target == "OpenposeEncoder":
                from ccedit_tpu_torch.conditioning.annotators.openpose import openpose_maps

                frames = clip[0].float() / 127.5 - 1.0
                ref = torch.cat(openpose_maps(emb.backbone, frames), -1).double()[None]
                out = torch.cat(openpose_maps(card.backbone, frames.to(cuda)), -1)
                out = out.double().cpu()[None]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out.shape == ref.shape and torch.isfinite(out).all()
    if target.startswith("Scribble"):  # strokes are -1: IoU of the stroke pixels
        ours, theirs = (out < 0).all(-1), (ref < 0).all(-1)
        union = (ours | theirs).sum().item()
        assert union > 0 and (ours & theirs).sum().item() / union >= 0.99
    else:
        a, b = out - out.mean(), ref - ref.mean()
        assert (a.flatten() @ b.flatten() / (a.norm() * b.norm())).item() >= 0.9999


# ---- head_dim 64: SD-2.x's heads (kernels 1, 1c with its pre-pass, 4) ----

@pytest.mark.parametrize("shape", [(2, 5, 9216, 64), (2, 10, 2304, 64), (2, 20, 576, 64),
                                   (2, 3, 1000, 64)])
def test_d64_kernel1_matches_plain(cuda, shape):
    """Kernel 1's d = 64 instantiation at SD-2.1-768's three levels (576:
    ragged, a shape the JAX gate leaves to XLA) and a ragged n_q; the same
    check must refuse the kernel with log2 e left out of its scale."""
    q, k, v = _qkv(shape, shape[2], cuda, seed=sum(shape))
    scale = 64 ** -0.5
    before = att.launch_counts().get("spatial_attention[d64 n_k=n_q]", 0)
    out = att.dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    assert att.launch_counts()["spatial_attention[d64 n_k=n_q]"] == before + 1
    ref = sa.plain_spatial_attention(q, k, v, scale)
    assert _agrees(out, ref)
    assert not _agrees(sa._forward(q, k, v, scale / sa._LOG2E), ref)


@pytest.mark.parametrize("shape,quantized", [((2, 5, 9216, 64), True), ((2, 10, 2304, 64), True),
                                             ((2, 20, 576, 64), False)])
def test_d64_int8_switch_quantizes_where_the_jax_gate_holds(cuda, shape, quantized):
    q, k, v = _qkv(shape, shape[2], cuda, seed=sum(shape) + 1)
    scale = 64 ** -0.5
    att.set_quantized_qk(True)
    try:
        before = att.launch_counts()
        out = att.dot_product_attention(q, k, v)
        torch.cuda.synchronize()
        after = att.launch_counts()
    finally:
        att.set_quantized_qk(False)
    key = "spatial_attention[int8 d64 n_k=n_q]" if quantized else "spatial_attention[d64 n_k=n_q]"
    assert after[key] == before.get(key, 0) + 1
    assert after["quantize_qk"] == before["quantize_qk"] + int(quantized)
    plain = sa.plain_spatial_attention_int8 if quantized else sa.plain_spatial_attention
    assert _agrees(out, plain(q, k, v, scale))
    assert _cosine(out, sa.plain_spatial_attention(q, k, v, scale)) > 0.9995


@pytest.mark.parametrize("shape", [(2, 5, 9216, 64), (2, 10, 2304, 64)])
def test_d64_prepass_equals_its_plain_version(cuda, shape):
    q, k, _ = _qkv(shape, shape[2], cuda, seed=sum(shape) + 2)
    for x, (b, h) in ((q, (0, 0)), (k, (-1, -1))):
        x[b, h] = torch.round(x[b, h].float() * 20).div(2).to(x.dtype)
        x[b, h, 0, 0] = 127.0
    scale = 64 ** -0.5
    got, want = sa.prepass(q, k, scale), sa.plain_prepass(q, k, scale)
    assert got[0].shape[-1] == 64  # 64-byte rows, no padding
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("shape,n_k", [((2, 10, 2304, 64), 2304), ((2, 5, 9216, 64), 9216),
                                        ((2, 20, 576, 64), 576), ((2, 8, 600, 64), 600),
                                        ((1, 2, 300, 64), 700)])
def test_d64_backward_kernel_matches_plain(cuda, shape, n_k):
    q, k, v = _qkv(shape, n_k, cuda, seed=sum(shape) + n_k)
    do = _qkv(shape, shape[2], cuda, seed=13)[0]
    scale = 64 ** -0.5
    b, h, n_q, _ = shape
    lse = torch.empty((b * h, n_q), device=cuda, dtype=torch.float32)
    out = sa._forward(q, k, v, scale, lse)
    key = f"spatial_attention_bwd[{sa.variant(q, k)}]"
    before = att.launch_counts().get(key, 0)
    grads = sa.spatial_attention_bwd(q, k, v, out, do, lse, scale)
    faulty = sa.spatial_attention_bwd(q, k, v, torch.zeros_like(out), do, lse, scale)
    torch.cuda.synchronize()
    assert att.launch_counts()[key] == before + 2
    refs = sa.plain_spatial_attention_bwd(q, k, v, do, scale)
    rels = [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
            for g, r in zip(grads, refs)]
    assert all(torch.isfinite(g.float()).all() for g in grads) and max(rels) <= TOL
    fault = [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
             for g, r in zip(faulty, refs)]
    assert max(fault) > TOL  # delta left out


@pytest.mark.parametrize("shape", [(1, 2, 9216, 64), (2, 3, 1000, 64)])
def test_d64_kernel1_rescales_past_the_first_tile(cuda, shape):
    """Scores spread wide (q scaled by 6) so later key tiles raise rows'
    maxima past 2^8, the d = 64 softmax's rescale threshold: kernel 1 still
    agrees with its plain version, and so does its lse."""
    q, k, v = _qkv(shape, shape[2], cuda, seed=sum(shape) + 5)
    q = (q.float() * 6).to(torch.bfloat16)
    scale = 64 ** -0.5
    b, h, n, _ = shape
    lse = torch.empty((b * h, n), device=cuda, dtype=torch.float32)
    out = sa._forward(q, k, v, scale, lse)
    assert _agrees(out, sa.plain_spatial_attention(q, k, v, scale))
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * sa._LOG2E)
    want = torch.logsumexp(s2 * math.log(2.0), -1) / math.log(2.0)
    assert (lse.view(b, h, n) - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("stage", ["qkt", "softmax", "full"])
@pytest.mark.parametrize("n", [2304, 960])  # 960: the last 128-key tile half past N
def test_d64_probe_matches_plain(cuda, stage, n):
    """Kernel 5's plain-layout probes at head_dim 64 within
    ``kv_resident_attn.compare``'s limits; softmax and full refuse log2 e
    left out of their scale."""
    from ccedit_tpu_torch.scripts import kv_resident_attn as kr

    x = kr.inputs(cuda, seed=2, b=4, n=n, d=64)
    q, k, v, scale, tr = kr.call_args(x, stage, False, False)
    before = kr.probe.variant_launches[f"{stage} plain bf16 d64"]
    out = kr.probe(stage, q, k, v, scale, tr)
    torch.cuda.synchronize()
    assert kr.probe.variant_launches[f"{stage} plain bf16 d64"] == before + 1
    ref = kr.plain_probe(stage, q, k, v, scale, tr)
    checked = kr.compare(stage, out, ref)
    assert checked["ok"], checked
    if stage != "qkt":
        log2e, kr._LOG2E = kr._LOG2E, 1.0
        try:
            assert not kr.compare(stage, kr.probe(stage, q, k, v, scale, tr), ref)["ok"]
        finally:
            kr._LOG2E = log2e


def test_d64_autograd_launches_kernel_4(cuda):
    q, k, v = (x.detach().requires_grad_(True) for x in _qkv((1, 5, 1024, 64), 1024, cuda, 9))
    before = att.launch_counts().get("spatial_attention_bwd[d64 n_k=n_q]", 0)
    att.dot_product_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert att.launch_counts()["spatial_attention_bwd[d64 n_k=n_q]"] == before + 1
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))


# ---- the W8A8 kernels (8-10) ----

@pytest.mark.parametrize("rows,groups,length,per_row,dtype", [
    (300, 1, 320, True, torch.bfloat16), (7, 1, 1280, True, torch.float32),
    (64, 9, 4, True, torch.bfloat16), (40, 9, 320, True, torch.bfloat16),
    (5000, 1, 320, False, torch.bfloat16), (3000, 1, 3, False, torch.float32),
    (6000, 1, 4, False, torch.bfloat16)])
def test_w8a8_quantizer_bit_for_bit(cuda, rows, groups, length, per_row, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows + length)
    x = (3 * torch.randn((rows, groups * length), generator=g, device=cuda)).to(dtype)
    x[rows // 2] = 0  # a zero row: scale 1
    q, s = quant.quantize_int8(x, per_row, groups)
    pq, ps = quant.plain_quantize_int8(x, per_row, groups)
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.parametrize("m,k,n,dtype", [
    (300, 320, 320, torch.bfloat16), (7, 1280, 5, torch.bfloat16), (129, 36, 640, torch.float32),
    (1000, 2560, 320, torch.bfloat16)])
def test_w8a8_gemm_matches_plain(cuda, m, k, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    w = torch.randn((n, k), generator=g, device=cuda).to(dtype)
    bias = torch.randn((n,), generator=g, device=cuda).to(dtype)
    x8, sx = quant.quantize_int8(x, per_row=True)
    w8, sw = quant.quantize_weight(w)
    for out_dtype, b in ((None, None), (dtype, bias)):
        out = quant.gemm_dequant(x8, sx, w8, sw, b, out_dtype)
        ref = quant.plain_gemm_dequant(x8, sx, w8, sw, b, out_dtype)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("m,k,n", [
    # kernel 9's tiles (quant.gemm_tiles) with several tiles a block: BN 160
    # resident (N 320) and streamed (K 2560), BN 256 resident (K 320) and
    # streamed (K 1280), BN 128 (N 384) and the ragged M of the
    # cross-attention k/v and the ResBlock embedding
    (40000, 320, 320), (20000, 2560, 640), (40000, 320, 2560), (20000, 1280, 1280),
    (3000, 640, 384), (2618, 768, 640), (34, 1280, 1280)])
def test_w8a8_gemm_tiles_match_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=g, device=cuda) / math.sqrt(k)).to(torch.bfloat16)
    bias = torch.randn((n,), generator=g, device=cuda).to(torch.bfloat16)
    x8, sx = quant.quantize_int8(x, per_row=True)
    w8, sw = quant.quantize_weight(w)
    for out_dtype, b in ((None, None), (torch.bfloat16, bias)):
        out = quant.gemm_dequant(x8, sx, w8, sw, b, out_dtype)
        assert torch.equal(out, quant.plain_gemm_dequant(x8, sx, w8, sw, b, out_dtype))


@pytest.mark.parametrize("m,k,n,dtype", [
    (40000, 320, 320, torch.bfloat16), (300, 320, 320, None), (2618, 320, 640, torch.bfloat16),
    (77, 40, 320, torch.bfloat16), (5, 96, 128, torch.float32), (1000, 384, 320, torch.bfloat16),
    (129, 448, 100, torch.bfloat16)])
def test_w8a8_fused_gemm_matches_plain(cuda, m, k, n, dtype):
    """Kernel 9's fused form (the bf16 activation quantized per row in
    shared memory): its int8 rows and scales bit for bit kernel 8's, its
    accumulators and outputs bit for bit the two-launch plain path's, at
    rows planted with exact .5 quotients and a zero row, K tails (40, 448)
    and a ragged M."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = (3 * torch.randn((m, k), generator=g, device=cuda)).to(torch.bfloat16)
    x[m // 2] = 0  # a zero row: scale 1
    # amax 31.75 (scale 0.25) and 127 (scale 1): every other quotient an exact .5
    x[0, :] = (torch.arange(k, device=cuda).remainder(9) - 3.5).to(torch.bfloat16) * 0.25
    x[0, 0] = 31.75
    x[-1, :] = torch.arange(k, device=cuda).remainder(7).to(torch.bfloat16) + 0.5
    x[-1, 0] = 127.0
    w = (torch.randn((n, k), generator=g, device=cuda) / math.sqrt(k)).to(torch.bfloat16)
    bias = torch.randn((n,), generator=g, device=cuda).to(torch.bfloat16)
    assert quant.gemm_route(k, n, torch.bfloat16) == "fused"
    w8, sw = quant.quantize_weight(w)
    b = None if dtype is None else bias.to(dtype)
    out, q8, sx = quant.gemm_dequant_bf16a(x, w8, sw, b, dtype, quantized=True)
    pq8, psx = quant.quantize_int8(x, per_row=True)
    assert torch.equal(q8, pq8) and torch.equal(sx, psx)
    assert torch.equal(out, quant.plain_gemm_dequant(pq8, psx, w8, sw, b, dtype))
    if dtype is not None:
        assert not torch.equal(quant.gemm_dequant_bf16a(x, w8, sw, b, dtype, faults=2), out)
        if m > 64:
            assert not torch.equal(quant.gemm_dequant_bf16a(x, w8, sw, b, dtype, faults=1), out)


def test_w8a8_fused_quantization_at_every_scale(cuda):
    """The fused form's quantization (a reciprocal and two corrections where
    2^-100 <= scale <= 2^100, kernel 8's division elsewhere) bit for bit
    kernel 8's and the plain version's: 20,000 rows of bf16 values drawn up
    to their row's amax, the amaxes log-uniform over 1e-38 .. 1e38 (so both
    sides of both limits), a row of exact .5 quotients, every bf16 value
    below 127 in the rows of scale 1."""
    g = torch.Generator(device=cuda).manual_seed(11)
    m, k = 20000, 320
    amax = torch.exp(torch.empty((m, 1), device=cuda).uniform_(-87.5, 87.5, generator=g))
    x = (amax * torch.empty((m, k), device=cuda).uniform_(-1, 1, generator=g)).to(torch.bfloat16)
    x[:, 0] = amax[:, 0].to(torch.bfloat16)
    every = torch.arange(32768, device=cuda, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    every = every[every.float() < 127].float()  # the non-negative finite values below 127
    rows = -(-every.numel() // (k - 1))
    block = torch.zeros(rows * (k - 1), device=cuda)
    block[:every.numel()] = every
    x[:rows, 1:] = block.view(rows, k - 1).to(torch.bfloat16)
    x[:rows, 0] = 127.0  # scale 1: the quotients are the values
    w8, sw = quant.quantize_weight(torch.ones((320, k), device=cuda, dtype=torch.bfloat16))
    _, q8, sx = quant.gemm_dequant_bf16a(x, w8, sw, None, None, quantized=True)
    kq8, ksx = quant.quantize_int8(x, per_row=True)
    pq8, psx = quant.plain_quantize_int8(x, True)
    assert torch.equal(kq8, pq8) and torch.equal(ksx, psx)
    assert torch.equal(q8, pq8) and torch.equal(sx, psx)


def test_w8a8_gemm_tiles_mirror_the_kernel(cuda):
    """``quant.gemm_tiles`` is the tile the built kernel 9 takes, at every K
    the quantizer writes up to 5120 against N 1 to 10240 (the multiples of
    8, 160 and 256 and the odd ones up to 40)."""
    outs = sorted(set(range(1, 41)) | set(range(8, 10241, 8)) | set(range(160, 10241, 160)))
    for k in range(8, 5121, 8):
        for n in outs[::7] + [320, 640, 1280, 2560, 5120, 10240]:
            assert quant.kernel_gemm_tiles(k, n) == quant.gemm_tiles(k, n), (k, n)


@pytest.mark.parametrize("x_shape,o,kernel,stride,padding", [
    ((2, 9, 13, 32), 48, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((2, 10, 14, 32), 40, (3, 3), (2, 2), ((0, 1), (0, 1))),
    ((2, 10, 14, 32), 40, (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 8, 8, 4), 320, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((3, 7, 9, 64), 130, (1, 1), (1, 1), ((0, 0), (0, 0))),
    ((100, 7, 48), 32, (3,), (1,), ((1, 1),)),
    ((2, 16, 16, 32), 3, (3, 3), (1, 1), ((1, 1), (1, 1))),
    # one case a tile of kernel 10 (quant.conv_tiles): BN 160 on 128-byte
    # chunks with a zero tail (Cp 320) and an M tail (234 pixels), BN 160
    # at stride 2 over O = 960, BN 128 over O = 512, the narrow BN 8 on
    # 128-byte chunks, BN 16 on a 64-byte chunk with a zero tail (Cp 48), BN
    # 128 over O = 168 (a ragged last N tile) on Cp 80, BN 32 on 32-byte
    # chunks, a 1-D k = 1; BN 160's bf16 output takes the persistent grid
    # and TMA stores, several tiles a block at (8, 64, 96) (512 tiles)
    ((2, 9, 13, 320), 320, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((8, 64, 96, 320), 320, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((1, 20, 30, 640), 960, (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 12, 20, 256), 512, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((2, 16, 24, 128), 3, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((3, 7, 9, 48), 16, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((2, 11, 13, 80), 168, (1, 1), (1, 1), ((0, 0), (0, 0))),
    ((2, 10, 14, 16), 32, (3, 3), (2, 2), ((0, 1), (0, 1))),
    ((50, 17, 320), 320, (1,), (1,), ((0, 0),))])
def test_w8a8_conv_matches_plain(cuda, x_shape, o, kernel, stride, padding):
    g = torch.Generator(device=cuda).manual_seed(o)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((o, x_shape[-1]) + kernel, generator=g, device=cuda).to(torch.bfloat16)
    bias = torch.randn((o,), generator=g, device=cuda).to(torch.bfloat16)
    x4, w4, geom = quant._to_2d(x, w, stride, padding)
    x8, sx = quant.quantize_int8(x4.reshape(-1, x_shape[-1]), per_row=False)
    x8 = x8.view(x4.shape[:3] + (-1,))
    w8, sw = quant.quantize_weight(w4)
    for out_dtype, b in ((None, None), (torch.bfloat16, bias)):
        out = quant.conv_dequant(x8, sx, w8, sw, b, geom, out_dtype)
        ref = quant.plain_conv_dequant(x8, sx, w8, sw, b, geom, out_dtype)
        assert torch.equal(out, ref)


def test_w8a8_conv_tiles_mirror_the_kernel(cuda):
    """``quant.conv_tiles`` (the CPU tests' chooser) is the tile the built
    kernel takes, at every Cp the quantizer writes up to 2560 against O
    from 1 to 2560 (every multiple of 8 and of 160, and the odd ones up to
    40)."""
    outs = sorted(set(range(1, 41)) | set(range(8, 2561, 8)) | set(range(160, 2561, 160)))
    for cp in range(16, 2561, 16):
        for o in outs:
            assert quant.kernel_conv_tiles(cp, o) == quant.conv_tiles(cp, o), (cp, o)


def test_w8a8_block_launches_the_kernels(cuda, monkeypatch):
    """A bf16 ResBlock3D with W8A8 on launches kernels 8-10 and equals
    itself through their plain versions bit for bit."""
    from ccedit_tpu_torch.modules.blocks import ResBlock3D

    torch.manual_seed(0)
    block = ResBlock3D(64, 128, 96).to(cuda, torch.bfloat16).eval()
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.1)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 5, 16, 24, 64), generator=g, device=cuda).to(torch.bfloat16)
    emb = torch.randn((2, 128), generator=g, device=cuda).to(torch.bfloat16)
    monkeypatch.setitem(quant._STATE, "matmul", True)
    before = {k: w.launches for k, w in quant.COUNTED.items()}
    with torch.no_grad():
        out = block(x, emb)
        # the embedding's dense takes the fused route
        launched = {k for k, w in quant.COUNTED.items() if w.launches > before[k]}
        assert launched == set(quant.COUNTED) - {"int8_gemm_dequant"}
        for name in ("quantize_int8", "gemm_dequant", "gemm_dequant_bf16a", "conv_dequant"):
            monkeypatch.setattr(quant, name, getattr(quant, f"plain_{name}"))
        ref = block(x, emb)
        assert torch.equal(out, ref)
        monkeypatch.undo()
        monkeypatch.setitem(quant._STATE, "matmul", True)
        monkeypatch.setattr(quant, "gemm_route", lambda k, n, dtype: "two_launches")
        before = quant.gemm_dequant.launches
        assert torch.equal(block(x, emb), ref) and quant.gemm_dequant.launches > before


@pytest.mark.parametrize("shape", [(8, 32, 48, 320), (1536, 17, 320), (4, 64, 96, 128)])
def test_group_norm_form_keeps_fp32_statistics(cuda, shape):
    """Kernel 8's norm form (the GroupNorm module on the card) against the
    plain fp32 form at phase 3's gate, and at most 1 % of its outputs off a
    GroupNorm with fp64 statistics."""
    import torch.nn.functional as F

    from ccedit_tpu_torch.modules.layers import GroupNorm

    g = torch.Generator(device=cuda).manual_seed(21)
    c = shape[-1]
    norm = GroupNorm(32, c, temporal=len(shape) == 3).to(cuda, torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn((c,), generator=g, device=cuda))
        norm.bias.copy_(0.1 * torch.randn((c,), generator=g, device=cuda))
        x = (torch.randn(shape, generator=g, device=cuda) * 3 + 1.5).to(torch.bfloat16)
        before = quant.group_norm.launches
        out = norm(x)
        assert quant.group_norm.launches == before + 1
        ref = F.group_norm(x.movedim(-1, 1).double(), 32, norm.weight.double(),
                           norm.bias.double(), norm.eps).movedim(1, -1).to(torch.bfloat16)
        assert _agrees(out, quant.plain_group_norm(x, norm))
    assert (out != ref).count_nonzero().item() / out.numel() <= 1e-2


@pytest.mark.parametrize("world", [2, 4])
def test_w8a8_staged_forms_under_a_shard_are_their_chains(cuda, world):
    """Under a height split (``group_norm_route.OrderOnlyShard``: this
    rank's block standing for every rank's) the per-tensor quantizer's
    staged form and kernel 8's external-statistics fused form are bit for
    bit their plain chains (the sharded GroupNorm, SiLU, the quantizer)."""
    from ccedit_tpu_torch.modules.layers import GroupNorm
    from ccedit_tpu_torch.parallel.shard import mesh_context
    from ccedit_tpu_torch.scripts.group_norm_route import OrderOnlyShard

    g = torch.Generator(device=cuda).manual_seed(22)
    norm = GroupNorm(32, 320).to(cuda, torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn((320,), generator=g, device=cuda))
        norm.bias.copy_(0.1 * torch.randn((320,), generator=g, device=cuda))
    x = torch.randn((8, 64 // world, 96, 320), generator=g, device=cuda).to(torch.bfloat16)
    add = (0.5 * torch.randn((8, 320), generator=g, device=cuda)).to(torch.bfloat16)
    with mesh_context(OrderOnlyShard(x.shape[1:3])), torch.no_grad():
        q, s = quant.quantize_int8(x.reshape(-1, 320), per_row=False)
        pq, ps = quant.plain_quantize_int8(x.reshape(-1, 320), per_row=False)
        assert torch.equal(q, pq) and torch.equal(s, ps)
        before = quant.norm_silu_quantize.variant_launches["external sharded"]
        got = quant.norm_silu_quantize(x, norm, add)
        ref = quant.plain_norm_silu_quantize(x, norm, add)
        assert quant.norm_silu_quantize.variant_launches["external sharded"] == before + 1
    assert torch.equal(got.q, ref.q) and torch.equal(got.scale, ref.scale)
