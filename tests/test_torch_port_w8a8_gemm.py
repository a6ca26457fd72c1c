"""Kernel 9 (``csrc/int8_gemm.cu``) on the CPU: its tile chooser and
route, a test-only torch mirror of its persistent tile walk, a test-only
torch mirror of its fused form's in-place per-token quantization, and the
entry points' plain versions against the two-launch path and the JAX
package.

- ``quant.gemm_tiles`` / ``quant.gemm_route`` at every dense shape of the
  CFG-doubled 17 x 512 x 768 edit (the SD-1.5 transformer sites and the
  ResBlock embedding) and at every ``QLinear`` call of the networks the
  census tests of ``test_torch_port_w8a8.py`` build, the shared-memory plan
  re-derived from the kernel's layout;
- the walk: grid = a block an SM (with resident weights the largest
  multiple of the n tiles), block b taking tiles b, b + grid, ..., tile t
  = (t // n_tiles, t % n_tiles): every (m, n) tile exactly once, a block's
  n tile fixed where its weights are resident, at every shape and at
  ragged M;
- the fused form's quantization, tile by tile as the kernel does it: the
  128-row tile's bf16 rows as TMA lands them (64-column chunks of 128-byte
  rows, 128-byte swizzle, zeros past M and K), two threads a row (the
  amax of thread h over chunks h, h + 2, ...), then at step j thread h
  reads bf16 chunk 2 j + h and writes bytes 64 h .. of int8 chunk j over
  bf16 chunk j of the same row, both reads before either write (the mirror
  asserts no chunk is read after it was overwritten), bit for bit
  ``symmetric_q`` at exact .5 quotients, zero rows and K tails; with one
  amax for 64 rows (the checks' planted fault) it must differ;
- ``gemm_dequant_bf16a``'s plain version bit for bit the two-launch plain
  path, launching nothing on CPU tensors; ``qlinear`` on bf16 through the
  fused route equal to the forced two-launch route bit for bit and to the
  JAX ``QDense`` in bf16 at 1e-6 of max|JAX|;
- every variant of ``scripts/gemm_breakdown.py`` still patches the source.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from ccedit_tpu.ops import quant as jquant
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import layers as tl
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.modules import vae as tvae
from ccedit_tpu_torch.ops import build, quant
from ccedit_tpu_torch.scripts import bwd_breakdown, gemm_breakdown

torch.set_num_threads(1)
SMS = 132  # an H100 SXM's SMs, which size the kernel's grid
SMEM = 223 * 1024  # the kernel's dynamic shared memory
STATIC = 8 * 17 + 4 * (3 * 128 + 2 * 256)  # its static barriers and tables, at most
FN_TOL = 1e-6

# (label, tokens M, K, N): 17 x 512 x 768 doubled by CFG
DENSE = (
    ("level 0 q/k/v/out", 208896, 320, 320), ("level 0 GEGLU", 208896, 320, 2560),
    ("level 0 ff out", 208896, 1280, 320), ("level 1 q/k/v/out", 52224, 640, 640),
    ("level 1 GEGLU", 52224, 640, 5120), ("level 1 ff out", 52224, 2560, 640),
    ("level 2 q/k/v/out", 13056, 1280, 1280), ("level 2 GEGLU", 13056, 1280, 10240),
    ("level 2 ff out", 13056, 5120, 1280), ("cross k/v 320", 2618, 768, 320),
    ("cross k/v 640", 2618, 768, 640), ("cross k/v 1280", 2618, 768, 1280),
    ("embedding 320", 34, 1280, 320), ("embedding 640", 34, 1280, 640),
    ("embedding 1280", 34, 1280, 1280),
)
FUSED = {"level 0 q/k/v/out"}  # where the bf16 tile fits beside the resident slice


def smem_plan(k, n, fused):
    """The kernel's dynamic shared memory, laid out as its host code lays it
    out: the ring (the int8 form's A boxes, with B's beside them unless
    resident) or the fused form's one bf16 tile, the resident weight slice,
    the bf16 staging; returns the bytes used past the 1024-byte alignment."""
    bm, bn, resident, stages, _ = quant.gemm_tiles(k, n)
    kc, xc = -(-quant.padded(k) // 128), -(-k // 64)
    resident = resident or fused
    stage = xc * bm * 128 if fused else bm * 128 + (0 if resident else bn * 128)
    return (1 if fused else stages) * stage + (kc * bn * 128 if resident else 0) + bm * bn * 2


def check_tiles(k, n):
    bm, bn, resident, stages, fused = quant.gemm_tiles(k, n)
    assert bm == 128 and bn == (256 if n % 256 == 0 else 160 if n % 160 == 0 else 128)
    assert 2 <= stages <= 8 and smem_plan(k, n, False) + 1024 <= SMEM
    assert SMEM + STATIC <= 232448  # a block's shared memory on an H100
    if resident:  # with two A boxes at least
        assert smem_plan(k, n, False) >= 2 * 128 * 128 + quant.padded(k) // 128 * bn * 128
    route = quant.gemm_route(k, n, torch.bfloat16)
    assert (route == "fused") == bool(fused and k % 8 == 0)
    if fused:
        assert smem_plan(k, n, True) + 1024 <= SMEM
    elif k % 8 == 0:  # the whole bf16 tile does not fit
        assert smem_plan(k, n, True) + 1024 > SMEM
    assert quant.gemm_route(k, n, torch.float32) == "two_launches"
    return route


@pytest.mark.parametrize("label,m,k,n", DENSE, ids=[d[0] for d in DENSE])
def test_tiles_and_route_at_the_dense_shapes(label, m, k, n):
    assert check_tiles(k, n) == ("fused" if label in FUSED else "two_launches")
    assert quant.gemm_tiles(quant.padded(k), n) == quant.gemm_tiles(k, n)


def _record_dense(monkeypatch, run):
    """The (K, N) of every ``qlinear`` call that ``run`` makes with W8A8 on."""
    seen = collections.Counter()
    sound = quant.qlinear

    def recording(x, weight, bias=None):
        seen[(x.shape[-1], weight.shape[0])] += 1
        return sound(x, weight, bias)

    monkeypatch.setattr(quant, "qlinear", recording)
    monkeypatch.setitem(quant._STATE, "matmul", True)
    with torch.no_grad():
        run()
    return seen


def test_tiles_at_every_census_qlinear(monkeypatch):
    """Every ``QLinear`` the census tests' networks call (the tiny
    CCEditNetwork, the VAE, an SD-2.1-style 2-D UNet, built as those tests
    build them) gets a tile and a route by the rules above."""
    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    net = tcn.CCEditNetwork(tun.UNetModel(unet_type="pseudo-3d", **_TINY),
                            tcn.ControlNet2D(hint_channels=3, **_TINY))
    cond = {"crossattn": t(rs.standard_normal((1, 7, 16))),
            "control_hint": t(rs.uniform(-1, 1, (1, 3, 64, 64, 3)))}
    vae = tvae.AutoencoderKL(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                             attn_resolutions=(16,))
    unet2d = tun.UNetModel(unet_type="2d", in_channels=4, model_channels=32, out_channels=4,
                           num_res_blocks=1, attention_resolutions=(2, 1), channel_mult=(1, 2),
                           num_head_channels=16, transformer_depth=1, context_dim=16,
                           use_linear_in_transformer=True)

    def run():
        net(t(rs.standard_normal((1, 3, 8, 8, 4))), t([500.0]), cond)
        vae.decode(vae.encode_moments(t(rs.uniform(-1, 1, (1, 32, 32, 3))))[..., :4])
        unet2d(t(rs.standard_normal((2, 8, 8, 4))), t([10.0, 700.0]),
               context=t(rs.standard_normal((2, 7, 16))))

    seen = _record_dense(monkeypatch, run)
    assert sum(seen.values()) > 50
    routes = {shape: check_tiles(*shape) for shape in seen}
    assert "fused" in routes.values()  # the narrow widths fit the bf16 tile


def test_table_holds_every_full_width_dense(monkeypatch):
    """Every dense product of the full-width TV2V and TVI2V networks (one
    CFG-batch forward at 17 x 512 x 768, W8A8 on, on the ``meta`` device)
    has its (K, N) in the table above, with its route."""
    from ccedit_tpu_torch import config
    from ccedit_tpu_torch.ops import attention as att

    calls = collections.Counter()

    def record(x, weight, bias=None):
        calls[(x.shape[-1], weight.shape[0])] += 1
        return torch.empty(x.shape[:-1] + (weight.shape[0],), dtype=x.dtype, device=x.device)

    h, w, t = 512, 768, 17
    with torch.device("meta"):
        nets = [config.build_network(c["model"]["params"]["network_config"])
                for c in (config.TV2V_CONFIG, config.TVI2V_CONFIG)]
    for name in list(att._ROUTES):
        monkeypatch.setitem(att._ROUTES, name, lambda q, k, v, scale: torch.empty_like(q))
    monkeypatch.setitem(quant._STATE, "matmul", True)
    monkeypatch.setattr(quant, "qlinear", record)
    with torch.no_grad(), torch.device("meta"):
        cond = {"crossattn": torch.empty(2, 77, 768),
                "control_hint": torch.empty(2, t, h, w, 3),
                "cond_feat": torch.empty(2, h // 8, w // 8, 4)}
        for net in nets:
            net(torch.empty(2, t, h // 8, w // 8, 4), torch.empty(2), cond)
    table = {(k, n): label for label, _, k, n in DENSE}
    assert set(calls) == set(table), sorted(set(calls) ^ set(table))
    for (k, n), count in calls.items():
        assert check_tiles(k, n) == ("fused" if table[(k, n)] in FUSED else "two_launches")
    assert sum(calls.values()) > 800


def mirror_walk(m, n, k, fused=False, sms=SMS):
    """The tiles each block of the persistent grid takes, in order."""
    bm, bn, resident, _, _ = quant.gemm_tiles(k, n)
    n_tiles = -(-n // bn)
    tiles = -(-m // bm) * n_tiles
    blocks = max(n_tiles, sms - sms % n_tiles) if resident or fused else sms
    blocks = min(blocks, tiles)
    return [[((t // n_tiles) * bm, (t % n_tiles) * bn) for t in range(b, tiles, blocks)]
            for b in range(blocks)]


@pytest.mark.parametrize("m", [None, 1, 34, 129, 2618])
@pytest.mark.parametrize("label,m_full,k,n", DENSE, ids=[d[0] for d in DENSE])
def test_walk_covers_every_tile_once(label, m_full, k, n, m):
    m = m_full if m is None else m
    bm, bn, resident, _, _ = quant.gemm_tiles(k, n)
    for fused in {False, label in FUSED}:
        walk = mirror_walk(m, n, k, fused)
        assert len(walk) <= max(SMS, -(-n // bn))
        taken = collections.Counter(tile for block in walk for tile in block)
        assert taken == collections.Counter(
            (m0, n0) for m0 in range(0, m, bm) for n0 in range(0, n, bn))
        if resident or fused:  # each block keeps its weight slice
            assert all(len({n0 for _, n0 in block}) == 1 for block in walk)
            # the n tiles of an m tile are taken in one step (its A rows hit L2)
            step = {tile: i for block in walk for i, tile in enumerate(block)}
            for m0 in range(0, m, bm):
                assert len({step[(m0, n0)] for n0 in range(0, n, bn)}) == 1


def _swizzle(r):
    """The 128-byte swizzle: logical byte i of row r at this physical byte."""
    i = torch.arange(128)
    return ((i // 16) ^ (r % 8)) * 16 + i % 16


def mirror_fused_quantize(x, one_amax_per_64_rows=False):
    """int8 rows (M, Kp) and scales (M,) of bf16 x (M, K) as the fused form
    computes them, in its order of work and in place (see the module
    docstring)."""
    m, k = x.shape
    kp = quant.padded(k)
    kc, xc = -(-kp // 128), -(-k // 64)
    q8 = torch.zeros((m, kp), dtype=torch.int8)
    sx = torch.zeros((m,), dtype=torch.float32)
    phys = torch.stack([_swizzle(r) for r in range(128)])  # (128 rows, 128 logical bytes)
    rows = torch.arange(128)[:, None]
    for m0 in range(0, m, 128):
        tile = torch.zeros((128, xc * 64), dtype=torch.bfloat16)
        part = x[m0:m0 + 128]
        tile[:part.shape[0], :k] = part
        logical = tile.view(torch.uint8).view(128, xc, 128).permute(1, 0, 2)
        buf = torch.zeros((xc, 128, 128), dtype=torch.uint8)  # as TMA lands it
        for c in range(xc):
            buf[c][rows, phys] = logical[c]
        clobbered = set()

        def read(c):  # bf16 chunk c of every row, logical order, as fp32
            if c >= xc:
                return torch.zeros((128, 64))
            assert c not in clobbered, f"bf16 chunk {c} read after it was overwritten"
            return buf[c][rows, phys].contiguous().view(torch.bfloat16).float()

        amax_h = [torch.zeros(128), torch.zeros(128)]  # the pair's partial maxima
        for c in range(xc):
            amax_h[c % 2] = torch.maximum(amax_h[c % 2], read(c).abs().amax(1))
        amax = torch.maximum(*amax_h)
        if one_amax_per_64_rows:
            amax = amax.view(2, 64).amax(1, keepdim=True).expand(2, 64).reshape(128)
        scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
        for j in range(kc):
            values = [read(2 * j + h) for h in (0, 1)]  # both threads read, then write
            clobbered.add(j)
            for h in (0, 1):
                q = (values[h] / scale[:, None]).round().clamp(-127, 127).to(torch.int8)
                logical_j = buf[j][rows, phys]
                logical_j[:, 64 * h:64 * h + 64] = q.view(torch.uint8)
                buf[j][rows, phys] = logical_j
        out = torch.stack([buf[j][rows, phys] for j in range(kc)], 1).reshape(128, kc * 128)
        n_rows = part.shape[0]
        q8[m0:m0 + n_rows] = out[:n_rows, :kp].view(torch.int8)
        sx[m0:m0 + n_rows] = scale[:n_rows]
    return q8, sx


def _tokens(m, k, seed):
    """bf16 tokens ~ 3 N(0, 1) with a zero row and two rows of exact .5
    quotients (amax 31.75, scale 0.25; amax 127, scale 1)."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(3 * rs.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    x[m // 2] = 0
    x[0] = ((torch.arange(k) % 9 - 3.5) * 0.25).to(torch.bfloat16)
    x[0, 0] = 31.75
    if m > 2:
        x[-1] = (torch.arange(k) % 7 + 0.5).to(torch.bfloat16)
        x[-1, 0] = 127.0
    return x


@pytest.mark.parametrize("m,k", [(300, 320), (77, 40), (5, 8), (130, 384), (129, 768),
                                 (131, 1280), (64, 200)])
def test_fused_quantization_mirror_is_symmetric_q(m, k):
    x = _tokens(m, k, seed=m + k)
    q8, sx = mirror_fused_quantize(x)
    pq8, psx = quant.plain_quantize_int8(x, True)
    assert torch.equal(q8, pq8) and torch.equal(sx, psx)
    jq, js = jquant._symmetric_q(jnp.asarray(x.float().numpy()), (-1,))
    np.testing.assert_array_equal(q8[:, :k].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(js).reshape(-1))
    ties = (x[0].float() / sx[0]) % 1 == 0.5
    assert ties.any() and torch.equal(q8[0, :k].float(), (x[0].float() / sx[0]).round())
    if m > 64:
        bad, _ = mirror_fused_quantize(x, one_amax_per_64_rows=True)
        assert not torch.equal(bad, pq8)


def test_fused_plain_version_is_the_two_launch_path():
    counts = {k: w.launches for k, w in quant.COUNTED.items()}
    x = _tokens(300, 320, seed=3)
    rs = np.random.RandomState(4)
    w8, sw = quant.quantize_weight(
        torch.from_numpy(rs.standard_normal((320, 320)).astype(np.float32)).to(torch.bfloat16))
    bias = torch.from_numpy(rs.standard_normal(320).astype(np.float32)).to(torch.bfloat16)
    x8, sx = quant.quantize_int8(x, per_row=True)
    for dtype, b in ((None, None), (torch.bfloat16, bias), (torch.float32, bias.float())):
        out, q8, s = quant.gemm_dequant_bf16a(x, w8, sw, b, dtype, quantized=True)
        assert torch.equal(out, quant.gemm_dequant(x8, sx, w8, sw, b, dtype))
        assert torch.equal(q8, x8) and torch.equal(s, sx)
        assert torch.equal(quant.gemm_dequant_bf16a(x, w8, sw, b, dtype), out)
    assert {k: w.launches for k, w in quant.COUNTED.items()} == counts


@pytest.mark.parametrize("c,f", [(320, 320), (96, 128), (40, 320), (640, 640)])
def test_qlinear_routes_match_jax(c, f, monkeypatch):
    """``QLinear`` on bf16 tokens: the route ``gemm_route`` picks (fused
    where it fits), the forced two-launch route bit for bit, the JAX
    ``QDense`` in bf16 within 1e-6 of max|JAX|."""
    rs = np.random.RandomState(c + f)
    x = _tokens(3 * 7, c, seed=c).reshape(3, 7, c)
    w = (rs.standard_normal((f, c)) / np.sqrt(c)).astype(np.float32)
    bias = (0.1 * rs.standard_normal(f)).astype(np.float32)
    layer = tl.QLinear(c, f).to(torch.bfloat16)
    layer.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(bias)})
    monkeypatch.setitem(quant._STATE, "matmul", True)
    monkeypatch.setitem(jquant._STATE, "matmul", True)
    ref = jquant.QDense(f, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(bias)}},
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    with torch.no_grad():
        out = layer(x)
        monkeypatch.setattr(quant, "gemm_route", lambda k, n, dtype: "two_launches")
        two = layer(x)
    assert torch.equal(out, two)
    ref = np.asarray(ref.astype(jnp.float32), np.float64)
    assert np.abs(out.double().numpy() - ref).max() <= FN_TOL * np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(gemm_breakdown.VARIANTS))
def test_breakdown_variant_patches_the_kernel_source(name):
    """Every substitution of the ``scripts/gemm_breakdown.py`` variant finds
    its text in ``csrc/int8_gemm.cu`` (``patched`` raises otherwise) and
    changes it, but for the kernel as it is."""
    src = (build.CSRC / gemm_breakdown.SOURCE).read_text()
    patched = bwd_breakdown.patched(name, gemm_breakdown.VARIANTS, gemm_breakdown.SOURCE)
    assert (patched == src) == (name == "kernel")
