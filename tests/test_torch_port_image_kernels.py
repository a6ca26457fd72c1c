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
* The d = 64 redesigns' order of work (``csrc/spatial_attention.cuh``'s
  ``kD64`` path, ``csrc/spatial_attention_bwd.cu``'s): kernel 1's softmax
  over 128-key tiles with the warp's lazy rescale (its 16 rows decide
  together; O and l rescaled only when a row's max grows 2^8), against the
  Pallas kernel in interpret mode at one-chunk, three-chunk and ragged n_k,
  1e-5 absolute as the other mirrors; kernel 4's order of work at d = 64
  against ``jax.vjp`` (1e-4, as ``test_torch_port_train_kernels.py``), its
  dQ added through the float4 lane exchange, whose targets cover every
  element of a warp's dQ rows exactly once; the query tile kernels 1 and 1c
  take at each phase-3 shape, whose blocks write every row exactly once.
"""

import copy
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_kernel_mirrors as km
import test_torch_port_train_kernels as tk
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


# ---- the d = 64 redesigns' order of work ----

_TILES = (Path(sa.__file__).resolve().parent.parent / "csrc" / "spatial_attention.cuh").read_text()
LAZY = float(re.search(r"kLazy = ([0-9.]+)f;", _TILES).group(1))
BN = 128  # kernel 1's key tile and kernel 4's key block


def mirror_d64(q, k, v, scale, lazy=LAZY, counts=None):
    """Kernel 1's order of work at d = 64, in fp32: 128-key tiles, keys
    past n_k masked to -inf; each warp's 16 rows rescale together, to the
    new maxima, only where one of them grows ``lazy`` past m; p = exp2(s *
    scale log2(e) - m); l and O summed against the m in force.  ``counts``
    collects the tiles that rescaled and those that did not."""
    b, h, n_q, d = q.shape
    n_k = k.shape[-2]
    rows = -(-n_q // 16) * 16  # rows past n_q: zeros, and they vote in their warp
    qp = torch.nn.functional.pad(q, (0, 0, 0, rows - n_q))
    sl2 = torch.tensor(np.float32(scale * km._LOG2E))
    m = torch.full((b, h, rows), -float("inf"))
    l = torch.zeros((b, h, rows))
    acc = torch.zeros((b, h, rows, d))
    cols = torch.arange(BN)
    for k0 in range(0, n_k, BN):
        pad = max(0, k0 + BN - n_k)
        kt, vt = (torch.nn.functional.pad(x[..., k0:k0 + BN, :], (0, 0, 0, pad)) for x in (k, v))
        s = torch.where(k0 + cols < n_k, qp @ kt.transpose(-1, -2), -float("inf"))
        mt = s.amax(-1) * sl2
        need = (mt > m + lazy).view(b, h, rows // 16, 16).any(-1, keepdim=True)
        need = need.expand(b, h, rows // 16, 16).reshape(b, h, rows)
        if counts is not None:
            counts["rescaled"] += int(need[..., ::16].sum())
            counts["kept"] += int((~need[..., ::16]).sum())
        mn = torch.where(need, torch.maximum(m, mt), m)
        corr = torch.where(need, torch.exp2(m - mn), torch.ones(()))
        l, acc, m = l * corr, acc * corr[..., None], mn
        p = torch.exp2(s * sl2 - m[..., None])
        l = l + p.sum(-1)
        acc = acc + p @ vt
    return (acc / l[..., None])[..., :n_q, :]


@pytest.mark.parametrize("n_q,n_k,spread", [
    (512, 512, 1.0), (512, 9216, 1.0),  # one chunk; the JAX kernel's 3-chunk branch
    (512, 9216, 6.0),                    # scores spread so later tiles' maxima grow past 2^8
    (300, 600, 6.0),                     # ragged rows and keys
])
def test_d64_kernel1_mirror_matches_pallas(n_q, n_k, spread, monkeypatch):
    q, k, v = _qkv((1, 2, n_q, D), n_k, seed=n_q + n_k + int(spread))
    q = q * np.float32(spread)
    scale = D ** -0.5
    if jsa._pick_qb(n_q, n_k) == 0:  # one query block of every row
        monkeypatch.setattr(jsa, "_pick_qb", lambda n_q, n_k: n_q)
    ref = np.asarray(jsa.kv_resident_attention(*map(jnp.asarray, (q, k, v)), scale,
                                               interpret=True))
    counts = {"rescaled": 0, "kept": 0}
    out = mirror_d64(*map(torch.from_numpy, (q, k, v)), scale, counts=counts)
    np.testing.assert_allclose(out.numpy(), ref, atol=km.ATOL, rtol=0)
    assert counts["kept"] > 0  # the lazy branch runs
    if spread > 1:
        assert counts["rescaled"] > q.shape[1] * -(-n_q // 16)  # past the first tile too


def dq_lane_targets(d=D):
    """Kernel 4's float4 dQ atomics at d = 64: for each lane (g, t) of a
    warp and 8-column block j, the (row, first column) its atomic adds 4
    columns at (t even: row g, odd: row g + 8; columns 8j + 2 (t & ~1)),
    and the (row, column) of each of the 4 values it holds after the
    exchange with lane t ^ 1 (its own pair and the neighbour's)."""
    targets = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        odd = t & 1
        for j in range(d // 8):
            row, col = (g + 8 if odd else g), 8 * j + 2 * (t & ~1)
            # the accumulator of lane (g, t): row g and g + 8 at 8j + 2t, + 1
            nb = t ^ 1
            own = [(row, 8 * j + 2 * t), (row, 8 * j + 2 * t + 1)]
            got = [(row, 8 * j + 2 * nb), (row, 8 * j + 2 * nb + 1)]
            values = got + own if odd else own + got
            targets.append(((row, col), values))
    return targets


def test_d64_dq_lane_exchange_covers_every_element_once():
    seen = []
    for (row, col), values in dq_lane_targets():
        assert col % 4 == 0  # 16-byte aligned float4
        assert values == [(row, col + i) for i in range(4)]
        seen += values
    assert sorted(seen) == [(r, c) for r in range(16) for c in range(D)]


def mirror_bwd_d64(q, k, v, do, scale, counts):
    """Kernel 4 at d = 64 in its order of work, in fp32: 128-key blocks
    outer, 64-query tiles inner from the block's own first tile, P^T from
    the mirrored forward's log2 lse, delta = rowsum(dO * O), queries past
    n_q zero with lse = +inf, keys past n_k masked, dS^T = P^T (dP^T -
    delta), P^T, dS^T (and so their fragments) formed in one pass over
    16-query blocks of the tile; each tile's dQ product added to the
    accumulator through the warps' float4 lane targets
    (``dq_lane_targets``), ``counts`` the elements each visit adds."""
    b, h, n_q, d = q.shape
    n_k = k.shape[-2]
    bm = tk.BM
    out, lse = tk._mirror_forward(q, k, v, scale)
    delta = (do * out).sum(-1)
    n_qt = -(-n_q // bm)
    pad = torch.nn.functional.pad
    qp, dop = (pad(x, (0, 0, 0, n_qt * bm - n_q)) for x in (q, do))
    lsep = pad(lse, (0, n_qt * bm - n_q), value=float("inf"))
    deltap = pad(delta, (0, n_qt * bm - n_q))
    kp, vp = (pad(x, (0, 0, 0, -(-n_k // BN) * BN - n_k)) for x in (k, v))
    dq_acc, dk, dv = torch.zeros_like(qp), torch.zeros_like(kp), torch.zeros_like(vp)
    sl2 = scale * km._LOG2E
    for blk, k0 in enumerate(range(0, n_k, BN)):
        kt, vt = kp[..., k0:k0 + BN, :], vp[..., k0:k0 + BN, :]
        valid = (torch.arange(k0, k0 + BN) < n_k)[:, None]
        for i in range(n_qt):
            q0 = ((blk + i) % n_qt) * bm
            qt, dot = qp[..., q0:q0 + bm, :], dop[..., q0:q0 + bm, :]
            pt = torch.where(valid, torch.exp2(kt @ qt.transpose(-1, -2) * sl2
                                               - lsep[..., None, q0:q0 + bm]), 0.0)
            dst = pt * (vt @ dot.transpose(-1, -2) - deltap[..., None, q0:q0 + bm])
            dv[..., k0:k0 + BN, :] += pt @ dot
            dk[..., k0:k0 + BN, :] += dst @ qt
            prod = dst.transpose(-1, -2) @ kt  # the tile's dQ, 64 queries x 64
            for w in range(bm // 16):
                for (row, col), _ in dq_lane_targets(d):
                    r = q0 + 16 * w + row
                    dq_acc[..., r, col:col + 4] += prod[..., r - q0, col:col + 4]
                    counts[(blk, r, col)] = counts.get((blk, r, col), 0) + 1
    return dq_acc[..., :n_q, :] * scale, dk[..., :n_k, :] * scale, dv[..., :n_k, :]


@pytest.mark.parametrize("shape,n_k", [((1, 2, 512, D), 512), ((1, 2, 300, D), 600)])
def test_d64_kernel4_mirror_matches_jax_vjp(shape, n_k):
    q, k, v, do = tk._inputs(shape, n_k, seed=shape[2] + n_k + 64)
    scale = D ** -0.5
    ref = tk._jax_grads(lambda a, b, c: jatt._xla_attention(a, b, c, scale), q, k, v, do)
    counts = {}
    grads = mirror_bwd_d64(*map(torch.from_numpy, (q, k, v, do)), scale, counts)
    # every 4 columns of every (padded) query row, once per key block
    n_qt, n_kb = -(-shape[2] // tk.BM), -(-n_k // BN)
    assert set(counts.values()) == {1}
    assert len(counts) == n_kb * n_qt * tk.BM * D // 4
    for ours, theirs in zip(grads, ref):
        np.testing.assert_allclose(ours.numpy(), theirs, atol=tk.ATOL, rtol=0)


def d64_query_tile(n_q, batch_heads, sms=132):
    """``csrc/spatial_attention.cuh``'s ``d64_query_tile`` on an H100's 132
    SMs: 192 query rows a block where that grid gives every SM a block, else
    128."""
    return 192 if -(-n_q // 192) * batch_heads >= sms else 128


@pytest.mark.parametrize("shape,tile", [
    ((2, 5, 9216, 64), 192), ((2, 10, 2304, 64), 192),  # SD-2.1-768's levels 0 and 1
    ((2, 20, 576, 64), 128),                              # level 2: 120 blocks of 192 < 132 SMs
    ((2, 3, 1000, 64), 128), ((2, 8, 600, 64), 128), ((1, 2, 300, 64), 128),
])
def test_d64_query_tiles_cover_every_row_once(shape, tile):
    """The tile the kernels take at phase 3's d = 64 shapes, and each block's
    rows as the kernel writes them (consumer warpgroup w, warp, lane group
    g: rows q0 + 64 w + 16 warp + g and + 8, those past n_q dropped): every
    (batch * head, query row) exactly once."""
    b, h, n_q, _ = shape
    assert d64_query_tile(n_q, b * h) == tile
    written = np.zeros((b * h, n_q), dtype=int)
    for bh in range(b * h):
        for q0 in range(0, n_q, tile):
            for w in range(tile // 64):
                for warp in range(4):
                    for g in range(8):
                        for row in (q0 + 64 * w + 16 * warp + g, q0 + 64 * w + 16 * warp + g + 8):
                            if row < n_q:
                                written[bh, row] += 1
    assert (written == 1).all()
