"""Torch mirrors of the Hopper kernels' order of work, on the CPU in fp32,
against the JAX package's Pallas kernels run in interpret mode.

* Kernel 1c (``csrc/spatial_attention_int8.cu``): the pre-pass's padded
  int8 rows (``plain_prepass``), int8 scores per 128-key tile summed exactly
  in integers, converted to fp32, an online exp2 softmax with each (batch,
  head)'s folded scale times log2(e) as the exp2's factor, the keys past
  n_k left out of the last tile; against
  ``kv_resident_attention(quantized_qk=True, interpret=True)``, whose gate
  (``_pick_qb``) is widened to the whole of n_q at the ragged shapes.
* Kernel 2 (``csrc/temporal_attention.cu``): each query's scores as
  partial dot products over ``parts`` column pieces of at most 5 16-byte
  vectors, summed across the pieces, keys padded with zero rows to the
  kernel's unrolled length and masked, fp32 softmax, P.V; against the JAX
  ``small_seq_attention``.

* Kernel 4 at d = 512 (``csrc/flash_attention_bwd.cu``): each of its three
  passes in its own tile order, P from the log2-domain lse of the forward,
  delta = rowsum(dO * O): the dV pass (64-key blocks over 32-query tiles,
  dV += P^T dO), the dK pass (64-key blocks over 16-query tiles, dS^T =
  P^T (dP^T - delta), dK += dS^T Q) and the dQ pass (64-query blocks over
  16-key tiles, P masked past n_k, dQ += dS K), the softmax scale applied
  to dK and dQ at the end; queries past n_q zero with lse = +inf; against
  ``_xla_attention_bwd`` at 1e-4 absolute.

Tolerance 1e-5 absolute for the forwards: fp32 on both sides, the integer
scores exact on both; exp2 vs exp and summation order differ.  The CUDA kernels run only on
a GPU (``chip_smoke.py`` phase 3, ``tests/test_torch_port_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.ops import attention as jatt
from ccedit_tpu.ops import spatial_attention as jsa
from ccedit_tpu.ops.temporal_attention import small_seq_attention
from ccedit_tpu_torch.ops import spatial_attention as sa

torch.set_num_threads(1)
ATOL = 1e-5
_LOG2E = 1.0 / np.log(2.0)
BN = 128  # kernel 1c's key tile


def _qkv(shape, n_k, seed):
    rs = np.random.RandomState(seed)
    kshape = shape[:2] + (n_k, shape[3])
    return (rs.standard_normal(shape).astype(np.float32),
            rs.standard_normal(kshape).astype(np.float32),
            rs.standard_normal(kshape).astype(np.float32))


def _mirror_int8_forward(q, k, v, scale):
    """Kernel 1c's order of work in fp32 (P kept in fp32 here; the kernel
    rounds it to bf16 for P.V)."""
    b, h, _, d = q.shape
    n_k = k.shape[-2]
    q8, k8, scales = sa.plain_prepass(q, k, scale)
    assert q8.shape[-1] == k8.shape[-1] == sa.int8_width(d)
    sl2 = (scales * np.float32(_LOG2E)).reshape(b, h, 1, 1)
    m = torch.full(q.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros_like(q)
    for k0 in range(0, n_k, BN):
        s32 = torch.matmul(q8.long(), k8[..., k0:k0 + BN, :].long().transpose(-1, -2))
        assert s32.abs().max() < 2 ** 24  # so its fp32 conversion is exact
        s = s32.to(torch.float32)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ v[..., k0:k0 + BN, :]
        m = m_new
    return acc / l


@pytest.mark.parametrize("shape,n_k", [
    ((1, 2, 512, 40), 512), ((1, 2, 512, 80), 512),
    ((1, 2, 512, 40), 1024),                         # the CFCA's n_k = 2 * n_q
    ((1, 2, 200, 40), 141), ((1, 2, 300, 80), 250),  # ragged rows and keys
])
def test_int8_mirror_matches_pallas(shape, n_k, monkeypatch):
    q, k, v = _qkv(shape, n_k, seed=shape[2] + n_k + shape[3])
    scale = shape[-1] ** -0.5
    if jsa._pick_qb(shape[2], n_k) == 0:  # one query block of every row
        monkeypatch.setattr(jsa, "_pick_qb", lambda n_q, n_k: n_q)
    ref = jsa.kv_resident_attention(*map(jnp.asarray, (q, k, v)), scale, quantized_qk=True,
                                    interpret=True)
    out = _mirror_int8_forward(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # the int8 path, not the exact one
    exact = sa.plain_spatial_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert (exact - out).abs().max() > 10 * ATOL


def _kernel2_split(d8: int, max_chunks: int = 5):
    """Kernel 2's lanes a query and 16-byte column vectors a lane."""
    parts = 1
    while parts < 8 and parts * max_chunks < d8:
        parts *= 2
    return parts, -(-d8 // parts)


def _padded_keys(t: int) -> int:
    return next(tp for tp in (8, 12, 16, 17, 24, 32) if t <= tp)


def _mirror_temporal(q, k, v, scale):
    b, h, t, d = q.shape
    parts, chunks = _kernel2_split(d // 8)
    tp = _padded_keys(t)
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, tp - t)) for x in (k, v))
    s = torch.zeros((b, h, t, tp))
    for part in range(parts):  # the partial sums the shuffles add
        cols = slice(8 * chunks * part, min(8 * chunks * (part + 1), d))
        s = s + q[..., cols] @ kp[..., cols].transpose(-1, -2)
    s = torch.where(torch.arange(tp) < t, s * scale, -float("inf"))
    p = torch.softmax(s, dim=-1)
    return p @ vp


@pytest.mark.parametrize("t,d", [(17, 40), (17, 80), (17, 160), (12, 40), (5, 8), (20, 256)])
def test_temporal_mirror_matches_pallas(t, d):
    q, k, v = _qkv((3, 2, t, d), t, seed=t * d)
    scale = d ** -0.5
    ref = small_seq_attention(*map(jnp.asarray, (q, k, v)), scale)
    out = _mirror_temporal(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_temporal_split_covers_the_columns():
    """40 columns a lane at most, in 1, 2, 4 or 8 lanes: d 40/80/160 keep
    one (head, query) a lane, two or four."""
    assert [_kernel2_split(d // 8) for d in (40, 80, 160, 256, 8)] == \
        [(1, 5), (2, 5), (4, 5), (8, 4), (1, 1)]


def _mirror_bwd512_pass(name, q, k, v, do, scale):
    """One pass of kernel 4 at d = 512 in fp32, in its tile order: "dv",
    "dk" or "dq"."""
    n_q, n_k = q.shape[2], k.shape[2]
    sl2 = np.float32(scale * _LOG2E)
    s_full = q @ k.transpose(-1, -2)
    lse = torch.logsumexp(s_full * scale, -1) * np.float32(_LOG2E)  # kernel 3's, log2 domain
    out = torch.softmax(s_full * scale, -1) @ v
    delta = (do * out).sum(-1)
    rows, cols = (q, k) if name == "dq" else (k, q)
    tile = 32 if name == "dv" else 16
    n_cols = cols.shape[2]
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n))  # TMA's zero rows
    lse_p = torch.nn.functional.pad(lse, (0, -n_q % tile), value=float("inf"))
    delta_p = torch.nn.functional.pad(delta, (0, -n_q % tile))
    qp, dop, kp, vp = pad(q, -n_q % tile), pad(do, -n_q % tile), pad(k, -n_k % tile), pad(v, -n_k % tile)
    result = torch.zeros_like(rows)
    for r0 in range(0, rows.shape[2], 64):  # a block's 64 rows
        acc = torch.zeros(rows.shape[:2] + (min(64, rows.shape[2] - r0), 512))
        for c0 in range(0, n_cols, tile):
            c = slice(c0, c0 + tile)
            if name == "dq":
                r = slice(r0, r0 + 64)
                s = q[:, :, r] @ kp[:, :, c].transpose(-1, -2)
                dp = do[:, :, r] @ vp[:, :, c].transpose(-1, -2)
                p = torch.exp2(s * sl2 - lse[:, :, r, None])
                p = torch.where(torch.arange(c0, c0 + tile) < n_k, p, 0.0)
                acc = acc + (p * (dp - delta[:, :, r, None])) @ kp[:, :, c]
            else:
                r = slice(r0, r0 + 64)
                st = k[:, :, r] @ qp[:, :, c].transpose(-1, -2)
                pt = torch.exp2(st * sl2 - lse_p[:, :, None, c])
                if name == "dv":
                    acc = acc + pt @ dop[:, :, c]
                else:
                    dpt = v[:, :, r] @ dop[:, :, c].transpose(-1, -2)
                    acc = acc + (pt * (dpt - delta_p[:, :, None, c])) @ qp[:, :, c]
        result[:, :, r0:r0 + 64] = acc * (1.0 if name == "dv" else np.float32(scale))
    return result


@pytest.mark.parametrize("shape,n_k", [((2, 1, 512, 512), 512), ((1, 1, 300, 512), 200)])
@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_bwd512_pass_mirror_matches_the_jax_backward(name, shape, n_k):
    rs = np.random.RandomState(shape[2] + n_k)
    kshape = shape[:2] + (n_k, shape[3])
    q, k, v, do = (rs.standard_normal(s).astype(np.float32) for s in (shape, kshape, kshape, shape))
    scale = 512 ** -0.5
    ref = jatt._xla_attention_bwd(scale, tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(do))
    out = _mirror_bwd512_pass(name, *map(torch.from_numpy, (q, k, v, do)), scale)
    want = np.asarray(ref[("dq", "dk", "dv").index(name)])
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4, rtol=0)
