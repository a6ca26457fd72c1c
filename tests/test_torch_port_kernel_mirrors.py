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

Tolerance 1e-5 absolute: fp32 on both sides, the integer scores exact on
both; exp2 vs exp and summation order differ.  The CUDA kernels run only on
a GPU (``chip_smoke.py`` phase 3, ``tests/test_torch_port_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
