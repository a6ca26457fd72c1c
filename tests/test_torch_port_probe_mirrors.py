"""Torch mirrors of the Hopper probes' order of work (kernels 5 and 6), on
the CPU in fp32, against the JAX scripts' Pallas kernel bodies run in
interpret mode.

* Kernel 5 (``csrc/attention_probe.cu``, kernel 1's template
  ``csrc/spatial_attention.cuh`` stopped after a stage): q and k read as
  rows zero-padded to the contraction (bf16 d 40 -> 48, the tr layout's
  d-rows past 40 zero-filled alike; int8 through the transposing pre-kernel
  to 48-byte rows, contracted over 64 bytes by the s8 wgmma), 128-key tiles
  with the keys past N zero (TMA's fill), int8 scores summed exactly in
  integers and converted to fp32 before the row sums; the online exp2
  softmax with log2 e folded into the scale and the keys past N masked; P.V
  per tile.  Both layouts, at (2, 256) and at N = 192 (a multiple of 64 but
  not of 128: the last key tile half past N).  Against the bodies of
  ``scripts/kv_resident_attn.py`` (loaded by ``test_torch_port_probes``'s
  fixture) at 1e-5 of max|JAX|.
* Kernel 6 (``csrc/int8_gemm.cu``): int8 B transposed to (N, K) by the
  pre-kernel's plain version, then 128-byte k-tiles (128 int8, 64 bf16),
  the tail past K zero, summed in int32 (fp32 for bf16); exactly equal to
  ``jax.lax.dot_general(..., preferred_element_type=jnp.int32)``, the body
  of ``scripts/int8_probe.py``'s ``part_pallas`` kernel (defined inside
  that function, so written out here), and the bf16 body within 1e-5 of
  max|JAX|.
* Kernel 7 (``csrc/attention_tiles.cu``, kernel 1's template at swept
  tiles): each (BM, BN) of ``profile_blocks.TILES``, a BM-row tile cut into
  the 64-row slices of its consumer warpgroups, BN-key tiles with the keys
  past n_k zero (TMA's fill) and masked, the online exp2 softmax with log2 e
  folded into the scale; at the ragged (1, 2, 600, 40) x 600 against the
  JAX package's ``kv_resident_attention(..., interpret=True)`` (its query
  block widened to all of n_q, which its gate refuses at 600) at 1e-5
  absolute.  The unmasked mirror must fail.
The CUDA kernels run only on a GPU (``chip_smoke.py`` phase 3b,
``tests/test_torch_port_gpu.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

import chip_smoke
from ccedit_tpu.ops import spatial_attention as jsa
from ccedit_tpu_torch.scripts import int8_probe as ip
from ccedit_tpu_torch.scripts import kv_resident_attn as kr
from ccedit_tpu_torch.scripts import profile_blocks as pb
from test_torch_port_probes import _bodies, _pallas, jax_script  # noqa: F401 (fixture)

torch.set_num_threads(1)
RTOL = 1e-5  # of max|JAX|
BN = 128  # the template's key tile at d = 40
_LOG2E = 1.0 / np.log(2.0)


def _rows(x, transposed: bool, width: int):
    """q or k as the kernel contracts it: (B, N, width) rows, zero past D."""
    if transposed:
        x = x.transpose(1, 2)
    return F.pad(x, (0, width - x.shape[-1]))


def mirror_probe(stage: str, q, k, v, scale: float, transposed: bool, mask: bool = True):
    """Kernel 5's order of work in fp32 (P kept in fp32; the kernel rounds
    it to bf16 for P.V).  ``mask=False`` leaves the keys past N in the
    softmax, a fault the test must see."""
    if q.dtype == torch.int8:  # the pre-kernel's 48-byte rows, 64 bytes a contraction
        qr, kr_ = (F.pad(ip.plain_transpose_int8(x, kr.INT8_WIDTH), (0, 16)).long()
                   for x in (q, k))
    else:
        qr, kr_ = (_rows(x.float(), transposed, 48) for x in (q, k))
    b, n, _ = qr.shape
    vr = None if v is None else (v.transpose(1, 2) if transposed else v).float()
    sl2 = np.float32(scale * _LOG2E)
    rows = torch.zeros((b, n))
    m = torch.full((b, n), -float("inf"))
    l = torch.zeros((b, n))
    acc = torch.zeros((b, n, kr.D))
    for k0 in range(0, n, BN):
        s = torch.matmul(qr, kr_[:, k0:k0 + BN].transpose(1, 2))
        if s.dtype == torch.int64:
            assert s.abs().max() < 2 ** 24  # so its fp32 conversion is exact
        s = F.pad(s.to(torch.float32), (0, k0 + BN - min(n, k0 + BN)))  # zero keys past N
        if stage == "qkt":
            rows = rows + s.sum(-1)
            continue
        if mask:
            s = torch.where(torch.arange(k0, k0 + BN) < n, s, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1) * sl2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new[..., None])
        l = l * corr + p.sum(-1)
        if stage == "full":
            acc = acc * corr[..., None] + p[..., :n - k0] @ vr[:, k0:k0 + BN]
        m = m_new
    if stage == "qkt":
        return rows
    if stage == "softmax":
        return l
    o = acc / l[..., None]
    return o.transpose(1, 2) if transposed else o


def _inputs(stage, transposed, int8, b, n):
    rs = np.random.RandomState(sum(map(ord, kr.variant_name(stage, transposed, int8))) + n)
    q, k, v = (rs.standard_normal((b, n, kr.D)).astype(np.float32) for _ in range(3))
    if transposed:
        q, k, v = (np.ascontiguousarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    sq = sk = 1.0
    if int8:
        sq, tq = kr.quantize_per_tensor(tq)
        sk, tk = kr.quantize_per_tensor(tk)
    return tq, tk, tv, sq, sk


def _reference(script, stage, transposed, int8, tq, tk, tv, sq, sk, b, n):
    body = _bodies(script)[(stage, transposed, int8)]
    if body is None:  # the tr int8 full body takes the host scales
        body = functools.partial(script._full8_tr_kernel, sq=sq, sk=sk)
    rowsum = stage != "full"
    args = (tq.numpy(), tk.numpy()) + (() if rowsum else (tv.numpy(),))
    qb = 128 if n % 128 == 0 else 64
    ref = _pallas(body, transposed, rowsum, len(args), b=b, n=n, qb=qb)(*map(jnp.asarray, args))
    ref = np.asarray(ref)
    return ref.reshape(b, n) if rowsum else ref


@pytest.mark.parametrize("n", [256, 192])
@pytest.mark.parametrize("stage,transposed,int8", kr.VARIANTS)
def test_probe_mirror_matches_the_script_kernel(jax_script, stage, transposed, int8, n):
    b = 2
    tq, tk, tv, sq, sk = _inputs(stage, transposed, int8, b, n)
    ref = _reference(jax_script, stage, transposed, int8, tq, tk, tv, sq, sk, b, n)
    out = mirror_probe(stage, tq, tk, tv if stage == "full" else None, sq * sk * kr.SCALE,
                       transposed).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=RTOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("stage", ["softmax", "full"])
def test_probe_mirror_needs_the_mask_past_n(jax_script, stage):
    """At N = 192 the last 128-key tile is half zero keys: the mirror that
    leaves them in the softmax fails the comparison."""
    b, n = 2, 192
    tq, tk, tv, _, _ = _inputs(stage, False, False, b, n)
    ref = _reference(jax_script, stage, False, False, tq, tk, tv, 1.0, 1.0, b, n)
    out = mirror_probe(stage, tq, tk, tv if stage == "full" else None, kr.SCALE, False,
                       mask=False).numpy()
    assert np.abs(out - ref).max() > 100 * RTOL * np.abs(ref).max()


def _int8_body(a_ref, b_ref, o_ref):  # part_pallas's `kern`
    o_ref[...] = jax.lax.dot_general(a_ref[...], b_ref[...], (((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.int32)


def _bf16_body(a_ref, b_ref, o_ref):  # part_pallas's `kernb`
    o_ref[...] = jnp.dot(a_ref[...], b_ref[...], preferred_element_type=jnp.float32)


def mirror_gemm(a, b):
    """Kernel 6's order of work: int8 B as the pre-kernel's B^T (N, K),
    128-byte k-tiles (the tail past K zero), int32 sums (fp32 for bf16)."""
    int8 = a.dtype == torch.int8
    bt = ip.plain_transpose_int8(b) if int8 else b.transpose(0, 1)
    kb = 128 if int8 else 64
    k = a.shape[1]
    a, bt = (F.pad(x, (0, -k % kb)) for x in (a, bt))
    c = torch.zeros((a.shape[0], bt.shape[0]), dtype=torch.int32 if int8 else torch.float32)
    for k0 in range(0, a.shape[1], kb):
        at, btt = a[:, k0:k0 + kb], bt[:, k0:k0 + kb]
        if int8:
            tile = at.long() @ btt.long().transpose(0, 1)
            assert tile.abs().max() < 2 ** 31
            c = c + tile.to(torch.int32)
        else:
            c = c + at.float() @ btt.float().transpose(0, 1)
    return c


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("mkn", [(256, 128, 384), (128, 320, 256), (128, 192, 640)])
def test_gemm_mirror_matches_the_script_kernel(int8, mkn):
    m, k, n = mkn
    a, b = ip.operands(m, k, n, int8, torch.device("cpu"), seed=k)
    body, dtype = (_int8_body, jnp.int32) if int8 else (_bf16_body, jnp.float32)
    to_jax = (lambda x: jnp.asarray(x.numpy())) if int8 else (
        lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    ref = np.asarray(pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((m, n), dtype),
                                    interpret=True)(to_jax(a), to_jax(b)))
    out = mirror_gemm(a, b).numpy()
    if int8:
        assert out.dtype == np.int32 and np.abs(ref).max() > 2 ** 16
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=RTOL * np.abs(ref).max(), rtol=0)


def test_gemm_mirror_without_the_transposition_fails(monkeypatch):
    """B's bytes read as B^T without the transposition (the planted fault of
    ``chip_smoke.py`` phase 3b) give another product."""
    a, b = ip.operands(256, 256, 256, True, torch.device("cpu"), seed=3)
    good = mirror_gemm(a, b)
    assert torch.equal(good, ip.plain_gemm(a, b))
    monkeypatch.setattr(ip, "plain_transpose_int8", chip_smoke.skip_transposition)
    assert not torch.equal(mirror_gemm(a, b), good)


@pytest.mark.parametrize("shape,width", [((3, 40, 64), 48), ((128, 256), None), ((64, 32), 80)])
def test_plain_transpose_int8(shape, width):
    rs = np.random.RandomState(len(shape))
    x = torch.from_numpy(rs.randint(-127, 127, shape).astype(np.int8))
    out = ip.transpose_int8(x, width)
    rows = shape[-2]
    width = rows if width is None else width
    assert out.shape == shape[:-2] + (shape[-1], width) and out.is_contiguous()
    assert torch.equal(out[..., :rows], x.transpose(-1, -2)) and not out[..., rows:].any()


TILE_SHAPE = (1, 2, 600, 40)  # ragged: 600 is no multiple of a query or key tile


def mirror_tiles(q, k, v, scale: float, bm: int, bn: int, mask: bool = True):
    """Kernel 7's order of work in fp32 at tiles (bm, bn) (P kept in fp32;
    the kernel rounds it to bf16 for P.V).  ``mask=False`` leaves the zero
    keys past n_k in the softmax, a fault the test must see."""
    n_q, n_k = q.shape[2], k.shape[2]
    sl2 = np.float32(scale * _LOG2E)
    pad = -n_k % bn
    kp, vp = (F.pad(x, (0, 0, 0, pad)) for x in (k, v))  # TMA's zero rows
    out = torch.zeros_like(q)
    for q0 in range(0, n_q, bm):  # a block
        for r0 in range(q0, min(q0 + bm, n_q), 64):  # its consumer warpgroups
            qs = q[:, :, r0:r0 + 64]
            m = torch.full(qs.shape[:-1], -float("inf"))
            l = torch.zeros(qs.shape[:-1])
            acc = torch.zeros_like(qs)
            for k0 in range(0, n_k, bn):
                s = qs @ kp[:, :, k0:k0 + bn].transpose(-1, -2)
                if mask:
                    s = torch.where(torch.arange(k0, k0 + bn) < n_k, s, -float("inf"))
                m_new = torch.maximum(m, s.amax(-1) * sl2)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s * sl2 - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + p @ vp[:, :, k0:k0 + bn]
                m = m_new
            out[:, :, r0:r0 + 64] = acc / l[..., None]
    return out


@pytest.fixture(scope="module")
def tile_case():
    """Seeded q, k, v at TILE_SHAPE and the JAX kernel's output on them."""
    rs = np.random.RandomState(600)
    q, k, v = (rs.standard_normal(TILE_SHAPE).astype(np.float32) for _ in range(3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsa, "_pick_qb", lambda n_q, n_k: n_q)  # one query block of every row
        ref = jsa.kv_resident_attention(*map(jnp.asarray, (q, k, v)), pb.SCALE, interpret=True)
    return tuple(map(torch.from_numpy, (q, k, v))), np.asarray(ref)


@pytest.mark.parametrize("bm,bn", pb.TILES)
def test_tile_mirror_matches_the_jax_kernel(tile_case, bm, bn):
    (q, k, v), ref = tile_case
    out = mirror_tiles(q, k, v, pb.SCALE, bm, bn).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_tile_mirror_needs_the_mask_past_n_k(tile_case):
    """600 keys end inside a tile at every BN: the zero keys past them,
    left in the softmax, change every row."""
    (q, k, v), ref = tile_case
    out = mirror_tiles(q, k, v, pb.SCALE, 128, 128, mask=False).numpy()
    assert np.abs(out - ref).max() > 100 * 1e-5
