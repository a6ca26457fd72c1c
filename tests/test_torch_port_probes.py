"""The probes of the port on the CPU: kernel 5's plain version against the
JAX script's seven Pallas kernel bodies, and kernel 6's against numpy.

``scripts/kv_resident_attn.py`` hard-codes (272, 6144, 40) in its
``make_*_call`` and passes no interpret flag, so the test builds each
``pl.pallas_call`` around the script's kernel body itself, at (2, 256, 40)
with 128-query blocks, in interpret mode.  fp32 inputs (int8 for the int8
variants): row sums within 1e-5 of max|JAX| (fp32 sums of 256 terms in
another order), attention within 1e-5 abs.  Kernel 6's plain version is
exact against numpy's int64 product, and within fp32 rounding of float64
for bf16.  Also the bounds of ``scripts/roofline.py`` at the shapes
``PERF.md`` quotes, and that each variant of ``scripts/bwd_breakdown.py``
still patches kernel 4's source (it runs only on the card).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ccedit_tpu_torch.scripts import bwd_breakdown as bb
from ccedit_tpu_torch.scripts import int8_probe as ip
from ccedit_tpu_torch.scripts import kv_resident_attn as kr
from ccedit_tpu_torch.scripts import roofline

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
B, N, QB = 2, 256, 128


@pytest.fixture(scope="module")
def jax_script():
    """``scripts/kv_resident_attn.py`` loaded by path.  It points JAX's
    compilation cache at ~/.cache at import; the previous settings are put
    back at once, before anything compiles."""
    saved = {k: getattr(jax.config, k) for k in
             ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location("jax_kv_resident_attn",
                                                  ROOT / "scripts" / "kv_resident_attn.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    assert module.D == kr.D and module.SCALE == kr.SCALE
    return module


def _pallas(body, transposed: bool, rowsum: bool, n_in: int):
    """A small-shape ``pallas_call`` of one of the script's kernel bodies,
    laid out as its ``make_call`` / ``make_tr_call`` / ``make_tr8_call``."""
    d = kr.D
    if transposed:
        qspec = pl.BlockSpec((1, d, QB), lambda b, i: (b, 0, i))
        kvspec = pl.BlockSpec((1, d, N), lambda b, i: (b, 0, 0))
        rspec, rshape = pl.BlockSpec((1, 1, QB), lambda b, i: (b, 0, i)), (B, 1, N)
        oshape = (B, d, N)
    else:
        qspec = pl.BlockSpec((1, QB, d), lambda b, i: (b, i, 0))
        kvspec = pl.BlockSpec((1, N, d), lambda b, i: (b, 0, 0))
        rspec, rshape = pl.BlockSpec((1, QB, 1), lambda b, i: (b, i, 0)), (B, N, 1)
        oshape = (B, N, d)
    return pl.pallas_call(
        body, grid=(B, N // QB), in_specs=[qspec] + [kvspec] * (n_in - 1),
        out_specs=rspec if rowsum else qspec,
        out_shape=jax.ShapeDtypeStruct(rshape if rowsum else oshape, jnp.float32),
        interpret=True)


def _bodies(script):
    return {("qkt", False, False): script._qkt_kernel,
            ("softmax", False, False): script._softmax_kernel,
            ("full", False, False): script._full_kernel,
            ("qkt", True, False): script._qkt_tr_kernel,
            ("full", True, False): script._full_tr_kernel,
            ("qkt", True, True): script._qkt8_tr_kernel,
            ("full", True, True): None}  # needs the host scales: built in the test


@pytest.mark.parametrize("stage,transposed,int8", kr.VARIANTS)
def test_plain_probe_matches_the_script_kernel(jax_script, stage, transposed, int8):
    rs = np.random.RandomState(sum(map(ord, kr.variant_name(stage, transposed, int8))))
    q, k, v = (rs.standard_normal((B, N, kr.D)).astype(np.float32) for _ in range(3))
    if transposed:
        q, k, v = (np.ascontiguousarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    scale = kr.SCALE
    body = _bodies(jax_script)[(stage, transposed, int8)]
    if int8:
        sq, tq = kr.quantize_per_tensor(tq)
        sk, tk = kr.quantize_per_tensor(tk)
        q, k = tq.numpy(), tk.numpy()
        scale = sq * sk * kr.SCALE
        if stage == "full":
            body = functools.partial(jax_script._full8_tr_kernel, sq=sq, sk=sk)
    rowsum = stage != "full"
    args = (q, k) if rowsum else (q, k, v)
    ref = np.asarray(_pallas(body, transposed, rowsum, len(args))(*map(jnp.asarray, args)))
    before = kr.probe.launches
    out = kr.probe(stage, tq, tk, None if rowsum else tv, scale, transposed).numpy()
    assert kr.probe.launches == before  # a CPU tensor takes the plain version
    if rowsum:
        assert out.shape == (B, N)
        np.testing.assert_allclose(out, ref.reshape(B, N), atol=1e-5 * np.abs(ref).max(), rtol=0)
    else:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("stage", ["softmax", "full"])
def test_compare_passes_rounding_and_refuses_a_temperature_off_by_ln2(stage):
    """``kr.compare``'s limits against a sound result computed another way
    (float64 row sums; attention with P unrounded and o rounded to bf16)
    and against the softmax temperature off by ln 2, the fault that leaving
    log2 e out of the kernel's exp2 scale makes."""
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.standard_normal((2, 1024, kr.D)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    ref = kr.plain_probe(stage, q, k, v)
    s = (q.double() @ k.double().transpose(1, 2)) * kr.SCALE
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)
    sound = l if stage == "softmax" else (p @ v.double() / l[..., None]).to(torch.bfloat16)
    assert kr.compare(stage, sound, ref)["ok"]
    fault = kr.compare(stage, kr.plain_probe(stage, q, k, v, kr.SCALE * np.log(2.0)), ref)
    assert not fault["ok"]
    if stage == "full":
        assert fault["max_rel_err"] > 5 * kr.FULL_TOLERANCE and fault["cosine"] < 0.99


@pytest.mark.parametrize("mkn", [(256, 128, 384), (1024, 512, 1024)])
def test_plain_gemm_int8_is_exact(mkn):
    m, k, n = mkn
    a, b = ip.operands(m, k, n, True, torch.device("cpu"), seed=m)
    c = ip.gemm(a, b)  # a CPU tensor: the plain version
    assert c.dtype == torch.int32
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    np.testing.assert_array_equal(c.numpy().astype(np.int64), want)
    assert np.abs(want).max() > 2 ** 16  # the int32 result needs more than 16 bits


def test_plain_gemm_bf16():
    a, b = ip.operands(256, 128, 384, False, torch.device("cpu"), seed=5)
    c = ip.gemm(a, b)
    assert c.dtype == torch.float32
    want = a.double().numpy() @ b.double().numpy()
    np.testing.assert_allclose(c.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("shape,n_k,kind,ms,what", [
    ((34, 8, 6144, 40), 6144, "fwd", 2.6327, "exp"),
    ((34, 8, 1536, 80), 1536, "fwd", 0.2075, "tensor"),
    ((34, 8, 1024, 160), 1024, "fwd", 0.1845, "tensor"),
    ((34, 8, 6144, 40), 12288, "fwd", 5.2655, "exp"),
    ((12288, 8, 17, 40), 17, "fwd", 0.1596, "bytes"),
    ((17, 1, 6144, 512), 6144, "fwd", 1.3289, "tensor"),
    ((48, 8, 3072, 40), 3072, "bwd", 1.4658, "tensor"),
    ((34, 8, 6144, 40), 6144, "int8", 2.6327, "exp"),
    ((34, 8, 1536, 80), 1536, "int8", 0.1646, "exp"),
])
def test_attention_bounds(shape, n_k, kind, ms, what):
    """The least times quoted in PERF.md's kernel table."""
    got = roofline.attention_bound(*shape[:3], n_k, shape[3], qk_int8=kind == "int8",
                                   backward=kind == "bwd")
    assert got["bound_what"] == what and got["bound_ms"] == pytest.approx(ms, rel=1e-3)
    assert got["bound_by"] == ("bytes" if what == "bytes" else "operations")


def test_probe_and_gemm_bounds():
    assert kr.probe_bound("qkt", False)["bound_ms"] == pytest.approx(0.8305, rel=1e-3)
    assert kr.probe_bound("qkt", True)["bound_ms"] == pytest.approx(0.4151, rel=1e-3)
    assert kr.probe_bound("softmax", False)["bound_what"] == "exp"
    assert ip.gemm_bound(1024, 512, 1024, True)["bound_what"] == "bytes"
    assert ip.gemm_bound(4096, 4096, 4096, True)["bound_ms"] == pytest.approx(0.06945, rel=1e-3)
    assert ip.gemm_bound(4096, 4096, 4096, False)["bound_ms"] == pytest.approx(0.13897, rel=1e-3)


@pytest.mark.parametrize("name", sorted(bb.VARIANTS))
def test_bwd_breakdown_variant_patches_the_kernel_source(name):
    """Every substitution of the variant finds its text in
    ``csrc/spatial_attention_bwd.cu`` (``patched`` raises otherwise)."""
    src = (bb.build.CSRC / "spatial_attention_bwd.cu").read_text()
    assert bb.patched(name) != src
