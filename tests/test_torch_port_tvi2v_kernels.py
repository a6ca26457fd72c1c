"""The TVI2V slice's kernel paths on the CPU: kernel 1's plain version at
n_k = 2 * n_q and beyond against the Pallas kernel's multi-chunk branch
(interpret mode), its head_dim 160 instantiation's plain version against
``_xla_attention``, and the route (R1): every attention shape the TV2V and
TVI2V networks and the VAE encoder and decoder produce, at corners of the
bucket grid, goes to a wrapper whose kernel has that head dim.

The shapes are recorded from forwards of the full-width modules on the
``meta`` device (no memory, no arithmetic), with every route replaced by a
recorder.  Tolerances: 3e-5 absolute for the multi-chunk online softmax (as
``tests/test_spatial_attention.py`` holds the Pallas kernel to
``_xla_attention``), 2e-5 for the one-pass d = 160 softmax; fp32 both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.ops.attention import _xla_attention
from ccedit_tpu.ops.spatial_attention import _n_chunks, kv_resident_attention
from ccedit_tpu.utils.buckets import HW_MAX, HW_MIN, T_GRID
from ccedit_tpu_torch import config
from ccedit_tpu_torch.ops import attention as att
from ccedit_tpu_torch.ops import flash_attention as fa
from ccedit_tpu_torch.ops import spatial_attention as sa
from ccedit_tpu_torch.ops import temporal_attention as ta

torch.set_num_threads(1)


def _qkv(q_shape, n_k, seed, k_scale=1.0):
    rs = np.random.RandomState(seed)
    kv_shape = q_shape[:2] + (n_k, q_shape[3])
    return (rs.standard_normal(q_shape).astype(np.float32),
            (rs.standard_normal(kv_shape) * k_scale).astype(np.float32),
            rs.standard_normal(kv_shape).astype(np.float32))


@pytest.mark.parametrize("d", [40, 80])
def test_1b_plain_matches_pallas_multi_chunk(d):
    """q (1, 2, 512, d) x k/v (1, 2, 12288, d), k scaled by 3 so the row
    maxima fall in different 3072-key chunks."""
    assert _n_chunks(12288) == 4
    q, k, v = _qkv((1, 2, 512, d), 12288, seed=d, k_scale=3.0)
    scale = d ** -0.5
    ref = kv_resident_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                interpret=True)
    out = sa.plain_spatial_attention(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=0)


@pytest.mark.parametrize("n_k", [512, 1024])
def test_d160_plain_matches_xla(n_k):
    q, k, v = _qkv((1, 2, 512, 160), n_k, seed=n_k)
    scale = 160 ** -0.5
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    out = sa.plain_spatial_attention(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


_KERNEL_HEAD_DIMS = {"spatial": sa.HEAD_DIMS, "flash": fa.HEAD_DIMS, "temporal": ta.HEAD_DIMS}
# (H, W, T): the bucket grid's corners and the headline geometry
GEOMETRIES = [(HW_MIN, HW_MIN, T_GRID[0]), (HW_MAX, HW_MAX, T_GRID[-1]),
              (HW_MIN, HW_MAX, 9), (HW_MAX, HW_MIN, 25), (768, 768, 12), (512, 768, 17)]


@pytest.fixture(scope="module")
def recorded_shapes():
    """{(H, W, T): [(route, q shape, k shape), ...]} over the TV2V and
    TVI2V networks (CFG batch 2) and the VAE encoder (reference frame and
    clip) and decoder, full SD-1.5 widths, on the meta device."""
    calls = []

    def recorder(route):
        def record(q, k, v, scale):
            calls.append((route, tuple(q.shape), tuple(k.shape)))
            return torch.empty_like(q)
        return record

    with torch.device("meta"):
        nets = [config.build_network(c["model"]["params"]["network_config"])
                for c in (config.TV2V_CONFIG, config.TVI2V_CONFIG)]
        vae = config.build_vae(config.TV2V_CONFIG["model"]["params"]["first_stage_config"])
    saved = dict(att._ROUTES)
    att._ROUTES.update({name: recorder(name) for name in saved})
    out = {}
    try:
        with torch.no_grad(), torch.device("meta"):
            for h, w, t in GEOMETRIES:
                calls.clear()
                x = torch.empty(2, t, h // 8, w // 8, 4)
                cond = {"crossattn": torch.empty(2, 77, 768),
                        "control_hint": torch.empty(2, t, h, w, 3),
                        "cond_feat": torch.empty(2, h // 8, w // 8, 4)}
                for net in nets:
                    net(x, torch.empty(2), cond)
                vae.encode_moments(torch.empty(1, h, w, 3))
                vae.encode_moments(torch.empty(1, t, h, w, 3))
                vae.decode(torch.empty(1, t, h // 8, w // 8, 4))
                out[(h, w, t)] = list(calls)
    finally:
        att._ROUTES.update(saved)
    return out


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_every_routed_shape_has_a_kernel_instantiation(recorded_shapes, geometry):
    calls = recorded_shapes[geometry]
    assert {r for r, _, _ in calls} >= {"spatial", "temporal", "flash", "plain"} - (
        {"temporal"} if geometry[2] > ta.MAX_T else set())
    for route, q_shape, k_shape in calls:
        q, k = torch.empty(q_shape, device="meta"), torch.empty(k_shape, device="meta")
        assert att.attention_route(q, k) == route
        if route != "plain":
            assert q_shape[-1] in _KERNEL_HEAD_DIMS[route], (route, q_shape)
        if route == "temporal":
            assert q_shape[2] == k_shape[2] <= ta.MAX_T


def test_the_route_reaches_1b_and_d160(recorded_shapes):
    """CFCA centre+self reaches kernel 1 at n_k = 2 * n_q; at 1024x1024 the
    level-2 self-attention (1024 tokens, d = 160) reaches the d = 160
    instantiation, a shape the previous route sent to kernel 3, which has
    no such head dim."""
    headline = recorded_shapes[(512, 768, 17)]
    assert ("spatial", (34, 8, 6144, 40), (34, 8, 12288, 40)) in headline
    assert ("spatial", (34, 8, 1536, 80), (34, 8, 3072, 80)) in headline
    assert ("flash", (1, 1, 6144, 512), (1, 1, 6144, 512)) in headline
    big = recorded_shapes[(HW_MAX, HW_MAX, T_GRID[-1])]
    d160 = [c for c in big if c[0] == "spatial" and c[1][-1] == 160]
    assert d160 and all(c[1][2] == 1024 for c in d160)
    assert 160 not in fa.HEAD_DIMS
