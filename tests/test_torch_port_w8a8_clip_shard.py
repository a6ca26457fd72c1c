"""W8A8 under a clip shard on the CPU: gloo ranks, each its own process,
against one process and against the JAX package, and the GroupNorms
against flax's.

The tiny TV2V and TVI2V networks of ``test_torch_port_clip_shard.py``
(seeded random JAX weights mapped with ``from_jax``) at 64x64 pixels, W8A8
on (``set_quantized_matmul(True)`` in both packages), the networks in fp64
(at fp32 an ulp of summation order flips int8 steps).  Both packages take
the JAX package's timestep embedding and an fp64 plain attention (each
computes its embedding and softmax in fp32 by design, an ulp apart: enough
to flip an int8 step; ``test_torch_port_w8a8.py`` does the same).  At world
2 and 4, on the height, width and frame axes:

* one CFG-doubled W8A8 forward, the rank blocks gathered, against the
  port's one-process W8A8 forward at 1e-5 of max|ref| and JAX's one-process
  W8A8 forward at ``test_torch_port_w8a8.py``'s BLOCK_TOL (JAX's GSPMD
  program computes that function: the amax of each ``QConv`` over the
  whole clip);
* every per-tensor quantization's scale, in call order, equal on every
  rank and to the one-process scale at that site to 1e-12, and bit for bit
  before the first GroupNorm whose statistics span the ranks;
* a 2-step W8A8 DPM++2S-ancestral sample through
  ``make_frame_sharded_sample`` against one process at 1e-5.

At world 2: a census of a row's collectives (one amax all-reduce a
per-tensor quantization, none for the per-token dense layers; one int8
halo a k > 1 ``QConv`` call under a spatial split and no other halo; norm
all-reduces one an image GroupNorm; a frame split's only all-to-alls,
broadcasts and amax all-reduces); the four planted faults of
``chip_smoke.w8a8_clip_fault`` (each rank on its own amax, the amaxes
summed, kernel 8's fused form on local statistics, int8 halos of zeros)
each fail the forward check, under the first the ranks' scales differ,
and under the second the scales before the first spanning GroupNorm are
not one process's; the external-
statistics form's arithmetic (u = bf16(bf16(x + add) * scale + shift), a
product then a sum, from ``GroupNorm.sharded_affine``; the amax from each
(sample, channel)'s extremes, then all-reduced) bit for bit the sharded
plain chain (``_sharded`` GroupNorm, SiLU, the per-tensor quantizer).

In this process: the port's ``GroupNorm`` (image and temporal) and the
DPT-Hybrid's at bf16 against flax's ``nn.GroupNorm(dtype=bfloat16)`` on the
same seeded data: at most 1 % of the outputs differ (statistics rounded to
bf16, as torch's CUDA GroupNorm stores a bf16 input's, differ in about a
third).
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_clip_shard import (APPEARANCE, FRAMES, PIX, STEPS, TINY, _jax_side,
                                        _name, _rel, _t, port_engine, port_network,
                                        sample_kwargs)

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
CASES = tuple((kind, world, axis) for world in (2, 4) for axis in (2, 3, 1)
              for kind in ("tv2v", "tvi2v"))
TIMEOUT = 300
TOLERANCE = 1e-5  # of max|ref|, against one process
BLOCK_TOL = 1e-5  # test_torch_port_w8a8.py's, against JAX in fp64
SCALE_TOL = 1e-12
DIFFERING = 1e-2  # share of bf16 GroupNorm outputs that may differ from flax's


# ---------------------------------------------------------------------------
# both sides
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def same_arithmetic(embeddings):
    """W8A8 on; the port's UNets take ``embeddings`` ({(timestep, dim): row},
    the JAX package's timestep embedding) where it holds every timestep,
    and an fp64 plain attention; all restored on exit."""
    from ccedit_tpu_torch.modules import unet as tun
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.ops import quant

    embedding, plain = tun.timestep_embedding, att._ROUTES["plain"]
    matmul = quant._STATE["matmul"]

    def table(t, dim):
        keys = [(float(v), dim) for v in t.reshape(-1)]
        if not all(k in embeddings for k in keys):
            return embedding(t, dim)
        return torch.from_numpy(np.stack([embeddings[k] for k in keys]))

    tun.timestep_embedding = table
    att._ROUTES["plain"] = lambda q, k, v, scale: torch.matmul(
        torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1), v)
    quant.set_quantized_matmul(True)
    try:
        yield
    finally:
        tun.timestep_embedding, att._ROUTES["plain"] = embedding, plain
        quant._STATE["matmul"] = matmul


@contextlib.contextmanager
def recorded_scales():
    """On exit ``scales``, every per-tensor quantization's scale in call
    order as floats, and ``exact_sites``, how many came before the first
    GroupNorm whose statistics span the ranks (``chip_smoke.qconv_scales``)."""
    import chip_smoke

    out = {}
    with chip_smoke.qconv_scales() as record:
        yield out
    out.update(scales=[float(s.reshape(())) for s in record["scales"]],
               exact_sites=record["exact_sites"])


def _t64(tree):
    return {k: _t64(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        torch.from_numpy(np.asarray(tree, np.float64)) if isinstance(tree, np.ndarray) else tree)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _forward(net, d, axis):
    from ccedit_tpu_torch.parallel.sampling import gather_clip, shard_clip_cond
    from ccedit_tpu_torch.parallel.shard import ClipShard, mesh_context

    shard = ClipShard(axis, d["shape"][1], size=d["shape"][2:4])
    x = shard.block(_t64(d["x2"]), axis)
    cond = shard_clip_cond(_t64(d["cond2"]), d["x2"].shape, axis, shard.rank, shard.world)
    with mesh_context(shard), torch.no_grad():
        out = net(x, _t(d["ts"]), cond)
    return gather_clip(out, axis)


def _every_rank(value):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _external(world):
    """The external-statistics form's arithmetic, mirrored, and the
    sharded plain chain on this rank's block of a height split."""
    import torch.nn.functional as F

    from ccedit_tpu_torch.modules.layers import GroupNorm
    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.parallel.shard import ClipShard, mesh_context

    torch.manual_seed(6)
    norm = GroupNorm(8, 32).to(torch.bfloat16)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.2)
        norm.bias.normal_(0.0, 0.2)
    x = (torch.randn(3, 4 * world, 6, 32) * 3 + 1.5).to(torch.bfloat16)
    add = (torch.randn(3, 32) * 0.5).to(torch.bfloat16)
    shard = ClipShard(2, 1, size=x.shape[1:3])
    xb = shard.block(x, 1)
    with mesh_context(shard), torch.no_grad():
        ref = quant.plain_norm_silu_quantize(xb, norm, add)
        v = xb + add[:, None, None, :]
        scale, shift = (t[:, None, None, :] for t in norm.sharded_affine(v, shard)[:2])
        affine = lambda vals: torch.add(torch.mul(vals.float(), scale), shift).to(torch.bfloat16)
        y = F.silu(affine(v)).float()
        flat = v.reshape(3, -1, 32)
        ends = torch.stack([flat.amin(1), flat.amax(1)], 1)[:, :, None]  # (S, 2, 1, C)
        endpoint = F.silu(affine(ends)).float().abs().max()
        every = y.abs().max()
        amax = quant.clip_amax(endpoint.clone().reshape(1, 1))
        s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
        q = (y / s).round_().clamp_(-127, 127).to(torch.int8).reshape(-1, 32)
    return dict(ref_q=ref.q, ref_scale=ref.scale, q=q, scale=s.reshape(-1),
                endpoint=endpoint, every=every)


def _worker(world, rank, tmp):
    import torch.distributed as dist

    import chip_smoke
    from ccedit_tpu_torch.parallel import sampling
    from ccedit_tpu_torch.parallel.sampling import gather_clip, make_frame_sharded_sample
    from ccedit_tpu_torch.parallel.shard import census

    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / f'store{world}'}", rank=rank,
                            world_size=world)
    data = torch.load(tmp / "inputs.pt", weights_only=False)
    nets = {}
    for kind in ("tv2v", "tvi2v"):
        nets[kind] = port_network(kind)
        nets[kind].load_state_dict(data["weights"][kind])
        nets[kind].double()
    res = {}
    with same_arithmetic(data["embeddings"]):
        for kind, w, axis in CASES:
            if w != world:
                continue
            d = data["inputs"][(kind, FRAMES[axis])]
            name = _name(kind, world, axis)
            with recorded_scales() as scales, census() as records:
                res[name, "forward"] = _forward(nets[kind], d, axis)
            res[name, "scales"] = _every_rank(scales["scales"])
            res[name, "exact_sites"] = scales["exact_sites"]
            res[name, "census"] = records
            pick = sampling.pick_clip_axis
            if axis == 3:  # T = 3 and H = 8 pick the height: force the width
                sampling.pick_clip_axis = lambda world, shape: 3
            try:
                call = make_frame_sharded_sample(port_engine(nets[kind]), d["shape"], STEPS)
            finally:
                sampling.pick_clip_axis = pick
            assert call.axis == axis, (call.axis, axis)
            res[name, "sample"] = gather_clip(call(_t(d["c"]), _t(d["uc"]),
                                                   **sample_kwargs(d)), axis)
        if world == 2:
            d = data["inputs"][("tvi2v", 3)]
            for fault in chip_smoke.W8A8_CLIP_FAULTS:
                with chip_smoke.w8a8_clip_fault(fault), recorded_scales() as scales:
                    res["fault", fault] = _forward(nets["tvi2v"], d, 2)
                res["fault scales", fault] = _every_rank(scales["scales"])
    if world == 2:
        res["external"] = _external(world)
    dist.destroy_process_group()
    if rank == 0:
        torch.save(res, tmp / f"ranks{world}.pt")


def _spawn(world, tmp):
    procs = []
    for rank in range(world):
        code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]; "
                f"import test_torch_port_w8a8_clip_shard as t; t._worker({world}, {rank}, "
                f"{str(tmp)!r})")
        log = open(tmp / f"w{world}_rank{rank}.log", "w")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs.append((subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                                       stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, world, tmp):
    try:
        for proc, _ in procs:
            proc.wait(timeout=TIMEOUT)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        assert proc.returncode == 0, (tmp / f"w{world}_rank{rank}.log").read_text()[-4000:]
    return torch.load(tmp / f"ranks{world}.pt", weights_only=False)


# ---------------------------------------------------------------------------
# the references, in this process
# ---------------------------------------------------------------------------
def _embeddings(side):
    """The JAX package's timestep embedding at every forward's timesteps."""
    import jax
    import jax.numpy as jnp

    from ccedit_tpu.modules import layers as jlayers

    out, dim = {}, TINY["model_channels"]
    with jax.enable_x64():
        for d in side["inputs"].values():
            ts = np.asarray(d["ts"], np.float32)
            rows = np.asarray(jlayers.timestep_embedding(jnp.asarray(ts), dim))
            out.update({(float(v), dim): row for v, row in zip(ts, rows)})
    return out


def _jax_forward(kind, params, d):
    """JAX's one-process W8A8 forward in fp64 (x64), its attention in the
    inputs' fp64."""
    import jax
    import jax.numpy as jnp

    from ccedit_tpu.modules import controlnet as jcn
    from ccedit_tpu.modules import unet as jun
    from ccedit_tpu.ops import attention as jatt
    from ccedit_tpu.ops import quant as jquant

    saved = jquant._STATE["matmul"], jatt._xla_attention
    jquant.set_quantized_matmul(True)
    jatt._xla_attention = lambda q, k, v, scale: jnp.einsum(
        "bhqk,bhkd->bhqd", jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale, axis=-1),
        v)
    try:
        with jax.enable_x64():
            f64 = dict(dtype=jnp.float64)
            cfca = dict(enable_attention3d_crossframe=True, st3dca_ca_type="center_self")
            jnet = jcn.CCEditNetwork(
                unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True,
                                   **(cfca if kind == "tvi2v" else {}), **f64, **TINY),
                controlnet=jcn.ControlNet2D(hint_channels=3, **f64, **TINY),
                controlnet_img=(jcn.ControlNet2D(**APPEARANCE, **f64, **TINY)
                                if kind == "tvi2v" else None))
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
            return np.asarray(jnet.apply(
                {"params": p64}, jnp.asarray(d["x2"], jnp.float64), jnp.asarray(d["ts"]),
                {k: jnp.asarray(v, jnp.float64) for k, v in d["cond2"].items()}))
    finally:
        jquant._STATE["matmul"], jatt._xla_attention = saved


def _references(side, embeddings):
    """The port's one-process W8A8 forwards (with their scales and the
    calls a census must match) and samples, then JAX's forwards."""
    from ccedit_tpu_torch.modules.layers import Conv2d, GroupNorm

    refs = {}
    with same_arithmetic(embeddings):
        for (kind, t), d in side["inputs"].items():
            net = port_network(kind)
            net.load_state_dict(side["weights"][kind])
            net.double()
            calls = {"int8_halo": 0, "halo": 0, "norm_all_reduce": 0}

            def hook(mod, *_):
                if isinstance(mod, Conv2d) and mod.kernel_size != (1, 1):
                    calls["int8_halo" if mod.quant else "halo"] += 1
                elif isinstance(mod, GroupNorm) and not mod.temporal:
                    calls["norm_all_reduce"] += 1

            handles = [m.register_forward_hook(hook) for m in net.modules()]
            with recorded_scales() as scales, torch.no_grad():
                refs[kind, t, "forward"] = net(_t64(d["x2"]), _t(d["ts"]), _t64(d["cond2"]))
            for h in handles:
                h.remove()
            refs[kind, t, "scales"], refs[kind, t, "calls"] = scales["scales"], calls
            refs[kind, t, "sample"] = port_engine(net).sample(
                _t(d["c"]), _t(d["uc"]), d["shape"], num_steps=STEPS, **sample_kwargs(d))
    for (kind, t), d in side["inputs"].items():
        refs[kind, t, "jax_forward"] = _jax_forward(kind, side["jax"][kind][2], d)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w8a8_clip_shard")
    side = _jax_side()
    embeddings = _embeddings(side)
    torch.save({"weights": side["weights"], "inputs": side["inputs"], "embeddings": embeddings},
               tmp / "inputs.pt")
    procs = {world: _spawn(world, tmp) for world in (2, 4)}
    refs = _references(side, embeddings)
    return {world: _join(p, world, tmp) for world, p in procs.items()}, refs


@pytest.mark.parametrize("kind,world,axis", CASES, ids=[_name(*c) for c in CASES])
def test_sharded_w8a8_forward(runs, kind, world, axis):
    ranks, refs = runs
    t = FRAMES[axis]
    out = ranks[world][_name(kind, world, axis), "forward"]
    ref = refs[kind, t, "forward"]
    assert out.dtype == torch.float64 and tuple(out.shape) == tuple(ref.shape)
    assert np.abs(ref.numpy()).max() > 0.1  # real work
    assert _rel(out, ref) <= TOLERANCE, _rel(out, ref)
    assert _rel(out, refs[kind, t, "jax_forward"]) <= BLOCK_TOL


@pytest.mark.parametrize("kind,world,axis", CASES, ids=[_name(*c) for c in CASES])
def test_every_site_takes_the_clips_scale(runs, kind, world, axis):
    ranks, refs = runs
    by_rank = ranks[world][_name(kind, world, axis), "scales"]
    want = np.asarray(refs[kind, FRAMES[axis], "scales"])
    assert len(by_rank) == world and len(want) > 10
    for scales in by_rank:
        assert scales == by_rank[0]
        np.testing.assert_allclose(scales, want, rtol=SCALE_TOL, atol=0)
    # before the first GroupNorm spanning the ranks the split computes one
    # process's values, and a MAX gives one process's scale bit for bit
    exact = ranks[world][_name(kind, world, axis), "exact_sites"]
    if axis == 1:
        assert exact is None  # a frame split's GroupNorms stay local
    else:
        assert 0 < exact < len(want)
        assert by_rank[0][:exact] == want[:exact].tolist()


@pytest.mark.parametrize("kind,world,axis", CASES, ids=[_name(*c) for c in CASES])
def test_sharded_w8a8_sample(runs, kind, world, axis):
    ranks, refs = runs
    out = ranks[world][_name(kind, world, axis), "sample"]
    ref = refs[kind, FRAMES[axis], "sample"]
    assert tuple(out.shape) == tuple(ref.shape)
    assert _rel(out, ref) <= TOLERANCE, _rel(out, ref)


@pytest.mark.parametrize("kind,axis", [(k, a) for k in ("tv2v", "tvi2v") for a in (2, 3, 1)])
def test_census_of_a_w8a8_row(runs, kind, axis):
    ranks, refs = runs
    records = ranks[2][_name(kind, 2, axis), "census"]
    kinds = [r["kind"] for r in records]
    t = FRAMES[axis]
    # one amax all-reduce a per-tensor quantization, none for the dense layers
    assert kinds.count("amax_all_reduce") == len(refs[kind, t, "scales"])
    assert all(r["dtype"] == "torch.int32" and np.prod(r["shape"]) == 1 for r in records
               if r["kind"] == "amax_all_reduce")
    if axis == 1:
        assert set(kinds) <= {"all_to_all", "broadcast", "amax_all_reduce"}
        assert "all_to_all" in kinds
        return
    calls = refs[kind, t, "calls"]
    assert calls["int8_halo"] > 0
    for k, n in calls.items():
        assert kinds.count(k) == n, (k, kinds.count(k), n)
    assert set(kinds) <= {"int8_halo", "halo", "norm_all_reduce", "amax_all_reduce",
                          "kv_all_gather"}
    assert all(r["dtype"] == "torch.int8" for r in records if r["kind"] == "int8_halo")


@pytest.mark.parametrize("fault", ("own_amax", "amax_sum", "fused_local_norm", "int8_halo_zero"))
def test_planted_w8a8_faults_fail(runs, fault):
    ranks, refs = runs
    assert _rel(ranks[2]["fault", fault], refs["tvi2v", 3, "forward"]) > TOLERANCE
    by_rank = ranks[2]["fault scales", fault]
    assert (by_rank[0] != by_rank[1]) == (fault == "own_amax")
    if fault == "amax_sum":  # one wrong scale on every rank: the exact sites see it
        exact = ranks[2][_name("tvi2v", 2, 2), "exact_sites"]
        assert by_rank[0][:exact] != refs["tvi2v", 3, "scales"][:exact]


def test_external_statistics_form_is_the_sharded_chain(runs):
    ranks, _ = runs
    e = ranks[2]["external"]
    assert torch.equal(e["endpoint"], e["every"])  # the extremes decide the amax here
    assert torch.equal(e["q"], e["ref_q"]) and torch.equal(e["scale"], e["ref_scale"])
    assert e["ref_q"].abs().max() == 127


# ---------------------------------------------------------------------------
# the GroupNorms against flax's, at bf16
# ---------------------------------------------------------------------------
def _flax_group_norm(x, num_groups=32, eps=1e-5, gamma=None, beta=None):
    import flax.linen as fnn
    import jax.numpy as jnp

    mod = fnn.GroupNorm(num_groups=num_groups, epsilon=eps, dtype=jnp.bfloat16)
    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    return np.asarray(mod.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))


def _group_norm_case(shape, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    c = shape[-1]
    gamma = (1 + 0.1 * rs.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rs.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


def _bf16_statistics(x, gamma, beta, groups=32, eps=1e-5):
    """torch's CUDA GroupNorm of a bf16 channels-last x: the mean and rstd
    stored in bf16, the affine map from them in fp32, the output in bf16."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)
    mean = mean.to(torch.bfloat16).float()
    rstd = torch.rsqrt(var + torch.tensor(eps).to(torch.bfloat16).float()).to(
        torch.bfloat16).float()
    a = rstd.repeat_interleave(c // groups, 1) * gamma
    b = beta - a * mean.repeat_interleave(c // groups, 1)
    shape = (n,) + (1,) * (x.dim() - 2) + (c,)
    return (x.float() * a.reshape(shape) + b.reshape(shape)).to(torch.bfloat16)


@pytest.mark.parametrize("kind", ("image", "temporal", "dpt"))
def test_bf16_group_norm_keeps_flax_statistics(kind):
    from ccedit_tpu_torch.conditioning.annotators.dpt_midas import _GroupNorm
    from ccedit_tpu_torch.modules.layers import GroupNorm

    shape = {"image": (2, 17, 8, 320), "temporal": (16, 17, 320), "dpt": (2, 16, 24, 256)}[kind]
    x, gamma, beta = _group_norm_case(shape)
    ref = _flax_group_norm(x, gamma=gamma, beta=beta)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    c = shape[-1]
    if kind == "dpt":
        norm = _GroupNorm(32, c, eps=1e-5)
        run = lambda m, t: m(t.movedim(-1, 1)).movedim(1, -1)
    else:
        norm = GroupNorm(32, c, eps=1e-5, temporal=kind == "temporal")
        run = lambda m, t: m(t)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(gamma))
        norm.bias.copy_(torch.from_numpy(beta))
        out = run(norm, xb)
        bf16_stats = _bf16_statistics(xb, norm.weight, norm.bias)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == shape
    share = lambda y: float((y.float().numpy() != ref).mean())
    assert share(out) <= DIFFERING, share(out)
    assert share(bf16_stats) > 10 * DIFFERING  # the check sees bf16 statistics
