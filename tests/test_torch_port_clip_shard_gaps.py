"""Single-clip sharding where the clip does not divide, on the CPU: gloo
ranks, each its own process, against one process and against the JAX
package (``test_torch_port_clip_shard.py``'s harness and tiny networks).

A UNet level whose rows do not divide over the ranks lies in GSPMD's
layout, blocks of ceil(R / world) rows with the padding at the clip's tail
(``parallel/shard.py``).  The cases, each a CFG-doubled forward (fp32,
gathered) against the port's one process at 1e-5 of max|ref| and the JAX
network at 1e-4 (``docs/PARITY.md``), and a 2-step DPM++2S-ancestral sample
through ``make_frame_sharded_sample`` (the network in fp64, the JAX key
schedule's draws injected) against one process at 1e-5 and JAX's
``engine.sample`` at 1e-4:

* a padded level on the height axis, (1, 3, 6, 8, 4) at world 2 (level 1:
  3 rows in blocks of 2), TV2V and TVI2V (the CFCA's two gathered
  segments);
* a rank holding only padding, (1, 3, 12, 8, 4) at world 4 (level 1: 6
  rows in blocks of 2, rank 3 all padding);
* a padded level feeding a padded level: a 3-level UNet
  (``channel_mult=(1, 2, 2)``) at (1, 3, 12, 8, 4), world 4;
* the width axis, (1, 3, 6, 12, 4) at world 4 (``pick_clip_axis``'s
  choice: 6 rows do not divide);
* padded temporal rows on the frame axis, (1, 4, 6, 6, 4) at world 4
  (level 1: 2 x 3 x 3 = 18 rows in blocks of 5);
* the interpolation network on the frame axis at T = 4, world 2 and 4
  (the first and the last frame on two ranks);
* RAIG's 2-D network on the height axis, (1, 6, 8, 4) at world 2, and on
  the width axis, (1, 6, 12, 4) at world 4.

W8A8 at a padded level (the fp64 networks, ``test_torch_port_w8a8_clip_shard``'s
``same_arithmetic``): the forward against one process at 1e-5, every
per-tensor scale equal on the ranks and to one process at 1e-12, and the
sample against one process.  (JAX's one-process W8A8 forward is held to
the port's in ``test_torch_port_w8a8_clip_shard.py``; run eagerly, as its
int8 codes need, it takes over a minute a shape.)  Blending at T = 4 on
the frame axis (the sampler's pre-step hook moves frames between ranks),
at world 2 and at world 4 (a frame a rank), against one process and JAX's
sampler, and at T = 6, where both raise.
``kv_reuse_every`` n = 2 and n = 3 under a frame split (n = 3 reads across
samples) against one process and JAX's ``CrossAttention``; a temporal
text cross-attention on padded frame-axis rows against one process.  The census: at
a divisible shape exactly the unpadded one (no "reblock", no other kind),
at a padded shape "reblock" only at the level transitions whose blocks do
not halve, each moving rows; at the divisible shape the forward is bit for
bit the one with the padding logic short-circuited.  The planted faults ``pad_unmasked``,
``pad_counted`` and (W8A8) ``pad_amax`` of ``chip_smoke.clip_shard_fault``
each fail the forward check; ``blend_local`` (blending's hook on each
rank's own frames: at world 4, one frame a rank, it silently moves none)
fails the blending sample and ``interp_local`` (the interpolation controls
added on every rank) the interpolation forward, at world 2 and 4.  ``pick_clip_axis`` against the JAX one on 4-D
shapes too.
"""

import copy
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_clip_shard import (APPEARANCE, CFG, F, PRIOR_NOISE, PRIOR_X, STEPS, TINY,
                                        _jax_side, _rel, _t, port_engine, port_network)

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
TINY3 = dict(TINY, channel_mult=(1, 2, 2))
# (name, network, latent shape, world, dim of the latent split)
CASES = (
    ("height-pad", "tv2v", (1, 3, 6, 8, 4), 2, 2),
    ("height-pad-tvi2v", "tvi2v", (1, 3, 6, 8, 4), 2, 2),
    ("only-padding", "tv2v", (1, 3, 12, 8, 4), 4, 2),
    ("pad-into-pad", "tv2v3", (1, 3, 12, 8, 4), 4, 2),
    ("width-pad", "tvi2v", (1, 3, 6, 12, 4), 4, 3),
    ("frame-pad", "tvi2v", (1, 4, 6, 6, 4), 4, 1),
    ("interp-frame-w2", "interp", (1, 4, 8, 8, 4), 2, 1),
    ("interp-frame-w4", "interp", (1, 4, 8, 8, 4), 4, 1),
    ("raig-height", "raig", (1, 6, 8, 4), 2, 1),
    ("raig-width", "raig", (1, 6, 12, 4), 4, 2),
)
W8A8_CASES = (
    ("w8a8-height-pad", "tv2v", (1, 3, 6, 8, 4), 2, 2),
    ("w8a8-only-padding", "tvi2v", (1, 3, 12, 8, 4), 4, 2),
    ("w8a8-frame-pad", "tv2v", (1, 4, 6, 6, 4), 4, 1),
)
DIVISIBLE = ("divisible", "tv2v", (1, 3, 8, 8, 4), 2, 2)
# blending on the frame axis, (world, T): T = 6 raises on both sides; at world 4
# each rank holds one frame
BLEND = ((2, 4), (2, 6), (4, 4))
REUSE = (2, 3)  # kv_reuse_every under a frame split of (3 samples x 4 frames)
PAD_FAULTS = ("pad_unmasked", "pad_counted")  # in the exact forward; pad_amax under W8A8
SAMPLE_FAULTS = ("blend_local", "interp_local")  # blending at T = 4; the interpolation forward
# the cases held to JAX too: each network's forward at one padded split (the
# others are its one process at another split, which the forward check
# holds), samples on each new path (JAX compiles each shape anew: seconds)
JAX_FORWARDS = ("height-pad", "width-pad", "pad-into-pad", "interp-frame-w4", "raig-width")
JAX_SAMPLES = ("height-pad", "frame-pad", "raig-height")
TIMEOUT = 240
TOLERANCE, JAX_TOLERANCE, SCALE_TOL = 1e-5, 1e-4, 1e-12


# ---------------------------------------------------------------------------
# networks and inputs
# ---------------------------------------------------------------------------
def _jax_network(kind):
    from ccedit_tpu.modules import controlnet as jcn
    from ccedit_tpu.modules import unet as jun

    if kind == "raig":
        return jcn.CCEditNetwork(unet=jun.UNetModel(unet_type="2d", enable_ref_attn=True, **TINY),
                                 controlnet_img=jcn.ControlNet2D(**APPEARANCE, **TINY), raig=True)
    tiny = TINY3 if kind == "tv2v3" else TINY
    return jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **tiny),
        controlnet=jcn.ControlNet2D(hint_channels=3, **tiny),
        controlnet_img=jcn.ControlNet2D(**APPEARANCE, **TINY) if kind == "interp" else None,
        interpolate=kind == "interp")


def net_of(kind):
    """The port's network of ``kind`` (the two of the clip-shard test, the
    3-level TV2V, the interpolation and the RAIG network), untrained."""
    from ccedit_tpu_torch.modules import controlnet as tcn
    from ccedit_tpu_torch.modules import unet as tun

    if kind in ("tv2v", "tvi2v"):
        return port_network(kind)
    if kind == "raig":
        return tcn.CCEditNetwork(tun.UNetModel(unet_type="2d", enable_ref_attn=True, **TINY),
                                 None, tcn.ControlNet2D(**APPEARANCE, **TINY), raig=True).eval()
    tiny = TINY3 if kind == "tv2v3" else TINY
    img = tcn.ControlNet2D(**APPEARANCE, **TINY) if kind == "interp" else None
    return tcn.CCEditNetwork(tun.UNetModel(unet_type="pseudo-3d", **tiny),
                             tcn.ControlNet2D(hint_channels=3, **tiny), img,
                             interpolate=kind == "interp").eval()


def make_inputs(kind, shape, seed):
    """numpy inputs of one (network, latent shape): a forward row and a
    sample."""
    rs = np.random.RandomState(seed)
    f32 = lambda *s: rs.standard_normal(s).astype(np.float32)
    image = len(shape) == 4
    h, w = shape[1:3] if image else shape[2:4]
    d = dict(shape=shape, x2=f32(2, *shape[1:]), ts=np.array([500.0, 320.0], np.float32),
             init_noise=f32(*shape), loop_noise=f32(STEPS, *shape))
    ctx = {"crossattn": f32(2, 77, 16)}
    if not image:
        hint = rs.uniform(-1, 1, (2, shape[1], h * F, w * F, 3)).astype(np.float32)
        ctx["control_hint"] = hint
    if kind in ("tvi2v", "raig"):
        ctx["cond_feat"] = f32(2, h, w, 4)
    if kind == "interp":
        ctx["interpolate_first_last"] = f32(2, 2, h, w, 4)
    d["cond2"] = ctx
    d["uc"] = {k: v[:1] for k, v in ctx.items()}
    d["c"] = {k: v[1:] for k, v in ctx.items()}
    if kind == "tvi2v":
        d["x_prior"] = np.repeat(ctx["cond_feat"][1:, None], shape[1], axis=1)
    return d


def sample_kwargs(d):
    kw = dict(init_noise=_t(d["init_noise"]), loop_noise=_t(d["loop_noise"]))
    if "x_prior" in d:
        kw.update(x_prior=_t(d["x_prior"]), prior_coefficient=PRIOR_X,
                  prior_noise_coefficient=PRIOR_NOISE)
    return kw


def _t64(tree):
    if isinstance(tree, dict):
        return {k: _t64(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float64)) if isinstance(tree, np.ndarray) else tree


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _shard_of(shape, dim):
    from ccedit_tpu_torch.parallel.shard import ClipShard

    image = len(shape) == 4
    return ClipShard(dim + image, 1 if image else shape[1],
                     size=shape[1:3] if image else shape[2:4])


def _forward(net, d, dim, cast=_t):
    from ccedit_tpu_torch.parallel.sampling import gather_clip, shard_clip_cond
    from ccedit_tpu_torch.parallel.shard import mesh_context

    shard = _shard_of(d["shape"], dim)
    x = shard.block(cast(d["x2"]), dim)
    cond = shard_clip_cond(cast(d["cond2"]), d["x2"].shape, dim, shard.rank, shard.world)
    with mesh_context(shard), torch.no_grad():
        out = net(x, _t(d["ts"]), cond)
    return gather_clip(out, dim)


def _sample(net, d, dim):
    from ccedit_tpu_torch.parallel.sampling import gather_clip, make_frame_sharded_sample

    call = make_frame_sharded_sample(port_engine(net), d["shape"], STEPS)
    assert call.axis == dim, (call.axis, dim)
    return gather_clip(call(_t(d["c"]), _t(d["uc"]), **sample_kwargs(d)), dim)


def _every_rank(value):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _blend_sampler():
    """Euler-ancestral: the JAX sampler that injects a pre-step hook's draws."""
    from ccedit_tpu_torch.diffusion import LegacyDDPMDiscretization
    from ccedit_tpu_torch.diffusion.samplers import EulerAncestralSampler

    return EulerAncestralSampler(LegacyDDPMDiscretization(), num_steps=STEPS)


def _blend(net, d, world):
    """The blending sampler on the frame axis: each rank's block of x and
    x0, the conditioning cut like them; the gathered latents, or the
    error's type."""
    from ccedit_tpu_torch.parallel.sampling import gather_clip, shard_clip_cond
    from ccedit_tpu_torch.parallel.shard import ClipShard, mesh_context

    engine = port_engine(net)
    sampler = _blend_sampler()
    shard = ClipShard(1, d["shape"][1], size=d["shape"][2:4])
    block = lambda a: shard.block(_t(a), 1)
    c = shard_clip_cond(_t(d["c"]), d["shape"], 1, shard.rank, world)
    uc = shard_clip_cond(_t(d["uc"]), d["shape"], 1, shard.rank, world)
    rows = {k: shard.block(_t(v), 2) for k, v in d["blend_noise"].items()}
    try:
        with mesh_context(shard), torch.no_grad():
            out = sampler.sampling_blending(engine.make_denoise_fn(c, uc),
                                                   block(d["init_noise"]), block(d["x0"]),
                                                   num_steps=STEPS, noise_override=rows)
    except RuntimeError as e:
        return type(e).__name__
    return gather_clip(out, 1)


def _reuse(attn, x, n, world):
    from ccedit_tpu_torch.parallel.shard import ClipShard, mesh_context

    b, t = 3, 4
    shard = ClipShard(1, t, size=(2, 3))  # 6 tokens a frame
    xb = shard.block(x.view(b, t, *x.shape[1:]), 1).reshape(-1, *x.shape[1:])
    with mesh_context(shard), torch.no_grad():
        y = attn(xb, kv_reuse_every=n)
    parts = [torch.empty_like(y) for _ in range(world)]
    import torch.distributed as dist

    dist.all_gather(parts, y)
    per = t // world
    return torch.stack([p.view(b, per, *y.shape[1:]) for p in parts], 1).reshape(x.shape)


def _temporal_text_ca(world):
    """A transformer whose temporal blocks read the text context, one copy
    per (h, b, w) row, on the frame axis where 2 x 3 x 3 rows do not divide
    the world (the context's rows padded like the fold's), gathered, with
    the one-process block on the same inputs."""
    from ccedit_tpu_torch.modules.transformer import SpatialTransformer3D
    from ccedit_tpu_torch.parallel.sampling import gather_clip
    from ccedit_tpu_torch.parallel.shard import ClipShard, mesh_context

    torch.manual_seed(7)
    st = SpatialTransformer3D(32, 2, 16, context_dim=16, disable_temporal_text_ca=False)
    with torch.no_grad():
        for prm in st.parameters():
            prm.normal_(0.0, 0.2)
    x, ctx = torch.randn(2, world, 3, 3, 32), torch.randn(2, 77, 16)
    frame = ClipShard(1, world, size=(3, 3))
    with torch.no_grad():
        with mesh_context(frame):
            y = st(frame.block(x, 1), context=ctx)
        return gather_clip(y, 1), st(x, context=ctx)


def _worker(world, rank, tmp):
    import torch.distributed as dist

    import chip_smoke
    import test_torch_port_w8a8_clip_shard as w8
    from ccedit_tpu_torch.modules.transformer import CrossAttention
    from ccedit_tpu_torch.parallel.shard import census
    from ccedit_tpu_torch.scripts.clip_collectives import _padding_logic_short_circuited

    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / f'store{world}'}", rank=rank,
                            world_size=world)
    data = torch.load(tmp / "inputs.pt", weights_only=False)
    nets = {}
    for kind, sd in data["weights"].items():
        nets[kind] = net_of(kind)
        nets[kind].load_state_dict(sd)
    nets64 = {k: copy.deepcopy(n).double() for k, n in nets.items()}
    res = {}
    for name, kind, shape, w, dim in CASES:
        if w == world:
            d = data["inputs"][name]
            with census() as records:
                res[name, "forward"] = _forward(nets[kind], d, dim)
            res[name, "census"] = records
            res[name, "sample"] = _sample(nets64[kind], d, dim)
    with w8.same_arithmetic(data["embeddings"]):
        for name, kind, shape, w, dim in W8A8_CASES:
            if w == world:
                d = data["inputs"][name]
                with w8.recorded_scales() as scales:
                    res[name, "forward"] = _forward(nets64[kind], d, dim, _t64)
                res[name, "scales"] = _every_rank(scales["scales"])
                res[name, "sample"] = _sample(nets64[kind], d, dim)
        if world == 2:
            d = data["inputs"]["w8a8-height-pad"]
            with chip_smoke.clip_shard_fault("pad_amax"):
                res["fault", "pad_amax"] = _forward(nets64["tv2v"], d, 2, _t64)
    for w, t in BLEND:
        if w == world:
            res["blend", t] = _blend(nets64["tv2v"], data["inputs"]["blend", t], world)
    with chip_smoke.clip_shard_fault("blend_local"):
        res["fault", "blend_local"] = _blend(nets64["tv2v"], data["inputs"]["blend", 4], world)
    with chip_smoke.clip_shard_fault("interp_local"):
        res["fault", "interp_local"] = _forward(nets["interp"],
                                                data["inputs"][f"interp-frame-w{world}"], 1)
    res["temporal_text_ca"] = _temporal_text_ca(world)
    attn = CrossAttention(16, 2, 8)
    attn.load_state_dict(data["attention"])
    for n in REUSE:
        res["reuse", n] = _reuse(attn, _t(data["reuse_x"]), n, world)
    if world == 2:
        for fault in PAD_FAULTS:
            with chip_smoke.clip_shard_fault(fault):
                res["fault", fault] = _forward(nets["tv2v"], data["inputs"]["height-pad"], 2)
        name, kind, shape, _, dim = DIVISIBLE
        with census() as records:
            res[name, "forward"] = _forward(nets[kind], data["inputs"][name], dim)
        res[name, "census"] = records
        with _padding_logic_short_circuited():
            res[name, "short_circuited"] = _forward(nets[kind], data["inputs"][name], dim)
    dist.destroy_process_group()
    if rank == 0:
        torch.save(res, tmp / f"ranks{world}.pt")


def _spawn(world, tmp):
    procs = []
    for rank in range(world):
        code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]; "
                f"import test_torch_port_clip_shard_gaps as t; t._worker({world}, {rank}, "
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
def _fill(shapes, rs):
    import jax

    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if leaf == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_engine(jnet):
    from ccedit_tpu.conditioning.conditioner import Conditioner as JaxConditioner
    from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
    from ccedit_tpu.diffusion import LegacyDDPMDiscretization as JaxDisc
    from ccedit_tpu.diffusion import make_sampler
    from ccedit_tpu.diffusion.guidance import VanillaCFG as JaxCFG
    from ccedit_tpu.models.engine import CCEditEngine as JaxEngine

    return JaxEngine(network=jnet, denoiser=JaxDenoiser(scaling="eps", weighting="eps"),
                     sampler=make_sampler("dpmpp_2s_ancestral", discretization=JaxDisc(),
                                          num_steps=STEPS),
                     conditioner=JaxConditioner([]), vae=None, guider=JaxCFG(scale=CFG))


def _side():
    """Every network's JAX params and the port's weights mapped from them,
    and every input."""
    import jax
    import jax.numpy as jnp

    from ccedit_tpu_torch.io.jax_params import from_jax

    base = _jax_side()
    side = {"jax": dict(base["jax"]), "weights": dict(base["weights"])}
    rs = np.random.RandomState(41)
    for kind in ("tv2v3", "interp", "raig"):
        jnet = _jax_network(kind)
        x = jnp.zeros((1, 8, 8, 4) if kind == "raig" else (1, 3, 8, 8, 4))
        cond = {"crossattn": jnp.zeros((1, 77, 16))}
        if kind == "raig":
            cond["cond_feat"] = jnp.zeros((1, 8, 8, 4))
        else:
            cond["control_hint"] = jnp.zeros((1, 3, 64, 64, 3))
        if kind == "interp":
            cond["interpolate_first_last"] = jnp.zeros((1, 2, 8, 8, 4))
        params = _fill(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, jnp.zeros((1,)),
                                      cond), rs)["params"]
        net = net_of(kind)
        sd = {f"unet.{k}": v for k, v in from_jax("unet", params["unet"]).items()}
        for part in ("controlnet", "controlnet_img"):
            if part in params:
                sd.update({f"{part}.{k}": v for k, v in from_jax("controlnet",
                                                                  params[part]).items()})
        net.load_state_dict(sd)
        side["weights"][kind] = net.state_dict()
        side["jax"][kind] = (jnet, _jax_engine(jnet), params)
    inputs = {}
    for i, (name, kind, shape, _, _) in enumerate(CASES + W8A8_CASES + (DIVISIBLE,)):
        inputs[name] = make_inputs(kind, shape, seed=200 + i)
    for t in sorted({t for _, t in BLEND}):
        d = make_inputs("tv2v", (1, t, 8, 8, 4), seed=300 + t)
        d["x0"] = np.random.RandomState(310 + t).standard_normal(d["shape"]).astype(np.float32)
        rs2 = np.random.RandomState(320 + t)
        d["blend_noise"] = {k: rs2.standard_normal((STEPS,) + d["shape"]).astype(np.float32)
                            for k in ("loop", "pre")}
        inputs["blend", t] = d
    side["inputs"] = inputs
    return side


def _reuse_side():
    """CrossAttention with seeded JAX params mapped to the port's, and its
    input: 3 samples x 4 frames of 6 tokens."""
    import jax
    import jax.numpy as jnp

    from ccedit_tpu.modules import transformer as jtr
    from ccedit_tpu_torch.modules.transformer import CrossAttention

    rs = np.random.RandomState(42)
    x = rs.standard_normal((12, 6, 16)).astype(np.float32)
    jm = jtr.CrossAttention(query_dim=16, heads=2, dim_head=8)
    params = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), rs)["params"]
    attn = CrossAttention(16, 2, 8)
    sd = {}
    for name in ("to_q", "to_k", "to_v"):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(params[name]["kernel"]).T.copy())
    out = params["to_out_0"] if "to_out_0" in params else params["to_out"]
    sd["to_out.0.weight"] = torch.from_numpy(np.asarray(out["kernel"]).T.copy())
    sd["to_out.0.bias"] = torch.from_numpy(np.asarray(out["bias"]).copy())
    attn.load_state_dict(sd)
    return jm, params, attn, x


def _calls(net, run):
    """``run()``'s calls of the modules a census counts: k > 1 convolutions
    (halos), image GroupNorms (norm all-reduces), clip-token attentions (two
    k/v all-gathers), and the resampling blocks' inputs (their rows on the
    split axis: dim 1 of an image, 2 of a clip)."""
    from ccedit_tpu_torch.modules.blocks import Downsample, Downsample3D, Upsample, Upsample3D
    from ccedit_tpu_torch.modules.layers import Conv2d, GroupNorm
    from ccedit_tpu_torch.modules.transformer import CrossAttention

    calls = {"halo": 0, "norm_all_reduce": 0, "kv_all_gather": 0, "resamples": []}

    def hook(mod, args, *_):
        if isinstance(mod, Conv2d) and mod.kernel_size != (1, 1):
            calls["halo"] += 1
        elif isinstance(mod, GroupNorm) and not mod.temporal:
            calls["norm_all_reduce"] += 1
        elif isinstance(mod, CrossAttention) and mod.token_kv:
            calls["kv_all_gather"] += 2
        elif isinstance(mod, (Downsample, Downsample3D, Upsample, Upsample3D)):
            x = args[0]
            calls["resamples"].append((isinstance(mod, (Upsample, Upsample3D)),
                                       tuple(x.shape[-3:-1])))

    handles = [m.register_forward_hook(hook) for m in net.modules()]
    try:
        out = run()
    finally:
        for h in handles:
            h.remove()
    return out, calls


def _references(side, embeddings):
    import jax
    import jax.numpy as jnp

    import test_torch_port_w8a8_clip_shard as w8
    from ccedit_tpu.diffusion import LegacyDDPMDiscretization as JaxDisc
    from ccedit_tpu.diffusion import make_sampler

    refs = {}
    jx = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    nets = {}
    for kind, sd in side["weights"].items():
        nets[kind] = net_of(kind)
        nets[kind].load_state_dict(sd)
    for name, kind, shape, _, _ in CASES + (DIVISIBLE,):
        d = side["inputs"][name]
        net = nets[kind]
        with torch.no_grad():
            refs[name, "forward"], refs[name, "calls"] = _calls(
                net, lambda: net(_t(d["x2"]), _t(d["ts"]), _t(d["cond2"])))
        jnet, jeng, params = side["jax"][kind]
        if name in JAX_FORWARDS:
            refs[name, "jax_forward"] = np.asarray(jax.jit(jnet.apply)(
                {"params": params}, jnp.asarray(d["x2"]), jnp.asarray(d["ts"]),
                jx(d["cond2"])))
        if name == DIVISIBLE[0]:
            continue
        engine = port_engine(copy.deepcopy(net).double())
        refs[name, "sample"] = engine.sample(_t(d["c"]), _t(d["uc"]), shape, num_steps=STEPS,
                                             **sample_kwargs(d))
        if name not in JAX_SAMPLES:
            continue
        kw = dict(init_noise=jnp.asarray(d["init_noise"]),
                  loop_noise=jnp.asarray(d["loop_noise"]))
        if "x_prior" in d:
            kw.update(x_prior=jnp.asarray(d["x_prior"]), prior_coefficient=PRIOR_X,
                      prior_noise_coefficient=PRIOR_NOISE)
        refs[name, "jax_sample"] = np.asarray(jeng.sample(
            {"network": params}, jx(d["c"]), jx(d["uc"]), shape, jax.random.PRNGKey(1),
            num_steps=STEPS, **kw))
    with w8.same_arithmetic(embeddings):
        for name, kind, shape, _, _ in W8A8_CASES:
            d = side["inputs"][name]
            net = copy.deepcopy(nets[kind]).double()
            with w8.recorded_scales() as scales, torch.no_grad():
                refs[name, "forward"] = net(_t64(d["x2"]), _t(d["ts"]), _t64(d["cond2"]))
            refs[name, "scales"] = scales["scales"]
            refs[name, "sample"] = port_engine(net).sample(
                _t(d["c"]), _t(d["uc"]), shape, num_steps=STEPS, **sample_kwargs(d))
    for t in sorted({t for _, t in BLEND}):
        d = side["inputs"]["blend", t]
        engine = port_engine(copy.deepcopy(nets["tv2v"]).double())
        jnet, jeng, params = side["jax"]["tv2v"]
        jsampler = make_sampler("euler_ancestral", discretization=JaxDisc(), num_steps=STEPS)
        try:
            with torch.no_grad():
                refs["blend", t] = _blend_sampler().sampling_blending(
                    engine.make_denoise_fn(_t(d["c"]), _t(d["uc"])), _t(d["init_noise"]),
                    _t(d["x0"]), num_steps=STEPS, noise_override=_t(d["blend_noise"]))
        except RuntimeError as e:
            refs["blend", t] = type(e).__name__
        try:
            refs["jax_blend", t] = np.asarray(jsampler.sampling_blending(
                jeng.make_denoise_fn({"network": params}, jx(d["c"]), jx(d["uc"])),
                jnp.asarray(d["init_noise"]), jax.random.PRNGKey(2), jnp.asarray(d["x0"]),
                STEPS, noise_override=jx(d["blend_noise"])))
        except (TypeError, ValueError) as e:  # jnp's set of a mismatched shape
            refs["jax_blend", t] = type(e).__name__
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import test_torch_port_w8a8_clip_shard as w8

    tmp = tmp_path_factory.mktemp("clip_shard_gaps")
    side = _side()
    embeddings = w8._embeddings(side)
    jm, params, attn, x = _reuse_side()
    torch.save({"weights": side["weights"], "inputs": side["inputs"], "embeddings": embeddings,
                "attention": attn.state_dict(), "reuse_x": x}, tmp / "inputs.pt")
    procs = {world: _spawn(world, tmp) for world in (2, 4)}
    refs = _references(side, embeddings)
    import jax.numpy as jnp

    for n in REUSE:
        with torch.no_grad():
            refs["reuse", n] = attn(_t(x), kv_reuse_every=n)
        refs["jax_reuse", n] = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                                   kv_reuse_every=n))
    return {world: _join(p, world, tmp) for world, p in procs.items()}, refs


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kind,shape,world,dim", CASES, ids=[c[0] for c in CASES])
def test_padded_forward_and_sample(runs, name, kind, shape, world, dim):
    ranks, refs = runs
    for what in ("forward", "sample"):
        out, ref = ranks[world][name, what], refs[name, what]
        assert tuple(out.shape) == tuple(ref.shape)
        assert np.abs(ref.numpy()).max() > 0.1  # real work
        assert _rel(out, ref) <= TOLERANCE, (what, _rel(out, ref))
        if (name, f"jax_{what}") in refs:
            assert _rel(out, refs[name, f"jax_{what}"]) <= JAX_TOLERANCE, what
    assert (name in JAX_FORWARDS) == ((name, "jax_forward") in refs)


def _reblocks_wanted(calls, world, dim):
    """The level transitions whose blocks do not halve (or double): (rows,
    (from, to)) of each reblock, in call order."""
    ceil = lambda a, b: -(-a // b)
    want = []
    for up, hw in calls["resamples"]:
        rows = hw[dim - 2]
        block = ceil(rows, world)
        if up:
            to = ceil(2 * rows, world)
            if to != 2 * block:
                want.append((2 * rows, (2 * block, to)))
        else:
            to = 2 * ceil(ceil(rows, 2), world)
            if to != block:
                want.append((rows, (block, to)))
    return want


@pytest.mark.parametrize("name,kind,shape,world,dim",
                         [c for c in CASES if c[4] in (2, 3) and len(c[2]) == 5] + [DIVISIBLE],
                         ids=[c[0] for c in CASES if c[4] in (2, 3) and len(c[2]) == 5]
                         + [DIVISIBLE[0]])
def test_census_reblocks_only_where_blocks_do_not_halve(runs, name, kind, shape, world, dim):
    ranks, refs = runs
    records = ranks[world][name, "census"]
    calls = refs[name, "calls"]
    kinds = [r["kind"] for r in records]
    for k in ("halo", "norm_all_reduce", "kv_all_gather"):
        assert kinds.count(k) == calls[k], (k, kinds.count(k), calls[k])
    assert set(kinds) <= {"halo", "norm_all_reduce", "kv_all_gather", "reblock"}
    got = [(r["rows"], r["blocks"]) for r in records if r["kind"] == "reblock"]
    assert got == _reblocks_wanted(calls, world, dim)
    if name == DIVISIBLE[0]:
        assert got == []  # exactly the unpadded census
    else:
        assert got  # at least one transition touches a padded level here
    if name == "pad-into-pad":  # levels 1 (6 rows) and 2 (3 rows) both padded, 2:1 blocks
        assert all(rows == 12 for rows, _ in got)


def test_padding_logic_is_inert_where_levels_divide(runs):
    """At a divisible shape the row is bit for bit the one with the shard's
    padding logic short-circuited to "no padding" (what
    ``scripts/clip_collectives.py`` times on the cards)."""
    ranks, _ = runs
    name = DIVISIBLE[0]
    assert torch.equal(ranks[2][name, "forward"], ranks[2][name, "short_circuited"])


def test_frame_census_pads_the_temporal_rows(runs):
    ranks, _ = runs
    kinds = {r["kind"] for r in ranks[4]["frame-pad", "census"]}
    assert kinds <= {"all_to_all", "broadcast"} and "all_to_all" in kinds


@pytest.mark.parametrize("name,kind,shape,world,dim", W8A8_CASES, ids=[c[0] for c in W8A8_CASES])
def test_padded_w8a8(runs, name, kind, shape, world, dim):
    ranks, refs = runs
    out, ref = ranks[world][name, "forward"], refs[name, "forward"]
    assert out.dtype == torch.float64 and tuple(out.shape) == tuple(ref.shape)
    assert _rel(out, ref) <= TOLERANCE, _rel(out, ref)
    by_rank, want = ranks[world][name, "scales"], np.asarray(refs[name, "scales"])
    assert len(by_rank) == world and len(want) > 10
    for scales in by_rank:
        assert scales == by_rank[0]
        np.testing.assert_allclose(scales, want, rtol=SCALE_TOL, atol=0)
    assert _rel(ranks[world][name, "sample"], refs[name, "sample"]) <= TOLERANCE


@pytest.mark.parametrize("fault", PAD_FAULTS + ("pad_amax",))
def test_planted_padding_faults_fail(runs, fault):
    ranks, refs = runs
    ref = refs["w8a8-height-pad" if fault == "pad_amax" else "height-pad", "forward"]
    assert _rel(ranks[2]["fault", fault], ref) > TOLERANCE


@pytest.mark.parametrize("world,t", BLEND)
def test_blending_on_the_frame_axis(runs, world, t):
    ranks, refs = runs
    out, ref = ranks[world]["blend", t], refs["blend", t]
    if t % 4:  # T / 2 - 1 frames onto T / 2: the one-process hook raises, as does the split's
        assert isinstance(ref, str) and out == ref
        assert isinstance(refs["jax_blend", t], str)
        return
    assert _rel(out, ref) <= TOLERANCE
    assert _rel(out, refs["jax_blend", t]) <= JAX_TOLERANCE


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("fault", SAMPLE_FAULTS)
def test_planted_sample_faults_fail(runs, fault, world):
    """Blending's hook on each rank's own frames raises at two frames a rank
    (it moves one frame onto none) and at one frame a rank silently moves
    nothing; the interpolation controls added on every rank's first and
    last frame.  Each leaves the one-process result."""
    ranks, refs = runs
    out = ranks[world]["fault", fault]
    if fault == "blend_local" and world == 2:
        assert out == "RuntimeError"
        return
    ref = refs["blend", 4] if fault == "blend_local" else refs[f"interp-frame-w{world}", "forward"]
    assert tuple(out.shape) == tuple(ref.shape)
    assert _rel(out, ref) > 1e-2, _rel(out, ref)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("n", REUSE)
def test_kv_reuse_on_the_frame_axis(runs, n, world):
    ranks, refs = runs
    out = ranks[world]["reuse", n]
    assert _rel(out, refs["reuse", n]) <= TOLERANCE
    assert _rel(out, refs["jax_reuse", n]) <= JAX_TOLERANCE


@pytest.mark.parametrize("world", (2, 4))
def test_temporal_text_context_on_padded_rows(runs, world):
    ranks, _ = runs
    out, ref = ranks[world]["temporal_text_ca"]
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 1e-6


def test_pick_clip_axis_matches_jax_on_images_and_clips():
    import jax

    from ccedit_tpu.parallel import sampling as jsampling
    from ccedit_tpu.parallel.mesh import make_mesh
    from ccedit_tpu_torch.parallel import sampling

    for world in (1, 2, 4, 8):
        plan = make_mesh(jax.devices()[:world], data=world, model=1)
        for shape in ((1, 6, 8, 4), (1, 6, 12, 4), (1, 5, 7, 4), (2, 64, 96, 4), (1, 72, 128, 4),
                      (1, 17, 72, 128, 4), (1, 16, 40, 72, 4), (1, 3, 12, 8, 4), (1, 3, 6, 12, 4)):
            try:
                want = jsampling.pick_clip_axis(plan, shape)
            except ValueError:
                with pytest.raises(ValueError):
                    sampling.pick_clip_axis(world, shape)
                continue
            assert sampling.pick_clip_axis(world, shape) == want


def test_levels_and_blocks_of_a_padded_split():
    """The layout's arithmetic on one rank's view: 576x1024 (72 x 128
    latent rows and columns) at 4 ranks, level 3 (9 rows in blocks of 3:
    rank 3 all padding)."""
    from ccedit_tpu_torch.parallel.shard import ClipShard

    shard = ClipShard(2, 17, size=(72, 128))
    shard.world = 4
    for rank, valid in enumerate((3, 3, 3, 0)):
        shard.rank = rank
        x = torch.zeros(2, 3, 16, 8)  # level 3: 16 columns
        pad = shard.padding(x)
        assert (pad.rows, pad.block, pad.valid) == (9, 3, valid)
        assert shard.level_rows(torch.zeros(2, 18, 128, 8), 1) == 72
        assert shard.padding(torch.zeros(2, 18, 128, 8)) is None  # level 0 divides
        assert shard.padding(torch.zeros(2, 9, 64, 8)) is None  # level 1: 36 rows
        assert shard.token_level(5 * 32) == (18, 5, 32)  # level 2: 18 rows in blocks of 5
        assert shard.token_level(9 * 64) is None
    with pytest.raises(ValueError):
        shard.level_rows(torch.zeros(2, 4, 16, 8), 1)  # no level of this latent
    assert math.prod(shard.padding(torch.zeros(2, 3, 16, 8)).lead) == 6
