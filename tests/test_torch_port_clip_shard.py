"""Single-clip sharding on the CPU: gloo ranks, each its own process, against
one process and against the JAX package.

The tiny TV2V and TVI2V networks (``__graft_entry__._TINY`` widths, CFCA
``center_self`` and the appearance ControlNet for TVI2V; seeded random JAX
weights mapped with ``from_jax``; fp32, plain attention) at 64x64 pixels (8x8
latents, two UNet levels).  At world 2 and 4, on the height axis (T = 3,
``pick_clip_axis``'s choice), the width axis (T = 3; at 8 latent rows
``pick_clip_axis`` picks the height, so these cases patch it) and the frame
axis (T = 4):

* one CFG-doubled network forward, the rank blocks gathered, against the
  port's one-process forward at 1e-5 of max|ref| and the JAX network at
  1e-4 (``docs/PARITY.md``);
* a 2-step DPM++2S-ancestral sample through ``make_frame_sharded_sample``
  with the JAX key schedule's draws injected (``init_noise``,
  ``loop_noise``; TVI2V with ``x_prior`` at prior_coefficient 0.3), the
  network in fp64 (the sampler state stays fp32), against the port's
  one-process ``engine.sample`` on the same fp64 network at 1e-5 and JAX's
  fp32 ``engine.sample`` at 1e-4 (JAX's sharded program is that program
  under GSPMD; compiling it for each case would take minutes); and at world
  2 a sample drawing from a generator against one process's: each rank
  draws the whole clip's noise and keeps its block.  The samples run the
  network in fp64 because CFG 7 amplifies rounding over the chain: the
  one-process fp32 TVI2V sample is itself 0.8e-5 of max|x| off its fp64
  run, so two fp32 chains compared at 1e-5 would compare rounding noise
  (the sharded forward rounds differently only in the GroupNorm: its
  statistics are summed per rank, 1.7e-7 of max|y| off the one-process
  norm); in fp64 the sharded sample is within 3.3e-6 (the attention's fp32
  scores) and equal on the frame axis.

At world 2, height axis: the halo convolution (stride 1 and 2, blocks of one
row, the width axis too), the image GroupNorm and the k/v-gathered
attention each against the one-process op at 1e-6 of max|ref|, the
token-sharded attention also against JAX's ``dot_product_attention`` under
``mesh_context`` on a 2- and 4-device mesh (``tests/test_parallel_sampling.py``'s
shapes); a census of one network row's collectives (halos exactly one per
k > 1 convolution call, norm all-reduces one per image GroupNorm call,
all-gathers two per clip-token attention call and k/v-shaped, no
all-to-all: the h-major fold is local) and of a frame-axis row (only
all-to-alls and broadcasts: no collective inside a spatial op); the three
planted faults of ``chip_smoke.clip_shard_fault`` (halos left out, the
GroupNorm on local statistics, k/v not gathered) must each fail the forward
check; and ``edit_clips(clip_shard=True)`` (every rank conditions the whole clip, rank
0 decodes) against the same edit in one process from the same generator
seed.

The ranks run ``_worker`` through ``python -c`` with a ``file://`` store, each
on one CPU thread, while this process computes the references.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
TINY = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(2, 1), channel_mult=(1, 2), num_heads=2,
            transformer_depth=1, context_dim=16)  # __graft_entry__._TINY
APPEARANCE = dict(hint_channels=4, input_hint_identity=True, no_add_x=True,
                  disable_text_ca=True)
STEPS, CFG, PIX, F = 2, 7.0, 64, 8
PRIOR_X, PRIOR_NOISE = 0.3, 0.9
FRAMES = {1: 4, 2: 3, 3: 3}  # T by axis: the frame axis needs T % world == 0
# (network, world, axis); axis 2 is pick_clip_axis's choice at T = 3
CASES = tuple((kind, world, axis) for world in (2, 4) for axis in (2, 3, 1)
              for kind in ("tv2v", "tvi2v"))
FAULTS = ("halo", "local_norm", "kv_local")
TIMEOUT = 240
TOLERANCE, JAX_TOLERANCE = 1e-5, 1e-4  # of max|ref|


def _name(kind, world, axis):
    return f"{kind}-w{world}-{ {1: 'frame', 2: 'height', 3: 'width'}[axis]}"


def port_network(kind):
    from ccedit_tpu_torch.modules import controlnet as tcn
    from ccedit_tpu_torch.modules import unet as tun

    cfca = dict(enable_attention3d_crossframe=True, st3dca_ca_type="center_self")
    unet = tun.UNetModel(unet_type="pseudo-3d", **(cfca if kind == "tvi2v" else {}), **TINY)
    img = tcn.ControlNet2D(**APPEARANCE, **TINY) if kind == "tvi2v" else None
    return tcn.CCEditNetwork(unet, tcn.ControlNet2D(hint_channels=3, **TINY), img).eval()


def port_engine(network):
    from ccedit_tpu_torch.conditioning.conditioner import Conditioner
    from ccedit_tpu_torch.diffusion import (DiscreteDenoiser, DPMPP2SAncestralSampler,
                                            LegacyDDPMDiscretization, VanillaCFG)
    from ccedit_tpu_torch.models.engine import CCEditEngine

    return CCEditEngine(network, DiscreteDenoiser(),
                        DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=STEPS),
                        Conditioner([]), guider=VanillaCFG(scale=CFG))


def make_inputs(kind, t, seed):
    """numpy inputs of one (network, T): a forward row and a sample."""
    rs = np.random.RandomState(seed)
    f32 = lambda *s: rs.standard_normal(s).astype(np.float32)
    hint = rs.uniform(-1, 1, (1, t, PIX, PIX, 3)).astype(np.float32)
    feat = f32(1, PIX // F, PIX // F, 4)
    shape = (1, t, PIX // F, PIX // F, 4)
    d = dict(shape=shape, x2=f32(2, *shape[1:]), ts=np.array([500.0, 320.0], np.float32),
             cond2={"crossattn": f32(2, 77, 16), "control_hint": np.concatenate([hint, hint])},
             c={"crossattn": f32(1, 77, 16), "control_hint": hint},
             uc={"crossattn": f32(1, 77, 16), "control_hint": hint},
             init_noise=f32(*shape), loop_noise=f32(STEPS, *shape))
    if kind == "tvi2v":
        d["cond2"]["cond_feat"] = np.concatenate([feat, feat])
        d["c"]["cond_feat"] = d["uc"]["cond_feat"] = feat
        d["x_prior"] = np.repeat(feat[:, None], t, axis=1)
    return d


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def sample_kwargs(d):
    kw = dict(init_noise=_t(d["init_noise"]), loop_noise=_t(d["loop_noise"]))
    if "x_prior" in d:
        kw.update(x_prior=_t(d["x_prior"]), prior_coefficient=PRIOR_X,
                  prior_noise_coefficient=PRIOR_NOISE)
    return kw


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _sharded_forward(net, d, axis):
    from ccedit_tpu_torch.parallel.sampling import gather_clip, shard_clip_cond
    from ccedit_tpu_torch.parallel.shard import ClipShard, mesh_context

    shard = ClipShard(axis, d["shape"][1], size=d["shape"][2:4])
    x = shard.block(_t(d["x2"]), axis)
    cond = shard_clip_cond(_t(d["cond2"]), d["x2"].shape, axis, shard.rank, shard.world)
    with mesh_context(shard), torch.no_grad():
        out = net(x, _t(d["ts"]), cond)
    return gather_clip(out, axis)


def _unit_ops(rank, world):
    """The halo convolution, the image GroupNorm and the gathered attention,
    sharded on H (and the conv on W), gathered, and two frame-split paths
    the networks above do not take; rank 0 returns them with the
    one-process ops'."""
    from ccedit_tpu_torch.modules.controlnet import ControlNet3D
    from ccedit_tpu_torch.modules.layers import Conv2d, GroupNorm
    from ccedit_tpu_torch.modules.transformer import CrossAttention, SpatialTransformer3D
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.ops.attention import dot_product_attention
    from ccedit_tpu_torch.parallel.sampling import gather_clip
    from ccedit_tpu_torch.parallel.shard import ClipShard, mesh_context

    torch.manual_seed(5)
    out = {}
    for name, k, stride, rows in (("conv3", 3, 1, world), ("conv3_s2", 3, 2, 2 * world),
                                  ("conv3_tall", 3, 1, 4 * world),
                                  ("conv3_s2_tall", 3, 2, 4 * world)):
        conv = Conv2d(4, 6, k, stride=stride, padding=k // 2)
        x = torch.randn(2, rows, rows, 4)
        for axis in (2, 3):
            shard = ClipShard(axis, 1, size=x.shape[1:3])
            with mesh_context(shard), torch.no_grad():
                y = conv(shard.block(x, axis - 1))
            with torch.no_grad():
                out[f"{name}_{'hw'[axis - 2]}"] = (gather_clip(y, axis - 1), conv(x))
    norm = GroupNorm(8, 32)
    with torch.no_grad():
        norm.weight.normal_()
        norm.bias.normal_()
    x = torch.randn(2, 2 * world, 6, 32) * 3 + 1.5
    shard = ClipShard(2, 1, size=x.shape[1:3])
    with mesh_context(shard), torch.no_grad():
        y = norm(shard.block(x, 1))
    with torch.no_grad():
        out["group_norm"] = (gather_clip(y, 1), norm(x))
    attn = CrossAttention(32, heads=2, dim_head=16, token_kv=True)
    x = torch.randn(2, 16 * world, 32)
    shard = ClipShard(2, 1, size=(4 * world, 4))  # the tokens of a 4 * world x 4 image
    with mesh_context(shard), torch.no_grad():
        y = attn(shard.block(x, 1))
    with torch.no_grad():
        out["attention"] = (gather_clip(y, 1), attn(x))
    # the token-sharded attention of tests/test_parallel_sampling.py
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(3, 2, 1024, 16).astype(np.float32)) for _ in range(3))
    tok = lambda a: a.permute(0, 2, 1, 3).reshape(3, 1024, 32)
    shard = ClipShard(2, 1, size=(32, 32))
    heads = lambda a: a.reshape(3, -1, 2, 16).permute(0, 2, 1, 3)
    kg, vg = (heads(shard.gather_tokens(shard.block(tok(a), 1))) for a in (k, v))
    y = dot_product_attention(shard.block(q, 2), kg, vg)
    out["token_attention"] = (gather_clip(y, 2), dot_product_attention(q, k, v))
    # the int8 switch: q quantized over this rank's block, k over the
    # gathered k, as under the JAX package's shard_map
    attn = CrossAttention(80, heads=2, dim_head=40, token_kv=True)
    x = torch.randn(1, 512 * world, 80)
    shard = ClipShard(2, 1, size=(16 * world, 32))
    att.set_quantized_qk(True)
    try:
        with mesh_context(shard), torch.no_grad():
            y = attn(shard.block(x, 1))
        with torch.no_grad():
            ref = torch.cat([attn(x.narrow(1, 512 * r, 512), context=x) for r in range(world)], 1)
            q = attn.to_q(x[:, :512]).view(1, 512, 2, 40).transpose(1, 2)
            k = attn.to_k(x).view(1, -1, 2, 40).transpose(1, 2)
            assert att.quantizes(q, k)
    finally:
        att.set_quantized_qk(False)
    with torch.no_grad():
        out["int8_attention"] = (gather_clip(y, 1), ref)
        out["int8_is_not_exact"] = _rel(ref, attn(x))
    # frame split: temporal text cross-attention (its context rows cut to
    # the rank's block of the fold) and ControlNet3D's centre frame
    t = 2 * world
    frame = ClipShard(1, t, size=(4, 4))
    st = SpatialTransformer3D(32, 2, 16, context_dim=16, disable_temporal_text_ca=False)
    cn3 = ControlNet3D(hint_channels=4, disable_temporal=True, **TINY)
    for m in (st, cn3):
        with torch.no_grad():
            for prm in m.parameters():
                prm.normal_(0.0, 0.2)
    x, ctx = torch.randn(2, t, 4, 4, 32), torch.randn(2, 77, 16)
    z, hint, ts = torch.randn(2, t, 8, 8, 4), torch.randn(2, t, 8, 8, 4), torch.tensor([5.0, 9.0])
    with torch.no_grad():
        with mesh_context(frame):
            y = st(frame.block(x, 1), context=ctx)
            taps = cn3(frame.block(z, 1), frame.block(hint, 1), ts, context=ctx)
        out["temporal_text_ca"] = (gather_clip(y, 1), st(x, context=ctx))
        out["controlnet3d_centre"] = (torch.cat([a.flatten() for a in taps]),
                                      torch.cat([a.flatten() for a in cn3(z, hint, ts,
                                                                          context=ctx)]))
    return out if rank == 0 else None


def _edit(net, rank, world):
    """``edit_clips`` with ``clip_shard``: each rank conditions the whole
    clip (CLIP and the luminance depth stand-in), the sample is split, rank
    0 decodes; rank 0 then edits in one process from the same generator
    seed.  The network in fp64, as the samples above."""
    from ccedit_tpu_torch.cli.pipeline import edit_clips
    from ccedit_tpu_torch.conditioning.annotators.base import AnnotatorEmbedder
    from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
    from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder
    from ccedit_tpu_torch.modules.clip import CLIPTextModel
    from ccedit_tpu_torch.modules.vae import AutoencoderKL

    torch.manual_seed(3)
    engine = port_engine(net)
    engine.conditioner = Conditioner([
        EmbedderSpec(CLIPTextEmbedder(CLIPTextModel(width=16, heads=2, layers=1)), "txt"),
        EmbedderSpec(AnnotatorEmbedder("depth_midas", allow_fake=True), "control_hint")])
    engine.vae = AutoencoderKL(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1).eval()
    frames = np.random.RandomState(4).randint(0, 256, (3, PIX, PIX, 3)).astype(np.uint8)

    def run(shard):
        return edit_clips(engine, frames, "a robot bear", "ugly", CFG, STEPS,
                          torch.Generator().manual_seed(9), clip_shard=shard)

    out, latents = run(True)
    if rank != 0:  # only rank 0 decodes
        assert out is None
        return None
    one_out, one_latents = run(False)
    return dict(out=out, latents=latents, one_out=one_out, one_latents=one_latents)


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
    nets, nets64 = {}, {}
    for kind in ("tv2v", "tvi2v"):
        nets[kind] = port_network(kind)
        nets[kind].load_state_dict(data["weights"][kind])
        nets64[kind] = copy.deepcopy(nets[kind]).double()
    res = {}
    for kind, w, axis in CASES:
        if w != world:
            continue
        d = data["inputs"][(kind, FRAMES[axis])]
        name = _name(kind, world, axis)
        res[name, "forward"] = _sharded_forward(nets[kind], d, axis)
        pick = sampling.pick_clip_axis
        if axis == 3:  # T = 3 and H = 8 pick the height: force the width
            sampling.pick_clip_axis = lambda world, shape: 3
        try:
            call = make_frame_sharded_sample(port_engine(nets64[kind]), d["shape"], STEPS)
        finally:
            sampling.pick_clip_axis = pick
        assert call.axis == axis, (call.axis, axis)
        res[name, "sample"] = gather_clip(call(_t(d["c"]), _t(d["uc"]), **sample_kwargs(d)),
                                          axis)
    if world == 2:
        d = data["inputs"][("tv2v", 3)]
        call = make_frame_sharded_sample(port_engine(nets64["tv2v"]), d["shape"], STEPS)
        res["generator"] = gather_clip(call(_t(d["c"]), _t(d["uc"]),
                                            generator=torch.Generator().manual_seed(11)), 2)
        for fault in FAULTS:
            with chip_smoke.clip_shard_fault(fault):
                res["fault", fault] = _sharded_forward(nets["tvi2v"], data["inputs"][("tvi2v", 3)],
                                                       2)
        for kind in ("tv2v", "tvi2v"):
            for axis in (2, 1):
                with census() as records:
                    _sharded_forward(nets[kind], data["inputs"][(kind, FRAMES[axis])], axis)
                res["census", kind, axis] = records
        res["units"] = _unit_ops(rank, world)
        res["edit"] = _edit(nets64["tv2v"], rank, world)
    dist.destroy_process_group()
    if rank == 0:
        torch.save(res, tmp / f"ranks{world}.pt")


def _spawn(world, tmp):
    procs = []
    for rank in range(world):
        code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]; "
                f"import test_torch_port_clip_shard as t; t._worker({world}, {rank}, "
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
def _jax_side(seed=40):
    """The JAX networks and engines with seeded random params, the port's
    weights mapped from them, and every input."""
    import jax
    import jax.numpy as jnp

    from ccedit_tpu.conditioning.conditioner import Conditioner as JaxConditioner
    from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
    from ccedit_tpu.diffusion import LegacyDDPMDiscretization as JaxDisc
    from ccedit_tpu.diffusion import make_sampler
    from ccedit_tpu.diffusion.guidance import VanillaCFG as JaxCFG
    from ccedit_tpu.models.engine import CCEditEngine as JaxEngine
    from ccedit_tpu.modules import controlnet as jcn
    from ccedit_tpu.modules import unet as jun
    from ccedit_tpu_torch.io.jax_params import from_jax

    rs = np.random.RandomState(seed)

    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        x = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (x * 0.1 + (1.0 if leaf == "scale" else 0.0)).astype(np.float32)

    out = {"jax": {}, "weights": {}}
    for kind in ("tv2v", "tvi2v"):
        cfca = dict(enable_attention3d_crossframe=True, st3dca_ca_type="center_self")
        jnet = jcn.CCEditNetwork(
            unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True,
                               **(cfca if kind == "tvi2v" else {}), **TINY),
            controlnet=jcn.ControlNet2D(hint_channels=3, **TINY),
            controlnet_img=jcn.ControlNet2D(**APPEARANCE, **TINY) if kind == "tvi2v" else None)
        cond = {"crossattn": jnp.zeros((1, 77, 16)),
                "control_hint": jnp.zeros((1, 3, PIX, PIX, 3))}
        if kind == "tvi2v":
            cond["cond_feat"] = jnp.zeros((1, PIX // F, PIX // F, 4))
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 3, PIX // F, PIX // F, 4)), jnp.zeros((1,)), cond)
        params = jax.tree_util.tree_map_with_path(draw, shapes)["params"]
        jeng = JaxEngine(network=jnet, denoiser=JaxDenoiser(scaling="eps", weighting="eps"),
                         sampler=make_sampler("dpmpp_2s_ancestral", discretization=JaxDisc(),
                                              num_steps=STEPS),
                         conditioner=JaxConditioner([]), vae=None, guider=JaxCFG(scale=CFG))
        net = port_network(kind)
        sd = {f"unet.{k}": v for k, v in from_jax("unet", params["unet"]).items()}
        sd.update({f"controlnet.{k}": v
                   for k, v in from_jax("controlnet", params["controlnet"]).items()})
        if kind == "tvi2v":
            sd.update({f"controlnet_img.{k}": v
                       for k, v in from_jax("controlnet", params["controlnet_img"]).items()})
        net.load_state_dict(sd)
        out["weights"][kind] = net.state_dict()
        out["jax"][kind] = (jnet, jeng, params)
    out["inputs"] = {(kind, t): make_inputs(kind, t, seed=100 + 10 * t + (kind == "tvi2v"))
                     for kind in ("tv2v", "tvi2v") for t in (3, 4)}
    return out


def _references(side):
    """The port's one-process forwards and samples, with counts of the calls
    a census must match; then JAX's."""
    import jax
    import jax.numpy as jnp

    from ccedit_tpu_torch.modules.layers import Conv2d, GroupNorm
    from ccedit_tpu_torch.modules.transformer import CrossAttention

    refs = {}
    for (kind, t), d in side["inputs"].items():
        net = port_network(kind)
        net.load_state_dict(side["weights"][kind])
        calls = {"halo": 0, "norm_all_reduce": 0, "kv_all_gather": 0}

        def hook(mod, *_):
            if isinstance(mod, Conv2d) and mod.kernel_size != (1, 1):
                calls["halo"] += 1
            elif isinstance(mod, GroupNorm) and not mod.temporal:
                calls["norm_all_reduce"] += 1
            elif isinstance(mod, CrossAttention) and mod.token_kv:
                calls["kv_all_gather"] += 2

        handles = [m.register_forward_hook(hook) for m in net.modules()]
        with torch.no_grad():
            refs[kind, t, "forward"] = net(_t(d["x2"]), _t(d["ts"]), _t(d["cond2"]))
        for h in handles:
            h.remove()
        refs[kind, t, "calls"] = calls
        engine = port_engine(copy.deepcopy(net).double())
        refs[kind, t, "sample"] = engine.sample(_t(d["c"]), _t(d["uc"]), d["shape"],
                                                num_steps=STEPS, **sample_kwargs(d))
        if (kind, t) == ("tv2v", 3):
            refs["generator"] = engine.sample(_t(d["c"]), _t(d["uc"]), d["shape"],
                                              num_steps=STEPS,
                                              generator=torch.Generator().manual_seed(11))
        jnet, jeng, params = side["jax"][kind]
        jx = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
        refs[kind, t, "jax_forward"] = np.asarray(jnet.apply(
            {"params": params}, jnp.asarray(d["x2"]), jnp.asarray(d["ts"]), jx(d["cond2"])))
        kw = dict(init_noise=jnp.asarray(d["init_noise"]),
                  loop_noise=jnp.asarray(d["loop_noise"]))
        if "x_prior" in d:
            kw.update(x_prior=jnp.asarray(d["x_prior"]), prior_coefficient=PRIOR_X,
                      prior_noise_coefficient=PRIOR_NOISE)
        refs[kind, t, "jax_sample"] = np.asarray(jeng.sample(
            {"network": params}, jx(d["c"]), jx(d["uc"]), d["shape"], jax.random.PRNGKey(1),
            num_steps=STEPS, **kw))
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clip_shard")
    side = _jax_side()
    torch.save({"weights": side["weights"], "inputs": side["inputs"]}, tmp / "inputs.pt")
    procs = {world: _spawn(world, tmp) for world in (2, 4)}
    refs = _references(side)
    return {world: _join(p, world, tmp) for world, p in procs.items()}, refs


def _rel(out, ref) -> float:
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(np.asarray(out, dtype=np.float64) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("kind,world,axis", CASES, ids=[_name(*c) for c in CASES])
def test_sharded_forward_and_sample(runs, kind, world, axis):
    ranks, refs = runs
    t = FRAMES[axis]
    name = _name(kind, world, axis)
    for what in ("forward", "sample"):
        out = ranks[world][name, what]
        assert tuple(out.shape) == tuple(refs[kind, t, what].shape)
        assert np.abs(refs[kind, t, what].numpy()).max() > 0.1  # real work
        assert _rel(out, refs[kind, t, what]) <= TOLERANCE, (what, _rel(out, refs[kind, t, what]))
        assert _rel(out, refs[kind, t, f"jax_{what}"]) <= JAX_TOLERANCE, what


def test_edit_clips_with_clip_shard(runs):
    ranks, _ = runs
    e = ranks[2]["edit"]
    assert e["out"].dtype == np.uint8 and e["out"].shape == e["one_out"].shape == (1, 3, PIX,
                                                                                   PIX, 3)
    assert _rel(e["latents"], e["one_latents"]) <= TOLERANCE
    assert np.abs(e["out"].astype(int) - e["one_out"].astype(int)).max() <= 1


def test_generator_draws_do_not_depend_on_the_world(runs):
    ranks, refs = runs
    assert _rel(ranks[2]["generator"], refs["generator"]) <= TOLERANCE


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_forward_check(runs, fault):
    ranks, refs = runs
    assert _rel(ranks[2]["fault", fault], refs["tvi2v", 3, "forward"]) > TOLERANCE


@pytest.mark.parametrize("kind", ("tv2v", "tvi2v"))
def test_census_of_a_row(runs, kind):
    ranks, refs = runs
    height = ranks[2]["census", kind, 2]
    kinds = [r["kind"] for r in height]
    want = refs[kind, 3, "calls"]
    for k, n in want.items():
        assert kinds.count(k) == n, (k, kinds.count(k), n)
    assert "all_to_all" not in kinds and "broadcast" not in kinds  # the fold is local
    gathers = [r for r in height if r["kind"] == "kv_all_gather"]
    assert gathers and all(len(r["shape"]) == 3 and r["shape"][-1] % 16 == 0 for r in gathers)
    assert all(r["bytes"] == int(np.prod(r["shape"])) * 4 for r in gathers)  # (world-1) blocks
    frame = {r["kind"] for r in ranks[2]["census", kind, 1]}
    assert frame <= {"all_to_all", "broadcast"} and "all_to_all" in frame
    assert ("broadcast" in frame) == (kind == "tvi2v")


@pytest.mark.parametrize("op", ("conv3_h", "conv3_w", "conv3_s2_h", "conv3_s2_w",
                                "conv3_tall_h", "conv3_tall_w", "conv3_s2_tall_h",
                                "conv3_s2_tall_w", "group_norm", "attention",
                                "token_attention", "int8_attention", "temporal_text_ca",
                                "controlnet3d_centre"))
def test_sharded_ops_equal_one_process(runs, op):
    ranks, _ = runs
    out, ref = ranks[2]["units"][op]
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 1e-6
    if op == "int8_attention":  # the switch really quantized
        assert ranks[2]["units"]["int8_is_not_exact"] > 1e-4


@pytest.mark.parametrize("world", (2, 4))
def test_token_sharded_attention_matches_jax_mesh_context(world):
    import jax
    import jax.numpy as jnp

    from ccedit_tpu.ops.attention import dot_product_attention as jdpa
    from ccedit_tpu.ops.attention import mesh_context as jmesh
    from ccedit_tpu.parallel.mesh import make_mesh
    from ccedit_tpu_torch.ops.attention import dot_product_attention
    from ccedit_tpu_torch.parallel.shard import ClipShard

    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(3, 2, 1024, 16).astype(np.float32) for _ in range(3))
    plan = make_mesh(jax.devices()[:world], data=world, model=1)
    with jmesh(plan.mesh):
        ref = np.asarray(jax.jit(jdpa)(*map(jnp.asarray, (q, k, v))))
    blocks = []
    for rank in range(world):  # each rank's queries against the gathered k/v
        shard = ClipShard(2, 1, size=(32, 32))  # 1024 tokens of a 32 x 32 image
        shard.rank, shard.world = rank, world
        blocks.append(dot_product_attention(shard.block(_t(q), 2), _t(k), _t(v)))
    assert _rel(torch.cat(blocks, dim=2), ref) <= 1e-5


def test_pick_clip_axis_and_shard_clip_cond_match_jax():
    import jax
    import jax.numpy as jnp

    from ccedit_tpu.parallel import sampling as jsampling
    from ccedit_tpu.parallel.mesh import make_mesh
    from ccedit_tpu_torch.parallel import sampling

    for world in (1, 2, 4, 8):
        plan = make_mesh(jax.devices()[:world], data=world, model=1)
        for shape in ((1, 17, 64, 96, 4), (1, 16, 64, 96, 4), (1, 3, 6, 8, 4), (2, 5, 8, 8, 4),
                      (1, 3, 5, 8, 4)):
            try:
                want = jsampling.pick_clip_axis(plan, shape)
            except ValueError:
                with pytest.raises(ValueError):
                    sampling.pick_clip_axis(world, shape)
                continue
            assert sampling.pick_clip_axis(world, shape) == want
    rs = np.random.RandomState(2)
    shape = (1, 4, 8, 8, 4)
    cond = {"control_hint": rs.randn(1, 4, 64, 64, 3).astype(np.float32),
            "control_hint_features": rs.randn(1, 4, 8, 8, 32).astype(np.float32),
            "concat": rs.randn(1, 4, 8, 8, 4).astype(np.float32),
            "crossattn": rs.randn(1, 77, 16).astype(np.float32),
            "cond_feat": rs.randn(1, 8, 8, 4).astype(np.float32)}
    for world, axis in ((2, 1), (4, 2), (2, 3)):
        plan = make_mesh(jax.devices()[:world], data=world, model=1)
        placed = jsampling.shard_clip_cond(plan, {k: jnp.asarray(v) for k, v in cond.items()},
                                           shape, axis)
        for rank in range(world):
            ours = sampling.shard_clip_cond(_t(cond), shape, axis, rank, world)
            for key, arr in placed.items():
                shard = next(s for s in arr.addressable_shards
                             if s.device == plan.mesh.devices.flat[rank])
                np.testing.assert_array_equal(ours[key].numpy(), np.asarray(shard.data))
