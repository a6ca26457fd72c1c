"""Data parallelism and ZeRO-1 on the CPU: two gloo ranks, each its own
process, against one process.  The tiny TV2V training engine
(``TV2V_TRAIN_CONFIG`` narrowed by a dotlist, CLIP at width 16, ucg off),
global batches of 2 synthetic 3-frame 64x64 clips, the draws (sigmas,
noise, VAE posterior noise) injected and sliced per rank.

* One step (``train_step`` with ``parallel.mesh.all_reduce_grads``), in
  four modes: plain AdamW, AdamW sharded (``make_optimizer(zero=True)``),
  2 accumulated batches, and the (stand-in) MiDaS hint.  The ranks'
  gradients and weights are identical, and, but for the MiDaS hint, equal
  at 1e-6 (of the largest gradient; absolute on the weights) to one process
  that runs the ranks' blocks as micro-batches of one accumulated step with
  plain AdamW (bit for bit but for the order of the accumulation's sums).  Against one
  process on the whole batch the gradient agrees at 1e-4 of its largest
  magnitude (measured 2.8e-5, and 6.3e-5 with accumulation, at
  ``unet.input_blocks_temporal.0.weight``): the CPU convolutions round a
  sample differently at batch 1 and batch 2, and the tiny network's
  temporal GroupNorms (a group is one channel x 3 frames) amplify it.  The
  weights after AdamW are not compared there: its first update, lr * g /
  (|g| + eps), turns that noise into a full step where g is ~0.  The other
  modes feed the ControlNet the clip itself (``IdentityEncoder``).  The
  MiDaS hint's min-max spans the global batch, as the JAX package's one SPMD
  program takes it: the ranks all-reduce its min and max
  (``parallel.mesh.data_parallel``), so the midas mode is held to the one
  process on the whole batch, not to the micro-batches, each of which
  normalises its own block.
* ``Trainer.fit`` under ZeRO at world 2: rank 0 alone writes the metrics
  (the loss the mean over the ranks, as the JAX step's global loss) and
  the checkpoint (its optimizer state consolidated), the LR is
  ``scale_learning_rate`` with the world size times the warm-up schedule,
  and a resume from it on both ranks continues the run (every Adam
  state's step counter goes on).
* ``cli/train.py`` under a torchrun environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` on localhost) with
  ``--mesh_data 2``: one run directory named by rank 0, two steps; and
  ``--mesh_data 2`` in a single process exits naming torchrun.

The ranks run ``_worker`` through ``python -c`` with their output in files,
each run bounded by a timeout; every process computes on one CPU thread.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ccedit_tpu_torch import config
from ccedit_tpu_torch.cli import train as train_cli
from ccedit_tpu_torch.data.dataset import DataLoader, SyntheticVideoDataset, collate
from ccedit_tpu_torch.modules.clip import CLIPTextModel
from ccedit_tpu_torch.parallel import mesh
from ccedit_tpu_torch.train.trainer import Trainer, TrainerConfig, scale_learning_rate

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
WORLD, GLOBAL_BS, SEED, LR = 2, 2, 3, 1e-4
NET = "model.params.network_config.params"
TINY = [f"{prefix}.{key}={value}" for prefix in (NET, f"{NET}.controlnet_config.params")
        for key, value in (("model_channels", 32), ("num_res_blocks", 1), ("num_heads", 2),
                           ("channel_mult", "[1,2]"), ("attention_resolutions", "[2,1]"),
                           ("context_dim", 16))] + [
    "model.params.first_stage_config.params.ddconfig.ch=32",
    "model.params.first_stage_config.params.ddconfig.num_res_blocks=1",
    "model.params.conditioner_config.params.emb_models.0.ucg_rate=0",
    "model.params.conditioner_config.params.emb_models.1.params.fake_annotator=true",
    "data.params.train.params.video_length=3",
    "data.params.train.params.resolution=[64,64]",
]
MODES = ("plain", "zero", "accum2", "midas")
SCHEDULE = config.TV2V_TRAIN_CONFIG["model"]["params"]["scheduler_config"]
IDENTITY_HINT = ["model.params.conditioner_config.params.emb_models.1.target="
                 "sgm.modules.encoders.modules.IdentityEncoder"]


def _narrow_clip():
    """CLIP at the tiny context width (a worker process's for good; ``_engine``
    puts the full one back)."""
    config.CLIPTextModel = lambda: CLIPTextModel(width=16, heads=2, layers=1)


def _engine(hint="identity"):
    overrides = TINY + (IDENTITY_HINT if hint == "identity" else [])
    clip_model = config.CLIPTextModel
    _narrow_clip()
    try:
        return train_cli.build_train_engine(
            config.apply_dotlist(config.TV2V_TRAIN_CONFIG, overrides), torch.device("cpu"), SEED)
    finally:
        config.CLIPTextModel = clip_model


def _global_batches():
    """Two global batches of 2 clips with their injected draws."""
    ds = SyntheticVideoDataset(n_items=4, num_frames=3, size_hw=(64, 64), seed=0)
    rs = np.random.RandomState(0)
    table = config.build_loss(config.TV2V_TRAIN_CONFIG["model"]["params"]["loss_fn_config"]
                              ).sigma_sampler.sigmas_np
    out = []
    for i in range(2):
        draws = {k: torch.from_numpy(rs.standard_normal((GLOBAL_BS, 3, 8, 8, 4)).astype(np.float32))
                 for k in ("noise", "vae_noise")}
        draws["sigmas"] = torch.from_numpy(table[[100 + 500 * i, 700 - 300 * i]])
        out.append((collate([ds[2 * i], ds[2 * i + 1]]), draws))
    return out


def _steps(rank, world, split="rank"):
    """Each mode's reduced gradients and the trainable weights after its
    step.  ``split`` "rank": this rank's block of the global batches;
    "micro": one process running every rank's block as a micro-batch of
    one accumulated step; "whole": one process on the whole batches."""
    engines = {hint: _engine(hint) for hint in ("identity", "midas")}
    init = {n: p.detach().clone() for n, p in engines["midas"].trainable_parameters().items()}
    blocks = {"rank": [mesh.batch_slice(GLOBAL_BS, rank, world)],
              "micro": [mesh.batch_slice(GLOBAL_BS, r, WORLD) for r in range(WORLD)],
              "whole": [slice(0, GLOBAL_BS)]}[split]
    results = {}
    for mode in MODES:
        eng = engines["midas" if mode == "midas" else "identity"]
        params = eng.trainable_parameters()
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(init[n])
                p.grad = None
        optimizer = eng.make_optimizer(LR, zero=mode == "zero" and split == "rank")
        grads = {}

        def reduce(ps):
            mesh.all_reduce_grads(ps)
            grads.update({n: p.grad.clone() for n, p in ps.items()})

        batches = _global_batches()[:2 if mode == "accum2" else 1]
        steps = [(batch, draws, block) for batch, draws in batches for block in blocks]
        for i, (batch, draws, block) in enumerate(steps):
            eng.train_step({k: v[block] for k, v in batch.items()}, optimizer,
                           accumulate=len(steps), apply=i == len(steps) - 1,
                           reduce_grads=reduce, **{k: v[block] for k, v in draws.items()})
        results[mode] = dict(grads=grads, init=init, params={
            n: p.detach().clone() for n, p in eng.trainable_parameters().items()})
    return results


def _fit(rank, world, tmp):
    """Two ZeRO steps with a checkpoint, then a resume to step 3."""
    def loader():
        return DataLoader(SyntheticVideoDataset(n_items=8, num_frames=3, size_hw=(64, 64), seed=0),
                          batch_size=GLOBAL_BS, seed=0, rank=rank, world=world)

    cfg = TrainerConfig(logdir=str(tmp / "run"), max_steps=2, ckpt_every=2, log_every=1,
                        seed=SEED, zero_sharding=True, base_lr=LR)
    schedule = config.build_lr_scheduler(SCHEDULE)
    first = Trainer(_engine(), cfg, schedule).fit(loader(), GLOBAL_BS, resume=False)
    eng = _engine()
    second = Trainer(eng, dataclasses.replace(cfg, max_steps=3), schedule).fit(
        loader(), GLOBAL_BS, resume=True)
    return dict(lr=first.lr, steps=(first.step, second.step), losses=first.losses + second.losses,
                params={n: p.detach().clone() for n, p in eng.trainable_parameters().items()})


def _worker(kind, rank, world, tmp):
    """One rank's part of a test, its results saved for the parent."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    if kind == "cli":  # torchrun's environment, through init_distributed
        _narrow_clip()
        train_cli.main(["--device", "cpu", "--mesh_data", str(world), "--name", "dp",
                        "--logdir", str(tmp / "logs"), "--max_steps", "2", "--ckpt_every", "2",
                        "--log_every", "1", "--synthetic_data", "--batch_size", str(GLOBAL_BS),
                        "--seed", str(SEED)] + TINY)
        dist.destroy_process_group()
        return
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=world)
    try:
        out = _steps(rank, world) if kind == "steps" else _fit(rank, world, tmp)
    finally:
        dist.destroy_process_group()
    torch.save(out, tmp / f"{kind}_rank{rank}.pt")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(kind, tmp, world=WORLD, timeout=150):
    tmp.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        if kind == "cli":
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]; "
                f"import test_torch_port_parallel as t; "
                f"t._worker({kind!r}, {rank}, {world}, {str(tmp)!r})")
        log = open(tmp / f"{kind}_rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                                       stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        assert proc.returncode == 0, (tmp / f"{kind}_rank{rank}.log").read_text()[-4000:]
    if kind != "cli":
        return [torch.load(tmp / f"{kind}_rank{r}.pt", weights_only=True) for r in range(world)]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    ranks = _spawn("steps", tmp_path_factory.mktemp("dp_steps"))
    return ranks, _steps(0, 1, "micro"), _steps(0, 1, "whole")


@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_equal_one_process(steps, mode):
    (rank0, rank1), micro, whole = steps
    r0, r1, ref = rank0[mode], rank1[mode], micro[mode]
    assert sorted(r0["grads"]) == sorted(ref["grads"]) and r0["grads"]
    scale = max(float(g.abs().max()) for g in ref["grads"].values())
    assert scale > 0
    for n, g in ref["grads"].items():
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
        if mode != "midas":  # the micro-batches normalise the hint per block
            torch.testing.assert_close(r0["grads"][n], g, rtol=0, atol=1e-6 * scale, msg=n)
    for n, p in ref["params"].items():
        assert torch.equal(r0["params"][n], r1["params"][n]), n
        if mode != "midas":
            torch.testing.assert_close(r0["params"][n], p, rtol=0, atol=1e-6, msg=n)
        assert not torch.equal(r0["params"][n], ref["init"][n]), n  # the step moved every tensor
    for n, g in whole[mode]["grads"].items():
        torch.testing.assert_close(r0["grads"][n], g, rtol=0, atol=1e-4 * scale, msg=n)


def test_zero_fit_checkpoints_on_rank_zero_and_resumes(tmp_path):
    rank0, rank1 = _spawn("fit", tmp_path)
    assert rank0["steps"] == rank1["steps"] == (2, 3)
    assert rank0["lr"] == rank1["lr"] == scale_learning_rate(LR, 1, WORLD, GLOBAL_BS)
    for n, p in rank0["params"].items():
        assert torch.equal(p, rank1["params"][n]), n
    run = tmp_path / "run"
    rows = [json.loads(r) for r in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]  # rank 0's rows alone
    # the logged loss is the global batch's: the mean over the ranks' blocks
    assert rank0["losses"] == rank1["losses"] == [r["loss"] for r in rows]
    # the LR schedule drives ZeRO's parameter groups, across the resume too
    schedule = config.build_lr_scheduler(SCHEDULE)
    np.testing.assert_allclose([r["lr"] for r in rows],
                               [rank0["lr"] * schedule(r["step"]) for r in rows], rtol=1e-12)
    ckpts = sorted(p.name for p in (run / "checkpoints").glob("*.pt"))
    assert ckpts == ["step_000000002.pt", "step_000000003.pt"]
    for step in (2, 3):
        state = torch.load(run / "checkpoints" / f"step_00000000{step}.pt", weights_only=True)
        opt = state["optimizer"]
        n_params = len(opt["param_groups"][0]["params"])
        assert n_params == len(state["trainable"]) == len(rank0["params"])
        # consolidated: every parameter's Adam state, the counters going on after the resume
        assert sorted(opt["state"]) == list(range(n_params))
        assert {int(s["step"]) for s in opt["state"].values()} == {step}
    for n, v in state["trainable"].items():
        assert torch.equal(v, rank0["params"][n]), n


def test_cli_under_torchrun_with_mesh_data(tmp_path):
    _spawn("cli", tmp_path)
    runs = list((tmp_path / "logs").iterdir())
    assert len(runs) == 1 and runs[0].name.endswith("_dp")
    rows = [json.loads(r) for r in (runs[0] / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert (runs[0] / "checkpoints" / "step_000000002.pt").exists()


def test_mesh_data_needs_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        train_cli.main(["--device", "cpu", "--mesh_data", "2"])


def test_batch_slice_and_loader_blocks():
    assert [mesh.batch_slice(8, r, 4) for r in range(4)] == [slice(0, 2), slice(2, 4),
                                                            slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not divide"):
        mesh.batch_slice(3, 0, 2)
    ds = SyntheticVideoDataset(n_items=8, num_frames=2, size_hw=(32, 32), seed=0)
    whole = [b["txt"] for b in DataLoader(ds, batch_size=4, seed=5)]
    blocks = [[b["txt"] for b in DataLoader(ds, batch_size=4, seed=5, rank=r, world=2)]
              for r in range(2)]
    assert [a + b for a, b in zip(*blocks)] == whole
    assert mesh.rank() == 0 and mesh.world_size() == 1
