"""What single-clip sharding's collectives cost a network row, on the cards.

    torchrun --nproc_per_node 4 -m ccedit_tpu_torch.scripts.clip_collectives [--workload tvi2v]
        [--w8a8]

Every rank builds the full-width engine of the edit (``profile_tv2v.build_edit``:
seeded random weights, bf16) and runs one CFG-doubled network row of the
17x512x768 clip (``--frames``) split over the ranks on ``pick_clip_axis``'s
axis, the ControlNet's hint pyramid computed once beforehand, as the sampler
hoists it; with ``--w8a8`` the row runs W8A8 (``CCEDIT_QUANT_MATMUL=1``:
int8 halos, the per-tensor amax all-reduces).  Rank 0 prints one JSON line
with

* ``row_seconds`` and ``row_seconds_without``: the medians of ``--rows``
  rows each (host clock around a row that ends in a device synchronise,
  every rank starting together), the second with the halo exchanges, the
  GroupNorm all-reduces and the amax all-reduces replaced by zero rows,
  local statistics and the local amax (wrong numbers, the same compute),
  the two taken in turns (with,
  without, without, with, ...) after a warm-up of each: the difference is
  what those collectives cost end to end, waiting included;
* ``isolated_seconds_per_row``: every collective that one row issues
  (``parallel/shard.py::census``), replayed alone by kind at its recorded
  shape and received bytes, every rank starting together, timed with CUDA
  events: the transfer and latency without the compute or the ranks' skew.
  A halo (bf16 or, under W8A8, int8) is replayed as its rows: ``before``
  to the next rank and ``after`` to the previous, as ``ClipShard.halo``
  sends them; an amax all-reduce as a MAX over one int32 word.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import subprocess
import time

import torch
import torch.distributed as dist

from ..parallel.shard import ClipShard

H, W = 512, 768


def _row(engine, device, t: int, seed: int):
    from ..parallel.sampling import pick_clip_axis, shard_clip_cond
    from ..parallel.shard import ClipShard, mesh_context

    rank, world = dist.get_rank(), dist.get_world_size()
    dtype = engine.network_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((2, t, H // 8, W // 8, 4), generator=gen, device=device).to(dtype)
    ts = torch.tensor([500.0, 500.0], device=device)
    cond = {"crossattn": torch.randn((2, 77, 768), generator=gen, device=device).to(dtype),
            "control_hint": (torch.rand((2, t, H, W, 3), generator=gen, device=device) * 2
                             - 1).to(dtype)}
    axis = pick_clip_axis(world, (1, t, H // 8, W // 8, 4))
    shard = ClipShard(axis, t)
    xb = shard.block(x, axis).contiguous()
    cb = shard_clip_cond(cond, x.shape, axis, rank, world)
    with mesh_context(shard), torch.no_grad():
        cb["control_hint_features"] = engine.network.encode_control_hint(cb.pop("control_hint"))

    def row():
        with mesh_context(shard), torch.no_grad():
            return engine.network(xb, ts, cb)

    return row, shard


def _timed(fn) -> float:
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@contextlib.contextmanager
def _without_halo_and_norm_collectives():
    halo, stats, amax = ClipShard.halo, ClipShard.all_reduce_stats, ClipShard.all_reduce_amax
    ClipShard.halo = lambda self, x, dim, before, after: torch.cat(
        [torch.zeros_like(x.narrow(dim, 0, before)), x,
         torch.zeros_like(x.narrow(dim, 0, after))], dim=dim)
    ClipShard.all_reduce_stats = lambda self, s: s.mul_(self.world)
    ClipShard.all_reduce_amax = lambda self, word: word
    try:
        yield
    finally:
        ClipShard.halo, ClipShard.all_reduce_stats = halo, stats
        ClipShard.all_reduce_amax = amax


def _rows_in_turns(row, n: int) -> tuple:
    """Median seconds of ``row`` with and without the halo and norm
    collectives, in turns."""
    variants = {"with": contextlib.nullcontext, "without": _without_halo_and_norm_collectives}
    times = {k: [] for k in variants}
    for k, ctx in variants.items():  # warm-up
        with ctx():
            row()
    for i in range(n):
        for k in (("with", "without") if i % 2 == 0 else ("without", "with")):
            with variants[k]():
                times[k].append(_timed(row))
    return statistics.median(times["with"]), statistics.median(times["without"])


def _replay(records, shard, device) -> dict:
    """Seconds of each kind's collectives, replayed alone."""
    by_kind = collections.defaultdict(list)
    for r in records:
        by_kind[r["kind"]].append(r)
    rank, world = shard.rank, shard.world
    out = {}
    for kind, recs in sorted(by_kind.items()):
        bufs = []
        for r in recs:
            dtype = getattr(torch, r["dtype"].split(".")[-1])
            if kind in ("halo", "int8_halo"):  # rows for the next rank (before), the previous
                bufs.append([torch.zeros(n * r["row"], dtype=dtype, device=device)
                             for n in r["rows"]])
            else:
                bufs.append(torch.zeros(r["shape"], dtype=dtype, device=device))

        def run():
            for b in bufs:
                if kind in ("halo", "int8_halo"):
                    ops = []
                    for send, recv_from, to in ((b[0], rank - 1, rank + 1),
                                                (b[1], rank + 1, rank - 1)):
                        if send.numel() and 0 <= recv_from < world:
                            ops.append(dist.P2POp(dist.irecv, torch.empty_like(send), recv_from))
                        if send.numel() and 0 <= to < world:
                            ops.append(dist.P2POp(dist.isend, send, to))
                    for work in dist.batch_isend_irecv(ops):
                        work.wait()
                elif kind == "norm_all_reduce":
                    dist.all_reduce(b)
                elif kind == "amax_all_reduce":
                    dist.all_reduce(b, op=dist.ReduceOp.MAX)
                elif kind == "kv_all_gather":
                    dist.all_gather_into_tensor(
                        b.new_empty((world * b.shape[0],) + tuple(b.shape[1:])), b)
                elif kind == "all_to_all":
                    dist.all_to_all_single(torch.empty_like(b), b)
                else:
                    dist.broadcast(b, 0)

        run()  # warm-up
        dist.barrier()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        out[kind] = dict(count=len(recs), seconds=start.elapsed_time(end) / 1e3,
                         mb_received=sum(r["bytes"] for r in recs) / 1e6)
    return out


def main(argv=None) -> None:
    from ..cli.profile_tv2v import build_edit, int8_environment
    from ..parallel.mesh import init_distributed
    from ..parallel.shard import AXES, census

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=("tv2v", "tvi2v"), default="tv2v")
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--w8a8", action="store_true", help="the row under CCEDIT_QUANT_MATMUL=1")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("clip_collectives needs a CUDA device")
    device = init_distributed("cuda")
    if not dist.is_initialized():
        raise SystemExit("run it under torchrun")
    engine, _, _ = build_edit(a.workload, device, a.seed, 1)
    with int8_environment(**({"CCEDIT_QUANT_MATMUL": "1"} if a.w8a8 else {})):
        row, shard = _row(engine, device, a.frames, a.seed)
        row_s, without = _rows_in_turns(row, a.rows)
        with census() as records:
            row()
    torch.cuda.synchronize()
    isolated = _replay(records, shard, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    dist.destroy_process_group()
    if rank != 0:
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"gpu": smi.splitlines()[0], "workload": a.workload, "world": world,
                      "w8a8": a.w8a8,
                      "axis": AXES[shard.axis], "frames": a.frames, "rows": a.rows,
                      "row_seconds": row_s, "row_seconds_without": without,
                      "isolated_seconds_per_row": isolated}))


if __name__ == "__main__":
    main()
