"""What single-clip sharding's collectives cost a network row, on the cards.

    torchrun --nproc_per_node 4 -m ccedit_tpu_torch.scripts.clip_collectives [--workload tvi2v]
        [--w8a8] [--height 576 --width 1024]

Every rank builds the full-width engine of the edit (``profile_tv2v.build_edit``:
seeded random weights, bf16) and runs one CFG-doubled network row of the
17x512x768 clip (``--frames``, ``--height``, ``--width``) split over the
ranks on ``pick_clip_axis``'s
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
  sends them; an amax all-reduce as a MAX over one int32 word; a reblock
  (a padded level's transition, ``ClipShard.reblock``) as its rows to and
  from each peer it trades with;
* ``padding_logic``: the row as it runs against the row with the shard's
  padding logic (``ClipShard.padding``, ``level_rows``, ``token_level``,
  ``fold_padding``, which every conv, GroupNorm, k/v gather and temporal
  fold consults) short-circuited to its answers where every level divides
  (no padding, blocks of R / world rows): the two rows' largest difference
  and, where it is 0 (no level of the shape is padded), the two taken in
  turns as above, each variant's median and every row's host seconds to
  issue it (until the row returns, before the synchronise) and wall
  seconds: what the padding logic costs a row that needs none.
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


def _row(engine, device, t: int, seed: int, h: int, w: int):
    from ..parallel.sampling import pick_clip_axis, shard_clip_cond
    from ..parallel.shard import ClipShard, mesh_context

    rank, world = dist.get_rank(), dist.get_world_size()
    dtype = engine.network_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((2, t, h // 8, w // 8, 4), generator=gen, device=device).to(dtype)
    ts = torch.tensor([500.0, 500.0], device=device)
    cond = {"crossattn": torch.randn((2, 77, 768), generator=gen, device=device).to(dtype),
            "control_hint": (torch.rand((2, t, h, w, 3), generator=gen, device=device) * 2
                             - 1).to(dtype)}
    axis = pick_clip_axis(world, (1, t, h // 8, w // 8, 4))
    shard = ClipShard(axis, t, size=(h // 8, w // 8))
    xb = shard.block(x, axis).contiguous()
    cb = shard_clip_cond(cond, x.shape, axis, rank, world)
    with mesh_context(shard), torch.no_grad():
        cb["control_hint_features"] = engine.network.encode_control_hint(cb.pop("control_hint"))

    def row():
        with mesh_context(shard), torch.no_grad():
            return engine.network(xb, ts, cb)

    return row, shard


def _timed(fn) -> tuple:
    """(host seconds until ``fn`` returns, wall seconds until the device is
    done), every rank starting together."""
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued, time.perf_counter() - t0


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


@contextlib.contextmanager
def _padding_logic_short_circuited():
    """The shard's padding logic answering as at a shape whose every level
    divides: no padding anywhere, a level's rows its block times the world."""
    saved = {k: getattr(ClipShard, k)
             for k in ("padding", "level_rows", "token_level", "fold_padding")}
    ClipShard.padding = lambda self, x: None
    ClipShard.level_rows = lambda self, x, dim: x.shape[dim] * self.world
    ClipShard.token_level = lambda self, n_tokens: None
    ClipShard.fold_padding = lambda self, x, batch: None
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ClipShard, k, fn)


def _rows_in_turns(row, n: int, variants: dict) -> dict:
    """(host seconds to issue, wall seconds) of ``row`` under each of two
    ``variants`` (name: context), in turns (a, b, b, a, ...) after a
    warm-up of each, n rows each."""
    a, b = variants
    times = {k: [] for k in variants}
    for ctx in variants.values():  # warm-up
        with ctx():
            row()
    for i in range(n):
        for k in ((a, b) if i % 2 == 0 else (b, a)):
            with variants[k]():
                times[k].append(_timed(row))
    return times


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
            elif kind == "reblock":  # (peer, rows from it, rows to it)
                bufs.append([(peer, torch.zeros(got * r["row"], dtype=dtype, device=device),
                              torch.zeros(sent * r["row"], dtype=dtype, device=device))
                             for peer, got, sent in r["moves"]])
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
                elif kind == "reblock":
                    ops = [dist.P2POp(op, buf, peer) for peer, got, sent in b
                           for op, buf in ((dist.irecv, got), (dist.isend, sent)) if buf.numel()]
                    for work in dist.batch_isend_irecv(ops) if ops else ():
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
    ap.add_argument("--height", type=int, default=512, help="pixels, a multiple of 64")
    ap.add_argument("--width", type=int, default=768, help="pixels, a multiple of 64")
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
        row, shard = _row(engine, device, a.frames, a.seed, a.height, a.width)
        turns = _rows_in_turns(row, a.rows, {"with": contextlib.nullcontext,
                                             "without": _without_halo_and_norm_collectives})
        row_s, without = (statistics.median(w for _, w in turns[k]) for k in ("with", "without"))
        variants = {"sound": contextlib.nullcontext,
                    "short_circuited": _padding_logic_short_circuited}
        outs = {}
        for k, ctx in variants.items():
            with ctx():
                outs[k] = row()
        diff = (outs["sound"].float() - outs["short_circuited"].float()).abs().max().item()
        del outs
        padding = {"max_abs_difference": diff}
        if diff == 0:
            turns = _rows_in_turns(row, a.rows, variants)
            padding.update({k: dict(issue_median=statistics.median(i for i, _ in v),
                                    wall_median=statistics.median(w for _, w in v),
                                    issue=[i for i, _ in v], wall=[w for _, w in v])
                            for k, v in turns.items()})
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
                      "axis": AXES[shard.axis], "frames": a.frames, "height": a.height,
                      "width": a.width, "rows": a.rows,
                      "row_seconds": row_s, "row_seconds_without": without,
                      "isolated_seconds_per_row": isolated, "padding_logic": padding}))


if __name__ == "__main__":
    main()
