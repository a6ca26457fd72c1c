"""The readings the limits of a cell's comparison are set from.

    python3 perfbench/control.py --workload tv2v.edit --seconds 32 --seeds 11,12,13
    python3 perfbench/control.py --workload tv2v.edit --seconds 32 --seeds 21,22,23 --int8

One process builds the cell once and, for each seed, loads that seed's
weights, runs a window of ``--seconds`` (long enough to finish the
traffic's longest edit, or as many rows as a run compares) and prints one
JSON line: ``numbers``, what the run's check compares, and ``control``,
each number as the control reads it.  The control is the nearest
precision below the configuration's bf16: where the program has such a
path, the program with it switched on (``--int8``: the configuration run
with both of the port's int8 switches, W8A8 and the int8 Q.K^T, so the
``numbers`` of such a process are the control's readings of the rows, the
encode and the decode); elsewhere the
reference put in the program's place, its matrix products and
convolutions fed fp8 (e4m3, one scale a tensor) operands for the text
encoder and the annotator's network, the hint post-process computed in
bf16 on the program's depth, and the sampler's latents rounded to bf16
after every update for the chain.  The benchmark's own runs never run
this.
"""

import time

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from perfbench import check, run as R  # noqa: E402
from perfbench.cell import INT8_SWITCHES, Cell, weight_seed  # noqa: E402
from perfbench.reference.diffusion import Chain, rel_err, replay  # noqa: E402
from perfbench.reference.nets import hash_tokens  # noqa: E402


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale for the tensor."""
    s = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` whose Linear and conv layers take fp8 weights and
    inputs."""
    m = copy.deepcopy(module)
    for mod in m.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            mod.weight.data = fake_fp8(mod.weight.data)
            mod.register_forward_pre_hook(lambda _m, args: (fake_fp8(args[0]),) + args[1:])
    return m


@torch.no_grad()
def controls(ref: check.Reference, traffic, cell) -> dict:
    """text_err, hint_err and step_err as the lower-precision reference reads
    them in the program's place."""
    clip8, ann8 = fp8_copy(ref.mods["clip"]), fp8_copy(ref.mods["annotator"])
    out = {"text_err": 0.0, "depth_err": 0.0, "post_err": 0.0, "step_err": 0.0}
    ref_cfg = traffic.get("reference")
    for e in cell.edits:
        rows = [r for r in cell.rows if r.clip == e.index]
        if not rows:
            continue
        ids = hash_tokens([traffic["negative_prompt"], e.prompt]).to(ref.device)
        out["text_err"] = max(out["text_err"], rel_err(clip8(ids), ref.mods["clip"](ids)))
        frames = check._frames(e.frames, ref.device)
        out["depth_err"] = max(out["depth_err"], rel_err(check.raw_depth(ref, frames, ann8),
                                                         check.raw_depth(ref, frames)))
        prog, hw = torch.cat([r.float() for r in e.raw]), frames.shape[2:]
        low = check.post(ref, prog.to(torch.bfloat16), hw).float()
        out["post_err"] = max(out["post_err"], rel_err(low, check.post(ref, prog, hw)))
        x0 = e.init_noise.float()
        if ref_cfg:
            feat = ref.mods["vae"].encode_mean(check._frames(e.reference[None], ref.device))
            x0 = x0 + ref_cfg["prior_coefficient_x"] * (feat * check.SCALE_FACTOR).permute(
                0, 2, 3, 1)[:, None].expand_as(x0)
        low = Chain(x0, traffic["steps"], traffic["cfg_scale"], e.loop_noise, torch.bfloat16)
        ins = []
        for r in rows:
            xin, _ = low.expected()
            ins.append(xin.to(torch.bfloat16))
            low.feed(r.out)
        err, _, _ = replay(x0, traffic["steps"], traffic["cfg_scale"], e.loop_noise, ins,
                           [r.t for r in rows], [r.out for r in rows])
        out["step_err"] = max(out["step_err"], err)
    return out


def with_int8(spec):
    """``spec`` with its configuration on both of the port's int8 switches."""
    bench, entry, config, traffic, limits = spec
    return bench, entry, dict(config, int8=sorted(INT8_SWITCHES)), traffic, limits


def calibrate(spec, seeds, seconds: float, device):
    """One JSON-ready reading a seed (after a first line with the set-up)."""
    _, _, config, traffic, limits = spec
    t0 = time.time()
    cell = Cell(config, traffic, seeds[0], device)
    cell.warm_up()
    ref = check.Reference(config, device)
    yield {"setup_s": time.time() - t0, "card": R.card(), "int8": config["int8"]}
    for seed in seeds:
        if seed != cell.seed:
            cell.reload(seed)
        cell.run_window(seconds)
        ref.load(weight_seed(seed))
        numbers = check.reference_numbers(ref, traffic, cell, seed)
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            ctl = controls(ref, traffic, cell)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        yield {"seed": seed, "rows": len(cell.rows), "numbers": numbers, "control": ctl,
               "correct": check.verdict(numbers, limits)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--int8", action="store_true",
                    help="run the program on its int8 path, the control of rows, encode, decode")
    a = ap.parse_args()
    spec = R.cell_spec(a.workload)
    if a.int8:
        spec = with_int8(spec)
    R.require_chips(spec[1]["chips"])
    for line in calibrate(spec, [int(s) for s in a.seeds.split(",")], a.seconds,
                          torch.device("cuda:0")):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
