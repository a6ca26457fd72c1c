"""The whole edit's share of the H100's bf16 peak, in percent: the model
FLOPs of the window's first clip's text, hint, encode, hint pyramid and
first ``trace_after`` rows, counted from the configuration's shapes, over
the seconds from the window's start to the end of those rows (before the
profiler starts), times 989 TFLOP/s."""

from perfbench.flops import BF16_FLOPS

UNIT, LAYER, MOVES = "%", "whole step", "clip_s"


def read(ctx):
    ends = ctx.clip_row_ends(0)[:ctx.traffic["trace_after"]]
    if not ends:
        return None
    f = ctx.flops()
    work = sum(f.get(k, 0.0) for k in ("text", "hint", "encode", "pyramid")) + len(ends) * f["row"]
    return 100.0 * work / (ends[-1] * BF16_FLOPS)
