"""Milliseconds a network row takes in the window's first clip, from the
row hooks' CUDA events: from the end of its first row to the end of its
last untraced one (``trace_after``), over the rows between (the sampler's
arithmetic between rows included)."""

UNIT, LAYER, MOVES = "ms", "engine and diffusion", "clip_s"


def read(ctx):
    ends = ctx.clip_row_ends(0)[:ctx.traffic["trace_after"]]
    return 1e3 * (ends[-1] - ends[0]) / (len(ends) - 1) if len(ends) > 1 else None
