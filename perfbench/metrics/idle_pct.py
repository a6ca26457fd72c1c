"""The share of the traced window in which no kernel, copy or memset ran
on the device, in percent: 100 less the union of the device events over
the profiled windows' wall time."""

UNIT, LAYER, MOVES = "%", "device", "clip_s"


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
