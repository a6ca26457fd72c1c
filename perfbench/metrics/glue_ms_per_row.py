"""Device milliseconds a row spends in copies, elementwise and
normalisation kernels (the frozen trace groups; attention spans left out),
over the traced rows."""

UNIT, LAYER, MOVES = "ms/row", "network", "clip_s"
GROUPS = ("copies", "other (elementwise)", "normalisation", "fused norm (ours)", "softmax")


def read(ctx):
    if not ctx.rows_traced:
        return None
    dur = sum(k["dur"] for k in ctx.kernels
              if k["row"] and not k["attention"] and k["group"] in GROUPS)
    return dur / 1e3 / ctx.rows_traced
