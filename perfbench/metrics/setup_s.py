"""Set-up seconds: process start to the window's start (imports, the
kernel library's load or build, the engine, the seeded weights, the
warm-up edit)."""

UNIT, LAYER, MOVES = "s", "end to end", None


def read(ctx):
    return ctx.setup_s
