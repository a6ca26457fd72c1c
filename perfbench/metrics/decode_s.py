"""The window's first clip's VAE decode and uint8 quantisation, in seconds
(``edit_clips``' stopwatch); nothing where the window holds no decode."""

UNIT, LAYER, MOVES = "s", "pipeline stages", "clip_s"


def read(ctx):
    stages = ctx.stages[0] if ctx.stages else {}
    return stages.get("decode")
