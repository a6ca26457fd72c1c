"""The window's first clip's text, hint and encode stages, in seconds
(``edit_clips``' stopwatch)."""

UNIT, LAYER, MOVES = "s", "pipeline stages", "clip_s"


def read(ctx):
    stages = ctx.stages[0] if ctx.stages else {}
    if "hint" not in stages:
        return None
    return sum(stages.get(k, 0.0) for k in ("text", "hint", "encode"))
