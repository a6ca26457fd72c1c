"""Seconds a user waits per clip on one GPU: the window's seconds times the
configuration's rows per clip over the rows finished in the window (the
row in flight at its close counted by the share of its interval that fell
inside).  The clips' other stages sit inside the window's time."""

UNIT, LAYER, MOVES = "s/clip", "end to end", None


def read(ctx):
    return ctx.seconds * ctx.rows_per_clip / ctx.work_rows if ctx.work_rows > 0 else None
