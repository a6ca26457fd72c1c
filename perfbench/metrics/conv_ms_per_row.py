"""Device milliseconds a row spends in convolution kernels, over the
traced rows: cuDNN's (the frozen trace groups' "convolution") and the
port's int8 convolution (kernel 10, which the frozen groups count among
the W8A8 products); nothing where no traced row ran a convolution."""

UNIT, LAYER, MOVES = "ms/row", "network", "clip_s"
INT8_CONV = "::conv_kernel<"


def read(ctx):
    durs = [k["dur"] for k in ctx.kernels
            if k["row"] and (k["group"] == "convolution" or INT8_CONV in k["name"])]
    if not ctx.rows_traced or not durs:
        return None
    return sum(durs) / 1e3 / ctx.rows_traced
