"""The traced attention calls' least time on the H100 (their shapes:
products at 989 TFLOP/s bf16, exponentials at the inferred exp2 rate, q,
k, v and o once at 3.35 TB/s; ``perfbench/flops.py``) over the device time
of the kernels their calls launched, in percent."""

from perfbench.flops import attention_bound_s

UNIT, LAYER, MOVES = "%", "kernels", "clip_s"


def read(ctx):
    device_s = sum(k["dur"] for k in ctx.kernels if k["attention"]) / 1e6
    if not ctx.attention_calls or device_s <= 0:
        return None
    return 100.0 * sum(attention_bound_s(*c) for c in ctx.attention_calls) / device_s
