"""The frozen trace reduction on a canned chrome trace: groups, the row and
attention spans by correlation id, the busy seconds and the idle gaps."""

import json

import pytest

from perfbench import trace as T


def canned(tmp_path):
    ev = []

    def span(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur})

    def kernel(name, op, ts, dur, launch_ts, corr):
        ev.append({"ph": "X", "cat": "cpu_op", "name": op, "ts": launch_ts - 1, "dur": 3,
                   "args": {"External id": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch_ts, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"External id": corr, "correlation": corr}})

    span(T.ROW_SPAN, 100, 100)
    span(T.ATTN_SPAN, 120, 20)
    kernel("sm90_xmma_fprop_implicit_gemm", "aten::cudnn_convolution", 200, 50, 110, 1)
    kernel("void ccedit::spatial_attention_kernel<40>", "", 250, 30, 125, 2)
    kernel("void at::native::elementwise_kernel<direct_copy_kernel_cuda>", "aten::copy_",
           280, 10, 150, 3)
    kernel("void at::native::vectorized_layer_norm_kernel", "aten::native_layer_norm",
           400, 20, 300, 4)  # launched outside the row
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 295, "dur": 100})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_summarise(tmp_path):
    s = T.summarise(canned(tmp_path))
    k = {x["name"][:20]: x for x in s["kernels"]}
    assert s["rows"] == 1
    conv, attn, copy, ln = (k[n] for n in ("sm90_xmma_fprop_impl", "void ccedit::spatial",
                                             "void at::native::ele", "void at::native::vec"))
    assert (conv["group"], attn["group"], copy["group"], ln["group"]) == (
        "convolution", "attention kernels (ours)", "copies", "normalisation")
    assert conv["row"] and attn["row"] and copy["row"] and not ln["row"]
    assert attn["attention"] and not conv["attention"] and not copy["attention"]


def test_busy_and_gaps(tmp_path):
    s = T.summarise(canned(tmp_path))
    intervals = [(x["ts"], x["ts"] + x["dur"]) for x in s["kernels"]]
    assert T.union_seconds(intervals) == pytest.approx(110e-6)
    assert T.union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    gaps = T.idle_gaps(s["kernels"], s["host"], (200, 420))
    assert gaps[0][0] == "aten::item" and gaps[0][1] == pytest.approx(110e-6)


def test_conv_reader_counts_the_int8_convolution():
    from types import SimpleNamespace

    from perfbench import run as R

    read = R.load_reader("conv_ms_per_row").read
    k = lambda name, group, dur, row=True: dict(name=name, group=group, dur=dur, row=row)
    exact = [k("sm90_xmma_fprop_implicit_gemm", "convolution", 300.0),
             k("void at::native::elementwise_kernel<copy>", "copies", 50.0)]
    int8 = [k("void ccedit::(anonymous namespace)::conv_kernel<128, 2, 2, 1>(CUtensorMap_st)",
              "W8A8 products (ours)", 400.0),
            k("void ccedit::(anonymous namespace)::dequant_gemm_kernel<256, false>(",
              "W8A8 products (ours)", 70.0)]
    assert read(SimpleNamespace(kernels=exact, rows_traced=2)) == pytest.approx(0.15)
    assert read(SimpleNamespace(kernels=int8, rows_traced=2)) == pytest.approx(0.2)
    assert read(SimpleNamespace(kernels=exact[1:], rows_traced=2)) is None
    assert read(SimpleNamespace(kernels=[], rows_traced=0)) is None
