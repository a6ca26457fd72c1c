// Kernel 5: probes of kernel 1's phases at the level-0 shape (272, 6144, 40)
// and, in the plain layout, at head_dim 64 (SD-2.x's heads: (10, 9216, 64)
// and (20, 2304, 64), SD-2.1-768's levels 0 and 1).
//
// Replaces: scripts/kv_resident_attn.py `make_call` (:188; bodies
// `_qkt_kernel` :73, `_softmax_kernel` :80, `_full_kernel` :90),
// `make_tr_call` (:170; `_qkt_tr_kernel` :104, `_full_tr_kernel` :113) and
// `make_tr8_call` (:149; `_qkt8_tr_kernel` :127, `_full8_tr_kernel` :135):
// the seven pallas_calls with which the JAX package took its kernel 1 apart.
//
// What each variant computes, per (batch, query row), over all N keys:
//   qkt      sum_j s_ij with s = q k^T raw (fp32; int32 scores, converted to
//            fp32 before the sum, for int8 q/k)
//   softmax  sum_j exp(s_ij * scale - max_j s_ij * scale)
//   full     softmax(s * scale) v, bf16
// in two layouts, (B, N, D) ("plain") and (B, D, N) ("tr", the TPU kernel's
// head_dim-in-sublanes layout), with bf16 or (tr only) int8 q and k, whose
// one per-tensor logits scale the caller folds into `scale_log2`.
//
// What bounds them on an H100: qkt the tensor cores (2*B*N^2*D = 0.82 TFLOP
// at level 0: 0.83 ms at 989 TFLOP/s bf16, 0.42 ms at 1,979 TOP/s int8);
// softmax and full the exponentials (B*N^2 = 1.03e10 exp2, 2.63 ms at the
// ~3.9 T/s of the special-function units).  As measured, K's TMA loads
// hold the qkt variants back, in time per box row (PERF.md section 7):
// kernel 1's own loads, which the probes keep.
//
// Design: every variant is kernel 1 itself, spatial_attention.cuh's
// template (warp-specialised: a TMA producer warpgroup, two ping-ponging
// wgmma consumers; see there), with heads = 1, stopped after a stage:
//   - qkt: the producer loads Q and K tiles only; the consumers issue S =
//     Q.K^T as kernel 1 does and sum the raw S rows;
//   - softmax: adds kernel 1's online exp2 softmax (keys past N masked),
//     writing l = sum exp2((s - m) * scale * log2 e), with no V and no P.V;
//   - full: kernel 1, so the three split kernel 1's time into Q.K^T,
//     softmax and P.V, and "full plain bf16" is the kernel the edits run.
// The plain layout is kernel 1's Bf16QK and row layout.  The tr layout
// loads 64-token x 48-d-row chunks (tokens innermost, d rows past 40
// zero-filled), so Q^T and K^T are MN-major operands of a transposed wgmma
// (Bf16QKTr), V^T's tile is a K-major B of P.V, and each warpgroup's O^T is
// staged through shared memory so its stores run along the tokens
// (TrLayout).  The tr int8 variants: 8-bit wgmma reads only K-major
// operands, so q8^T and k8^T are turned into kernel 1c's (B, N, 48) rows
// first, by a transposing pre-kernel (transpose_int8.cu) that the wrapper
// launches inside the timed call, and then run kernel 1c's Int8QK with the
// scalar scale and the tr V and O.  A pre-kernel rather than a transpose
// inside the kernel: it moves 0.29 GB at the bytes bound (~0.09 ms, a fifth
// of the int8 qkt bound), and it keeps the kernel kernel 1c's own
// instantiation instead of adding a transposing stage between the TMA and
// the wgmma to kernel 1's pipeline.  N is a multiple of 64; D is 40, or 64
// for the three plain bf16 variants (kernel 1's d = 64 instantiation, 192
// query rows a block, stopped after each stage).
#include "spatial_attention.cuh"

namespace ccedit {

namespace {

// (batch, token, d) element strides of one probe operand
struct Layout {
  long long b, n, d;
};

// Kernel 1's strides of a (B, 1, N, D) operand from the plain layout's, and
// of a (B, 1, D, N) one from the tr layout's (Strides::n is then the d-row
// stride; the head stride of the one head is the batch stride).
Strides row_strides(Layout l) { return Strides{l.b, l.b, l.n}; }
Strides tr_strides(Layout l) { return Strides{l.b, l.b, l.d}; }

template <int kD, class QK, int ST, class L>
int launch_probe(const void* q, const void* k, const void* v, void* out, int batch, int n,
                 Layout lq, Layout lk, Layout lv, Layout lo, float scale_log2,
                 cudaStream_t stream) {
  using T = SpatialTiles<kD, QK, ST, L>;
  constexpr bool kTrQK = !QK::kInt8 && L::kTr;  // bf16 tr: q and k tokens-innermost too
  CUtensorMap mq, mk, mv;
  bool iq = false, ik = false, iv = false;
  int err;
  if constexpr (kTrQK) {
    err = tensor_map_tr(&mq, q, batch, 1, n, kD, tr_strides(lq), Bf16QKTr<kD>::kRows);
    if (err == 0) err = tensor_map_tr(&mk, k, batch, 1, n, kD, tr_strides(lk), Bf16QKTr<kD>::kRows);
  } else {
    err = tensor_map(&mq, &iq, q, batch, 1, n, QK::kWidth, row_strides(lq), T::kBM, QK::kInt8);
    if (err == 0)
      err = tensor_map(&mk, &ik, k, batch, 1, n, QK::kWidth, row_strides(lk), T::kBN, QK::kInt8);
  }
  if constexpr (ST != kFull) {
    mv = mk;  // not read
  } else if constexpr (L::kTr) {
    if (err == 0) err = tensor_map_tr(&mv, v, batch, 1, n, kD, tr_strides(lv), kD);
  } else {
    if (err == 0) err = tensor_map(&mv, &iv, v, batch, 1, n, kD, row_strides(lv), T::kBN);
  }
  if (err != 0) return err;
  const bool full = ST == kFull;
  const Strides so = !full ? Strides{} : L::kTr ? tr_strides(lo) : row_strides(lo);
  return launch_kernel<kD, QK, ST, L>(mq, mk, mv, (iq ? 1 : 0) | (ik ? 2 : 0) | (iv ? 4 : 0),
                                      full ? out : nullptr,
                                      full ? nullptr : static_cast<float*>(out), nullptr, batch,
                                      1, n, n, so, scale_log2, stream);
}

}  // namespace

}  // namespace ccedit

// C entry point.  stage 0 qkt, 1 softmax, 2 full; int8 q/k only with the
// transposed layout, head_dim 64 only with bf16 q/k in the plain layout.  q
// and k are (B, N, D) or, transposed, (B, D, N)
// with unit token stride; v and out (full) likewise, bf16; out is (B, N)
// fp32 for qkt and softmax.  For int8 the q and k given are the (B, N, 48)
// rows that ccedit_transpose_int8 makes of the transposed q8 and k8.
// `strides` holds (batch, token, d) element strides of q, k, v and out.
// n % 64 == 0.  Returns the launch's cudaError_t; -1 for a combination the
// probes do not have.
extern "C" int ccedit_attention_probe(int stage, int int8, int transposed, const void* q,
                                      const void* k, const void* v, void* out, int batch,
                                      int n, int head_dim, const long long* strides,
                                      float scale_log2, void* stream) {
  using namespace ccedit;
  const Layout lq{strides[0], strides[1], strides[2]};
  const Layout lk{strides[3], strides[4], strides[5]};
  const Layout lv{strides[6], strides[7], strides[8]};
  const Layout lo{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 64 != 0) return -1;
  if (head_dim == 64 && !int8 && !transposed) {
    switch (stage) {
      case kQKT:
        return launch_probe<64, Bf16QK<64>, kQKT, RowLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
      case kSoftmax:
        return launch_probe<64, Bf16QK<64>, kSoftmax, RowLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
      case kFull:
        return launch_probe<64, Bf16QK<64>, kFull, RowLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
      default:
        return -1;
    }
  }
  if (head_dim != 40) return -1;
  constexpr int kD = 40;
  using Plain = Bf16QK<kD>;
  using Tr = Bf16QKTr<kD>;
  using Tr8 = Int8QK<kD, true>;
  switch (stage * 4 + int8 * 2 + transposed) {
    case kQKT * 4:
      return launch_probe<kD, Plain, kQKT, RowLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kSoftmax * 4:
      return launch_probe<kD, Plain, kSoftmax, RowLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kFull * 4:
      return launch_probe<kD, Plain, kFull, RowLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kQKT * 4 + 1:
      return launch_probe<kD, Tr, kQKT, TrLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kFull * 4 + 1:
      return launch_probe<kD, Tr, kFull, TrLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kQKT * 4 + 3:
      return launch_probe<kD, Tr8, kQKT, TrLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kFull * 4 + 3:
      return launch_probe<kD, Tr8, kFull, TrLayout>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    default:
      return -1;
  }
}
