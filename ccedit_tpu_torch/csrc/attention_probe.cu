// Kernel 5: probes of kernel 1's phases at the level-0 shape (272, 6144, 40).
//
// Replaces: scripts/kv_resident_attn.py `make_call` (:188; bodies
// `_qkt_kernel` :73, `_softmax_kernel` :80, `_full_kernel` :90),
// `make_tr_call` (:170; `_qkt_tr_kernel` :104, `_full_tr_kernel` :113) and
// `make_tr8_call` (:149; `_qkt8_tr_kernel` :127, `_full8_tr_kernel` :135):
// the seven pallas_calls with which the JAX package took its kernel 1 apart.
//
// What each variant computes, per (batch, query row), over all N keys:
//   qkt      sum_j s_ij with s = q k^T raw (fp32; int32 scores for int8 q/k)
//   softmax  sum_j exp(s_ij * scale - max_j s_ij * scale)
//   full     softmax(s * scale) v, bf16
// in two layouts, (B, N, D) ("plain") and (B, D, N) ("tr", the TPU kernel's
// head_dim-in-sublanes layout), with bf16 or (tr only) int8 q and k, whose
// one per-tensor logits scale the caller folds into `scale_log2`.
//
// What bounds them on an H100: qkt the tensor cores (2*B*N^2*D = 0.82 TFLOP
// at level 0: 0.83 ms at 989 TFLOP/s bf16, 0.42 ms at 1,979 TOP/s int8);
// softmax and full the exponentials (B*N^2 = 1.03e10 exp2, 2.63 ms at the
// ~3.9 T/s of the special-function units).
//
// Design: kernel 1's tile loop (4 warps per 64-query tile, 64-key tiles in
// shared memory, mma.sync, fp32 exp2 online softmax), templated on the stage
// the loop stops after, the input type and the layout.  qkt runs kernel 1's
// staging and QK^T only, softmax adds the online softmax, full is kernel 1
// with the layout's loads, so their times split kernel 1's into QK^T,
// softmax and P.V.  Strides are per operand (batch, token, d), so one body
// reads both layouts: the plain layout is staged with 16-byte row loads as
// kernel 1 does; the tr layout with 16-byte loads along the tokens of one
// d-row, transposed into the same row-major shared-memory tiles (its V^T
// tile needs no transpose).  An online row max gives the same sums as the
// TPU's one-pass max.  N is a multiple of 64 (no ragged tiles); D is 40,
// staged 48 wide with zero columns.
#include <stdint.h>

#include "attention_common.cuh"

namespace ccedit {

namespace {

constexpr int kBM = 64;      // query rows per block (16 per warp)
constexpr int kBN = 64;      // keys per staged tile
constexpr int kThreads = 128;
constexpr int kD = 40;       // head_dim of the probes
constexpr int kDK = 48;      // staged width: 40 + 8 zero columns
enum Stage { kQKT = 0, kSoftmax = 1, kFull = 2 };

struct Layout {  // element strides of a (B, N, D) operand: batch, token, d
  long long b, n, d;
};

// A 64-token tile of q or k into row-major shared memory (pitch LDQ bytes,
// columns [0, kD)).
template <bool Q8, bool TR, int LDQ>
__device__ __forceinline__ void stage_qk(unsigned char* s, const unsigned char* x,
                                         Layout lx, int tok0, int tid) {
  constexpr int EB = Q8 ? 1 : 2;
  if constexpr (!TR) {
    static_assert(!Q8, "the plain-layout probes are bf16");
    constexpr int VPR = kD / 8;
    for (int i = tid; i < kBN * VPR; i += kThreads) {
      const int r = i / VPR, c = i % VPR;
      st128b(s + r * LDQ + c * 16, ld128b(x + (tok0 + r) * lx.n * EB + c * 16));
    }
  } else {  // tokens contiguous (lx.n == 1): 16-byte loads along one d-row
    constexpr int NV = 16 / EB;    // tokens per vector
    constexpr int VPD = kBN / NV;  // vectors per d-row of the tile
    for (int i = tid; i < kD * VPD; i += kThreads) {
      const int c = i / VPD, r0 = (i % VPD) * NV;
      const uint4 vec = ld128b(x + (c * lx.d + tok0 + r0) * EB);
      const unsigned char* e = reinterpret_cast<const unsigned char*>(&vec);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if constexpr (Q8) {
          s[(r0 + j) * LDQ + c] = e[j];
        } else {
          *reinterpret_cast<uint16_t*>(s + (r0 + j) * LDQ + 2 * c) =
              reinterpret_cast<const uint16_t*>(e)[j];
        }
      }
    }
  }
}

// A 64-key tile of v into shared memory as V^T (pitch LDV elements).
template <bool TR, int LDV>
__device__ __forceinline__ void stage_vt(bf16* s_vt, const bf16* v, Layout lv, int tok0,
                                         int tid) {
  if constexpr (!TR) {
    constexpr int VPR = kD / 8;
    for (int i = tid; i < kBN * VPR; i += kThreads) {
      const int r = i / VPR, c = i % VPR;
      const uint4 vv = ld128(v + (tok0 + r) * lv.n + c * 8);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_vt[(c * 8 + j) * LDV + r] = ve[j];
    }
  } else {
    constexpr int VPD = kBN / 8;
    for (int i = tid; i < kD * VPD; i += kThreads) {
      const int c = i / VPD, r0 = (i % VPD) * 8;
      st128(s_vt + c * LDV + r0, ld128(v + c * lv.d + tok0 + r0));
    }
  }
}

template <int STAGE, bool Q8, bool TR>
__global__ void __launch_bounds__(kThreads)
attention_probe_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                       const bf16* __restrict__ v, void* __restrict__ out, int n,
                       Layout lq, Layout lk, Layout lv, Layout lo, float scale_log2) {
  constexpr int EB = Q8 ? 1 : 2;
  constexpr int LDQ = Q8 ? kDK : 2 * (kDK + 8);  // bytes, as kernel 1
  constexpr int LDV = kBN + 8;
  constexpr int KB = kDK * EB;
  constexpr int NKS = KB / 32;
  constexpr bool TAIL = KB % 32 != 0;
  constexpr int NDB = kD / 8;
  constexpr int NSB = kBN / 8;
  constexpr int PADW = (kDK - kD) * EB / 4;  // 32-bit words of zero pad a row

  __shared__ __align__(16) unsigned char s_k[kBN * LDQ];
  __shared__ __align__(16) bf16 s_vt[STAGE == kFull ? kD * LDV : 8];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kBM;
  const unsigned char* q = static_cast<const unsigned char*>(q_) + b * lq.b * EB;
  const unsigned char* k = static_cast<const unsigned char*>(k_) + b * lk.b * EB;
  v += b * lv.b;

  stage_qk<Q8, TR, LDQ>(s_k, q, lq, q0, tid);
  for (int i = tid; i < kBN * PADW; i += kThreads) {  // zero pad columns [kD, kDK) once
    const int r = i / PADW, w = i % PADW;
    *reinterpret_cast<uint32_t*>(s_k + r * LDQ + kD * EB + 4 * w) = 0u;
  }
  __syncthreads();

  uint32_t qa[NKS][4], qt[2];
  {
    const unsigned char* base = s_k + (warp * 16 + g) * LDQ + 4 * t;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      qa[kk][0] = ld32b(base + kk * 32);
      qa[kk][1] = ld32b(base + 8 * LDQ + kk * 32);
      qa[kk][2] = ld32b(base + kk * 32 + 16);
      qa[kk][3] = ld32b(base + 8 * LDQ + kk * 32 + 16);
    }
    if constexpr (TAIL) {
      qt[0] = ld32b(base + NKS * 32);
      qt[1] = ld32b(base + 8 * LDQ + NKS * 32);
    }
  }

  float acc[NDB][4];
#pragma unroll
  for (int nd = 0; nd < NDB; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2], rs[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();  // the previous tile (on the first pass, Q) has been consumed
    stage_qk<Q8, TR, LDQ>(s_k, k, lk, k0, tid);
    if constexpr (STAGE == kFull) stage_vt<TR, LDV>(s_vt, v, lv, k0, tid);
    __syncthreads();

    float s[NSB][4];
    if constexpr (Q8) {
      int si[NSB][4];
#pragma unroll
      for (int nb = 0; nb < NSB; ++nb) si[nb][0] = si[nb][1] = si[nb][2] = si[nb][3] = 0;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
        for (int nb = 0; nb < NSB; ++nb) {
          const unsigned char* kb = s_k + (nb * 8 + g) * LDQ + kk * 32 + 4 * t;
          mma_s8_16832(si[nb], qa[kk], ld32b(kb), ld32b(kb + 16));
        }
      }
      if constexpr (TAIL) {
#pragma unroll
        for (int nb = 0; nb < NSB; ++nb)
          mma_s8_16816(si[nb], qt, ld32b(s_k + (nb * 8 + g) * LDQ + NKS * 32 + 4 * t));
      }
#pragma unroll
      for (int nb = 0; nb < NSB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = static_cast<float>(si[nb][e]);
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < NSB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
        for (int nb = 0; nb < NSB; ++nb) {
          const unsigned char* kb = s_k + (nb * 8 + g) * LDQ + kk * 32 + 4 * t;
          mma_16816(s[nb], qa[kk], ld32b(kb), ld32b(kb + 16));
        }
      }
    }
    if constexpr (STAGE == kQKT) {
#pragma unroll
      for (int nb = 0; nb < NSB; ++nb) {
        rs[0] += s[nb][0] + s[nb][1];
        rs[1] += s[nb][2] + s[nb][3];
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < NSB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= scale_log2;
      }
      online_softmax<NSB>(s, k0, t, n, m, l, corr);
    }
    if constexpr (STAGE == kFull) {
#pragma unroll
      for (int nd = 0; nd < NDB; ++nd) {
        acc[nd][0] *= corr[0]; acc[nd][1] *= corr[0];
        acc[nd][2] *= corr[1]; acc[nd][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        uint32_t pa[4];
        p_fragment(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int nd = 0; nd < NDB; ++nd) {
          const bf16* vb = s_vt + (nd * 8 + g) * LDV + j * 16 + 2 * t;
          mma_16816(acc[nd], pa, ld32(vb), ld32(vb + 8));
        }
      }
    }
  }

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  if constexpr (STAGE == kFull) {
    bf16* o = static_cast<bf16*>(out) + b * lo.b;
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
    for (int nd = 0; nd < NDB; ++nd) {
      const int col = nd * 8 + 2 * t;
      if constexpr (!TR) {
        *reinterpret_cast<uint32_t*>(o + row0 * lo.n + col) = pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
        *reinterpret_cast<uint32_t*>(o + row1 * lo.n + col) = pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
      } else {
        o[row0 * lo.n + col * lo.d] = __float2bfloat16(acc[nd][0] * inv0);
        o[row0 * lo.n + (col + 1) * lo.d] = __float2bfloat16(acc[nd][1] * inv0);
        o[row1 * lo.n + col * lo.d] = __float2bfloat16(acc[nd][2] * inv1);
        o[row1 * lo.n + (col + 1) * lo.d] = __float2bfloat16(acc[nd][3] * inv1);
      }
    }
  } else {
    float r0v = l[0], r1v = l[1];
    if constexpr (STAGE == kQKT) {
      rs[0] += __shfl_xor_sync(0xffffffffu, rs[0], 1);
      rs[0] += __shfl_xor_sync(0xffffffffu, rs[0], 2);
      rs[1] += __shfl_xor_sync(0xffffffffu, rs[1], 1);
      rs[1] += __shfl_xor_sync(0xffffffffu, rs[1], 2);
      r0v = rs[0];
      r1v = rs[1];
    }
    if (t == 0) {
      float* o = static_cast<float*>(out) + static_cast<long long>(b) * n;
      o[row0] = r0v;
      o[row1] = r1v;
    }
  }
}

template <int STAGE, bool Q8, bool TR>
int launch_probe(const void* q, const void* k, const void* v, void* out, int batch, int n,
                 Layout lq, Layout lk, Layout lv, Layout lo, float scale_log2,
                 cudaStream_t stream) {
  dim3 grid(n / kBM, batch);
  attention_probe_kernel<STAGE, Q8, TR><<<grid, kThreads, 0, stream>>>(
      q, k, static_cast<const bf16*>(v), out, n, lq, lk, lv, lo, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// C entry point.  stage 0 qkt, 1 softmax, 2 full; int8 q/k only with the
// transposed layout.  q and k are (B, N, 40) or, transposed, (B, 40, N) with
// unit token stride; v and out (full) likewise, bf16; out is (B, N) fp32 for
// qkt and softmax.  `strides` holds (batch, token, d) element strides of q,
// k, v and out.  n % 64 == 0.  Returns the launch's cudaError_t; -1 for a
// combination the probes do not have.
extern "C" int ccedit_attention_probe(int stage, int int8, int transposed, const void* q,
                                      const void* k, const void* v, void* out, int batch,
                                      int n, const long long* strides, float scale_log2,
                                      void* stream) {
  using namespace ccedit;
  const Layout lq{strides[0], strides[1], strides[2]};
  const Layout lk{strides[3], strides[4], strides[5]};
  const Layout lv{strides[6], strides[7], strides[8]};
  const Layout lo{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % kBN != 0) return -1;
  switch (stage * 4 + int8 * 2 + transposed) {
    case kQKT * 4:
      return launch_probe<kQKT, false, false>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kSoftmax * 4:
      return launch_probe<kSoftmax, false, false>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kFull * 4:
      return launch_probe<kFull, false, false>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kQKT * 4 + 1:
      return launch_probe<kQKT, false, true>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kFull * 4 + 1:
      return launch_probe<kFull, false, true>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kQKT * 4 + 3:
      return launch_probe<kQKT, true, true>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    case kFull * 4 + 3:
      return launch_probe<kFull, true, true>(q, k, v, out, batch, n, lq, lk, lv, lo, scale_log2, st);
    default:
      return -1;
  }
}
