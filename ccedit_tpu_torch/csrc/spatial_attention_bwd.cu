// Kernel 4: the backward of kernel 1 (exact softmax attention), dq, dk and dv
// for head_dim 40, 80 and 160 and any n_k: the UNet's spatial
// self-attention in training, (48, 8, 3072, 40) and (48, 8, 768, 80) at the
// recipe's 12 frames of 384x512, batch 4.
//
// Replaces: the stock Pallas TPU flash-attention backward that
// ccedit_tpu/ops/attention.py `_xla_attention_bwd` reaches through
// `jax.vjp(flash_attention)` at kernel 1's shapes.
//
// What bounds it on an H100: arithmetic.  Four products of the forward's
// size (S = Q K^T and dP = dO V^T recomputed, dV = P^T dO, dK = dS^T Q) in
// one kernel and three (S, dP, dQ = dS K) in the other: 3.5x the forward's
// FLOPs, far above the card's bf16 ridge point.  The (n_q x n_k) P and dS
// never reach device memory.
//
// Design: FlashAttention-2's backward, two kernels and no atomics.
//   delta = rowsum(dO * O) is an fp32 torch reduction in the wrapper (the
//   stock Pallas backward also computes its `di` outside its kernels).
//   dK/dV kernel: one block of 8 warps per (batch*head, 64-key tile) walks
//   the query tiles.  Per tile, each warp recomputes a 16-query x 32-key
//   block of S and dP (mma.sync m16n8k16, bf16 in, fp32 accumulate),
//   P = exp2(S * scale_log2 - lse) with the forward's log2-domain lse,
//   dS = P * (dP - delta), and writes P^T and dS^T in bf16 to shared
//   memory; then warps 0-3 accumulate dV += P^T dO and warps 4-7
//   dK += dS^T Q, 16 keys x head_dim each, in fp32 registers.  Going
//   through shared memory decouples the two warp layouts, so no warp holds
//   both a dK and a dV accumulator: at head_dim 160 that is 80 fp32
//   registers a thread instead of 160.
//   dQ kernel: one block of 4 warps per (batch*head, 64-query tile) walks
//   the key tiles, each warp owning 16 query rows: S, dP, P and dS stay in
//   registers, and dS's C fragments are the A fragments of dQ += dS K (as P
//   feeds P.V in the forward).
//   The softmax scale multiplies dK and dQ once, in the epilogue.
// Head-dim padding as in the forward: Q, K, V and dO are staged DK = 48 wide
// at head_dim 40 (k-steps of 16 over the head dim); the products over
// queries or keys need none.  Ragged n_q and n_k: rows past the end are
// staged as zeros and their P is masked to 0, so they add exact zeros.
// The B operands of the products over queries or keys (dO^T, Q^T, K^T) are
// staged transposed by scalar shared-memory stores, as the forward stages
// V^T.  Shared memory (dynamic): 151 KB for the dK/dV block at head_dim 160.
//
// Left for later: cp.async/TMA pipelining, ldmatrix, wgmma.
#include "attention_common.cuh"

namespace ccedit {

namespace {

constexpr int kT = 64;  // queries and keys per tile

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  bf16 *dq, *dk, *dv;
  const float *lse, *delta;  // (batch * heads, n_q), fp32
  int heads, n_q, n_k;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale_log2, scale;
};

// Stage rows [r0, r0 + kT) of a (N x D) operand into shared memory: row-major
// at pitch LD with zero columns [D, DK) (when `rows` is not null) and
// transposed, (D x kT) at pitch LDT (when `cols` is not null).  Rows at or
// past n are zeros.
template <int D, int DK, int LD, int LDT>
__device__ __forceinline__ void stage(bf16* rows, bf16* cols, const bf16* g,
                                      long long stride_n, int r0, int n,
                                      int nthreads) {
  constexpr int VPR = DK / 8;  // 16-byte vectors per staged row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < kT * VPR; i += nthreads) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = zero;
    if (c < D / 8 && r0 + r < n) val = ld128(g + (r0 + r) * stride_n + c * 8);
    if (rows != nullptr) st128(rows + r * LD + c * 8, val);
    if (cols != nullptr && c < D / 8) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[(c * 8 + j) * LDT + r] = e[j];
    }
  }
}

// A fragment (16 x 16, row-major) at `p` with row pitch `ld`.
__device__ __forceinline__ void a_fragment(uint32_t a[4], const bf16* p, int ld) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

template <int D, int DK>
struct Smem {
  static constexpr int LD = DK + 8;   // pitch of row-major tiles
  static constexpr int LDT = kT + 8;  // pitch of transposed tiles
  static constexpr int kDkdvBytes =
      (4 * kT * LD + 2 * D * LDT + 2 * kT * LDT) * 2 + 2 * kT * 4;
  static constexpr int kDqBytes = (4 * kT * LD + D * LDT) * 2;
};

constexpr int kDkdvThreads = 256;  // 8 warps
constexpr int kDqThreads = 128;    // 4 warps

template <int D, int DK>
__global__ void __launch_bounds__(kDkdvThreads)
attention_bwd_dkdv_kernel(BwdArgs a) {
  using S = Smem<D, DK>;
  constexpr int LD = S::LD, LDT = S::LDT;
  constexpr int NKS = DK / 16;  // k-steps over the head dim
  constexpr int NDB = D / 8;    // 8-wide head-dim column blocks
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);  // keys x LD
  bf16* s_v = s_k + kT * LD;                  // keys x LD
  bf16* s_q = s_v + kT * LD;                  // queries x LD
  bf16* s_do = s_q + kT * LD;                 // queries x LD
  bf16* s_qt = s_do + kT * LD;                // D x LDT: Q^T
  bf16* s_dot = s_qt + D * LDT;               // D x LDT: dO^T
  bf16* s_pt = s_dot + D * LDT;               // keys x LDT: P^T
  bf16* s_dst = s_pt + kT * LDT;              // keys x LDT: dS^T
  float* s_lse = reinterpret_cast<float*>(s_dst + kT * LDT);
  float* s_delta = s_lse + kT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * kT;
  const bf16* q = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* k = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* v = a.v + b * a.sv.b + h * a.sv.h;
  const bf16* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
  const float* lse = a.lse + static_cast<long long>(bh) * a.n_q;
  const float* delta = a.delta + static_cast<long long>(bh) * a.n_q;

  stage<D, DK, LD, LDT>(s_k, nullptr, k, a.sk.n, k0, a.n_k, kDkdvThreads);
  stage<D, DK, LD, LDT>(s_v, nullptr, v, a.sv.n, k0, a.n_k, kDkdvThreads);

  // phase A: warp tile of S / dP is 16 queries x 32 keys
  const int qr = (warp & 3) * 16, kc = (warp >> 2) * 32;
  // phase B: warps 0-3 own dV rows, warps 4-7 dK rows, 16 keys each
  const int kr = (warp & 3) * 16;
  const bool is_dv = warp < 4;
  float acc[NDB][4];
#pragma unroll
  for (int nd = 0; nd < NDB; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int q0 = 0; q0 < a.n_q; q0 += kT) {
    __syncthreads();  // the previous query tile (and P^T, dS^T) has been consumed
    stage<D, DK, LD, LDT>(s_q, s_qt, q, a.sq.n, q0, a.n_q, kDkdvThreads);
    stage<D, DK, LD, LDT>(s_do, s_dot, dout, a.sdo.n, q0, a.n_q, kDkdvThreads);
    if (tid < kT) {  // past n_q: P = exp2(-inf) = 0 and dS = 0
      const bool valid = q0 + tid < a.n_q;
      s_lse[tid] = valid ? lse[q0 + tid] : INFINITY;
      s_delta[tid] = valid ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      uint32_t qa[4], da[4];
      a_fragment(qa, s_q + (qr + g) * LD + kk * 16 + 2 * t, LD);
      a_fragment(da, s_do + (qr + g) * LD + kk * 16 + 2 * t, LD);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const bf16* kb = s_k + (kc + nb * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[nb], qa, ld32(kb), ld32(kb + 8));
        const bf16* vb = s_v + (kc + nb * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(dp[nb], da, ld32(vb), ld32(vb + 8));
      }
    }
    const float lse0 = s_lse[qr + g], lse1 = s_lse[qr + g + 8];
    const float dl0 = s_delta[qr + g], dl1 = s_delta[qr + g + 8];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qr + g + (e >= 2 ? 8 : 0);
        const int col = kc + nb * 8 + 2 * t + (e & 1);
        float p = exp2f(s[nb][e] * a.scale_log2 - (e >= 2 ? lse1 : lse0));
        if (k0 + col >= a.n_k) p = 0.f;
        const float ds = p * (dp[nb][e] - (e >= 2 ? dl1 : dl0));
        s_pt[col * LDT + row] = __float2bfloat16(p);
        s_dst[col * LDT + row] = __float2bfloat16(ds);
      }
    }
    __syncthreads();

    const bf16* a_src = is_dv ? s_pt : s_dst;   // 16 keys x 64 queries
    const bf16* b_src = is_dv ? s_dot : s_qt;   // (64 queries x D) as its transpose
#pragma unroll
    for (int j = 0; j < kT / 16; ++j) {
      uint32_t pa[4];
      a_fragment(pa, a_src + (kr + g) * LDT + j * 16 + 2 * t, LDT);
#pragma unroll
      for (int nd = 0; nd < NDB; ++nd) {
        const bf16* bb = b_src + (nd * 8 + g) * LDT + j * 16 + 2 * t;
        mma_16816(acc[nd], pa, ld32(bb), ld32(bb + 8));
      }
    }
  }

  bf16* out = is_dv ? a.dv + b * a.sdv.b + h * a.sdv.h : a.dk + b * a.sdk.b + h * a.sdk.h;
  const long long stride_n = is_dv ? a.sdv.n : a.sdk.n;
  const float mult = is_dv ? 1.f : a.scale;
  const int row0 = k0 + kr + g, row1 = row0 + 8;
#pragma unroll
  for (int nd = 0; nd < NDB; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 < a.n_k)
      *reinterpret_cast<uint32_t*>(out + row0 * stride_n + col) = pack_bf16(acc[nd][0] * mult, acc[nd][1] * mult);
    if (row1 < a.n_k)
      *reinterpret_cast<uint32_t*>(out + row1 * stride_n + col) = pack_bf16(acc[nd][2] * mult, acc[nd][3] * mult);
  }
}

template <int D, int DK>
__global__ void __launch_bounds__(kDqThreads)
attention_bwd_dq_kernel(BwdArgs a) {
  using S = Smem<D, DK>;
  constexpr int LD = S::LD, LDT = S::LDT;
  constexpr int NKS = DK / 16;
  constexpr int NDB = D / 8;
  constexpr int NSB = kT / 8;  // 8-key blocks of a score tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // queries x LD
  bf16* s_do = s_q + kT * LD;                 // queries x LD
  bf16* s_k = s_do + kT * LD;                 // keys x LD
  bf16* s_v = s_k + kT * LD;                  // keys x LD
  bf16* s_kt = s_v + kT * LD;                 // D x LDT: K^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kT;
  const bf16* q = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* k = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* v = a.v + b * a.sv.b + h * a.sv.h;
  const bf16* dout = a.dout + b * a.sdo.b + h * a.sdo.h;
  bf16* dq = a.dq + b * a.sdq.b + h * a.sdq.h;

  stage<D, DK, LD, LDT>(s_q, nullptr, q, a.sq.n, q0, a.n_q, kDqThreads);
  stage<D, DK, LD, LDT>(s_do, nullptr, dout, a.sdo.n, q0, a.n_q, kDqThreads);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const long long base = static_cast<long long>(bh) * a.n_q;
  const float lse0 = row0 < a.n_q ? a.lse[base + row0] : INFINITY;
  const float lse1 = row1 < a.n_q ? a.lse[base + row1] : INFINITY;
  const float dl0 = row0 < a.n_q ? a.delta[base + row0] : 0.f;
  const float dl1 = row1 < a.n_q ? a.delta[base + row1] : 0.f;

  float acc[NDB][4];
#pragma unroll
  for (int nd = 0; nd < NDB; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int k0 = 0; k0 < a.n_k; k0 += kT) {
    __syncthreads();  // the previous key tile has been consumed
    stage<D, DK, LD, LDT>(s_k, s_kt, k, a.sk.n, k0, a.n_k, kDqThreads);
    stage<D, DK, LD, LDT>(s_v, nullptr, v, a.sv.n, k0, a.n_k, kDqThreads);
    __syncthreads();

    float s[NSB][4], dp[NSB][4];
#pragma unroll
    for (int nb = 0; nb < NSB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      uint32_t qa[4], da[4];
      a_fragment(qa, s_q + (warp * 16 + g) * LD + kk * 16 + 2 * t, LD);
      a_fragment(da, s_do + (warp * 16 + g) * LD + kk * 16 + 2 * t, LD);
#pragma unroll
      for (int nb = 0; nb < NSB; ++nb) {
        const bf16* kb = s_k + (nb * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[nb], qa, ld32(kb), ld32(kb + 8));
        const bf16* vb = s_v + (nb * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(dp[nb], da, ld32(vb), ld32(vb + 8));
      }
    }
#pragma unroll
    for (int nb = 0; nb < NSB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nb][e] * a.scale_log2 - (e >= 2 ? lse1 : lse0));
        if (k0 + nb * 8 + 2 * t + (e & 1) >= a.n_k) p = 0.f;
        s[nb][e] = p * (dp[nb][e] - (e >= 2 ? dl1 : dl0));  // s now holds dS
      }
    }
#pragma unroll
    for (int j = 0; j < kT / 16; ++j) {
      uint32_t pa[4];
      p_fragment(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int nd = 0; nd < NDB; ++nd) {
        const bf16* kb = s_kt + (nd * 8 + g) * LDT + j * 16 + 2 * t;
        mma_16816(acc[nd], pa, ld32(kb), ld32(kb + 8));
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < NDB; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 < a.n_q)
      *reinterpret_cast<uint32_t*>(dq + row0 * a.sdq.n + col) = pack_bf16(acc[nd][0] * a.scale, acc[nd][1] * a.scale);
    if (row1 < a.n_q)
      *reinterpret_cast<uint32_t*>(dq + row1 * a.sdq.n + col) = pack_bf16(acc[nd][2] * a.scale, acc[nd][3] * a.scale);
  }
}

template <int D, int DK>
int launch_bwd(const BwdArgs& a, int batch, cudaStream_t stream) {
  using S = Smem<D, DK>;
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<D, DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kDkdvBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(attention_bwd_dq_kernel<D, DK>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDqBytes);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bhs = batch * a.heads;
  attention_bwd_dkdv_kernel<D, DK><<<dim3((a.n_k + kT - 1) / kT, bhs), kDkdvThreads,
                                     S::kDkdvBytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<D, DK><<<dim3((a.n_q + kT - 1) / kT, bhs), kDqThreads,
                                   S::kDqBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// C entry point.  Strides are the (batch, head, token) element strides of q,
// k, v, dout, dq, dk, dv in that order (21 values); the D stride is 1.  `lse`
// is kernel 1's log2-domain row log-sum-exp and `delta` rowsum(dO * O), both
// contiguous fp32 (batch * heads, n_q).  Launches the dK/dV kernel, then the
// dQ kernel, on `stream`.  Returns the first cudaError_t (0 = success); -1
// for a head_dim without an instantiation.
extern "C" int ccedit_spatial_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int batch, int heads, int n_q,
    int n_k, int head_dim, const long long* strides, float scale_log2, float scale,
    void* stream) {
  using ccedit::bf16;
  using ccedit::Strides;
  ccedit::BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.heads = heads;
  a.n_q = n_q;
  a.n_k = n_k;
  Strides* s[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.scale_log2 = scale_log2;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 40:
      return ccedit::launch_bwd<40, 48>(a, batch, st);
    case 80:
      return ccedit::launch_bwd<80, 80>(a, batch, st);
    case 160:
      return ccedit::launch_bwd<160, 160>(a, batch, st);
    default:
      return -1;
  }
}
