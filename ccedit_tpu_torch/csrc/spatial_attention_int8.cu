// Kernel 1c: kernel 1 with an int8 QK^T (the opt-in int8 QK^T path,
// head_dim 40 and 80, any n_k).  It keeps the first port's simple mma.sync
// design, kept for the int8 path until its own redesign (an s8 wgmma QK^T
// after a fused quantizing pre-pass); exact kernel 1 is the Hopper design
// of spatial_attention.cu.
//
// Replaces: ccedit_tpu/ops/spatial_attention.py `kv_resident_attention`'s
// `quant=True` path (:190-202; `_kernel` :59, `_run` :113).
//
// What bounds it on an H100: the exponentials (272*6144^2 exp2 at (34, 8,
// 6144, 40): 2.63 ms), then the tensor cores; the int8 products halve only
// the QK^T half of the tensor time, which is not the bound.
//
// Design: flash-style forward.  One block of 4 warps per (batch*head,
// 64-query tile); each warp owns 16 query rows.  K and V tiles of 64 keys are
// staged through shared memory (V transposed, so the P.V operand reads two
// neighbouring keys with one 32-bit load).  Scores, probabilities and the
// output accumulator stay in registers (mma.sync, fp32 accumulate); the
// softmax is an fp32 online softmax with log2(e) folded into the scale and
// exp2, as the TPU kernel does, over 64-key tiles whatever n_k is, the last
// tile masked by `k0 + r < n_k`.  Q is staged through the K tile buffer (it
// moves to registers before the first K tile arrives).
//
// q8 and k8 arrive from the wrapper's quantisation pre-pass already
// zero-padded to DK bytes a row (40 -> 48, 80 -> 80), so rows stay whole
// 16-byte vectors.  QK^T runs in mma.sync m16n8k32 s8 steps of 32 bytes
// plus one m16n8k16 s8 step for the last 16 (48 = 32 + 16, 80 = 2*32 + 16),
// with exact int32 sums (|S| <= 127^2 * 80 < 2^24, so the fp32 conversion
// is exact too).  The fp32 logits scale, scale * amax_q * amax_k / 127^2
// for this (batch, head), is read from `scales[b*h]` on the device and
// multiplied by log2(e) as the TPU kernel does; softmax and P.V are bf16.
// The int8 Q/K tile pitch of DK bytes (48 or 80) spreads the 8 rows of a
// fragment load over all 32 banks.
#include "attention_common.cuh"

namespace ccedit {

namespace {

constexpr int kBM = 64;      // query rows per block (16 per warp)
constexpr int kBN = 64;      // keys per staged tile
constexpr int kThreads = 128;

template <int D, int DK>
__global__ void __launch_bounds__(kThreads)
spatial_attention_int8_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         const float* __restrict__ scales,
                         int heads, int n_q, int n_k,
                         Strides sq, Strides sk, Strides sv, Strides so) {
  constexpr int LDQ = DK;                      // smem row pitch of Q and K, bytes (bank-conflict free)
  constexpr int LDV = kBN + 8;                 // smem row pitch of V^T, elements
  constexpr int KB = DK;                       // contraction bytes of a Q/K row
  constexpr int NKS = KB / 32;                 // 32-byte steps of QK^T
  constexpr bool TAIL = KB % 32 != 0;          // int8: a last 16-byte step
  constexpr int NDB = D / 8;                   // 8-wide output column blocks
  constexpr int NSB = kBN / 8;                 // 8-wide key blocks of a score tile
  constexpr int VPR = D / 8;                   // 16-byte vectors per global bf16 row
  constexpr int QVPR = DK / 16;                // 16-byte vectors per global q/k row
  static_assert(DK % 16 == 0, "int8 q/k rows are whole 16-byte vectors");

  static_assert(kBM == kBN, "Q is staged through the K tile buffer");
  __shared__ __align__(16) unsigned char s_k[kBN * LDQ];
  __shared__ __align__(16) bf16 s_vt[D * LDV];
  unsigned char* s_q = s_k;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBM;
  const unsigned char* q = static_cast<const unsigned char*>(q_) + (b * sq.b + h * sq.h);
  const unsigned char* k = static_cast<const unsigned char*>(k_) + (b * sk.b + h * sk.h);
  v += b * sv.b + h * sv.h;
  o += b * so.b + h * so.h;
  const float scale_log2 = scales[bh] * kLog2e;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kBM * QVPR; i += kThreads) {
    const int r = i / QVPR, c = i % QVPR;
    st128b(s_q + r * LDQ + c * 16,
           q0 + r < n_q ? ld128b(q + (q0 + r) * sq.n + c * 16) : zero);
  }
  __syncthreads();

  uint32_t qa[NKS][4], qt[2];
  {
    const unsigned char* base = s_q + (warp * 16 + g) * LDQ + 4 * t;
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
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  for (int k0 = 0; k0 < n_k; k0 += kBN) {
    __syncthreads();  // the previous tile (on the first pass, Q) has been consumed
    for (int i = tid; i < kBN * VPR; i += kThreads) {
      const int r = i / VPR, c = i % VPR;
      const uint4 vv = k0 + r < n_k ? ld128(v + (k0 + r) * sv.n + c * 8) : zero;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_vt[(c * 8 + j) * LDV + r] = ve[j];
    }
    for (int i = tid; i < kBN * QVPR; i += kThreads) {
      const int r = i / QVPR, c = i % QVPR;
      st128b(s_k + r * LDQ + c * 16,
             k0 + r < n_k ? ld128b(k + (k0 + r) * sk.n + c * 16) : zero);
    }
    __syncthreads();

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
    float s[NSB][4];
#pragma unroll
    for (int nb = 0; nb < NSB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = static_cast<float>(si[nb][e]) * scale_log2;
    }
    online_softmax<NSB>(s, k0, t, n_k, m, l, corr);
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

  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int nd = 0; nd < NDB; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 < n_q)
      *reinterpret_cast<uint32_t*>(o + row0 * so.n + col) = pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
    if (row1 < n_q)
      *reinterpret_cast<uint32_t*>(o + row1 * so.n + col) = pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
  }
}

template <int D, int DK>
int launch(const void* q8, const void* k8, const void* v, void* o, const float* scales,
           int batch, int heads, int n_q, int n_k, Strides sq, Strides sk, Strides sv,
           Strides so, cudaStream_t stream) {
  dim3 grid((n_q + kBM - 1) / kBM, batch * heads);
  spatial_attention_int8_kernel<D, DK><<<grid, kThreads, 0, stream>>>(
      q8, k8, static_cast<const bf16*>(v), static_cast<bf16*>(o), scales, heads, n_q, n_k,
      sq, sk, sv, so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// Kernel 1c's entry point.  q8 and k8 are int8 (B, H, N, DK) with DK the
// head_dim rounded up to 16 and zero columns past head_dim; `scales` is the
// contiguous fp32 (batch * heads) folded logits scale.  Strides are the
// (batch, head, token) strides of q8, k8, v and out, in bytes for q8 and k8
// and in elements for v and out; the last dimension's stride is 1.  Returns
// the launch's cudaError_t (0 = success); -1 for a head_dim without an
// instantiation.
extern "C" int ccedit_spatial_attention_int8(
    const void* q8, const void* k8, const void* v, void* o, const void* scales,
    int batch, int heads, int n_q, int n_k, int head_dim, const long long* strides,
    void* stream) {
  using ccedit::Strides;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  switch (head_dim) {
    case 40:
      return ccedit::launch<40, 48>(q8, k8, v, o, sc, batch, heads, n_q, n_k, sq, sk, sv, so, st);
    case 80:
      return ccedit::launch<80, 80>(q8, k8, v, o, sc, batch, heads, n_q, n_k, sq, sk, sv, so, st);
    default:
      return -1;
  }
}
