// Kernel 1: exact softmax attention for the UNet/ControlNet spatial
// attention, head_dim 40 (level 0, 6144 tokens), 80 (level 1, 1536) and 160
// (level 2 at geometries of 512 tokens and more, e.g. 1024 at 1024x1024).
// n_k may differ from n_q: the CFCA "center_self" cross-frame attention of
// the TVI2V network attends 6144 queries to 12288 keys (anchor frame + own).
//
// Replaces: ccedit_tpu/ops/spatial_attention.py `_kernel` / `_run` /
// `kv_resident_attention` (the k/v-VMEM-resident Pallas kernel).
//
// What bounds it on an H100: arithmetic.  At (34, 8, 6144, 40) the two
// products are 4*272*6144^2*40 = 1.64 TFLOP against 0.5 GB of q/k/v/out, far
// above the card's bf16 ridge point of ~295 FLOP/byte; the fp32 score tensor
// (41 GB at level 0) cannot be materialised at all.
//
// Design: flash-style forward.  One block of 4 warps per (batch*head,
// 64-query tile); each warp owns 16 query rows.  K and V tiles of 64 keys are
// staged through shared memory (V transposed, so the P.V operand reads two
// neighbouring keys with one 32-bit load).  Scores, probabilities and the
// output accumulator stay in registers (mma.sync m16n8k16, fp32 accumulate);
// the softmax is an fp32 online softmax with log2(e) folded into the scale
// and exp2, as the TPU kernel does.  The online softmax takes any n_k, so the
// same kernel covers the TPU kernel's multi-chunk n_k = 2*n_q case (its
// `n_chunks > 1` branch): keys are walked in 64-key tiles whatever n_k is,
// the last tile masked by `k0 + r < n_k`.
//
// Shared memory: Q is staged through the K tile buffer (it moves to
// registers before the first K tile arrives), so a block holds one 64-row
// Q/K buffer and the transposed V tile: 44 KB at head_dim 160, under the
// 48 KB static limit.  At head_dim 160 a thread keeps 80 fp32 accumulators
// and 40 Q-fragment registers (the 16-row warp tile of mma.sync).
//
// Head-dim padding: the QK^T contraction runs in k-steps of 16, and 40 is not
// a multiple of 16.  Q and K are staged with DK = 48 columns whose last 8 are
// zeros, so the padded products add exact zeros.  The P.V product needs no
// pad: its output columns come in blocks of 8, and 40 = 5*8.  The TPU kernel's
// "head_dim in sublanes" transposed layout is a TPU fact and is not used.
//
// Training: given a non-null `lse`, the kernel also writes each row's fp32
// log-sum-exp in the log2 domain of its scores, m + log2(l) over
// s * scale_log2, to lse[b*h, row]; the backward (spatial_attention_bwd.cu)
// recomputes P = exp2(s * scale_log2 - lse) from it.  Inference passes null
// and writes nothing more.
//
// Left for later: cp.async/TMA double buffering, wgmma, ldmatrix.
#include "attention_common.cuh"

namespace ccedit {

namespace {

constexpr int kBM = 64;      // query rows per block (16 per warp)
constexpr int kBN = 64;      // keys per staged tile
constexpr int kThreads = 128;

template <int D, int DK>
__global__ void __launch_bounds__(kThreads)
spatial_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int heads, int n_q, int n_k,
                         Strides sq, Strides sk, Strides sv, Strides so,
                         float scale_log2) {
  constexpr int LDQ = DK + 8;   // smem row pitch of Q and K (bank-conflict free)
  constexpr int LDV = kBN + 8;  // smem row pitch of V^T
  constexpr int NKS = DK / 16;  // k-steps of QK^T
  constexpr int NDB = D / 8;    // 8-wide output column blocks
  constexpr int NSB = kBN / 8;  // 8-wide key blocks of a score tile
  constexpr int VPR = D / 8;    // 16-byte vectors per global row

  static_assert(kBM == kBN, "Q is staged through the K tile buffer");
  __shared__ __align__(16) bf16 s_k[kBN * LDQ];
  __shared__ __align__(16) bf16 s_vt[D * LDV];
  bf16* s_q = s_k;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBM;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  o += b * so.b + h * so.h;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kBM * VPR; i += kThreads) {
    const int r = i / VPR, c = i % VPR;
    st128(s_q + r * LDQ + c * 8, q0 + r < n_q ? ld128(q + (q0 + r) * sq.n + c * 8) : zero);
  }
  if constexpr (DK > D) {  // zero pad columns [D, DK) of the Q/K buffer once
    constexpr int PAD = (DK - D) / 8;
    for (int i = tid; i < kBN * PAD; i += kThreads) {
      const int r = i / PAD, c = D / 8 + i % PAD;
      st128(s_k + r * LDQ + c * 8, zero);
    }
  }
  __syncthreads();

  uint32_t qa[NKS][4];
  {
    const bf16* base = s_q + (warp * 16 + g) * LDQ + 2 * t;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      qa[kk][0] = ld32(base + kk * 16);
      qa[kk][1] = ld32(base + 8 * LDQ + kk * 16);
      qa[kk][2] = ld32(base + kk * 16 + 8);
      qa[kk][3] = ld32(base + 8 * LDQ + kk * 16 + 8);
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
      uint4 kv = zero, vv = zero;
      if (k0 + r < n_k) {
        kv = ld128(k + (k0 + r) * sk.n + c * 8);
        vv = ld128(v + (k0 + r) * sv.n + c * 8);
      }
      st128(s_k + r * LDQ + c * 8, kv);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) s_vt[(c * 8 + j) * LDV + r] = ve[j];
    }
    __syncthreads();

    float s[NSB][4];
#pragma unroll
    for (int nb = 0; nb < NSB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NSB; ++nb) {
        const bf16* kb = s_k + (nb * 8 + g) * LDQ + kk * 16 + 2 * t;
        mma_16816(s[nb], qa[kk], ld32(kb), ld32(kb + 8));
      }
    }
#pragma unroll
    for (int nb = 0; nb < NSB; ++nb) {
      s[nb][0] *= scale_log2; s[nb][1] *= scale_log2;
      s[nb][2] *= scale_log2; s[nb][3] *= scale_log2;
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
  if (lse != nullptr && t == 0) {  // m and l are full-row values in every lane of the quad
    float* row_lse = lse + static_cast<long long>(bh) * n_q;
    if (row0 < n_q) row_lse[row0] = m[0] + log2f(l[0]);
    if (row1 < n_q) row_lse[row1] = m[1] + log2f(l[1]);
  }
}

template <int D, int DK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int heads, int n_q, int n_k, Strides sq, Strides sk,
           Strides sv, Strides so, float scale_log2, cudaStream_t stream) {
  dim3 grid((n_q + kBM - 1) / kBM, batch * heads);
  spatial_attention_kernel<D, DK><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, heads, n_q, n_k,
      sq, sk, sv, so, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// C entry point.  Strides are (batch, head, token) element strides of the
// (B, H, N, D) operands; the D stride is 1.  `lse` is null or a contiguous
// fp32 (batch * heads, n_q) output.  Returns the launch's cudaError_t
// (0 = success); -1 for a head_dim without an instantiation.
extern "C" int ccedit_spatial_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch,
    int heads, int n_q, int n_k, int head_dim, const long long* strides,
    float scale_log2, void* stream) {
  using ccedit::Strides;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (head_dim) {
    case 40:
      return ccedit::launch<40, 48>(q, k, v, o, l, batch, heads, n_q, n_k, sq, sk, sv, so, scale_log2, st);
    case 80:
      return ccedit::launch<80, 80>(q, k, v, o, l, batch, heads, n_q, n_k, sq, sk, sv, so, scale_log2, st);
    case 160:
      return ccedit::launch<160, 160>(q, k, v, o, l, batch, heads, n_q, n_k, sq, sk, sv, so, scale_log2, st);
    default:
      return -1;
  }
}

// Message for a cudaError_t returned by one of the entry points.
extern "C" const char* ccedit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
