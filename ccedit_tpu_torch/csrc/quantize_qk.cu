// Kernel 1c's pre-pass: per-(batch, head) symmetric int8 quantization of q
// and k, and the folded logits scale, bit for bit the JAX one.
//
// Replaces: ccedit_tpu/ops/spatial_attention.py `kv_resident_attention`
// :191-201 (plain XLA in the JAX package):
//   a  = max(max |x| over (N, D), 1e-6)              per (b, h), x = q, k
//   x8 = clip(round(x * (127 / a)), -127, 127)       round half to even
//   scale_bh = scale * (a_q * a_k) / (127 * 127)
// Every step is the same fp32 operation in the same order: true quotients
// (__fdiv_rn), products rounded once (__fmul_rn, so nvcc cannot contract
// them into an FMA), rintf's half-to-even; the build has no fast-math flag.
// The max does not depend on the order of its operands, so the atomics
// below leave the result deterministic.
//
// What bounds it on an H100: memory.  It reads q and k twice (the max must
// be known before any row quantizes; at level 0, 2 x 134 MB, more than the
// 50 MB L2) and writes the int8 rows once: at (34, 8, 6144, 40), 535 MB +
// 160 MB, 0.21 ms at 3.35 TB/s (0.13 ms for each byte once).
//
// Design: two launches after a memset of the (2, B*H) max buffer.
//   1. amax_kernel: grid (blocks, B*H, q|k).  Each thread reduces 16-byte
//      vectors (8 bf16) of one (b, h) slab with a grid stride, the block
//      reduces through shuffles and shared memory, and thread 0 combines
//      the blocks with atomicMax on the max's bits (a non-negative fp32
//      orders as an unsigned integer).  q and k come in any (B, H, N, D)
//      strides with a unit D stride (the model's head-split view reads as
//      80- or 160-byte pieces of 640-byte rows; neighbouring heads' blocks
//      run together and share the L2's sectors).
//   2. quantize_kernel: one thread per 16-byte vector of the output, which
//      is contiguous (B, H, N, DK) int8, DK = D rounded up to 16 (40 -> 48;
//      64 and 80 need no padding),
//      the columns past D zero: kernel 1c's TMA maps read it.  A thread
//      reads the one or two 16-byte vectors of x under its output vector
//      and writes one 16-byte store.  The thread of each (b, h)'s first q
//      vector writes the folded scale.
#include "attention_common.cuh"

namespace ccedit {

namespace {

constexpr int kThreads = 256;
constexpr int kVectorsPerThread = 16;  // amax_kernel's share of a slab a thread

// max |x| over the 8 bf16 of a 16-byte vector (bf16 to fp32 is a shift)
__device__ __forceinline__ float vec_amax(uint4 v) {
  const uint32_t w[4] = {v.x & 0x7fff7fffu, v.y & 0x7fff7fffu, v.z & 0x7fff7fffu,
                         v.w & 0x7fff7fffu};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = fmaxf(m, fmaxf(__uint_as_float(w[i] << 16), __uint_as_float(w[i] & 0xffff0000u)));
  return m;
}

__global__ void __launch_bounds__(kThreads)
amax_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, unsigned* __restrict__ amax,
            int heads, int n_q, int n_k, int vectors_per_row, Strides sq, Strides sk) {
  const int z = blockIdx.z, bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const Strides s = z ? sk : sq;
  const bf16* x = (z ? k : q) + b * s.b + h * s.h;
  const long long total = static_cast<long long>(z ? n_k : n_q) * vectors_per_row;
  float m = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / vectors_per_row;
    const int c = static_cast<int>(i - r * vectors_per_row);
    m = fmaxf(m, vec_amax(ld128(x + r * s.n + 8 * c)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, warp_max[i]);
    atomicMax(amax + z * gridDim.y + bh, __float_as_uint(m));
  }
}

// clip(round(x * r), -127, 127) of two bf16 in a 32-bit word, as int8 bytes
__device__ __forceinline__ uint32_t quantize2(uint32_t w, float r) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  const int a = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(lo, r)), -127.f), 127.f));
  const int b = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(hi, r)), -127.f), 127.f));
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8);
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                unsigned char* __restrict__ q8, unsigned char* __restrict__ k8,
                const unsigned* __restrict__ amax, float* __restrict__ scales, int bhs,
                int heads, int n_q, int n_k, int d, Strides sq, Strides sk, float scale) {
  const int z = blockIdx.y, n = z ? n_k : n_q, w16 = (d + 15) / 16;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(bhs) * n * w16) return;
  const int c = static_cast<int>(i % w16);
  const long long row = i / w16;
  const int r = static_cast<int>(row % n), bh = static_cast<int>(row / n);
  const int b = bh / heads, h = bh % heads;
  const float a = fmaxf(__uint_as_float(amax[z * bhs + bh]), 1e-6f);
  const float factor = __fdiv_rn(127.f, a);
  const Strides s = z ? sk : sq;
  const bf16* x = (z ? k : q) + b * s.b + h * s.h + r * s.n + 16 * c;
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  const uint4 lo = ld128(x);  // columns 16c .. 16c + 7 (d % 8 == 0: all or none)
  out.x = quantize2(lo.x, factor) | (quantize2(lo.y, factor) << 16);
  out.y = quantize2(lo.z, factor) | (quantize2(lo.w, factor) << 16);
  if (16 * c + 8 < d) {
    const uint4 hi = ld128(x + 8);
    out.z = quantize2(hi.x, factor) | (quantize2(hi.y, factor) << 16);
    out.w = quantize2(hi.z, factor) | (quantize2(hi.w, factor) << 16);
  }
  st128b((z ? k8 : q8) + 16 * i, out);
  if (z == 0 && r == 0 && c == 0) {
    const float aq = a, ak = fmaxf(__uint_as_float(amax[bhs + bh]), 1e-6f);
    scales[bh] = __fdiv_rn(__fmul_rn(scale, __fmul_rn(aq, ak)), 127.f * 127.f);
  }
}

}  // namespace

}  // namespace ccedit

// Kernel 1c's pre-pass.  q and k are bf16 (B, H, N_q | N_k, D) with element
// strides (batch, head, token) in `strides` (q's, then k's) and a unit D
// stride, D % 8 == 0; q8 and k8 are contiguous int8 (B, H, N, DK) outputs,
// DK = D rounded up to 16; `amax` is (2, B*H) 32-bit scratch, zeroed here;
// `scales` the fp32 (B*H) output.  Returns the launches' cudaError_t (0 =
// success); -1 for a D that is not a multiple of 8 or empty operands.
extern "C" int ccedit_quantize_qk(const void* q, const void* k, void* q8, void* k8, void* amax,
                                  void* scales, int batch, int heads, int n_q, int n_k,
                                  int head_dim, const long long* strides, float scale,
                                  void* stream) {
  using namespace ccedit;
  if (head_dim % 8 != 0 || head_dim <= 0 || n_q <= 0 || n_k <= 0 || batch * heads <= 0) return -1;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bhs = batch * heads, n = n_q > n_k ? n_q : n_k;
  unsigned* bits = static_cast<unsigned*>(amax);
  cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(unsigned) * 2 * bhs, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slab = static_cast<long long>(n) * (head_dim / 8);
  const int per_slab = static_cast<int>((slab + kThreads * kVectorsPerThread - 1) /
                                        (kThreads * kVectorsPerThread));
  amax_kernel<<<dim3(per_slab, bhs, 2), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), bits, heads, n_q, n_k,
      head_dim / 8, sq, sk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vectors = static_cast<long long>(bhs) * n * ((head_dim + 15) / 16);
  quantize_kernel<<<dim3(static_cast<unsigned>((vectors + kThreads - 1) / kThreads), 2),
                    kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<unsigned char*>(q8),
      static_cast<unsigned char*>(k8), bits, static_cast<float*>(scales), bhs, heads, n_q, n_k,
      head_dim, sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}
