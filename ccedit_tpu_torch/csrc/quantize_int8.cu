// Kernel 8: the W8A8 path's quantizer -- symmetric int8 with one scale per
// row or one for the whole tensor, bit for bit the JAX package's
// `_symmetric_q` (ccedit_tpu/ops/quant.py:61-72):
//   amax  = max |x|                         (over a row, or the tensor)
//   scale = amax > 0 ? amax / 127 : 1
//   q     = clip(round(x / scale), -127, 127)   round half to even
// in fp32 from bf16 or fp32 x, true quotients (__fdiv_rn; the build has no
// fast-math flag), rintf's half-to-even.  The max does not depend on the
// order of its operands, so the atomics of the per-tensor mode leave the
// result deterministic.
//
// Replaces no Pallas kernel: the JAX package runs the quantizer in XLA.  The
// port has it by hand because its int8 products (int8_gemm.cu's dequant
// GEMM, int8_conv.cu) read its padded layout.
//
// Layout.  x is a contiguous (R, G * L) tensor: R rows of G groups of L
// values.  q is (R, G * Lp), each group zero-padded to Lp = L rounded up to
// 16 (whole 16-byte vectors: TMA's global strides and cp.async's 16-byte
// copies need them).  Dense activations: rows = tokens, G = 1, per-row
// scales.  Weights: rows = output channels, G = kh * kw taps of L = C_in
// (the products' K order: taps outer, channels inner), per-row scales.  Conv
// activations: rows = pixels, G = 1, L = C, one scale for the tensor.
//
// What bounds it on an H100: memory.  Per row it reads x twice (the second
// time from L1/L2) and writes q once; per tensor it reads x twice from
// device memory (the amax must be known before any value quantizes) and
// writes q once: at the level-0 conv input (34, 64, 96, 320) bf16, 134 MB
// x 2 + 67 MB, 0.10 ms at 3.35 TB/s.
//
// Design.  Per row: one warp a row computes the amax (shuffles), then
// writes the row's 16-byte output vectors.  Per tensor: a grid-stride amax
// kernel whose blocks combine with atomicMax on the max's bits (a
// non-negative fp32 orders as an unsigned integer) into a device word the
// wrapper zeroes, then a quantize kernel, one thread a 16-byte output
// vector, that reads the word: the scale never visits the host.  Where L is
// a multiple of 16 a thread reads its 16 values as 16-byte vectors; else
// value by value (conv_in's 4 channels, the RGB hint's 3).
#include "attention_common.cuh"

namespace ccedit {

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

__device__ __forceinline__ uint32_t q8(float v, float scale) {
  const int q = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f));
  return static_cast<uint32_t>(q) & 0xffu;
}

// 16 values from 16-byte aligned p
__device__ __forceinline__ void load16(const bf16* p, float (&v)[16]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + 8 * h);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[8 * h + 2 * i] = __uint_as_float(w[i] << 16);
      v[8 * h + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 u = *reinterpret_cast<const float4*>(p + 4 * h);
    v[4 * h] = u.x;
    v[4 * h + 1] = u.y;
    v[4 * h + 2] = u.z;
    v[4 * h + 3] = u.w;
  }
}

// output vector j of a group: the quantized values c0 .. c0 + 15 of `xg`
// (length `len`), zeros past it
template <typename T>
__device__ __forceinline__ uint4 quantize16(const T* xg, int c0, int len, float scale, bool vec) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (vec) {
    float v[16];
    load16(xg + c0, v);
#pragma unroll
    for (int e = 0; e < 16; ++e) w[e / 4] |= q8(v[e], scale) << (8 * (e % 4));
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (c0 + e < len) w[e / 4] |= q8(to_f(xg[c0 + e]), scale) << (8 * (e % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ x, unsigned char* __restrict__ q, float* __restrict__ scales,
            long long rows, int groups, int len, int len_p, bool vec) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long n = static_cast<long long>(groups) * len;
  const T* xr = x + row * n;
  float m = 0.f;
  if (vec) {
    for (long long i = 16LL * lane; i < n; i += 32 * 16) {
      float v[16];
      load16(xr + i, v);
#pragma unroll
      for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(v[e]));
    }
  } else {
    for (long long i = lane; i < n; i += 32) m = fmaxf(m, fabsf(to_f(xr[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float scale = scale_of(m);
  const int chunks = len_p / 16;
  unsigned char* qr = q + row * groups * len_p;
  for (int i = lane; i < groups * chunks; i += 32) {
    const int g = i / chunks, j = i % chunks;
    st128b(qr + static_cast<long long>(g) * len_p + 16 * j,
           quantize16(xr + static_cast<long long>(g) * len, 16 * j, len, scale, vec));
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tensor_amax_kernel(const T* __restrict__ x, unsigned* __restrict__ amax, long long n, bool vec) {
  float m = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec) {
    for (long long i = first; i < n / 16; i += stride) {
      float v[16];
      load16(x + 16 * i, v);
#pragma unroll
      for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(v[e]));
    }
  } else {
    for (long long i = first; i < n; i += stride) m = fmaxf(m, fabsf(to_f(x[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, warp_max[i]);
    atomicMax(amax, __float_as_uint(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tensor_quantize_kernel(const T* __restrict__ x, unsigned char* __restrict__ q,
                       const unsigned* __restrict__ amax, float* __restrict__ scales,
                       long long rows, int len, int len_p, bool vec) {
  const int chunks = len_p / 16;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows * chunks) return;
  const long long row = i / chunks;
  const int j = static_cast<int>(i - row * chunks);
  const float scale = scale_of(__uint_as_float(*amax));
  st128b(q + 16 * i, quantize16(x + row * len, 16 * j, len, scale, vec));
  if (i == 0) scales[0] = scale;
}

template <typename T>
int launch(int per_row, const void* x_, void* q_, void* scales_, void* amax_, long long rows,
           int groups, int len, int len_p, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  unsigned char* q = static_cast<unsigned char*>(q_);
  float* scales = static_cast<float*>(scales_);
  const bool vec = len % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (per_row) {
    const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
    rows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(x, q, scales, rows, groups,
                                                                         len, len_p, vec);
    return static_cast<int>(cudaGetLastError());
  }
  unsigned* amax = static_cast<unsigned*>(amax_);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = rows * len, units = vec ? n / 16 : n;
  const long long want = (units + kThreads * 16LL - 1) / (kThreads * 16LL);
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want > 65536 ? 65536 : want));
  tensor_amax_kernel<T><<<blocks, kThreads, 0, st>>>(x, amax, n, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vectors = rows * (len_p / 16);
  tensor_quantize_kernel<T><<<static_cast<unsigned>((vectors + kThreads - 1) / kThreads), kThreads,
                              0, st>>>(x, q, amax, scales, rows, len, len_p, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// Kernel 8.  x: contiguous (rows, groups * len), bf16 (fp32 = 0) or fp32;
// q: contiguous int8 (rows, groups * len_p); scales: fp32 (rows) per row or
// (1) per tensor; amax: one 32-bit word of scratch (per tensor; zeroed
// here).  Per tensor takes groups = 1.  Returns the launches' cudaError_t
// (0 = success); -1 for arguments it does not take.
extern "C" int ccedit_quantize_int8(int fp32, int per_row, const void* x, void* q, void* scales,
                                    void* amax, long long rows, int groups, int len, int len_p,
                                    void* stream) {
  using namespace ccedit;
  if (rows <= 0 || groups <= 0 || len <= 0 || len_p < len || len_p % 16 ||
      (!per_row && groups != 1))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? launch<float>(per_row, x, q, scales, amax, rows, groups, len, len_p, st)
              : launch<bf16>(per_row, x, q, scales, amax, rows, groups, len, len_p, st);
}
