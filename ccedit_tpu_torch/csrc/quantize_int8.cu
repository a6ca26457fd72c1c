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
//
// The fused norm form (ccedit_norm_silu_quantize): the per-tensor int8 rows
// of silu(group_norm(x + add)), the input of every ResBlock conv under W8A8,
// from the bf16 activation where it lies, with no bf16 GroupNorm or SiLU
// output in device memory.  x is (S, P, C): S samples (an image's frame, or
// a folded (h, b, w) row of the temporal GroupNorm), P positions, C
// channels in G groups; `add` an optional (S, C) addend (the ResBlock's
// embedding), rounded into x in bf16 first, as the plain chain's add does.
// Each value goes as the plain chain (the port's GroupNorm module -> SiLU ->
// _symmetric_q on the card) computes it, bit for bit:
//   v = bf16(x + add)
//   mean, rstd of each (sample, group): torch's CUDA GroupNorm statistics
//     of the input in fp32 (RowwiseMomentsCUDAKernel: Welford in its thread
//     order, its reduction tree, rsqrtf(var + eps), all in fp32, as flax
//     keeps a bf16 GroupNorm's statistics)
//   k = rstd * gamma;  b = beta - k * mean        (torch's fused parameters)
//   u = bf16(k * v + b);  y = bf16(u / (1 + exp(-u)))
//   q = clip(round(y / scale), -127, 127),  scale = max|y| / 127
// Any other order of the statistics' sums moves a mean or an rstd by an ulp
// now and then, which can flip a u across a bf16 rounding boundary; int8
// codes flip behind it and the flips cascade through a W8A8 network, so the
// order is torch's own.  On the card the GroupNorm module itself runs the
// statistics stage and then writes u (the norm form, ccedit_group_norm), so
// the fused form is the module's chain by construction.
//
// Under a clip shard (the clip's rows split over the ranks) an image
// GroupNorm's statistics span the ranks: the caller computes each (sample,
// channel)'s fp32 scale and shift from sums all-reduced over the ranks, and
// the external-statistics form takes them, u = bf16(bf16(x + add) * scale
// + shift) as the sharded module computes it (a product, then a sum, each
// rounded: no fma); it skips the statistics and keeps the extremes.  Every
// form under a shard runs in two stages: up to the local amax (the word
// words[3]), which the caller MAX all-reduces over the ranks (a
// non-negative fp32 orders as its bits), then the quantize pass with it.
//
// What bounds it: the statistics follow torch's order, in which a thread
// walks a group channel by channel, each channel's positions T apart, a
// sequence of dependent divisions; in channels-last memory that is one
// 2-byte value a row, so a block stages its group's rows through shared
// memory where a chunk of its channels fits (64 KB), and reads in place
// where not (the VAE's full-resolution rows; the temporal GroupNorm's
// 17-row samples, which stay in L1).  The amax comes without another
// read: u is monotone in v for each (sample, channel) (an affine map, then
// rounding), and |y| is monotone in u on each side of SiLU's minimum (u* =
// -1.2785, |y| <= 0.2793 in bf16), so the amax is the largest |y| at each
// (sample, channel)'s min and max of v -- unless that is below kSiluPeak
// while some channel's u-interval reaches SiLU's minimum (kSiluWindow).
// Then a third pass computes max|y| over the tensor (the device's decision:
// the host never waits), counted in `third`.  The quantize pass reads x
// once more and writes q once: at level 0 (34, 64, 96, 320) the bound is
// 134 MB x 2 + 67 MB at 3.35 TB/s, 0.10 ms; the unfused chain moves about
// five times that.
//
// The quantize pass: a wave of blocks each walking a range of rows, one
// thread 4 channels of a row with the next row's load in flight, SiLU from a
// shared-memory table of every bf16 input between 2^-10 and 2^5 (built by
// the block from the formula), int8 by kernel 9's quotient (a reciprocal,
// two Markstein corrections, a magic-number rounding).  The stages stay apart
// (statistics, amax word, quantize), so a sharded run all-reduces the amax
// between them; the per-tensor mode likewise (ccedit_quantize_int8's stages).
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

// the per-tensor amax into the word `amax` (zeroed first)
template <typename T>
int tensor_amax(const T* x, unsigned* amax, long long n, bool vec, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = vec ? n / 16 : n;
  const long long want = (units + kThreads * 16LL - 1) / (kThreads * 16LL);
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want > 65536 ? 65536 : want));
  tensor_amax_kernel<T><<<blocks, kThreads, 0, st>>>(x, amax, n, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tensor_quantize(const T* x, unsigned char* q, const unsigned* amax, float* scales,
                    long long rows, int len, int len_p, bool vec, cudaStream_t st) {
  const long long vectors = rows * (len_p / 16);
  tensor_quantize_kernel<T><<<static_cast<unsigned>((vectors + kThreads - 1) / kThreads), kThreads,
                              0, st>>>(x, q, amax, scales, rows, len, len_p, vec);
  return static_cast<int>(cudaGetLastError());
}

// per_row, or per tensor in `stages` (1: the amax into the word, 2: the
// quantize pass reading it, 3: both)
template <typename T>
int launch(int per_row, int stages, const void* x_, void* q_, void* scales_, void* amax_,
           long long rows, int groups, int len, int len_p, cudaStream_t st) {
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
  if (stages & 1) {
    const int err = tensor_amax<T>(x, amax, rows * len, vec, st);
    if (err != 0) return err;
  }
  if (stages & 2) return tensor_quantize<T>(x, q, amax, scales, rows, len, len_p, vec, st);
  return 0;
}

// ---- the fused norm form ----

constexpr float kSiluWindowLo = -1.5f, kSiluWindowHi = -1.0f;  // around SiLU's minimum
constexpr float kSiluPeak = 0.28f;  // above every |bf16(silu(u))| (the minimum rounds to 0.2793)
constexpr int kStageBytes = 64 * 1024;  // the statistics' shared-memory stage: 3 blocks an SM
constexpr int kApplyRows = 16;  // rows a thread of the quantize pass walks, at least

struct NormArgs {
  const bf16* x;     // (S, P, C), contiguous
  const bf16* add;   // (S, C) or null
  const void* gamma;  // (C) or null (1)
  const void* beta;   // (C) or null (0)
  int affine_fp32;
  long long s, p;
  int c, g, cg;
  float eps;
  int fault;         // 1: each sample quantized with its own amax; 2: statistics over P / 2
  const float* ext_scale;  // (S, C) or null: u = bf16(v * scale + shift), the statistics
  const float* ext_shift;  // computed outside (over a clip shard's ranks)
  int extremes;      // track each channel's min and max for the amax (not the norm form)
  int global;        // the quantize pass reads its amax from words[3] (a caller's all-reduce)
  unsigned char* q;  // (S * P, C)
  float* scale;      // (1)
  bf16* out;         // (S * P, C): the norm form's GroupNorm output
  // workspace
  unsigned* words;   // [0] endpoint amax bits, [1] a channel reaches SiLU's minimum,
                     // [2] the third pass's amax bits, [3] the local amax (staged form)
  float* amax_s;     // (S) each sample's endpoint amax
  float* mean;       // (S, G)
  float* rstd;       // (S, G)
  int* third;        // third passes taken (cumulative)
};

// whether the third pass must run: the endpoint amax is below every
// |silu| SiLU's minimum can give while a channel's u-interval reaches it
__device__ __forceinline__ bool third_pass_needed(const NormArgs& a) {
  return a.words[1] != 0u && __uint_as_float(a.words[0]) < kSiluPeak;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float lo_bf(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float affine(const void* t, int fp32, int c, float none) {
  if (t == nullptr) return none;
  return fp32 ? static_cast<const float*>(t)[c] : __bfloat162float(static_cast<const bf16*>(t)[c]);
}

// the GroupNorm of channel c as one fma: u = k * v + b
__device__ __forceinline__ void coeffs(const NormArgs& a, float mean, float rstd, int c, float& k,
                                       float& b) {
  k = __fmul_rn(rstd, affine(a.gamma, a.affine_fp32, c, 1.f));
  b = __fmaf_rn(-k, mean, affine(a.beta, a.affine_fp32, c, 0.f));
}

// channel c of sample s: (k, b) from the group statistics, or the external
// scale and shift
__device__ __forceinline__ void coeffs_of(const NormArgs& a, long long s, int c, float mean,
                                          float rstd, float& k, float& b) {
  if (a.ext_scale != nullptr) {
    k = a.ext_scale[s * a.c + c];
    b = a.ext_shift[s * a.c + c];
  } else {
    coeffs(a, mean, rstd, c, k, b);
  }
}

// u before its rounding to bf16: one fma, or (external statistics) the
// sharded GroupNorm's product then sum, each rounded (no fma)
template <bool EXT>
__device__ __forceinline__ float affine_u(float k, float v, float b) {
  return EXT ? __fadd_rn(__fmul_rn(v, k), b) : __fmaf_rn(k, v, b);
}

// torch's SiLU in fp32 (an accurate exp, a true quotient)
__device__ __forceinline__ float silu(float u) { return u / (1.f + expf(-u)); }

// bf16(silu(u)) of every bf16 u with 2^-10 <= |u| < 2^5 (15 binades of 128
// values a sign), built in shared memory by the kernel that reads it, from
// `silu` itself: the same bits as the formula, a shared-memory read in place
// of an exp and a quotient.  Outside it: |u| < 2^-10 gives bf16(u / 2)
// (u / (1 + exp(-u)) lies within a quarter of a bf16 step of u / 2), u >=
// 2^5 gives u (exp(-u) is below half an fp32 step of 1), u <= -2^5 (and
// NaN) the formula.
constexpr uint32_t kSiluLoExp = 117;  // bf16's biased exponent of 2^-10
constexpr uint32_t kSiluBinades = 15;
constexpr int kSiluTable = 2 * kSiluBinades * 128;

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ void fill_silu_table(unsigned short* table) {
  for (int i = threadIdx.x; i < kSiluTable; i += blockDim.x) {
    const uint32_t sign = i / (kSiluBinades * 128), rest = i % (kSiluBinades * 128);
    const uint32_t bits = sign << 15 | (kSiluLoExp + rest / 128) << 7 | rest % 128;
    table[i] = static_cast<unsigned short>(bf16_bits(silu(__uint_as_float(bits << 16))));
  }
}

// bf16(silu(u)) of the bf16 u in the low 16 bits of `bits`, as bits
__device__ __forceinline__ uint32_t silu_bits(uint32_t bits, const unsigned short* table) {
  const uint32_t e = (bits >> 7) & 0xffu, i = e - kSiluLoExp;  // i wraps past 2^31 below 2^-10
  if (i < kSiluBinades) return table[((bits >> 15) * kSiluBinades + i) * 128 + (bits & 127u)];
  const float u = __uint_as_float(bits << 16);
  if (e < kSiluLoExp) return bf16_bits(u * 0.5f);
  if (!(bits >> 15)) return bits;
  return bf16_bits(silu(u));
}

// kernel 9's quotient (int8_gemm.cu q8_fast) where 2^-100 <= scale <= 2^100:
// v * inv corrected twice by its exact residual, clamped, rounded by the
// magic-number addition whose low byte is the int8
__device__ __forceinline__ uint32_t q8_magic(float v, float scale, float inv) {
  float q = __fmul_rn(v, inv);
  q = __fmaf_rn(__fmaf_rn(-q, scale, v), inv, q);
  q = __fmaf_rn(__fmaf_rn(-q, scale, v), inv, q);
  return __float_as_uint(fminf(fmaxf(q, -127.f), 127.f) + 12582912.f);
}

// the max of m over the block (every thread gets it); `w` 32 floats of shared memory
__device__ float block_max(float m, float* w) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) w[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>((blockDim.x + 31) / 32) ? w[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) w[0] = m;
  }
  __syncthreads();
  m = w[0];
  __syncthreads();
  return m;
}

// The endpoint amax of channel c (u = bf16(k v + b) over v in [lo, hi]):
// the larger |y| at the two ends; `cross` whether the u-interval reaches
// SiLU's minimum (kSiluWindow), where |y| may peak inside it.
template <bool EXT>
__device__ __forceinline__ float endpoint_amax(float k, float b, float lo, float hi, int& cross) {
  const float u_lo = bf16r(affine_u<EXT>(k, lo, b)), u_hi = bf16r(affine_u<EXT>(k, hi, b));
  cross = fminf(u_lo, u_hi) <= kSiluWindowHi && fmaxf(u_lo, u_hi) >= kSiluWindowLo;
  return fmaxf(fabsf(bf16r(silu(u_lo))), fabsf(bf16r(silu(u_hi))));
}

// torch's WelfordData / WelfordOps (ATen/native/SharedReduceOps.h) over
// fp32, written as the same expressions so that nvcc contracts them alike
struct Welford {
  float mean, m2, nf;
};

__device__ __forceinline__ Welford welford_reduce(Welford acc, float data) {
  const float new_nf = acc.nf + 1.f;  // torch counts in int64; exact here below 2^24
  const float delta = data - acc.mean;
  const float new_mean = acc.mean + delta / new_nf;
  const float new_delta = data - new_mean;
  return {new_mean, acc.m2 + delta * new_delta, new_nf};
}

__device__ __forceinline__ Welford welford_combine(Welford a, Welford b) {
  if (a.nf == 0) return b;
  if (b.nf == 0) return a;
  const float delta = b.mean - a.mean;
  const float new_count = a.nf + b.nf;
  const float nb_over_n = b.nf / new_count;
  return {a.mean + delta * nb_over_n, a.m2 + b.m2 + delta * delta * a.nf * nb_over_n, new_count};
}

// torch's WarpReduce (ATen/native/cuda/block_reduce.cuh): shuffle down 16 .. 1
__device__ __forceinline__ Welford welford_warp(Welford w) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Welford other = {__shfl_down_sync(0xffffffffu, w.mean, o),
                           __shfl_down_sync(0xffffffffu, w.m2, o),
                           __shfl_down_sync(0xffffffffu, w.nf, o)};
    w = welford_combine(w, other);
  }
  return w;
}

__host__ __device__ constexpr int align16_dev(int n) { return (n + 15) / 16 * 16; }

// atomicMax where it can raise the word: most callers find it already as
// high once the largest values are in, and same-address atomics serialise
__device__ __forceinline__ void raise_to(unsigned* word, unsigned v) {
  if (v > *reinterpret_cast<volatile unsigned*>(word)) atomicMax(word, v);
}

// a float as an unsigned whose order is the float's (for atomicMin / Max)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// Each channel's min and max into the keys, a warp's lanes on one channel
// combined first (shared atomics on one address serialise)
__device__ __forceinline__ void flush_minmax(unsigned* kmin, unsigned* kmax, int c, float lo,
                                             float hi) {
  const unsigned grp = __match_any_sync(__activemask(), c);
  const unsigned kl = __reduce_min_sync(grp, order_key(lo));
  const unsigned kh = __reduce_max_sync(grp, order_key(hi));
  if (static_cast<int>(threadIdx.x % 32) == __ffs(grp) - 1) {
    atomicMin(&kmin[c], kl);
    atomicMax(&kmax[c], kh);
  }
}

// One thread's values of a (sample, group) row in torch's order, from
// `src`: channel-major bf16 (channel stride `cstride`, position stride
// `pstride`), j = t, t + T, ... < `d`, starting at channel 0 of `src`:
// Welford over them (all positions, or the first half under the planted
// fault 2); TRACK: each channel's min and max into the keys too (from
// device memory; the staged values have theirs from the staging).
template <int T, bool TRACK>
__device__ __forceinline__ Welford moments_walk(const NormArgs& a, const bf16* src,
                                                long long cstride, long long pstride,
                                                const bf16* addp, int t, long long d,
                                                Welford w, unsigned* kmin, unsigned* kmax) {
  const long long half = a.p / 2;
  int c = static_cast<int>(t / a.p), c_cur = -1;
  long long p = t - static_cast<long long>(c) * a.p;
  float lo = 0.f, hi = 0.f, addv = 0.f;
  for (long long j = t; j < d; j += T) {
    if (TRACK && c != c_cur) {
      if (c_cur >= 0) flush_minmax(kmin, kmax, c_cur, lo, hi);
      if (addp != nullptr) addv = __bfloat162float(addp[c]);
    }
    float v = __bfloat162float(src[c * cstride + p * pstride]);
    if (TRACK) {
      if (addp != nullptr) v = bf16r(v + addv);
      if (c != c_cur) {
        c_cur = c;
        lo = hi = v;
      } else {
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
    }
    if (a.fault != 2 || p < half) w = welford_reduce(w, v);  // planted: half the positions
    for (p += T; p >= a.p; p -= a.p) ++c;
  }
  if (TRACK && c_cur >= 0) flush_minmax(kmin, kmax, c_cur, lo, hi);
  return w;
}

// Channels [c0, c0 + n) of sample s, all P positions, into `stage`
// channel-major (stage[c * P + p]), x + add rounded to bf16 on the way, and
// each channel's min and max into the keys (from key index k0): 4-byte
// loads along the rows (n is even), a thread on one 2-channel word of
// every rows-at-once-th row.
__device__ __forceinline__ void stage_channels(const NormArgs& a, long long s, int c0, int n,
                                               bf16* stage, unsigned* kmin, unsigned* kmax,
                                               int k0) {
  const int words = n / 2, rpi = blockDim.x / words, pp = static_cast<int>(a.p);
  if (static_cast<int>(threadIdx.x) >= rpi * words) return;
  const int w = threadIdx.x % words;
  const bf16* base = a.x + s * a.p * a.c + c0 + 2 * w;
  float d0 = 0.f, d1 = 0.f;
  if (a.add != nullptr) {
    d0 = __bfloat162float(a.add[s * a.c + c0 + 2 * w]);
    d1 = __bfloat162float(a.add[s * a.c + c0 + 2 * w + 1]);
  }
  float lo0 = INFINITY, hi0 = -INFINITY, lo1 = INFINITY, hi1 = -INFINITY;
  for (int p = threadIdx.x / words; p < pp; p += rpi) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(base + static_cast<long long>(p) * a.c);
    float v0 = lo_bf(u), v1 = hi_bf(u);
    if (a.add != nullptr) {
      v0 = bf16r(v0 + d0);
      v1 = bf16r(v1 + d1);
    }
    stage[(2 * w) * pp + p] = __float2bfloat16_rn(v0);
    stage[(2 * w + 1) * pp + p] = __float2bfloat16_rn(v1);
    lo0 = fminf(lo0, v0), hi0 = fmaxf(hi0, v0), lo1 = fminf(lo1, v1), hi1 = fmaxf(hi1, v1);
  }
  if (a.extremes) {
    flush_minmax(kmin, kmax, k0 + 2 * w, lo0, hi0);
    flush_minmax(kmin, kmax, k0 + 2 * w + 1, lo1, hi1);
  }
}

// The statistics, in torch's own order (RowwiseMomentsCUDAKernel, torch's
// CUDA GroupNorm): each (sample s, group g) is a row of D = Cg * P values
// v(c, p) in channels-first order, j = c * P + p; T virtual threads (512,
// or 32 where D < 512) each run Welford over j = t, t + T, ...; a warp's
// states combine by shuffles down, then (T = 512) the 16 warps' in one
// warp; mean and rsqrtf(var + eps) stay in fp32 (torch's fp32 GroupNorm, as
// the port runs a bf16 input's: flax keeps a bf16 GroupNorm's statistics in
// fp32).  Here a CUDA thread is a virtual thread: T = 512 is a
// block, T = 32 a warp of a block of 4.  At T = 512 the values come through
// shared memory, channel-major, `cc` channels at a time, so that each is
// read from device memory once along the rows (a thread's walk is
// channel-major, and with P a multiple of 512 a chunk of channels is a run
// of its steps; the staging takes each channel's min and max); `cc` = 0
// (T = 32: a row of fewer than 512 values, its sample's 10 KB in L1)
// reads device memory directly, the walk taking the min and max.  The
// extremes go to shared memory as order-preserving keys; then each
// channel's endpoint amax, the sample's
// and the tensor's (atomicMax on the bits: the order of a max does not
// matter) and whether any channel's u-interval reaches SiLU's minimum.
// With external statistics (EXT: a clip shard's, summed over the ranks)
// the Welford walk is skipped where the staging takes the extremes; without
// `extremes` (the norm form) only the statistics are made.
template <int T, bool EXT>
__global__ void __launch_bounds__(512) norm_moments_kernel(NormArgs a, int cc) {
  constexpr int kPairs = T == 512 ? 1 : 4;  // T = 32: a block of 4 warps
  extern __shared__ uint4 dyn[];
  unsigned* keys = reinterpret_cast<unsigned*>(dyn);  // the pairs' min keys, then their max keys
  bf16* stage = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(dyn) +
                                        align16_dev(kPairs * 2 * a.cg * 4));
  __shared__ Welford partial[16];
  __shared__ float stat[kPairs][2];
  __shared__ unsigned pair_max[kPairs];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int local = T == 512 ? 0 : warp, t = T == 512 ? threadIdx.x : lane;
  const long long pair = static_cast<long long>(blockIdx.x) * kPairs + local;
  const bool live = pair < a.s * a.g;
  const long long s = pair / a.g;
  const int g = static_cast<int>(pair - s * a.g);
  for (int i = threadIdx.x; i < kPairs * 2 * a.cg; i += blockDim.x)
    keys[i] = i < kPairs * a.cg ? 0xffffffffu : 0u;
  if (threadIdx.x < kPairs) pair_max[threadIdx.x] = 0u;
  unsigned* kmin = keys + local * a.cg;
  unsigned* kmax = keys + (kPairs + local) * a.cg;
  const long long d = static_cast<long long>(a.cg) * a.p;
  const bf16* xg = a.x + s * a.p * a.c + g * a.cg;  // the pair's channels in device memory
  const bf16* addg = a.add == nullptr ? nullptr : a.add + s * a.c + g * a.cg;
  Welford w = {0.f, 0.f, 0.f};
  if (cc == 0) {  // device memory directly
    __syncthreads();
    if (live && a.extremes) w = moments_walk<T, true>(a, xg, 1, a.c, addg, t, d, w, kmin, kmax);
    else if (live && !EXT) w = moments_walk<T, false>(a, xg, 1, a.c, addg, t, d, w, kmin, kmax);
  } else {
    for (int c0 = 0; c0 < a.cg; c0 += cc) {
      const int n = min(cc, a.cg - c0);
      __syncthreads();  // the keys are set, the previous chunk is walked
      stage_channels(a, s, g * a.cg + c0, n, stage, kmin, kmax, c0);
      __syncthreads();
      if (!EXT)
        w = moments_walk<T, false>(a, stage, a.p, 1, nullptr, t,
                                   static_cast<long long>(n) * a.p, w, kmin, kmax);
    }
  }
  w = welford_warp(w);
  if (T == 512) {
    __syncthreads();
    if (lane == 0) partial[warp] = w;
    __syncthreads();
    w = threadIdx.x < 16 ? partial[lane] : Welford{0.f, 0.f, 0.f};
    if (warp == 0) w = welford_warp(w);
  }
  if (t == 0 && live && !EXT) {
    const float var = w.m2 / w.nf;
    const float mean = w.mean, rstd = rsqrtf(var + a.eps);
    a.mean[pair] = mean;
    a.rstd[pair] = rstd;
    stat[local][0] = mean;
    stat[local][1] = rstd;
  }
  __syncthreads();  // the keys and the statistics are complete
  if (!a.extremes) return;  // the norm form: the statistics alone
  int cross = 0;
  if (live) {
    for (int c = t; c < a.cg; c += T) {
      float k, b;
      int crossing;
      coeffs_of(a, s, g * a.cg + c, stat[local][0], stat[local][1], k, b);
      const float m = endpoint_amax<EXT>(k, b, from_key(kmin[c]), from_key(kmax[c]), crossing);
      atomicMax(&pair_max[local], __float_as_uint(m));
      cross |= crossing;
    }
  }
  cross = __syncthreads_or(cross);
  if (t == 0 && live) raise_to(reinterpret_cast<unsigned*>(&a.amax_s[s]), pair_max[local]);
  if (threadIdx.x == 0) {
    unsigned m = 0u;
    for (int i = 0; i < kPairs; ++i) m = max(m, pair_max[i]);
    raise_to(&a.words[0], m);
    if (cross) atomicOr(&a.words[1], 1u);
  }
}

// 4 bf16 from 8-byte aligned p
__device__ __forceinline__ uint2 ld64(const bf16* p) { return *reinterpret_cast<const uint2*>(p); }

// u = bf16(k * v + b) of 4 values, two bf16 a word
template <bool EXT>
__device__ __forceinline__ uint2 norm4(uint2 raw, const float (&d)[4], bool add,
                                       const float (&k)[4], const float (&b)[4]) {
  const uint32_t w[2] = {raw.x, raw.y};
  uint32_t u[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v0 = lo_bf(w[h]), v1 = hi_bf(w[h]);
    if (add) {
      const uint32_t r = pack_bf16(v0 + d[2 * h], v1 + d[2 * h + 1]);
      v0 = lo_bf(r);
      v1 = hi_bf(r);
    }
    u[h] = pack_bf16(affine_u<EXT>(k[2 * h], v0, b[2 * h]),
                     affine_u<EXT>(k[2 * h + 1], v1, b[2 * h + 1]));
  }
  return make_uint2(u[0], u[1]);
}

// y = bf16(silu(u)) of the 4 values of norm4
__device__ __forceinline__ void silu4(uint2 u, float (&y)[4], const unsigned short* table) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    y[2 * h] = __uint_as_float(silu_bits(w[h] & 0xffffu, table) << 16);
    y[2 * h + 1] = __uint_as_float(silu_bits(w[h] >> 16, table) << 16);
  }
}

// 4 values quantized into one 32-bit word (kernel 9's quotient where fast)
__device__ __forceinline__ uint32_t quantize4(const float (&y)[4], float scale, float inv,
                                              bool fast) {
  if (fast) {
    const uint32_t lo = __byte_perm(q8_magic(y[0], scale, inv), q8_magic(y[1], scale, inv), 0x0040);
    const uint32_t hi = __byte_perm(q8_magic(y[2], scale, inv), q8_magic(y[3], scale, inv), 0x0040);
    return __byte_perm(lo, hi, 0x5410);
  }
  return q8(y[0], scale) | q8(y[1], scale) << 8 | q8(y[2], scale) << 16 | q8(y[3], scale) << 24;
}

// The apply passes' modes: the third pass (max|y| into words[2], only where
// the endpoints cannot decide it), the quantize pass, and the norm form's
// output u
enum ApplyMode { kThird = 0, kQuantize = 1, kNormOut = 2 };

// The resolved amax of the staged form: the third pass's where it ran, else
// the endpoints', into words[3] for the caller's all-reduce
__global__ void resolve_amax_kernel(NormArgs a) {
  a.words[3] = third_pass_needed(a) ? a.words[2] : a.words[0];
}

// An apply pass (MODE; EXT: external statistics): a wave of blocks, block b
// walking rows [b * block_rows, (b + 1) * block_rows); one thread 4
// channels (fixed), rows at once = blockDim / (C / 4), the next row's load
// in flight under this row's arithmetic.  Few registers a thread, so that
// many warps hide the loads' latency.
template <int MODE, bool EXT>
__global__ void __launch_bounds__(1024) norm_apply_kernel(NormArgs a, long long block_rows) {
  constexpr bool WRITE = MODE == kQuantize;
  __shared__ float wmax[32];
  __shared__ unsigned short table[MODE == kNormOut ? 1 : kSiluTable];
  if (MODE == kThird && !third_pass_needed(a)) return;
  if (MODE != kNormOut) fill_silu_table(table);
  __syncthreads();
  const int v = a.c / 4, rc = blockDim.x / v;
  const int t = threadIdx.x, r = t / v, c0 = 4 * (t % v);
  const long long rows = a.s * a.p;
  const long long row0 = static_cast<long long>(blockIdx.x) * block_rows;
  const long long row1 = min(rows, row0 + block_rows);
  // the 4 channels' groups: g0, and g0 + 1 from channel `split` on (a group holds 4 or more)
  const int g0 = c0 / a.cg, split = (g0 + 1) * a.cg - c0;
  float scale = 1.f, inv = 1.f;
  bool fast = true;
  if (WRITE) {
    scale = scale_of(__uint_as_float(a.global            ? a.words[3]
                                     : third_pass_needed(a) ? a.words[2]
                                                            : a.words[0]));
    inv = __frcp_rn(scale);
    fast = scale >= 7.888609052210118e-31f && scale <= 1.2676506002282294e30f;  // 2^-100, 2^100
    if (blockIdx.x == 0 && t == 0) a.scale[0] = scale;
  }
  const bool has_add = a.add != nullptr;
  long long s_cur = -1, s = (row0 + r) / a.p, pos = row0 + r - s * a.p;  // the row's sample, position
  float k[4], b[4], d[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.f;
  uint2 next = row0 + r < row1 ? ld64(a.x + (row0 + r) * a.c + c0) : make_uint2(0u, 0u);
  for (long long row = row0 + r; row < row1; row += rc) {
    const uint2 cur = next;
    if (row + rc < row1) next = ld64(a.x + (row + rc) * a.c + c0);
    if (s != s_cur) {
      s_cur = s;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long sg = s * a.g + g0 + (e >= split);
        if (EXT) coeffs_of(a, s, c0 + e, 0.f, 0.f, k[e], b[e]);
        else coeffs(a, a.mean[sg], a.rstd[sg], c0 + e, k[e], b[e]);
      }
      if (has_add) {
        const uint2 w = ld64(a.add + s * a.c + c0);
        d[0] = lo_bf(w.x), d[1] = hi_bf(w.x), d[2] = lo_bf(w.y), d[3] = hi_bf(w.y);
      }
      if (WRITE && a.fault == 1) {  // planted: the sample's own amax
        scale = scale_of(a.amax_s[s]);
        inv = __frcp_rn(scale);
        fast = scale >= 7.888609052210118e-31f && scale <= 1.2676506002282294e30f;
      }
    }
    const uint2 u = norm4<EXT>(cur, d, has_add, k, b);
    if (MODE == kNormOut) {
      *reinterpret_cast<uint2*>(a.out + row * a.c + c0) = u;
    } else {
      float y[4];
      silu4(u, y, table);
      if (WRITE) {
        *reinterpret_cast<uint32_t*>(a.q + row * a.c + c0) = quantize4(y, scale, inv, fast);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) m = fmaxf(m, fabsf(y[e]));
      }
    }
    for (pos += rc; pos >= a.p; pos -= a.p) ++s;  // no division a row
  }
  if (MODE == kThird) {
    m = block_max(m, wmax);
    if (t == 0) {
      atomicMax(&a.words[2], __float_as_uint(m));
      if (blockIdx.x == 0) atomicAdd(a.third, 1);
    }
  }
}

// The card's SMs and how many blocks of `threads` of the apply kernel one
// SM holds, queried once a block size (one device a process).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int apply_blocks_per_sm(int threads) {
  static int cache[1025];
  int& n = cache[threads];
  if (n == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, norm_apply_kernel<kQuantize, false>,
                                                      threads, 0) !=
            cudaSuccess || n < 1)
      n = 1;
  }
  return n;
}

long long align16(long long n) { return (n + 15) / 16 * 16; }

// The workspace: words and the samples' amax (zeroed at each launch: the
// first `zeroed` bytes), then the (S, G) means and rstds.
long long norm_zeroed(long long s) { return align16(16 + 4 * s); }
long long norm_workspace(long long s, int g) { return norm_zeroed(s) + 2 * align16(4 * s * g); }

// The statistics kernel at torch's block size for a (sample, group) row of
// Cg * P values, and the channels a T = 512 block stages at a time (all of
// them, or a run of whole steps: P a multiple of 512), within kStageBytes
template <bool EXT>
int launch_moments(const NormArgs& a, cudaStream_t st) {
  const long long pairs = a.s * a.g;
  if (static_cast<long long>(a.cg) * a.p < 512) {
    norm_moments_kernel<32, EXT><<<static_cast<unsigned>((pairs + 3) / 4), 128,
                                   align16_dev(4 * 2 * 4 * a.cg), st>>>(a, 0);
  } else {
    int cc = static_cast<int>(kStageBytes / (2 * a.p));  // staged 4 bytes (2 channels) a load
    cc = a.cg % 2 ? 0 : cc >= a.cg ? a.cg : a.p % 512 == 0 ? cc & ~1 : 0;
    const size_t smem = align16_dev(2 * 4 * a.cg) + 2 * static_cast<size_t>(cc) * a.p;
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(norm_moments_kernel<512, EXT>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   kStageBytes + align16_dev(2 * 4 * 1024));
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    norm_moments_kernel<512, EXT><<<static_cast<unsigned>(pairs), 512, smem, st>>>(a, cc);
  }
  return static_cast<int>(cudaGetLastError());
}

// An apply pass over the rows: one wave of blocks, each a contiguous range
template <int MODE, bool EXT>
int launch_apply(const NormArgs& a, cudaStream_t st) {
  const long long rows = a.s * a.p;
  const int v4 = a.c / 4, threads = v4 * (v4 >= 256 ? 1 : 256 / v4), rows_at_once = threads / v4;
  const long long slots = static_cast<long long>(sm_count()) * apply_blocks_per_sm(threads);
  const long long want = (rows + static_cast<long long>(rows_at_once) * kApplyRows - 1) /
                         (static_cast<long long>(rows_at_once) * kApplyRows);
  const long long blocks = want < slots ? want : slots;
  const long long block_rows = (rows + blocks - 1) / blocks;
  norm_apply_kernel<MODE, EXT><<<static_cast<unsigned>(blocks), threads, 0, st>>>(a, block_rows);
  return static_cast<int>(cudaGetLastError());
}

// The launch stages: kAll the fused form whole; kLocalAmax its statistics
// (or the external ones' extremes), the third pass where needed and the
// resolved local amax in words[3]; kQuantizeGlobal the quantize pass with
// the amax words[3] holds (after the caller's all-reduce, on the
// workspace kLocalAmax filled); kNorm the norm form (statistics, then u).
enum Stage { kAll = 0, kLocalAmax = 1, kQuantizeGlobal = 2, kNorm = 3 };

template <bool EXT>
int launch_norm_stages(NormArgs a, int stage, cudaStream_t st) {
  int err = 0;
  if (stage != kQuantizeGlobal) {
    err = launch_moments<EXT>(a, st);
    if (err != 0) return err;
  }
  if (stage == kNorm) return launch_apply<kNormOut, false>(a, st);
  if (stage == kAll || stage == kLocalAmax) {
    // the third pass: its blocks return at once unless the endpoints cannot decide
    err = launch_apply<kThird, EXT>(a, st);
    if (err != 0) return err;
  }
  if (stage == kLocalAmax) {
    resolve_amax_kernel<<<1, 1, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  a.global = stage == kQuantizeGlobal;
  return launch_apply<kQuantize, EXT>(a, st);
}

int launch_norm(NormArgs a, void* workspace, int stage, cudaStream_t st) {
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  a.words = reinterpret_cast<unsigned*>(ws);
  a.amax_s = reinterpret_cast<float*>(ws + 16);
  a.mean = reinterpret_cast<float*>(ws + norm_zeroed(a.s));
  a.rstd = a.mean + align16(4 * a.s * a.g) / 4;
  a.extremes = stage != kNorm;
  if (stage != kQuantizeGlobal) {
    const cudaError_t err = cudaMemsetAsync(ws, 0, norm_zeroed(a.s), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return a.ext_scale != nullptr ? launch_norm_stages<true>(a, stage, st)
                                : launch_norm_stages<false>(a, stage, st);
}

}  // namespace

}  // namespace ccedit

// Kernel 8.  x: contiguous (rows, groups * len), bf16 (fp32 = 0) or fp32;
// q: contiguous int8 (rows, groups * len_p); scales: fp32 (rows) per row or
// (1) per tensor; amax: one 32-bit word of scratch (per tensor; zeroed
// here).  Per tensor takes groups = 1 and runs `stages`: 1 writes the
// tensor's amax (its fp32 bits) into the word, 2 quantizes with the amax the
// word then holds, 3 both (a sharded tensor's caller all-reduces the word
// between 1 and 2); per row takes 3.  Returns the launches' cudaError_t
// (0 = success); -1 for arguments it does not take.
extern "C" int ccedit_quantize_int8(int fp32, int per_row, int stages, const void* x, void* q,
                                    void* scales, void* amax, long long rows, int groups, int len,
                                    int len_p, void* stream) {
  using namespace ccedit;
  if (rows <= 0 || groups <= 0 || len <= 0 || len_p < len || len_p % 16 ||
      (!per_row && groups != 1) || stages < 1 || stages > 3 || (per_row && stages != 3))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? launch<float>(per_row, stages, x, q, scales, amax, rows, groups, len, len_p, st)
              : launch<bf16>(per_row, stages, x, q, scales, amax, rows, groups, len, len_p, st);
}

// Kernel 8's fused norm form.  s, p, c, g: x's (S, P, C) and the groups.
// out: (the statistics' block: 32 or 512 threads a (sample, group), as
// torch's GroupNorm; workspace bytes).  Returns 0; -1 for shapes it does not
// take.
extern "C" int ccedit_norm_quantize_plan(long long s, long long p, int c, int g, long long* out) {
  using namespace ccedit;
  if (s <= 0 || p <= 0 || c <= 0 || g <= 0 || c % 8 || c % g || c / g < 4 || c > 4096)
    return -1;
  out[0] = static_cast<long long>(c / g) * p < 512 ? 32 : 512;
  out[1] = norm_workspace(s, g);
  return 0;
}

// x: contiguous bf16 (S, P, C), 16-byte aligned; add: null or contiguous
// bf16 (S, C), 16-byte aligned; gamma, beta: null or (C) bf16 (affine_fp32
// = 0) or fp32; ext_scale, ext_shift: null, or contiguous fp32 (S, C) each,
// the statistics made outside (u = bf16(v * scale + shift); gamma, beta and
// eps unread); q: int8 (S * P, C); scale: fp32 (1); workspace: the plan's
// bytes; third: a 32-bit counter of third passes; fault: 0, or a planted
// fault of the checks (1: each sample quantized with its own amax; 2: the
// statistics over the first P / 2 positions); stage: 0 the whole form, 1 up
// to the local amax (the word at workspace + 12 bytes, for the caller to
// all-reduce), 2 the quantize pass with the amax that word holds (the
// workspace stage 1 filled).  Returns the launches' cudaError_t (0 =
// success); -1 for arguments it does not take.
extern "C" int ccedit_norm_silu_quantize(const void* x, const void* add, const void* gamma,
                                         const void* beta, int affine_fp32, const void* ext_scale,
                                         const void* ext_shift, long long s, long long p, int c,
                                         int g, float eps, void* q, void* scale, void* workspace,
                                         void* third, int fault, int stage, void* stream) {
  using namespace ccedit;
  if (s <= 0 || p <= 0 || c <= 0 || g <= 0 || c % 8 || c % g || c / g < 4 || c > 4096 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(add) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 8 || fault < 0 || fault > 2 || stage < 0 || stage > 2 ||
      (ext_scale == nullptr) != (ext_shift == nullptr) || (ext_scale != nullptr && fault == 2))
    return -1;
  NormArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.add = static_cast<const bf16*>(add);
  a.gamma = gamma;
  a.beta = beta;
  a.affine_fp32 = affine_fp32;
  a.ext_scale = static_cast<const float*>(ext_scale);
  a.ext_shift = static_cast<const float*>(ext_shift);
  a.s = s;
  a.p = p;
  a.c = c;
  a.g = g;
  a.cg = c / g;
  a.eps = eps;
  a.fault = fault;
  a.q = static_cast<unsigned char*>(q);
  a.scale = static_cast<float*>(scale);
  a.third = static_cast<int*>(third);
  return launch_norm(a, workspace, stage, static_cast<cudaStream_t>(stream));
}

// Kernel 8's norm form: the GroupNorm alone, out = bf16(k * x + b) from the
// fp32 statistics of the fused form (torch's fp32 GroupNorm of the bf16
// input, rounded once), channels-last.  x: contiguous bf16 (S, P, C),
// 16-byte aligned; gamma, beta as above; out: contiguous bf16 (S * P, C),
// 8-byte aligned; workspace: the plan's bytes.  Returns the launches'
// cudaError_t (0 = success); -1 for arguments it does not take.
extern "C" int ccedit_group_norm(const void* x, const void* gamma, const void* beta,
                                 int affine_fp32, long long s, long long p, int c, int g,
                                 float eps, void* out, void* workspace, void* stream) {
  using namespace ccedit;
  if (s <= 0 || p <= 0 || c <= 0 || g <= 0 || c % 8 || c % g || c / g < 4 || c > 4096 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 8)
    return -1;
  NormArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.gamma = gamma;
  a.beta = beta;
  a.affine_fp32 = affine_fp32;
  a.s = s;
  a.p = p;
  a.c = c;
  a.g = g;
  a.cg = c / g;
  a.eps = eps;
  a.out = static_cast<bf16*>(out);
  return launch_norm(a, workspace, kNorm, static_cast<cudaStream_t>(stream));
}
