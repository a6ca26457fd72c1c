// Kernel 10: the W8A8 path's convolution -- an implicit-GEMM int8 x int8 ->
// int32 convolution on channels-last data with kernel 9's dequant epilogue
// (ops/quant.py `conv_dequant`).
//
// Replaces no Pallas kernel: the JAX package runs `int8_conv`
// (ccedit_tpu/ops/quant.py:91-107, lax.conv_general_dilated with int32
// accumulation) in XLA.  PyTorch has no int8 convolution on CUDA, so the
// port writes one.
//
// The product.  Output pixel m = (b, oh, ow) of (N, Ho, Wo) against output
// channel o: acc[m][o] = sum over taps (dy, dx) and input channels c of
// x8[b][oh*sh - pt + dy][ow*sw - pl + dx][c] * w8[o][dy][dx][c], x8 read as
// zero outside the image (the padding: symmetric, or the VAE downsample's
// (0, 1), which is pt = pl = 0 with the bottom/right rows past the image).
// x8 is (N, H, W, Cp), w8 (O, kh * kw * Cp), Cp = C rounded up to 16 with
// zeros (the quantizer's layout).  A 1-D conv over (N, L, C) is the (k, 1)
// 2-D one over (N, L, 1, C).  k in {1, 3} (any kh, kw work), stride 1 or 2,
// groups 1.  out = bf16(bf16(f32(acc) * sx * sw[o]) + bias[o]) with sx the
// tensor's one activation scale (or fp32; or the raw int32 accumulators).
//
// What bounds it on an H100: the int8 tensor cores at the UNet's 3x3 convs
// (level 0, 320 -> 320 on (34, 64, 96): 385 GOP, 0.19 ms at 1,979 TOP/s,
// against 67 MB of int8 in and 134 MB of bf16 out, 0.06 ms), the bytes at
// its 1x1 and k = 3 temporal ones.  A simple kernel first: mma.sync, not
// wgmma.
//
// Design: a block computes a 128-pixel x 128-channel output tile with 8
// warps (2 along the pixels x 4 along the channels, a warp 64 x 32: 4 x 4
// m16n8k32 s8 mma.sync tiles, 64 int32 accumulators a thread).  The K loop
// walks the taps, and inside a tap 64-byte slices of the channels (a slice
// past Cp reads zeros).  A 4-stage cp.async ring holds each slice's A tile
// (128 pixels x 64 B) and B tile (128 channels x 64 B), 16 KB a stage:
// the im2col happens in the load stage, each thread issuing 16-byte copies
// whose source size is 0 (a zero fill) where the tap falls in the padding,
// past M or past O; no im2col buffer exists (at the VAE decoder's (17, 512,
// 768) it would be 15 GB).  Tiles sit in shared memory as 64-byte rows with
// the 16-byte unit u of row r at u ^ ((r / 2) % 4), so ldmatrix's 8-row
// reads are conflict-free; ldmatrix.x4 gives the A fragments (16 rows x 32
// k) and two n-tiles' B fragments (weights are K-major per output channel,
// mma's "col" B).  The epilogue dequantizes from the accumulator registers
// and stores 2 values (4 or 8 bytes) at a time, clipped at M and O.
#include "hopper.cuh"

namespace ccedit {

namespace {

using hopper::smem_addr;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4, kThreads = 256;
constexpr int kTileBytes = kBM * kBK;              // A or B of a stage: 8 KB
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes;  // 64 KB

struct Geometry {
  int batch, h, w, cp, o, kh, kw, sh, sw, pt, pl, ho, wo;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte unit u of row r of a 64-byte-row tile
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return static_cast<uint32_t>(r * kBK + ((u ^ ((r >> 1) & 3)) << 4));
}

template <int kOut>
__device__ __forceinline__ void store2(void* out, long long idx, int o, float sx, int acc0,
                                       int acc1, const float* sw, const void* bias, bool pair) {
  // idx: the element index of (pixel, channel o); o + 1 may lie past O
  if constexpr (kOut == 0) {
    int* c = static_cast<int*>(out) + idx;
    if (pair) {
      *reinterpret_cast<int2*>(c) = make_int2(acc0, acc1);
    } else {
      c[0] = acc0;
    }
  } else {
    float y[2];
    const int accs[2] = {acc0, acc1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e == 1 && !pair) break;
      y[e] = __fmul_rn(__fmul_rn(__int2float_rn(accs[e]), sx), sw[o + e]);
      if constexpr (kOut == 1) {
        y[e] = __bfloat162float(__float2bfloat16_rn(y[e]));
        if (bias != nullptr)
          y[e] = __fadd_rn(y[e], __bfloat162float(static_cast<const bf16*>(bias)[o + e]));
      } else if (bias != nullptr) {
        y[e] = __fadd_rn(y[e], static_cast<const float*>(bias)[o + e]);
      }
    }
    if constexpr (kOut == 1) {
      bf16* c = static_cast<bf16*>(out) + idx;
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(y[0], y[1]);
      } else {
        c[0] = __float2bfloat16_rn(y[0]);
      }
    } else {
      float* c = static_cast<float*>(out) + idx;
      if (pair) {
        *reinterpret_cast<float2*>(c) = make_float2(y[0], y[1]);
      } else {
        c[0] = y[0];
      }
    }
  }
}

template <int kOut>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const unsigned char* __restrict__ x8, const unsigned char* __restrict__ w8,
            void* __restrict__ out, const float* __restrict__ sx_, const float* __restrict__ sw,
            const void* __restrict__ bias, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m_total = static_cast<long long>(g.batch) * g.ho * g.wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int slices = (g.cp + kBK - 1) / kBK;
  const int k_tiles = g.kh * g.kw * slices;
  const int taps = g.kh * g.kw;

  // this thread's two rows of each tile (r and r + 64) and 16-byte unit u
  const int u = tid % 4, r_lo = tid / 4;
  int img[2], ih0[2], iw0[2];
  bool m_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + r_lo + 64 * i;
    m_ok[i] = m < m_total;
    const long long mm = m_ok[i] ? m : 0;
    const int ow = static_cast<int>(mm % g.wo);
    const long long t = mm / g.wo;
    const int oh = static_cast<int>(t % g.ho);
    img[i] = static_cast<int>(t / g.ho);
    ih0[i] = oh * g.sh - g.pt;
    iw0[i] = ow * g.sw - g.pl;
  }

  auto load = [&](int kt, int stage) {
    const int tap = kt / slices, c = (kt - tap * slices) * kBK + 16 * u;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const uint32_t sa = base + stage * kStageBytes, sb = sa + kTileBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 64 * i;
      const int ih = ih0[i] + dy, iw = iw0[i] + dx;
      const bool a_ok = m_ok[i] && c < g.cp && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      const unsigned char* a_src =
          a_ok ? x8 + ((static_cast<long long>(img[i]) * g.h + ih) * g.w + iw) * g.cp + c : x8;
      cp_async16(sa + swz(r, u), a_src, a_ok ? 16 : 0);
      const int oc = n0 + r;
      const bool b_ok = oc < g.o && c < g.cp;
      const unsigned char* b_src =
          b_ok ? w8 + (static_cast<long long>(oc) * taps + tap) * g.cp + c : w8;
      cp_async16(sb + swz(r, u), b_src, b_ok ? 16 : 0);
    }
  };

  const int wm = warp / 4, wn = warp % 4;  // the warp's 64 rows and 32 columns
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed for every thread; stage kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load(next, next % kStages);
    cp_async_commit();
    const uint32_t sa = base + (kt % kStages) * kStageBytes, sb = sa + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // two 32-byte k steps a slice
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], sa + swz(64 * wm + 16 * i + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4(b[p], sb + swz(32 * wn + 16 * p + (lane & 7) + ((lane >> 4) << 3),
                                   2 * ks + ((lane >> 3) & 1)));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j / 2][2 * (j % 2)],
                                           b[j / 2][2 * (j % 2) + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: rows g and g + 8 of each 16-row tile, columns 2t, 2t + 1
  const float sx = kOut == 0 ? 0.f : sx_[0];
  const int gid = lane / 4, t = lane % 4;
  const bool even = g.o % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + 64 * wm + 16 * i + gid + 8 * h;
      if (m >= m_total) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = n0 + 32 * wn + 8 * j + 2 * t;
        if (o >= g.o) continue;
        const bool pair = o + 1 < g.o;
        if (pair && even) {
          store2<kOut>(out, m * g.o + o, o, sx, acc[i][j][2 * h], acc[i][j][2 * h + 1], sw, bias,
                       true);
        } else {
          store2<kOut>(out, m * g.o + o, o, sx, acc[i][j][2 * h], 0, sw, bias, false);
          if (pair)
            store2<kOut>(out, m * g.o + o + 1, o + 1, sx, acc[i][j][2 * h + 1], 0, sw, bias,
                         false);
        }
      }
    }
  }
}

template <int kOut>
int launch(const void* x8, const void* w8, void* out, const void* sx, const void* sw,
           const void* bias, const Geometry& g, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_kernel<kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long m = static_cast<long long>(g.batch) * g.ho * g.wo;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM), (g.o + kBN - 1) / kBN);
  conv_kernel<kOut><<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const unsigned char*>(x8), static_cast<const unsigned char*>(w8), out,
      static_cast<const float*>(sx), static_cast<const float*>(sw), bias, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// Kernel 10.  x8: contiguous int8 (batch, h, w, cp), cp a multiple of 16;
// w8: contiguous int8 (o, kh * kw * cp); out: contiguous (batch, ho, wo, o)
// of int32 (out_kind 0), bf16 (1) or fp32 (2); sx: one fp32 value; sw: fp32
// (o); bias: (o) of out's type or null.  The window reads input row oh * sh
// - pad_top + dy and column ow * sw - pad_left + dx (zero outside).
// Returns the launch's cudaError_t; -1 for arguments it does not take.
extern "C" int ccedit_int8_conv(int out_kind, const void* x8, const void* w8, void* out,
                                const void* sx, const void* sw, const void* bias, int batch,
                                int h, int w, int cp, int o, int kh, int kw, int sh, int sw_,
                                int pad_top, int pad_left, int ho, int wo, void* stream) {
  using namespace ccedit;
  if (batch <= 0 || h <= 0 || w <= 0 || cp <= 0 || cp % 16 || o <= 0 || kh <= 0 || kw <= 0 ||
      sh <= 0 || sw_ <= 0 || ho <= 0 || wo <= 0 || out_kind < 0 || out_kind > 2 ||
      static_cast<long long>(batch) * ho * wo / 128 >= (1LL << 31))
    return -1;
  const Geometry g{batch, h, w, cp, o, kh, kw, sh, sw_, pad_top, pad_left, ho, wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0: return launch<0>(x8, w8, out, sx, sw, nullptr, g, st);
    case 1: return launch<1>(x8, w8, out, sx, sw, bias, g, st);
    default: return launch<2>(x8, w8, out, sx, sw, bias, g, st);
  }
}
