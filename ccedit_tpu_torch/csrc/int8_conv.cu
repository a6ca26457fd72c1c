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
// 2-D one over (N, L, 1, C).  k in {1, 3} (any kh, kw up to the map's
// limits), stride 1 or 2, groups 1.  out = bf16(bf16(f32(acc) * sx *
// sw[o]) + bias[o]) with sx the tensor's one activation scale (or fp32; or
// the raw int32 accumulators).  int32 sums of int8 products are exact in any
// order (9 * 2560 * 127^2 < 2^31), so the accumulators equal the plain
// version's bit for bit.
//
// What bounds it on an H100: the int8 tensor cores at the UNet's and the
// VAE's 3x3 convs (level 0, 320 -> 320 on (34, 64, 96): 385 GOP, 0.19 ms
// at 1,979 TOP/s, against 67 MB of int8 in and 134 MB of bf16 out, 0.06
// ms); the bytes at the 1x1s, the k = 3 temporal convs, conv_in (Cp = 16)
// and the narrow outputs (the VAE's conv_out, O = 3: 0.86 GB of int8 in,
// 0.27 ms).  Between the two sit L2 and the epilogue: each tap re-reads the
// input tile and each M tile the weights, and every output crosses the
// registers, shared memory and HBM once more (the VAE's 3x3 writes 1.7 GB
// of bf16), so the tiles are sized to keep the re-reads few and the
// epilogue short.
//
// Design: a warp-specialised block works BM x BN output tiles, BM
// consecutive output pixels in (N, Ho, Wo) order; NC consumer warpgroups,
// then one producer warpgroup.  No setmaxnreg: ptxas compiles every
// thread within the launch bound's registers (168 at 384 threads)
// whatever it grants.
//   - The A operand (the im2col rows) comes by TMA in im2col mode
//     (cuTensorMapEncodeIm2col over the (N, H, W, Cp) input): the map's
//     pixel box is the window's first tap's input positions (rows -pt ..,
//     every sh-th; columns -pl .., every sw-th; its upper corners are set
//     from Ho and Wo), a column is 128 pixels (64 at BM = 192) of one
//     k-chunk of channels, and each tap (dy, dx) is the load's pair of
//     im2col offsets.  TMA walks the box across image rows and images, and
//     zero-fills what falls outside the image, past Cp and past the last
//     image, so image edges, ragged Wo, the (0, 1) padding and the 1-D
//     (L, 1) case need no special casing.  No geometry takes another path:
//     the pixel box's corners must lie in [-128, 127] and the taps'
//     offsets in [0, 255] (the 4-D map's limits), which every conv of the
//     port meets; the entry refuses others.
//   - The B operand (the weights) comes by TMA over a 3-D view (Cp, taps,
//     O) of w8, box (chunk, 1, BN): a k-chunk past Cp and rows past O
//     arrive as zeros instead of the next tap's channels.
//   - The producer (one thread) keeps a ring of as many stages as fit, at
//     most 8, each guarded by a full mbarrier (TMA bytes) and an empty one
//     (the consumer warps).  The K loop walks the taps, and inside a tap
//     the k-chunks of Cp; a stage holds 128 bytes of K, one 128-byte box or
//     two 64-byte or four 32-byte ones (consecutive (tap, k-chunk) pairs,
//     the last stage filled up with boxes of channels past Cp, which arrive
//     as zeros), so every stage is four k32 steps and no wgmma sits behind
//     a branch (ptxas serialises those).
//   - Each consumer warpgroup owns MT 64-row slices of the tile: s8 wgmma
//     m64nBNk32, both operands K-major from the swizzled ring (128-, 64- or
//     32-byte swizzle, the chunk's span), int32 accumulators in registers
//     (MT * BN / 2 a thread), one wgmma group in flight behind the next
//     stage's.  No __syncthreads in the main loop.
//   - The tiles (conv_tiles, mirrored by ops/quant.py; the instantiations
//     in `run`, timed by scripts/conv_tiles.py): 256 x 128 (two consumers
//     of 128 rows, 128 accumulators a thread) wherever O > 32 is not an
//     odd multiple of 160; 192 x 160 (three consumers of 64 rows, 80
//     accumulators) at O = 320 and 960, where 128-wide tiles leave a
//     part-empty last N tile; a narrow 256 x BN, BN 8, 16 or 32 (two blocks
//     an SM) for O <= 32 (conv_out's 3, the hint pyramid's 16 and 32),
//     bound by the bytes of A.  A 256 x 160 tile would need 160
//     accumulators a thread, and spills within 168 registers.
//     k-chunks of 128 bytes for Cp > 64 (a zero tail past Cp: 320 takes
//     three), 64 for Cp <= 64 and 32 for Cp <= 32 (conv_in and the hint
//     pyramid's first conv at Cp = 16: half of it zero fill).
//   - Epilogue, in one of two forms.  (a) bf16 out with O a multiple of 8
//     at the tiles of one 64-row slice a consumer (192 x 160): the grid is
//     persistent (a block an SM, walking the tiles in order, the ring's
//     stages and phases running on from tile to tile); the consumers
//     dequantize from the accumulator registers (kernel 9's arithmetic,
//     __fmul_rn in the JAX order) with the tile's scales and biases from a
//     table in shared memory into a staging buffer of its own (BN / 32
//     boxes of BM rows x 64 bytes, 64-byte swizzle: conflict-free 4-byte
//     stores), and one thread stores each box by TMA, clipped at M and O,
//     while the consumers go on to the next tile's main loop, whose stages
//     the producer has been loading meanwhile.  (b) Otherwise (fp32 or
//     int32 out, O not a multiple of 8, the narrow tiles, and the 256 x
//     128 tile, whose 128 accumulators leave ptxas no room for (a): it
//     spills): one tile a block; the raw accumulators are staged through the
//     freed ring (rows of BN + 8 words, or BN where BN / 8 is odd:
//     conflict-free 8-byte stores), then each thread takes 8 (bf16) or 4
//     (fp32, int32) consecutive outputs of a row, dequantizes them from
//     the table and writes them in one 16-byte store, clipped at M and O;
//     an O that is not a multiple of 8 (4) is written element by element
//     along the tile's contiguous rows.  The table is read while the main
//     loop runs; dequantizing from registers with global scale and bias
//     loads between the staging stores cost as much as the stores
//     (scripts/conv_breakdown.py).  Tiles run in order, the N tiles of one
//     M tile together, so an input tile crosses HBM once and its taps hit
//     L2.
#include <algorithm>

#include "hopper.cuh"

namespace ccedit {

namespace {

using namespace hopper;

constexpr int kMaxStages = 8;

struct Geometry {
  int batch, h, w, cp, o, kh, kw, sh, sw, pt, pl, ho, wo;
};

// The tile of one instantiation: BN output channels, NC consumer
// warpgroups of MT 64-row wgmma slices each (BM = 64 NC MT pixels), BPS
// blocks an SM; A arrives in im2col columns of kPixels pixels.
template <int BN, int NC, int MT, int BPS>
struct ConvTiles {
  static constexpr int kBM = 64 * NC * MT;
  static constexpr int kThreads = 128 * (NC + 1);  // the consumers, then the producer
  static constexpr int kPixels = kBM % 128 == 0 ? 128 : 64;
  static constexpr int kPitch = BN + ((BN / 8) % 2 == 0 ? 8 : 0);  // words of a staged row
  // dynamic shared memory: one block an SM takes nearly all of it; two
  // share it (each also holds 1 KB of the system's and its barriers)
  static constexpr int kSmemBytes = BPS == 1 ? 224 * 1024 : 110 * 1024;
  static_assert(kBM * kPitch * 4 + 1024 <= kSmemBytes, "the staged tile fits in the ring");
  // the persistent TMA-store epilogue dequantizes from the accumulators'
  // registers, which needs room beside them: one 64-row slice a consumer
  // (80 accumulators at BN 160) has it, two (128 at BN 128) spill
  static constexpr bool kTmaStore = BPS == 1 && MT == 1 && BN % 32 == 0;
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma widths");
};

struct Params {
  Geometry g;
  // a stage holds 128 bytes of K: `per` boxes of `chunk` bytes
  int out_kind, chunk, per, chunks, k_stages, stages, stage_bytes, n_tiles, tiles;
  // tma_store: bf16 out through a staging buffer of its own at out_offset
  // and TMA stores, the grid persistent; else one tile a block, the tile
  // staged through the freed ring
  int tma_store, out_offset;
  long long m;
};

// the dequant epilogue of one accumulator: bf16(f32(acc) * sx * sw), then
// + bias in bf16 (kOut 1: `bias` holds the bf16 bias exactly in fp32);
// f32(acc) * sx * sw + bias in fp32 (kOut 2)
template <int kOut>
__device__ __forceinline__ float dequant(int acc, float sx, float sw, bool has_bias,
                                         float bias) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if constexpr (kOut == 1) {
    y = __bfloat162float(__float2bfloat16_rn(y));
    if (has_bias) y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(y, bias)));
  } else if (has_bias) {
    y = __fadd_rn(y, bias);
  }
  return y;
}

template <int BN, int NC, int MT, int BPS>
__global__ void __launch_bounds__(128 * (NC + 1), BPS)
conv_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_out, void* __restrict__ out,
            const float* __restrict__ sx_, const float* __restrict__ sw,
            const void* __restrict__ bias, const Params p) {
  using T = ConvTiles<BN, NC, MT, BPS>;
  constexpr int BM = T::kBM, PIX = T::kPixels, LOADS = BM / PIX;
  extern __shared__ unsigned char raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ float col_sw[BN], col_bias[BN];  // the tile's output channels

  const Geometry& g = p.g;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int taps = g.kh * g.kw, chunk = p.chunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {  // the producer warpgroup
    if (tid == 0) {
      int s = 0, issued = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const long long m0 = static_cast<long long>(tile / p.n_tiles) * BM;
        const int n0 = (tile % p.n_tiles) * BN;
        // the first pixel of each im2col column: its first tap's input position
        int cw[LOADS], chh[LOADS], cn[LOADS], loads = 0;
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const long long pix = m0 + PIX * j;
          if (pix < p.m) {
            const int ow = static_cast<int>(pix % g.wo);
            const long long t = pix / g.wo;
            cw[j] = ow * g.sw - g.pl;
            chh[j] = static_cast<int>(t % g.ho) * g.sh - g.pt;
            cn[j] = static_cast<int>(t / g.ho);
            ++loads;
          }
        }
        const uint32_t bytes = static_cast<uint32_t>(p.per * (loads * PIX + BN) * chunk);
        int tap = 0, c = 0;
        for (int ks = 0; ks < p.k_stages; ++ks, ++issued) {
          if (issued >= p.stages) mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], bytes);
          unsigned char* sa = ring + s * p.stage_bytes;
          for (int u = 0; u < p.per; ++u) {
            // box u: (tap, chunk c); past the last tap, channels past Cp (zeros)
            const int t = min(tap, taps - 1), c0 = tap < taps ? c * chunk : p.chunks * chunk;
            const int dy = t / g.kw, dx = t - dy * g.kw;
#pragma unroll
            for (int j = 0; j < LOADS; ++j)
              if (j < loads)
                tma_load_im2col_4d(sa + (u * BM + j * PIX) * chunk, &map_a, &full[s], c0,
                                   cw[j], chh[j], cn[j], static_cast<uint16_t>(dx),
                                   static_cast<uint16_t>(dy));
            tma_load_3d(sa + (p.per * BM + u * BN) * chunk, &map_b, &full[s], c0, t, n0);
            if (++c == p.chunks) {
              c = 0;
              ++tap;
            }
          }
          if (++s == p.stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64 MT w .. 64 MT (w + 1) - 1 of each tile
  const int w = wg, lane = tid % 32;
  // K-major swizzled operands: SBO = 8 rows; layout 1/2/3 = 128/64/32-byte
  // swizzle.  The k32 step kk of a stage lies `within` bytes into box kk /
  // (chunk / 32): A's boxes are BM rows apart, B's BN, after the A boxes'
  // 128 BM bytes (few registers live across the main loop: no spills).
  const uint32_t sbo = 8 * chunk, layout = chunk == 128 ? 1 : chunk == 64 ? 2 : 3;
  const int kmask = chunk / 32 - 1, a_base = w * MT * 64 * chunk;
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    // the tile's scales and biases, read while the main loop runs: every
    // consumer is past the previous epilogue's last barrier, so none still
    // reads the table
    for (int i = threadIdx.x; i < BN; i += 128 * NC) {
      const int c = (tile % p.n_tiles) * BN + i;
      const bool in = c < g.o && p.out_kind != 0;
      col_sw[i] = in ? sw[c] : 0.f;
      col_bias[i] = !in || bias == nullptr ? 0.f
                    : p.out_kind == 1   ? __bfloat162float(static_cast<const bf16*>(bias)[c])
                                        : static_cast<const float*>(bias)[c];
    }
    int acc[MT][BN / 2];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0;
    int prev = 0;
    for (int ks = 0; ks < p.k_stages; ++ks) {
      mbar_wait(&full[s], phase);
      const unsigned char* stage = ring + s * p.stage_bytes;
#pragma unroll
      for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int within = (kk & kmask) * 32, boxes = 32 * kk - within;
        const uint64_t db = desc(stage + 128 * BM + BN * boxes + within, 16, sbo, layout);
#pragma unroll
        for (int t = 0; t < MT; ++t)
          WgmmaS8<BN>::run(
              acc[t], desc(stage + BM * boxes + within + a_base + t * 64 * chunk, 16, sbo, layout),
              db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group is done
#pragma unroll
      for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
      if (ks > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
    if (lane == 0) mbar_arrive(&empty[prev]);  // the tile's last stage
    const long long m0 = static_cast<long long>(tile / p.n_tiles) * BM;
    const int n0 = (tile % p.n_tiles) * BN;
    const int kind = p.out_kind, r0 = 16 * (tid / 32) + lane / 4, t4 = lane & 3;
    const bool has_bias = bias != nullptr;
    const float sx = kind == 0 ? 0.f : sx_[0];

    if constexpr (T::kTmaStore) {
      if (p.tma_store) {
        // bf16 out: dequantized from the registers into BN / 32 boxes of BM
        // rows x 64 bytes (64-byte swizzle: the 16-byte unit u of row r at
        // u ^ ((r / 2) % 4)), then one TMA store a box, clipped at M and O,
        // which runs on while the consumers start the next tile
        unsigned char* ost = ring + p.out_offset;
        if (threadIdx.x == 0) bulk_wait_read<0>();  // the previous tile's stores have read it
        named_sync(1, 128 * NC);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const float w0 = col_sw[col], w1 = col_sw[col + 1];
          const float b0 = col_bias[col], b1 = col_bias[col + 1];
#pragma unroll
          for (int t = 0; t < MT; ++t) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = w * MT * 64 + 64 * t + r0 + 8 * h;
              const uint32_t v =
                  pack_bf16(dequant<1>(acc[t][4 * j + 2 * h], sx, w0, has_bias, b0),
                            dequant<1>(acc[t][4 * j + 2 * h + 1], sx, w1, has_bias, b1));
              *reinterpret_cast<uint32_t*>(ost + (j / 4) * BM * 64 + r * 64 +
                                           (((j % 4) ^ ((r >> 1) & 3)) << 4) + 4 * t4) = v;
            }
          }
        }
        fence_proxy_async();
        named_sync(1, 128 * NC);
        if (threadIdx.x == 0) {
          for (int b = 0; b < BN / 32; ++b)
            tma_store_2d(&map_out, ost + b * BM * 64, n0 + 32 * b, static_cast<int>(m0));
          bulk_commit();
        }
        continue;
      }
    }

    // one tile a block: the ring now holds the tile of raw accumulators,
    // staged row by row, then dequantized along the rows: 8 bf16 or 4 fp32
    // / int32 a 16-byte store
    named_sync(1, 128 * NC);
    constexpr int P = T::kPitch;
    int* st = reinterpret_cast<int*>(ring) + w * MT * 64 * P;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        *reinterpret_cast<int2*>(st + (64 * t + r0) * P + 8 * j + 2 * t4) =
            make_int2(acc[t][4 * j], acc[t][4 * j + 1]);
        *reinterpret_cast<int2*>(st + (64 * t + r0 + 8) * P + 8 * j + 2 * t4) =
            make_int2(acc[t][4 * j + 2], acc[t][4 * j + 3]);
      }
    }
    named_sync(2 + w, 128);
    const long long row0 = m0 + w * MT * 64;
    const int rows = static_cast<int>(min(static_cast<long long>(MT * 64), p.m - row0));
    const int cols = min(BN, g.o - n0);
    const int vec = kind == 1 ? 8 : 4;
    if (rows > 0 && g.o % vec == 0) {
      const int groups = (cols + vec - 1) / vec;
      for (int i = tid; i < rows * groups; i += 128) {
        const int r = i / groups, q = vec * (i - r * groups);
        const int* src = st + r * P + q;
        const long long idx = (row0 + r) * g.o + n0 + q;
        if (kind == 1) {
          const int4 a0 = *reinterpret_cast<const int4*>(src);
          const int4 a1 = *reinterpret_cast<const int4*>(src + 4);
          const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          float y[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            y[e] = dequant<1>(a[e], sx, col_sw[q + e], has_bias, col_bias[q + e]);
          st128(static_cast<bf16*>(out) + idx,
                make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                           pack_bf16(y[6], y[7])));
        } else {
          int4 v = *reinterpret_cast<const int4*>(src);
          if (kind == 2) {
            v = make_int4(
                __float_as_int(dequant<2>(v.x, sx, col_sw[q], has_bias, col_bias[q])),
                __float_as_int(dequant<2>(v.y, sx, col_sw[q + 1], has_bias, col_bias[q + 1])),
                __float_as_int(dequant<2>(v.z, sx, col_sw[q + 2], has_bias, col_bias[q + 2])),
                __float_as_int(dequant<2>(v.w, sx, col_sw[q + 3], has_bias, col_bias[q + 3])));
          }
          *reinterpret_cast<int4*>(static_cast<int*>(out) + idx) = v;
        }
      }
    } else if (rows > 0) {  // element by element along the rows (contiguous when cols == O)
      for (int i = tid; i < rows * cols; i += 128) {
        const int r = i / cols, q = i - r * cols;
        const int a = st[r * P + q];
        const long long idx = (row0 + r) * g.o + n0 + q;
        if (kind == 1) {
          static_cast<bf16*>(out)[idx] =
              __float2bfloat16_rn(dequant<1>(a, sx, col_sw[q], has_bias, col_bias[q]));
        } else {
          static_cast<int*>(out)[idx] =
              kind == 0 ? a : __float_as_int(dequant<2>(a, sx, col_sw[q], has_bias, col_bias[q]));
        }
      }
    }
  }
  if constexpr (T::kTmaStore) {
    if (p.tma_store && threadIdx.x == 0) bulk_wait_read<0>();  // the staging outlives the reads
  }
}

template <int BN, int NC, int MT, int BPS>
int launch(int out_kind, const void* x8, const void* w8, void* out, const void* sx,
           const void* sw, const void* bias, const Geometry& g, int chunk, cudaStream_t st) {
  using T = ConvTiles<BN, NC, MT, BPS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_kernel<BN, NC, MT, BPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Params p{};
  p.g = g;
  p.out_kind = out_kind;
  p.chunk = chunk;
  p.per = 128 / chunk;
  p.chunks = (g.cp + chunk - 1) / chunk;
  p.k_stages = (g.kh * g.kw * p.chunks + p.per - 1) / p.per;
  p.stage_bytes = (T::kBM + BN) * 128;  // a multiple of 1024: BM + BN is of 8
  // bf16 out at whole 16-byte rows goes by TMA store from a staging buffer
  // of its own (BN / 32 boxes of BM rows x 64 bytes) past the ring
  p.tma_store = T::kTmaStore && out_kind == 1 && g.o % 8 == 0;
  const int out_bytes = p.tma_store ? T::kBM * BN * 2 : 0;
  p.stages = std::min(kMaxStages, (T::kSmemBytes - 1024 - out_bytes) / p.stage_bytes);
  p.out_offset = p.stages * p.stage_bytes;
  p.n_tiles = (g.o + BN - 1) / BN;
  p.m = static_cast<long long>(g.batch) * g.ho * g.wo;
  const long long tiles = (p.m + T::kBM - 1) / T::kBM * p.n_tiles;
  if (p.stages < 2 || tiles >= (1LL << 31)) return -1;
  p.tiles = static_cast<int>(tiles);
  int blocks = p.tiles;  // one tile a block, or persistent: every SM's blocks
  if (p.tma_store) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = std::min(blocks, sms * BPS);
  }
  const CUtensorMapSwizzle swizzle = chunk == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : chunk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  // the first tap's input positions: rows -pt, -pt + sh, .. (ho of them),
  // columns likewise; the upper corners are offsets from the last row and
  // column ({W, H} order)
  const int lower[2] = {-g.pl, -g.pt};
  const int upper[2] = {-g.pl + (g.wo - 1) * g.sw - (g.w - 1),
                        -g.pt + (g.ho - 1) * g.sh - (g.h - 1)};
  const int stride[2] = {g.sw, g.sh};
  CUtensorMap ma, mb;
  int err = im2col_map(&ma, x8, g.batch, g.h, g.w, g.cp, lower, upper, stride, chunk, T::kPixels,
                       swizzle);
  const int taps = g.kh * g.kw;
  const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(g.cp), static_cast<cuuint64_t>(taps),
                                static_cast<cuuint64_t>(g.o)};
  const cuuint64_t b_strides[2] = {static_cast<cuuint64_t>(g.cp),
                                   static_cast<cuuint64_t>(taps) * g.cp};
  const cuuint32_t b_box[3] = {static_cast<cuuint32_t>(chunk), 1u, static_cast<cuuint32_t>(BN)};
  if (err == 0) err = tiled_map(&mb, true, 3, w8, b_dims, b_strides, b_box, swizzle);
  CUtensorMap mo{};  // out (O, M) in boxes of 32 channels x BM pixels
  if (err == 0 && p.tma_store) {
    const cuuint64_t o_dims[2] = {static_cast<cuuint64_t>(g.o), static_cast<cuuint64_t>(p.m)};
    const cuuint64_t o_strides[1] = {static_cast<cuuint64_t>(g.o) * 2};
    const cuuint32_t o_box[2] = {32u, static_cast<cuuint32_t>(T::kBM)};
    err = tiled_map(&mo, false, 2, out, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err != 0) return err;
  conv_kernel<BN, NC, MT, BPS><<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes,
                                 st>>>(
      ma, mb, mo, out, static_cast<const float*>(sx), static_cast<const float*>(sw),
      out_kind == 0 ? nullptr : bias, p);
  return static_cast<int>(cudaGetLastError());
}

// The tile conv_tiles picks (mirrored by ops/quant.py `conv_tiles`).
struct Tiles {
  int bm, bn, chunk;
};

Tiles conv_tiles(int cp, int o) {
  const int chunk = cp > 64 ? 128 : cp > 32 ? 64 : 32;
  if (o <= 32) return {256, o <= 8 ? 8 : o <= 16 ? 16 : 32, chunk};
  if (o % 160 == 0 && o % 128 != 0) return {192, 160, chunk};
  return {256, 128, chunk};
}

bool geometry_ok(const Geometry& g) {
  const int lo_w = -g.pl, lo_h = -g.pt;
  const int up_w = lo_w + (g.wo - 1) * g.sw - (g.w - 1);
  const int up_h = lo_h + (g.ho - 1) * g.sh - (g.h - 1);
  auto in8 = [](int v) { return v >= -128 && v <= 127; };
  return in8(lo_w) && in8(lo_h) && in8(up_w) && in8(up_h) && g.kh <= 256 && g.kw <= 256 &&
         g.sh <= 8 && g.sw <= 8;
}

int run(int out_kind, const void* x8, const void* w8, void* out, const void* sx, const void* sw,
        const void* bias, const Geometry& g, Tiles t, cudaStream_t st) {
  if (t.chunk != 32 && t.chunk != 64 && t.chunk != 128) return -1;
#define CONV_TILE(BN, NC, MT, BPS)                      \
  if (t.bn == BN && t.bm == 64 * NC * MT)               \
    return launch<BN, NC, MT, BPS>(out_kind, x8, w8, out, sx, sw, bias, g, t.chunk, st);
  CONV_TILE(8, 2, 2, 2)
  CONV_TILE(16, 2, 2, 2)
  CONV_TILE(32, 2, 2, 2)
  CONV_TILE(128, 2, 2, 1)
  CONV_TILE(160, 3, 1, 1)
#undef CONV_TILE
  return -1;
}

int checked(int out_kind, int batch, int h, int w, int cp, int o, int kh, int kw, int sh,
            int sw_, int pad_top, int pad_left, int ho, int wo, Geometry* g) {
  if (batch <= 0 || h <= 0 || w <= 0 || cp <= 0 || cp % 16 || o <= 0 || kh <= 0 || kw <= 0 ||
      sh <= 0 || sw_ <= 0 || ho <= 0 || wo <= 0 || out_kind < 0 || out_kind > 2)
    return -1;
  *g = Geometry{batch, h, w, cp, o, kh, kw, sh, sw_, pad_top, pad_left, ho, wo};
  return geometry_ok(*g) ? 0 : -1;
}

}  // namespace

}  // namespace ccedit

// Kernel 10.  x8: contiguous int8 (batch, h, w, cp), cp a multiple of 16;
// w8: contiguous int8 (o, kh * kw * cp); out: contiguous (batch, ho, wo, o)
// of int32 (out_kind 0), bf16 (1) or fp32 (2); sx: one fp32 value; sw: fp32
// (o); bias: (o) of out's type or null.  The window reads input row oh * sh
// - pad_top + dy and column ow * sw - pad_left + dx (zero outside).  The
// tile is conv_tiles(cp, o).  Returns the launch's cudaError_t (or a tensor
// map's); -1 for arguments it does not take.
extern "C" int ccedit_int8_conv(int out_kind, const void* x8, const void* w8, void* out,
                                const void* sx, const void* sw, const void* bias, int batch,
                                int h, int w, int cp, int o, int kh, int kw, int sh, int sw_,
                                int pad_top, int pad_left, int ho, int wo, void* stream) {
  using namespace ccedit;
  Geometry g;
  if (checked(out_kind, batch, h, w, cp, o, kh, kw, sh, sw_, pad_top, pad_left, ho, wo, &g))
    return -1;
  return run(out_kind, x8, w8, out, sx, sw, bias, g, conv_tiles(cp, o),
             static_cast<cudaStream_t>(stream));
}

// Kernel 10 at a given tile (bm, bn, chunk): one of the instantiations
// listed in `run`, for sweeps (scripts/conv_tiles.py); -1 for another.
extern "C" int ccedit_int8_conv_tiled(int out_kind, const void* x8, const void* w8, void* out,
                                      const void* sx, const void* sw, const void* bias,
                                      int batch, int h, int w, int cp, int o, int kh, int kw,
                                      int sh, int sw_, int pad_top, int pad_left, int ho, int wo,
                                      int bm, int bn, int chunk, void* stream) {
  using namespace ccedit;
  Geometry g;
  if (checked(out_kind, batch, h, w, cp, o, kh, kw, sh, sw_, pad_top, pad_left, ho, wo, &g))
    return -1;
  return run(out_kind, x8, w8, out, sx, sw, bias, g, Tiles{bm, bn, chunk},
             static_cast<cudaStream_t>(stream));
}

// The tile ccedit_int8_conv takes for (cp, o): tiles[0..2] = (BM, BN,
// k-chunk bytes).  Returns 0.
extern "C" int ccedit_int8_conv_tiles(int cp, int o, int* tiles) {
  const ccedit::Tiles t = ccedit::conv_tiles(cp, o);
  tiles[0] = t.bm;
  tiles[1] = t.bn;
  tiles[2] = t.chunk;
  return 0;
}
