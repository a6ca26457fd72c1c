// Kernel 6: int8 x int8 -> int32 and bf16 x bf16 -> fp32 matrix products,
// C (M, N) = A (M, K) @ B (K, N), all row-major.
//
// Replaces: scripts/int8_probe.py `part_pallas` (:127): the Mosaic int8 dot
// (pallas_call :142) and the bf16 dot (:159) at (1024, 512) @ (512, 1024),
// with which the JAX package asked whether a hand-written kernel reaches the
// matrix unit's int8 rate.  Here it asks the same of wgmma on the H100.
//
// What bounds it: at 1024x512x1024 the bytes.  The product is 1.07 GOP
// (0.54 us at 1,979 TOP/s int8, 1.09 us at 989 TFLOP/s bf16) against 1 MB
// (int8) or 2 MB (bf16) in and 4 MB out (1.5 / 1.8 us at 3.35 TB/s).  At
// 4096^3 the tensor cores: 137 GOP, 69 us int8 / 139 us bf16; its 64 MiB
// fp32 or int32 output alone is 20 us of bytes.
//
// Design: one warp-specialised block of three warpgroups per 128 x 256
// output tile.
//   - Warpgroup 0 is the producer (setmaxnreg 40): one thread keeps a
//     4-stage TMA ring of A and B k-tiles in flight, each stage guarded by a
//     full mbarrier (TMA transaction bytes) and an empty one (the 8
//     consumer warps arrive).  A stage holds 128 bytes of k: A 128 rows x
//     128 B (16 KB) and B 256 columns x 128 B (32 KB).
//   - Warpgroups 1 and 2 are consumers (setmaxnreg 232), 64 rows of the
//     tile each, the 64 x 256 fp32 or s32 accumulator in registers (128 a
//     thread).  bf16: wgmma m64n256k16, A K-major (its rows), B (K, N)
//     row-major read MN-major (4 chunks of 64 columns by 64 k-rows,
//     hopper.cuh's header), 4 steps a stage.  int8: wgmma m64n256k32 .s32.s8.s8, which
//     takes only K-major operands, so B is transposed to B^T (N, K) first
//     (transpose_int8.cu, launched by the wrapper inside the timed call;
//     the bound stays the product's), its tile 256 rows x 128 B; 4 steps a
//     stage.  Each consumer keeps one wgmma group in flight behind the
//     next stage's (wait_group 1) and frees a stage when its group is done.
//   - Epilogue: when both consumers are done the ring is free; each stages
//     its 64 x 256 accumulator through shared memory (rows of 256 + 8
//     words: conflict-free 8-byte stores) and writes it back in 16-byte
//     stores along the rows of C.
// Tails: k past K and B columns past N arrive as zeros from TMA (a bf16 B
// chunk wholly past N is not loaded: its accumulator columns are not
// stored), and the stores clip at N.  M and N are multiples of 128, K of
// 64 (int8) or 32 (bf16).
//
// Kernel 9, the W8A8 path's dense product (ops/quant.py `gemm_dequant` and
// `gemm_dequant_bf16a`), is `dequant_gemm_kernel` (kernel 6's
// instantiations are left as they were, instruction for instruction):
// out (M, N) = dequant(A8 (M, K) @ W8 (N, K)^T), torch's (N, K) Linear
// weight being the K-major B^T that s8 wgmma reads, with no transposition.
// It replaces no Pallas kernel: the JAX package runs `int8_matmul`
// (ccedit_tpu/ops/quant.py:75-88) in XLA.  Its second form takes the bf16
// activation itself and quantizes it per token in shared memory, kernel 8's
// per-row mode folded into its load path: no int8 copy of the activation
// goes to device memory.
//
// What bounds it: at the UNet's widths the bytes (a 320 -> 320 layer over
// 208,896 tokens: 27 GOP, 14 us at int8 peak, against 67 MB of int8 in, or
// 134 MB of bf16 in for the fused form, and 134 MB of bf16 out: 60 us, 80
// us).  So nothing may stand between the loads and the stores: the grid is
// persistent, the weights stay in shared memory, the epilogue runs under
// the next tile's loads and the tile fits N.
//
// Design: a persistent grid of warp-specialised blocks (two consumer
// warpgroups of 64 rows, then a producer warpgroup; a block an SM), each
// walking 128 x BN output tiles in a fixed order (tile t = (m tile, n
// tile), t = blockIdx.x, blockIdx.x + gridDim.x, ..., the n tiles of an m
// tile adjacent, so its A rows cross HBM once and hit L2 after).
//   - The tile (dense_tiles, mirrored by ops/quant.py `gemm_tiles` and
//     reported by `ccedit_int8_gemm_tiles`): BN = 256 where N is a multiple
//     of 256 (1280, 2560, 5120, 10240), 160 where it is a multiple of 160
//     (320, 640: a 256-wide tile there is a quarter or three eighths
//     zeros), else 128; s8 wgmma m64nBNk32, int32 accumulators in registers
//     (BN / 2 a thread).  No setmaxnreg: ptxas compiles every thread within
//     the launch bound's 168 registers whatever it grants.
//   - Resident weights: where the block's BN x Kp slice of W8, the bf16
//     staging and two A boxes fit, the grid is a multiple of the n tiles,
//     so a block keeps one n tile: its slice is loaded once by TMA (128-byte
//     k-chunks of BN rows, 128-byte swizzle) and only A streams, through a
//     ring of 128-row x 128-byte boxes (at most 8).  Otherwise each stage
//     holds A's box and B's.  The ring's stages and phases run on from tile
//     to tile.
//   - Epilogue: the tile's sw and bias (and, on the int8 path, its rows'
//     sx) are read into shared tables while the main loop runs; each
//     consumer dequantizes its accumulators along the rows, out =
//     bf16(bf16(f32(acc) * sx[m] * sw[n]) + bias[n]) with the products
//     rounded one by one (__fmul_rn, no FMA contraction) in the order of the
//     JAX expression, two columns at a time (the card converts types at 16
//     a clock an SM, against 128 FMAs: one bf16 rounding a pair), into a
//     bf16 staging tile (BN / 32 boxes of 128 rows x 64 bytes, 64-byte
//     swizzle: conflict-free 4-byte stores), and one thread stores each box
//     by TMA, clipped at M and N, while the consumers go on to the next
//     tile, whose A the producer has been loading meanwhile (kernel 10's
//     epilogue).  fp32 and int32 outputs, and bf16 with N not a multiple of
//     8, are written from the registers.
//   - The fused form (`dequant_gemm_kernel<BN, true>`): where the block's
//     whole bf16 tile (ceil(K / 64) boxes of 128 rows x 64 columns) fits
//     beside the resident slice and the staging (dense_tiles' `fused`: K <=
//     384 at BN = 160), the producer loads the tile's bf16 rows by TMA into
//     one buffer, and the consumers quantize it in place, two threads a
//     row: the row's amax over its bf16 chunks (fp32, a shuffle between the
//     pair), scale = amax > 0 ? amax / 127 : 1 and q = rint(v / scale)
//     clamped to +-127 with true quotients (__fdiv_rn; kernel 8's
//     arithmetic bit for bit), written as the 128-byte-swizzled K-major s8
//     chunks wgmma reads: int8 chunk j over bf16 chunk j of the same row,
//     thread h of the pair writing its bytes 64 h .. from bf16 chunk 2 j +
//     h, both reading before either writes.  k past K arrives as zeros,
//     quantizes to zeros and matches the quantizer's padded layout.  The
//     buffer is loaded again once both consumers' products are done, under
//     the epilogue.  A debug form writes the quantized rows and scales out.
// Tails: any M (TMA zero-fills rows past M and clips the stores), any N
// (W8 rows past N read as zeros), K a multiple of 16 (the quantizer's zero
// padding: TMA needs 16-byte global strides and zero-fills k past K), the
// fused form's bf16 K a multiple of 8.
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace ccedit {

namespace {

using namespace hopper;

template <bool I8>
struct GemmTiles {
  static constexpr int kBM = 128, kBN = 256, kStages = 4;
  static constexpr int kBK = I8 ? 128 : 64;       // k elements a stage: 128 bytes
  static constexpr int kABytes = kBM * 128;       // A: 128 rows x 128 B
  static constexpr int kBBytes = kBN * 128;       // B: 256 columns x 128 B of k
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPitch = kBN + 8;          // words of a staged output row
  // + 1024: the dynamic buffer is aligned up to the swizzle atom by hand
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes;
  static_assert(kBM * kPitch * 4 <= kStages * kStageBytes, "the output tile fits in the ring");
  static_assert(kSmemBytes + 128 <= 232448, "the ring does not fit in a block's shared memory");
};

template <bool I8>
__global__ void __launch_bounds__(384, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            void* __restrict__ c_, int n, int k) {
  using T = GemmTiles<I8>;
  using Acc = typename std::conditional<I8, int, float>::type;
  using Acc2 = typename std::conditional<I8, int2, float2>::type;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ uint64_t full[S], empty[S];

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * T::kBM, n0 = blockIdx.x * T::kBN;
  const int k_tiles = (k + T::kBK - 1) / T::kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dec<40>();
    if (tid == 0) {
      // bf16: B's 64-column chunks that hold a column of C
      const int chunks = I8 ? 0 : min(4, (n - n0 + 63) / 64);
      const uint32_t bytes = T::kABytes + (I8 ? T::kBBytes : chunks * 64 * 128);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], (kt / S - 1) & 1);
        mbar_expect_tx(&full[s], bytes);
        unsigned char* sa = ring + s * T::kStageBytes;
        unsigned char* sb = sa + T::kABytes;
        tma_load_2d(sa, &map_a, &full[s], kt * T::kBK, m0);
        if constexpr (I8) {
          tma_load_2d(sb, &map_b, &full[s], kt * T::kBK, n0);  // B^T rows n0 .. n0 + 255
        } else {
          for (int ch = 0; ch < chunks; ++ch)
            tma_load_2d(sb + ch * 64 * 128, &map_b, &full[s], n0 + 64 * ch, kt * T::kBK);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64w .. 64w + 63 of the tile
  regs_inc<232>();
  const int w = wg - 1, warp = tid / 32, lane = tid % 32, t = lane & 3;
  Acc acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const unsigned char* sa = ring + s * T::kStageBytes + w * 64 * 128;
    const unsigned char* sb = ring + s * T::kStageBytes + T::kABytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (I8) {
        WgmmaS8<256>::run(acc, desc(sa + kk * 32, 16, 1024, 1), desc(sb + kk * 32, 16, 1024, 1), 1);
      } else {
        WgmmaSS<256, 1>::run(acc, desc(sa + kk * 32, 16, 1024, 1),
                             desc(sb + kk * 2048, 64 * 128, 1024, 1), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group is done
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: both consumers are past the ring, which now holds the tile
  named_sync(1, 256);
  Acc* st = reinterpret_cast<Acc*>(ring) + 64 * w * T::kPitch;
  const int r0 = 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * t;
    Acc2 v0, v1;
    v0.x = acc[4 * j];
    v0.y = acc[4 * j + 1];
    v1.x = acc[4 * j + 2];
    v1.y = acc[4 * j + 3];
    *reinterpret_cast<Acc2*>(st + r0 * T::kPitch + col) = v0;
    *reinterpret_cast<Acc2*>(st + (r0 + 8) * T::kPitch + col) = v1;
  }
  named_sync(2 + w, 128);
  Acc* c = static_cast<Acc*>(c_) + static_cast<long long>(m0 + 64 * w) * n + n0;
  for (int i = tid; i < 64 * 64; i += 128) {
    const int r = i / 64, p = i % 64;
    if (n0 + 4 * p < n)
      *reinterpret_cast<uint4*>(c + static_cast<long long>(r) * n + 4 * p) =
          *reinterpret_cast<const uint4*>(st + r * T::kPitch + 4 * p);
  }
}

// ---- kernel 9 ----

constexpr int kDenseBM = 128;             // two consumer warpgroups of 64 rows
constexpr int kDenseThreads = 384;        // the consumers, then the producer
constexpr int kDenseSmem = 223 * 1024;    // dynamic shared memory; the tables are static
constexpr int kDenseBudget = kDenseSmem - 1024;  // less the alignment slack
constexpr int kDenseMaxStages = 8;
constexpr int kBox = kDenseBM * 128;      // a 128-row box of 128 bytes

// The tile for K (the activation's row length) and N.
struct DenseTile {
  int bn;        // 256 (N % 256 == 0), 160 (N % 160 == 0), else 128
  int resident;  // the block's BN x Kp weight slice stays in shared memory
  int stages;    // the int8 form's ring: A boxes (and B's, unless resident)
  int fused;     // the bf16 form takes (K, N): its whole tile fits beside the slice
};

DenseTile dense_tiles(int k, int n) {
  DenseTile t;
  t.bn = n % 256 == 0 ? 256 : n % 160 == 0 ? 160 : 128;
  const int kc = (k + 127) / 128, xc = (k + 63) / 64;
  const int w_bytes = kc * t.bn * 128, out_bytes = kDenseBM * t.bn * 2;
  t.resident = w_bytes + out_bytes + 2 * kBox <= kDenseBudget;
  const int stage = kBox + (t.resident ? 0 : t.bn * 128);
  t.stages = std::min(kDenseMaxStages,
                      (kDenseBudget - out_bytes - (t.resident ? w_bytes : 0)) / stage);
  t.fused = xc * kBox + w_bytes + out_bytes <= kDenseBudget;
  return t;
}

struct DenseParams {
  int m, n, k, kp;  // k: the A rows' length (int8: kp; bf16: K), kp: W8's
  int out_kind, n_tiles, tiles;
  int kc, xc;       // 128-byte k-chunks of the int8 operands; 64-column chunks of bf16 x
  int stages, stage_bytes, resident, tma_store, w_offset, out_offset;
  int faults;       // planted faults of the checks (bf16 form): 1 one amax a
                    // consumer's 64 rows, 2 every row dequantized with its tile's
                    // first row's scale
};

// The dequant epilogue, out = bf16(bf16(f32(acc) * sx * sw) + bias), the
// products rounded one by one in the order of the JAX expression, for two
// neighbouring columns at once: the card converts types at 16 a clock an SM
// (against 128 FMAs), so each bf16 rounding takes one conversion for the
// pair.  The pair's bf16 values packed, the first in the low half.
__device__ __forceinline__ uint32_t dequant_bf16x2(int a0, int a1, float sx, float w0, float w1,
                                                   bool has_bias, float b0, float b1) {
  uint32_t v = pack_bf16(__fmul_rn(__fmul_rn(__int2float_rn(a0), sx), w0),
                         __fmul_rn(__fmul_rn(__int2float_rn(a1), sx), w1));
  if (has_bias)
    v = pack_bf16(__fadd_rn(__uint_as_float(v << 16), b0),
                  __fadd_rn(__uint_as_float(v & 0xffff0000u), b1));
  return v;
}

// the fp32 epilogue of one accumulator: f32(acc) * sx * sw + bias
__device__ __forceinline__ float dequant_f32(int acc, float sx, float sw, bool has_bias,
                                             float bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  return has_bias ? __fadd_rn(y, bias) : y;
}

// kernel 8's arithmetic (quantize_int8.cu): the scale of a row, one value
__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

__device__ __forceinline__ uint32_t q8(float v, float scale) {
  const int q = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f));
  return static_cast<uint32_t>(q) & 0xffu;
}

// The same value without a division or a conversion, where 2^-100 <= scale
// <= 2^100 (`inv` = __frcp_rn(scale)): the quotient v / scale rounded to
// nearest is the product v * inv corrected twice by its exact residual
// (Markstein: once the estimate is within an ulp, the fma of the residual
// by the correctly rounded reciprocal rounds to the correctly rounded
// quotient; the first step brings it there); clamped, then rounded to an
// integer by the magic-number addition, whose float's low byte is the int8.
__device__ __forceinline__ uint32_t q8_fast(float v, float scale, float inv) {
  float q = __fmul_rn(v, inv);
  q = __fmaf_rn(__fmaf_rn(-q, scale, v), inv, q);
  q = __fmaf_rn(__fmaf_rn(-q, scale, v), inv, q);
  return __float_as_uint(fminf(fmaxf(q, -127.f), 127.f) + 12582912.f);
}

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the largest |value| of 8 bf16 and m
__device__ __forceinline__ float absmax8(uint4 v, float m) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) m = fmaxf(fmaxf(m, fabsf(lo_bf16(w[i]))), fabsf(hi_bf16(w[i])));
  return m;
}

// 16 bf16 values (two 16-byte units) quantized into one 16-byte unit
__device__ __forceinline__ uint4 quantize16(uint4 a, uint4 b, float scale, float inv,
                                            bool fast) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t o[4];
  if (fast) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the low bytes of four magic floats
      const uint32_t p = __byte_perm(q8_fast(lo_bf16(w[2 * i]), scale, inv),
                                     q8_fast(hi_bf16(w[2 * i]), scale, inv), 0x0040);
      const uint32_t r = __byte_perm(q8_fast(lo_bf16(w[2 * i + 1]), scale, inv),
                                     q8_fast(hi_bf16(w[2 * i + 1]), scale, inv), 0x0040);
      o[i] = __byte_perm(p, r, 0x5410);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = q8(lo_bf16(w[2 * i]), scale) | q8(hi_bf16(w[2 * i]), scale) << 8 |
             q8(lo_bf16(w[2 * i + 1]), scale) << 16 | q8(hi_bf16(w[2 * i + 1]), scale) << 24;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Kernel 9.  FUSED: A is bf16 x (M, K), quantized per row in shared memory;
// else int8 A8 (M, Kp) with its row scales sx.  q_out / sx_out (FUSED,
// optional): the quantized rows (M, Kp) and scales (M), written by the
// blocks of the first n tile.
template <int BN, bool FUSED>
__global__ void __launch_bounds__(kDenseThreads, 1)
dequant_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_out, void* __restrict__ out,
                    const float* __restrict__ sx_, const float* __restrict__ sw,
                    const void* __restrict__ bias, unsigned char* __restrict__ q_out,
                    float* __restrict__ sx_out, const DenseParams p) {
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ uint64_t full[kDenseMaxStages], empty[kDenseMaxStages], w_full;
  __shared__ float s_sx[kDenseBM], s_sw[BN], s_bias[BN], s_amax[kDenseBM];

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init(&w_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup
    if (tid == 0) {
      if (p.resident) {  // the block's one n tile: gridDim.x is a multiple of n_tiles
        const int n0 = (blockIdx.x % p.n_tiles) * BN;
        mbar_expect_tx(&w_full, static_cast<uint32_t>(p.kc * BN * 128));
        for (int c = 0; c < p.kc; ++c)
          tma_load_2d(smem + p.w_offset + c * BN * 128, &map_w, &w_full, 128 * c, n0);
      }
      const int k_stages = FUSED ? 1 : p.kc;
      int s = 0, issued = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * kDenseBM, n0 = (tile % p.n_tiles) * BN;
        for (int ks = 0; ks < k_stages; ++ks, ++issued) {
          if (issued >= p.stages) mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = smem + s * p.stage_bytes;
          mbar_expect_tx(&full[s], static_cast<uint32_t>(p.stage_bytes));
          if constexpr (FUSED) {
            for (int c = 0; c < p.xc; ++c) tma_load_2d(st + c * kBox, &map_a, &full[s], 64 * c, m0);
          } else {
            tma_load_2d(st, &map_a, &full[s], 128 * ks, m0);
            if (!p.resident) tma_load_2d(st + kBox, &map_w, &full[s], 128 * ks, n0);
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

  // consumers: warpgroup w owns rows 64 w .. 64 w + 63 of each tile
  const int w = wg, lane = tid % 32, t4 = lane & 3;
  const int r0 = 16 * (tid / 32) + lane / 4;  // the accumulator rows r0, r0 + 8 of the 64
  const int kind = p.out_kind;
  const bool has_bias = bias != nullptr;
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.n_tiles) * kDenseBM, n0 = (tile % p.n_tiles) * BN;
    // the tables, read while the main loop runs: every consumer is past the
    // previous epilogue's last barrier, so none still reads them
    for (int i = threadIdx.x; i < BN; i += 256) {
      const int c = n0 + i;
      const bool in = c < p.n && kind != 0;
      s_sw[i] = in ? sw[c] : 0.f;
      s_bias[i] = !in || !has_bias ? 0.f
                  : kind == 1      ? __bfloat162float(static_cast<const bf16*>(bias)[c])
                                   : static_cast<const float*>(bias)[c];
    }
    if constexpr (!FUSED) {
      for (int i = threadIdx.x; i < kDenseBM; i += 256)
        s_sx[i] = m0 + i < p.m && kind != 0 ? sx_[m0 + i] : 0.f;
    }
    if (p.resident && tile == static_cast<int>(blockIdx.x)) mbar_wait(&w_full, 0);

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    if constexpr (FUSED) {
      mbar_wait(&full[0], phase);
      // quantize this warpgroup's rows in place, two threads a row
      const int rr = 64 * w + tid / 2, h = tid & 1, sw8 = rr & 7;
      unsigned char* xrow = smem + rr * 128;  // row rr of chunk c at xrow + c * kBox
      float amax = 0.f;
      for (int c = h; c < p.xc; c += 2) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          amax = absmax8(*reinterpret_cast<const uint4*>(xrow + c * kBox + ((u ^ sw8) << 4)),
                         amax);
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      if (p.faults & 1) {  // planted fault: one amax for the warpgroup's 64 rows
        s_amax[rr] = amax;
        named_sync(2 + w, 128);
        for (int i = 0; i < 64; ++i) amax = fmaxf(amax, s_amax[64 * w + i]);
      }
      const float scale = row_scale(amax), inv = __frcp_rn(scale);
      const bool fast = scale >= 0x1p-100f && scale <= 0x1p100f;
      const long long grow = static_cast<long long>(m0) + rr;
      const bool emit = q_out != nullptr && n0 == 0 && grow < p.m;
      for (int j = 0; j < p.kc; ++j) {
        const int c = 2 * j + h;
        uint4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = c < p.xc ? *reinterpret_cast<const uint4*>(xrow + c * kBox + ((u ^ sw8) << 4))
                          : make_uint4(0u, 0u, 0u, 0u);
        __syncwarp();  // the pair has read what step j overwrites
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 o = quantize16(v[2 * q], v[2 * q + 1], scale, inv, fast);
          *reinterpret_cast<uint4*>(xrow + j * kBox + (((4 * h + q) ^ sw8) << 4)) = o;
          const int col = 128 * j + 64 * h + 16 * q;
          if (emit && col < p.kp) st128b(q_out + grow * p.kp + col, o);
        }
      }
      if (h == 0) {
        s_sx[rr] = scale;
        if (emit && sx_out != nullptr) sx_out[grow] = scale;
      }
      fence_proxy_async();  // the int8 rows, written by threads, read by wgmma
      named_sync(2 + w, 128);
      const unsigned char* a = smem + w * 64 * 128;
      for (int j = 0; j < p.kc; ++j) {
        const unsigned char* b = smem + p.w_offset + j * BN * 128;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaS8<BN>::run(acc, desc(a + j * kBox + kk * 32, 16, 1024, 1),
                           desc(b + kk * 32, 16, 1024, 1), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[0]);  // the buffer may take the next tile
      phase ^= 1;
    } else {
      int prev = 0;
      for (int ks = 0; ks < p.kc; ++ks) {
        mbar_wait(&full[s], phase);
        const unsigned char* a = smem + s * p.stage_bytes + w * 64 * 128;
        const unsigned char* b = p.resident ? smem + p.w_offset + ks * BN * 128
                                            : smem + s * p.stage_bytes + kBox;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaS8<BN>::run(acc, desc(a + kk * 32, 16, 1024, 1), desc(b + kk * 32, 16, 1024, 1), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group is done
        fence_regs(acc);
        if (ks > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == p.stages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);  // the tile's last stage
    }

    // epilogue: every consumer's tables and scales are written, and the
    // previous tile's TMA stores have read the staging
    if (p.tma_store && threadIdx.x == 0) bulk_wait_read<0>();
    named_sync(1, 256);
    const int rs = (p.faults & 2) ? 0 : 64 * w + r0;
    const float sx0 = s_sx[rs], sx1 = s_sx[(p.faults & 2) ? 0 : rs + 8];
    if (p.tma_store) {
      // bf16 out: dequantized from the registers into BN / 32 boxes of 128
      // rows x 64 bytes (64-byte swizzle: the 16-byte unit u of row r at u ^
      // ((r / 2) % 4)), then one TMA store a box, clipped at M and N, which
      // runs on while the consumers start the next tile
      unsigned char* ost = smem + p.out_offset;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        const float w0 = s_sw[col], w1 = s_sw[col + 1];
        const float b0 = s_bias[col], b1 = s_bias[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * w + r0 + 8 * h;
          const float sxr = h ? sx1 : sx0;
          const uint32_t v = dequant_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], sxr, w0,
                                            w1, has_bias, b0, b1);
          *reinterpret_cast<uint32_t*>(ost + (j / 4) * kDenseBM * 64 + r * 64 +
                                       (((j % 4) ^ ((r >> 1) & 3)) << 4) + 4 * t4) = v;
        }
      }
      fence_proxy_async();
      named_sync(1, 256);
      if (threadIdx.x == 0) {
        for (int b = 0; b < BN / 32; ++b) tma_store_2d(&map_out, ost + b * kDenseBM * 64, n0 + 32 * b, m0);
        bulk_commit();
      }
      continue;
    }
    // otherwise from the registers: two consecutive outputs a store where N
    // is even, clipped at M and N
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int lc = 8 * j + 2 * t4, col = n0 + lc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = static_cast<long long>(m0) + 64 * w + r0 + 8 * h;
        if (row >= p.m || col >= p.n) continue;
        const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        const float sxr = h ? sx1 : sx0;
        const bool two = col + 1 < p.n, vec = two && p.n % 2 == 0;
        const long long idx = row * p.n + col;
        if (kind == 0) {
          int* o = static_cast<int*>(out) + idx;
          if (vec) {
            *reinterpret_cast<int2*>(o) = make_int2(a0, a1);
          } else {
            o[0] = a0;
            if (two) o[1] = a1;
          }
        } else if (kind == 2) {
          float* o = static_cast<float*>(out) + idx;
          const float y0 = dequant_f32(a0, sxr, s_sw[lc], has_bias, s_bias[lc]);
          const float y1 = dequant_f32(a1, sxr, s_sw[lc + 1], has_bias, s_bias[lc + 1]);
          if (vec) {
            *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
          } else {
            o[0] = y0;
            if (two) o[1] = y1;
          }
        } else {
          bf16* o = static_cast<bf16*>(out) + idx;
          const uint32_t v = dequant_bf16x2(a0, a1, sxr, s_sw[lc], s_sw[lc + 1], has_bias,
                                            s_bias[lc], s_bias[lc + 1]);
          if (vec) {
            *reinterpret_cast<uint32_t*>(o) = v;
          } else {
            o[0] = __ushort_as_bfloat16(static_cast<unsigned short>(v & 0xffffu));
            if (two) o[1] = __ushort_as_bfloat16(static_cast<unsigned short>(v >> 16));
          }
        }
      }
    }
    named_sync(1, 256);  // the tables are read
  }
  if (p.tma_store && threadIdx.x == 0) bulk_wait_read<0>();  // the staging outlives the reads
}

template <int BN, bool FUSED>
int launch_dense(const DenseTile& t, int out_kind, const void* a, const void* w8, void* out,
                 const void* sx, const void* sw, const void* bias, void* q_out, void* sx_out,
                 int faults, int m, int n, int k, cudaStream_t st) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(dequant_gemm_kernel<BN, FUSED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kDenseSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  DenseParams p{};
  p.m = m;
  p.n = n;
  p.k = k;
  p.kp = (k + 15) / 16 * 16;
  p.out_kind = out_kind;
  p.n_tiles = (n + BN - 1) / BN;
  const long long tiles = static_cast<long long>((m + kDenseBM - 1) / kDenseBM) * p.n_tiles;
  if (tiles >= (1LL << 31)) return -1;
  p.tiles = static_cast<int>(tiles);
  p.kc = (p.kp + 127) / 128;
  p.xc = (k + 63) / 64;
  p.resident = FUSED || t.resident;
  p.stages = FUSED ? 1 : t.stages;
  p.stage_bytes = FUSED ? p.xc * kBox : kBox + (p.resident ? 0 : BN * 128);
  p.w_offset = p.stages * p.stage_bytes;
  p.out_offset = p.w_offset + (p.resident ? p.kc * BN * 128 : 0);
  p.tma_store = out_kind == 1 && n % 8 == 0;
  p.faults = faults;
  if (p.stages < 1 || p.out_offset + kDenseBM * BN * 2 > kDenseBudget) return -1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent: a block an SM; with resident weights a multiple of the n tiles
  long long blocks = p.resident ? std::max(p.n_tiles, sms - sms % p.n_tiles) : sms;
  blocks = std::min(blocks, tiles);
  CUtensorMap ma, mw, mo{};
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(FUSED ? k : p.kp),
                                static_cast<cuuint64_t>(m)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(FUSED ? 2 * k : p.kp)};
  const cuuint32_t a_box[2] = {FUSED ? 64u : 128u, static_cast<cuuint32_t>(kDenseBM)};
  int err = tiled_map(&ma, !FUSED, 2, a, a_dims, a_strides, a_box);
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(p.kp), static_cast<cuuint64_t>(n)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(p.kp)};
  const cuuint32_t w_box[2] = {128u, static_cast<cuuint32_t>(BN)};
  if (err == 0) err = tiled_map(&mw, true, 2, w8, w_dims, w_strides, w_box);
  if (err == 0 && p.tma_store) {  // out (N, M) in boxes of 32 columns x 128 rows
    const cuuint64_t o_dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(m)};
    const cuuint64_t o_strides[1] = {static_cast<cuuint64_t>(n) * 2};
    const cuuint32_t o_box[2] = {32u, static_cast<cuuint32_t>(kDenseBM)};
    err = tiled_map(&mo, false, 2, out, o_dims, o_strides, o_box, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err != 0) return err;
  dequant_gemm_kernel<BN, FUSED><<<static_cast<unsigned>(blocks), kDenseThreads, kDenseSmem, st>>>(
      ma, mw, mo, out, static_cast<const float*>(sx), static_cast<const float*>(sw),
      out_kind == 0 ? nullptr : bias, static_cast<unsigned char*>(q_out),
      static_cast<float*>(sx_out), p);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED>
int run_dense(int out_kind, const void* a, const void* w8, void* out, const void* sx,
              const void* sw, const void* bias, void* q_out, void* sx_out, int faults, int m,
              int n, int k, cudaStream_t st) {
  const DenseTile t = dense_tiles(k, n);
  if (FUSED && !t.fused) return -1;
  switch (t.bn) {
    case 256:
      return launch_dense<256, FUSED>(t, out_kind, a, w8, out, sx, sw, bias, q_out, sx_out,
                                      faults, m, n, k, st);
    case 160:
      return launch_dense<160, FUSED>(t, out_kind, a, w8, out, sx, sw, bias, q_out, sx_out,
                                      faults, m, n, k, st);
    default:
      return launch_dense<128, FUSED>(t, out_kind, a, w8, out, sx, sw, bias, q_out, sx_out,
                                      faults, m, n, k, st);
  }
}



template <bool I8>
int launch_gemm(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t stream) {
  using T = GemmTiles<I8>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cuuint64_t esize = I8 ? 1 : 2;
  // A (M, K): boxes of 128 bytes of k by 128 rows
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(k) * esize};
  const cuuint32_t a_box[2] = {static_cast<cuuint32_t>(T::kBK), T::kBM};
  // int8: B^T (N, K), boxes of 128 bytes of k by 256 rows; bf16: B (K, N),
  // boxes of 64 columns by 64 k-rows
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(I8 ? k : n),
                                static_cast<cuuint64_t>(I8 ? n : k)};
  const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(I8 ? k : n) * esize};
  const cuuint32_t b_box[2] = {I8 ? 128u : 64u, I8 ? 256u : 64u};
  CUtensorMap ma, mb;
  int err = tiled_map(&ma, I8, 2, a, a_dims, a_strides, a_box);
  if (err == 0) err = tiled_map(&mb, I8, 2, b, b_dims, b_strides, b_box);
  if (err != 0) return err;
  const dim3 grid((n + T::kBN - 1) / T::kBN, m / T::kBM);
  gemm_kernel<I8><<<grid, 384, T::kSmemBytes, stream>>>(ma, mb, c, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// C entry point: int8 != 0 takes int8 a (M, K) and b^T (N, K) (B
// transposed by ccedit_transpose_int8) and writes int32 c; else bf16 a (M,
// K), b (K, N) and fp32 c.  All row-major and contiguous; m, n multiples of
// 128, k of 64 (int8) or 32 (bf16).  Returns the launch's cudaError_t; -1
// for a shape the kernel does not take.
extern "C" int ccedit_gemm(int int8, const void* a, const void* b, void* c, int m, int n,
                           int k, void* stream) {
  using namespace ccedit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || m % 128 || n % 128 || k % (int8 ? 64 : 32)) return -1;
  return int8 ? launch_gemm<true>(a, b, c, m, n, k, st) : launch_gemm<false>(a, b, c, m, n, k, st);
}

// Kernel 9: out (M, N) = dequant(a8 (M, K) @ w8 (N, K)^T), int8 operands
// contiguous, K a multiple of 16, any M and N.  out_kind 0 writes the int32
// accumulators, 1 bf16, 2 fp32.  sx: fp32 (M), a scale a row of a8; sw:
// fp32 (N); bias: (N) of out's type, or null (ignored for out_kind 0).
// The tile is dense_tiles(k, n).  Returns the launch's cudaError_t (or a
// tensor map's); -1 for arguments it does not take.
extern "C" int ccedit_int8_gemm(int out_kind, const void* a8, const void* w8, void* out,
                                const void* sx, const void* sw, const void* bias, int m,
                                int n, int k, void* stream) {
  using namespace ccedit;
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || out_kind < 0 || out_kind > 2) return -1;
  return run_dense<false>(out_kind, a8, w8, out, sx, sw, bias, nullptr, nullptr, 0, m, n, k,
                          static_cast<cudaStream_t>(stream));
}

// Kernel 9 on the bf16 activation: x (M, K) bf16, contiguous, 16-byte
// aligned, K a multiple of 8, quantized per row in the kernel (kernel 8's
// arithmetic); w8 (N, Kp) int8, Kp = K rounded up to 16; out, sw, bias as
// ccedit_int8_gemm.  q_out (M, Kp) int8 and sx_out (M) fp32, or null: the
// quantized rows and their scales.  faults: the planted faults of the
// checks (DenseParams), 0 in use.  Returns -1 where dense_tiles(k, n) has
// no fused form, else as ccedit_int8_gemm.
extern "C" int ccedit_int8_gemm_bf16a(int out_kind, const void* x, const void* w8, void* out,
                                      const void* sw, const void* bias, void* q_out,
                                      void* sx_out, int faults, int m, int n, int k,
                                      void* stream) {
  using namespace ccedit;
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 || out_kind < 0 || out_kind > 2 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return -1;
  return run_dense<true>(out_kind, x, w8, out, nullptr, sw, bias, q_out, sx_out, faults, m, n,
                         k, static_cast<cudaStream_t>(stream));
}

// The tile kernel 9 takes for (k, n): tiles[0..4] = (BM, BN, resident
// weights, ring stages of the int8 form, whether the bf16 form takes it).
// Returns 0.
extern "C" int ccedit_int8_gemm_tiles(int k, int n, int* tiles) {
  const ccedit::DenseTile t = ccedit::dense_tiles(k, n);
  tiles[0] = ccedit::kDenseBM;
  tiles[1] = t.bn;
  tiles[2] = t.resident;
  tiles[3] = t.stages;
  tiles[4] = t.fused;
  return 0;
}
