// The int8 transposition in front of the probes' 8-bit wgmma: a (batch,
// rows, cols) int8 operand into contiguous (batch, cols, width) rows,
// width >= rows, the columns past `rows` zero.  8-bit wgmma reads only
// K-major operands (hopper.cuh), so
//   - kernel 5's tr int8 probes (attention_probe.cu) turn q8^T and k8^T,
//     (B, 40, N) with the tokens innermost, into kernel 1c's (B, N, 48)
//     rows, and
//   - kernel 6's int8 product (int8_gemm.cu) turns B (K, N) into B^T (N, K),
// each launched by the probe's wrapper as part of its timed call.  The TPU
// kernels they serve (scripts/kv_resident_attn.py `_qkt8_tr_kernel` :127,
// `_full8_tr_kernel` :135; scripts/int8_probe.py `part_pallas` :142) needed
// none: the TPU's matrix unit contracts over either axis.
//
// What bounds it: the bytes, read once and written once (at (272, 40,
// 6144) two operands of 66.8 MB in, 80.2 MB out: 0.088 ms at 3.35 TB/s;
// 4096^2: 16.8 MB each way, 0.010 ms).
//
// Design: a block transposes a 64 x 64-byte tile through shared memory (rows
// of 17 words, so a warp's reads below meet at most two to a bank): 16-byte
// loads along the source rows, then each thread reads a 4 x 4-byte
// block (four 32-bit words of four source rows), transposes it in registers
// (__byte_perm) and stores four 32-bit words to four destination rows, so
// that 16 neighbouring threads write 64 contiguous bytes of a row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ccedit {

namespace {

constexpr int kTile = 64;             // source rows and columns (bytes) of a block's tile
constexpr int kPitch = kTile + 4;     // shared bytes a tile row: an odd count of words
constexpr int kThreads = 256;         // one 4 x 4-byte block each

__global__ void __launch_bounds__(kThreads)
transpose_int8_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                      int rows, int cols, int width, long long sb, long long sr) {
  __shared__ __align__(4) unsigned char tile[kTile * kPitch];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile, b = blockIdx.z;
  src += b * sb;
  for (int i = threadIdx.x; i < kTile * kTile / 16; i += kThreads) {
    const int r = i / (kTile / 16), p = i % (kTile / 16);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows && c0 + 16 * p < cols)
      v = *reinterpret_cast<const uint4*>(src + (r0 + r) * sr + c0 + 16 * p);
    uint32_t* t = reinterpret_cast<uint32_t*>(tile + r * kPitch + 16 * p);
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  }
  __syncthreads();
  // source rows 4 * r4 .., columns 4 * c4 ..: neighbouring threads take
  // neighbouring row groups, so a destination row's bytes are contiguous
  const int r4 = threadIdx.x % 16, c4 = threadIdx.x / 16;
  if (c0 + 4 * c4 >= cols || r0 + 4 * r4 >= width) return;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = *reinterpret_cast<const uint32_t*>(tile + (4 * r4 + k) * kPitch + 4 * c4);
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                         __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
  unsigned char* d = dst + (static_cast<long long>(b) * cols + c0 + 4 * c4) * width + r0 + 4 * r4;
#pragma unroll
  for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(d + static_cast<long long>(j) * width) = o[j];
}

}  // namespace

}  // namespace ccedit

// C entry point: src (batch, rows, cols) int8 with byte strides (sb, sr)
// and unit column stride into contiguous dst (batch, cols, width).  cols
// and width multiples of 16, width >= rows, src, sb and sr 16-byte aligned.
// Returns the launch's cudaError_t (0 = success); -1 for arguments it does
// not take.
extern "C" int ccedit_transpose_int8(const void* src, void* dst, int batch, int rows, int cols,
                                     int width, long long sb, long long sr, void* stream) {
  using namespace ccedit;
  if (batch <= 0 || rows <= 0 || cols % 16 || width % 16 || width < rows || sb % 16 || sr % 16)
    return -1;
  const dim3 grid((cols + kTile - 1) / kTile, (width + kTile - 1) / kTile, batch);
  transpose_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), rows, cols, width,
      sb, sr);
  return static_cast<int>(cudaGetLastError());
}
