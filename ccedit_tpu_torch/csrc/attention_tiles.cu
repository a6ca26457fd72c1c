// Kernel 7: the tile sweep.  Kernel 1's Hopper forward (the template of
// spatial_attention.cuh, with its bf16 Q.K^T policy Bf16QK<40> and the row
// layout) instantiated at head_dim 40 over swept tiles: BM query rows a
// block (64 a consumer warpgroup) and BN keys a K/V tile.  (128, 128) is
// kernel 1's own instantiation.  Launched only by
// ccedit_tpu_torch/scripts/profile_blocks.py and chip_smoke.py's probe
// phase, never by the attention dispatch.
//
// Replaces: scripts/profile_blocks.py:26-39 (the stock Pallas TPU flash
// attention forward at eight swept block sizes, call :36).  The TPU script
// swept the block sizes of the kernel its edits ran; this sweeps the tiles
// of the port's, so its answer applies to kernel 1.
//
// What bounds it on an H100: at d = 40 the exponentials (272*6144^2 exp2 at
// (34, 8, 6144, 40): 2.63 ms), then the tensor cores (1.66 ms).
//
// The pairs, from BM in {64, 128, 192} x BN in {64, 128, 256}: ptxas keeps
// the kernel's registers within 65536 / threads (255 at BM 64, 168 at 128,
// 128 at 192) whatever setmaxnreg grants, and a consumer holds S (BN / 2),
// P (BN / 4) and O (20) beside the addresses and the softmax state.
// ptxas (sm_90a, -Xptxas -v), registers a thread, no spills:
//   BM 64 (one consumer, no ping-pong): BN 64 79, BN 128 110, BN 256 185
//   BM 128 (two consumers, kernel 1's ping-pong): BN 64 168, BN 128 168
//   BM 192 (three consumers, round-robin turns): BN 64 78, BN 128 121
// Left out: (128, 256), 168 registers with 400 bytes of spill stores (S +
// P + O = 212 over the cap); (192, 256), which ptxas refuses ("insufficient
// registers (128)", it asks for 154: m64n256's accumulator alone is 128).
// Shared memory: Q BM x 128 B and a ring of K + V stages of 2 x BN x 128 B
// (4 stages at BN 64 and 128, 3 at BN 256), at most 208 KB (BM 64, BN 256).
#include "spatial_attention.cuh"

// C entry point.  Strides are (batch, head, token) element strides of the
// (B, H, N, D) operands q, k, v, o; the D stride is 1.  Returns the launch's
// cudaError_t (0 = success); -1 for a head_dim other than 40, a tile pair
// without an instantiation, or an empty n_q or n_k.
extern "C" int ccedit_attention_tiles(const void* q, const void* k, const void* v, void* o,
                                      int batch, int heads, int n_q, int n_k, int head_dim,
                                      int bm, int bn, const long long* strides, float scale_log2,
                                      void* stream) {
  using namespace ccedit;
  if (head_dim != 40) return -1;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CCEDIT_TILES(BM, BN)                                                                  \
  if (bm == BM && bn == BN)                                                                   \
    return launch_spatial<40, Bf16QK<40>, BM, BN>(q, k, v, o, nullptr, nullptr, batch, heads, \
                                                  n_q, n_k, sq, sk, sv, so, scale_log2, st);
  CCEDIT_TILES(64, 64) CCEDIT_TILES(64, 128) CCEDIT_TILES(64, 256)
  CCEDIT_TILES(128, 64) CCEDIT_TILES(128, 128)
  CCEDIT_TILES(192, 64) CCEDIT_TILES(192, 128)
#undef CCEDIT_TILES
  return -1;
}
