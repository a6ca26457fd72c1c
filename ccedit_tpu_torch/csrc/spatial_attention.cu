// Kernel 1: exact softmax attention for the UNet/ControlNet spatial
// attention, head_dim 40 (level 0, 6144 tokens), 80 (level 1, 1536) and 160
// (level 2 at geometries of 512 tokens and more, e.g. 1024 at 1024x1024),
// and 64 (every level of an SD-2.x UNet, num_head_channels 64: 9216, 2304
// and 576 tokens at 768x768), any n_k: the CFCA "center_self" cross-frame attention of the TVI2V
// network attends 6144 queries to 12288 keys (row 1b).  Redesigned for
// Hopper; the kernel itself is spatial_attention.cuh's template, shared
// with kernel 1c (spatial_attention_int8.cu) and kernel 5's probes
// (attention_probe.cu), here with a bf16 Q.K^T (Bf16QK).
//
// Replaces: ccedit_tpu/ops/spatial_attention.py `_run` :113 (`pallas_call`
// :127, `_kernel` :59, `kv_resident_attention` :169), its one-chunk path
// and its `n_chunks > 1` path (:93-108).
//
// What bounds it on an H100: at d = 40 the exponentials, at d 80/160 the
// tensor cores.  At (34, 8, 6144, 40) the products are 4*272*6144^2*40 =
// 1.64 TFLOP (1.66 ms at 989 TFLOP/s) and the softmax 272*6144^2 = 1.03e10
// exp2 (2.63 ms at the ~3.9 T/s of the special-function units); at d = 80
// the tensor time is twice the exp time.  q/k/v/out are 0.5 GB; the fp32
// scores (41 GB at level 0) never leave the SM.
//
// At d = 64 the tile is 192 query rows (three consumers) where that grid
// covers the SMs, and the softmax rescales lazily: spatial_attention.cuh's
// "Head dim 64" says why.
//
// What held the simple design back, and what this one does about it:
// synchronous K/V staging (now TMA into a ring, overlapped), V transposed
// element by element (now read MN-major by wgmma), mma.sync from 4 warps
// per 64 rows (now wgmma from two warpgroups per 128 rows), the softmax
// after the products (now overlapping the other warpgroup's products).
//
// The design, tiles and budgets: spatial_attention.cuh.
#include "spatial_attention.cuh"

// C entry point.  Strides are (batch, head, token) element strides of the
// (B, H, N, D) operands; the D stride is 1.  `lse` is null or a contiguous
// fp32 (batch * heads, n_q) output.  Returns the launch's cudaError_t
// (0 = success); -1 for a head_dim without an instantiation or an empty
// n_q or n_k.
extern "C" int ccedit_spatial_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch,
    int heads, int n_q, int n_k, int head_dim, const long long* strides,
    float scale_log2, void* stream) {
  using namespace ccedit;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (head_dim) {
    case 40:
      return launch_spatial<40, Bf16QK<40>>(q, k, v, o, l, nullptr, batch, heads, n_q, n_k, sq,
                                            sk, sv, so, scale_log2, st);
    case 64:
      if (d64_query_tile(n_q, batch * heads) == 192)
        return launch_spatial<64, Bf16QK<64>, 192>(q, k, v, o, l, nullptr, batch, heads, n_q,
                                                   n_k, sq, sk, sv, so, scale_log2, st);
      return launch_spatial<64, Bf16QK<64>, 128>(q, k, v, o, l, nullptr, batch, heads, n_q, n_k,
                                                 sq, sk, sv, so, scale_log2, st);
    case 80:
      return launch_spatial<80, Bf16QK<80>>(q, k, v, o, l, nullptr, batch, heads, n_q, n_k, sq,
                                            sk, sv, so, scale_log2, st);
    case 160:
      return launch_spatial<160, Bf16QK<160>>(q, k, v, o, l, nullptr, batch, heads, n_q, n_k, sq,
                                              sk, sv, so, scale_log2, st);
    default:
      return -1;
  }
}

// Message for a cudaError_t returned by one of the entry points.
extern "C" const char* ccedit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
