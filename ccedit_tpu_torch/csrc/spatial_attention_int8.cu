// Kernel 1c: kernel 1 with an int8 Q.K^T (the opt-in int8 QK^T path,
// head_dim 40, 64 and 80, any n_k), after its quantizing pre-pass
// (quantize_qk.cu).  Redesigned for Hopper: the kernel is
// spatial_attention.cuh's template, kernel 1's warp-specialised ping-pong
// design (a producer warpgroup issuing TMA loads into a full/empty mbarrier
// ring, two consumer warpgroups, P.V on wgmma with P from registers and V
// read MN-major), here with Q.K^T as an s8 wgmma.
//
// Replaces: ccedit_tpu/ops/spatial_attention.py `kv_resident_attention`'s
// `quantized_qk=True` call of `_run` (:202; `_kernel` :59, `pallas_call`
// :127), whose int8 q, k and folded scales come from :191-201.
//
// What bounds it on an H100: the exponentials (272*6144^2 exp2 at (34, 8,
// 6144, 40): 2.63 ms), then the tensor cores; the int8 products halve only
// the QK^T half of the tensor time, which is not the bound.
//
// Q.K^T: q8 and k8 arrive from the pre-pass as contiguous int8 (B, H, N,
// DK) rows, DK = head_dim rounded up to 16 bytes (40 -> 48, 64 -> 64, 80 -> 80) with
// zero columns past head_dim.  Their tensor maps load one 128-byte-swizzled
// chunk a row (128 int8 columns; the box's columns past DK arrive as
// zeros), so Q is 16 KB and a K tile of 128 keys 16 KB, and S = Q.K^T is
// wgmma m64n128k32 .s32.s8.s8 over D rounded up to 32 bytes (2 steps at d =
// 40 and 64, 3 at d = 80), with the descriptors of a bf16 chunk (hopper.cuh's
// header): the policy Int8QK in spatial_attention.cuh.  Integer sums are
// exact; so is their fp32 conversion (|S| <= 127^2 * 80 < 2^24).  The
// (batch, head)'s folded scale, scale * amax_q * amax_k / 127^2
// (scales[b*h], on the device), times log2(e) is the exp2's factor, as
// kernel 1's scalar scale is.  With K in one chunk the ring takes 4 stages
// at d = 80 (kernel 1: 3).  At d = 64 kernel 1's tile and softmax: 192 query
// rows where that grid covers the SMs, the lazy rescale
// (spatial_attention.cuh's "Head dim 64").
#include "spatial_attention.cuh"

// Kernel 1c's entry point.  q8 and k8 are int8 (B, H, N, DK) with DK the
// head_dim rounded up to 16 and zero columns past head_dim; `scales` is the
// contiguous fp32 (batch * heads) folded logits scale.  Strides are the
// (batch, head, token) strides of q8, k8, v and out, in bytes for q8 and k8
// and in elements for v and out; the last dimension's stride is 1.  Returns
// the launch's cudaError_t (0 = success); -1 for a head_dim without an
// instantiation or an empty n_q or n_k.
extern "C" int ccedit_spatial_attention_int8(
    const void* q8, const void* k8, const void* v, void* o, const void* scales,
    int batch, int heads, int n_q, int n_k, int head_dim, const long long* strides,
    void* stream) {
  using namespace ccedit;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  switch (head_dim) {
    case 40:
      return launch_spatial<40, Int8QK<40>>(q8, k8, v, o, nullptr, sc, batch, heads, n_q, n_k,
                                            sq, sk, sv, so, 0.f, st);
    case 64:
      if (d64_query_tile(n_q, batch * heads) == 192)
        return launch_spatial<64, Int8QK<64>, 192>(q8, k8, v, o, nullptr, sc, batch, heads, n_q,
                                                   n_k, sq, sk, sv, so, 0.f, st);
      return launch_spatial<64, Int8QK<64>, 128>(q8, k8, v, o, nullptr, sc, batch, heads, n_q,
                                                 n_k, sq, sk, sv, so, 0.f, st);
    case 80:
      return launch_spatial<80, Int8QK<80>>(q8, k8, v, o, nullptr, sc, batch, heads, n_q, n_k,
                                            sq, sk, sv, so, 0.f, st);
    default:
      return -1;
  }
}
