// Kernel 1c: kernel 1 with an int8 Q.K^T (the opt-in int8 QK^T path,
// head_dim 40 and 80, any n_k), after its quantizing pre-pass
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
// DK) rows, DK = head_dim rounded up to 16 bytes (40 -> 48, 80 -> 80) with
// zero columns past head_dim.  Their tensor maps load one 128-byte-swizzled
// chunk a row (128 int8 columns; the box's columns past DK arrive as
// zeros), so Q is 16 KB and a K tile of 128 keys 16 KB, and S = Q.K^T is
// wgmma m64n128k32 .s32.s8.s8 over D rounded up to 32 bytes (2 steps at d =
// 40, 3 at d = 80), with the descriptors of a bf16 chunk (hopper.cuh's
// header).  Integer sums are exact; so is their fp32 conversion (|S| <=
// 127^2 * 80 < 2^24).  The (batch, head)'s folded scale, scale * amax_q *
// amax_k / 127^2 (scales[b*h], on the device), times log2(e) is the exp2's
// factor, as kernel 1's scalar scale is.  With K in one chunk the ring
// takes 4 stages at d = 80 (kernel 1: 3).
#include "spatial_attention.cuh"

namespace ccedit {

namespace {

// d[64] (+)= A * B, m64n128k32, s8 in, s32 accumulate, A and B from shared
// memory, both K-major (8-bit wgmma has no transposed operands); scale_d =
// 0 overwrites d.  The accumulator's layout is the fp32 one (hopper.cuh).
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <int D>
struct Int8QK {
  using Acc = int;
  static constexpr bool kInt8 = true;
  static constexpr int kChunks = 1;
  static constexpr int kWidth = (D + 15) / 16 * 16;
  static constexpr int kStages = 4;
  static_assert(kWidth <= 128, "an int8 row is one 128-byte chunk");

  template <int BM, int BN>
  static __device__ __forceinline__ void scores(int (&s)[BN / 2], const unsigned char* q,
                                                const unsigned char* k) {
    static_assert(BN == 128, "the s8 product is m64n128k32");
#pragma unroll
    for (int kk = 0; kk < (D + 31) / 32; ++kk)
      wgmma_s8_m64n128k32(s, desc(q + kk * 32, 16, 1024, 1), desc(k + kk * 32, 16, 1024, 1),
                          kk > 0);
  }

  static __device__ __forceinline__ float scale_log2(float, const float* scales, int bh) {
    return scales[bh] * kLog2e;
  }
};

}  // namespace

}  // namespace ccedit

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
    case 80:
      return launch_spatial<80, Int8QK<80>>(q8, k8, v, o, nullptr, sc, batch, heads, n_q, n_k,
                                            sq, sk, sv, so, 0.f, st);
    default:
      return -1;
  }
}
