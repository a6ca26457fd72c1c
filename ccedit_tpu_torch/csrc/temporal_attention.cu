// Kernel 2: full self-attention over T <= 32 frame tokens for a huge folded
// batch: the temporal attention of the pseudo-3D transformers, (B*H*W rows,
// heads, 17, d) with d = 40, 80, 160 at UNet levels 0-2 (T = 12 in the
// training recipe).
//
// Replaces: ccedit_tpu/ops/temporal_attention.py `_kernel` /
// `_temporal_attention_tdn` / `small_seq_attention`.
//
// What bounds it on an H100: memory.  Per (row, head) it reads q, k, v
// (T x d each) and writes out (T x d) while doing ~2*17*17*d*2 FLOP: at
// level 0, (12288, 8, 17, 40) bf16, that is 4 * 12288*8*17*40 * 2 B = 535 MB
// moved for 4.5 GFLOP, about 8 FLOP/byte, far below the ridge point; the
// floor at the data-sheet 3.35 TB/s is about 160 us.  So the design streams:
// the next item's bytes are in flight while this one is computed.
//
// Design: a persistent grid (as many blocks as fit on the SMs) walks over
// items, an item being G heads of one folded row: G is the most heads with
// G*d <= 320 (all 8 at level 0, 4 at level 1, 2 at level 2), so an item's q,
// k and v are each T x G*d, 10.9 KB at T = 17.  In the model's layout
// (to_q(x) viewed (rows, T, heads, d)) those are contiguous runs of G*d*2
// bytes at a stride of heads*d*2.
//   - Loads: every thread copies 16-byte vectors with cp.async into a ring
//     of two stages (q, k and v of one item a stage, rows padded to an odd
//     number of vectors); the next item's group is committed before this
//     item is waited for, so its loads overlap this item's work.  Any
//     strides with a unit d stride work; each thread keeps one column
//     vector of the item and steps over the tokens.
//   - `parts` neighbouring lanes (1 at d = 40, 2 at 80, 4 at 160) share a
//     (head, query), each with at most kMaxChunks = 5 of its 16-byte column
//     vectors, so every level keeps 8 x 17 = 136 lanes busy an item.  A
//     lane's partial scores (TP in registers; every lane of a head reads
//     the same key, a broadcast, and converts its 8 bf16 as it reads them)
//     are summed across its parts by shuffles; fp32 softmax (expf, as the
//     JAX kernel's exp; padded keys masked); then each 8-column block of its
//     share of the output row, the sum over the keys of p * v, written as
//     one 16-byte store of 8 bf16.  The key loops are unrolled over TP
//     (T = 17 and 12 unpadded), with no branch; keys past T are zero rows
//     of the stage.
//   scripts/temporal_breakdown.py measures other tilings on the card, and
//   the time split into loads and compute.
// Everything is fp32 on the CUDA cores, as the JAX kernel computes: at ~8
// FLOP a byte, bf16 tensor cores would gain nothing and lose exactness.
// Scores never reach device memory, and every input byte is read once.
#include <algorithm>

#include "hopper.cuh"

namespace ccedit {

namespace {

constexpr int kStages = 2;
constexpr int kMaxItemColumns = 320;  // G * d of an item
constexpr int kMaxChunks = 5;         // 16-byte column vectors of a (head, query) a lane
constexpr int kMaxThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shape of one launch, fixed over its items.
struct Item {
  int heads, G, T, D;
  int d8, v8, pitch;  // 16-byte vectors of a head row, of an item row, row pitch in vectors
  int parts, chunks;  // lanes sharing a (head, query), 16-byte column vectors each
};

// TP >= T: the keys, padded with zero rows (their scores masked), that the
// loops unroll over without a branch.
template <int TP>
__global__ void __launch_bounds__(kMaxThreads)
temporal_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int items,
                          Item it, Strides sq, Strides sk, Strides sv, Strides so,
                          float scale) {
  extern __shared__ uint4 smem[];
  const int T = it.T, G = it.G;
  const int tensor_vecs = TP * it.pitch, stage_vecs = 3 * tensor_vecs;
  const int groups = it.heads / G;

  // the padded keys' rows stay zero in every stage
  const int pad_vecs = (TP - T) * it.pitch;
  for (int e = threadIdx.x; e < kStages * 3 * pad_vecs; e += blockDim.x)
    smem[(e / pad_vecs) * tensor_vecs + T * it.pitch + e % pad_vecs] = make_uint4(0u, 0u, 0u, 0u);

  // loads: this thread's column vector u of an item row (head lg, 8 columns
  // at 8 lc), tokens t0, t0 + rows_per_pass, ...
  const int rows_per_pass = blockDim.x / it.v8;
  const bool loader = threadIdx.x < rows_per_pass * it.v8;
  const int u = threadIdx.x % it.v8, t0 = threadIdx.x / it.v8;
  const int lg = u / it.d8, lc = u % it.d8;
  const long long col[3] = {lg * sq.h + 8 * lc, lg * sk.h + 8 * lc, lg * sv.h + 8 * lc};
  const Strides st[3] = {sq, sk, sv};
  const bf16* src[3] = {q, k, v};

  auto load = [&](int item, int stage) {
    if (!loader) return;
    const int b = item / groups, h0 = (item % groups) * G;
    uint4* dst = smem + stage * stage_vecs;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const bf16* base = src[x] + b * st[x].b + h0 * st[x].h + col[x];
      for (int t = t0; t < T; t += rows_per_pass)
        cp_async16(dst + x * tensor_vecs + t * it.pitch + u, base + t * st[x].n);
    }
  };

  // compute: `parts` neighbouring lanes share head g's query i, each with
  // `chunks` column vectors from c0 on; lanes past the item compute query 0
  // of head 0 and store nothing
  const int part = threadIdx.x % it.parts, pair = threadIdx.x / it.parts;
  const bool worker = pair < G * T;
  const int g = worker ? pair / T : 0, i = worker ? pair % T : 0;
  const int c0 = part * it.chunks, c1 = min(c0 + it.chunks, it.d8);

  int item = blockIdx.x;
  if (item < items) load(item, 0);
  cp_async_commit();
  for (int n = 0; item < items; ++n, item += gridDim.x) {
    if (item + gridDim.x < items) load(item + gridDim.x, (n + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just committed: this item's
    __syncthreads();
    const uint4* s_q = smem + (n % kStages) * stage_vecs + g * it.d8;
    const uint4* s_k = s_q + tensor_vecs;
    const uint4* s_v = s_k + tensor_vecs;

    float s[TP];
#pragma unroll
    for (int j = 0; j < TP; ++j) s[j] = 0.f;
    for (int c = c0; c < c1; ++c) {
      float qf[8];
      unpack8(s_q[i * it.pitch + c], qf);
#pragma unroll
      for (int j = 0; j < TP; ++j) {
        float kf[8];
        unpack8(s_k[j * it.pitch + c], kf);
        float acc = s[j];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(qf[e], kf[e], acc);
        s[j] = acc;
      }
    }
    for (int off = 1; off < it.parts; off <<= 1) {
#pragma unroll
      for (int j = 0; j < TP; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      s[j] = j < T ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      s[j] = expf(s[j] - mx);
      sum += s[j];
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int j = 0; j < TP; ++j) s[j] *= inv;
    const int b = item / groups, h = (item % groups) * G + g;
    bf16* o_row = o + b * so.b + h * so.h + i * so.n;
    for (int c = c0; c < c1; ++c) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < TP; ++j) {
        float vf[8];
        unpack8(s_v[j * it.pitch + c], vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(s[j], vf[e], acc[e]);
      }
      if (worker)
        st128(o_row + 8 * c, make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                                        pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7])));
    }
    __syncthreads();  // this stage is free again
  }
  cp_async_wait<0>();
}

template <int TP>
int launch(const void* q, const void* k, const void* v, void* o, int batch, const Item& it,
           Strides sq, Strides sk, Strides sv, Strides so, float scale, cudaStream_t stream) {
  const auto kernel = temporal_attention_kernel<TP>;
  const int threads = std::max(64, (it.G * it.T * it.parts + 31) / 32 * 32);
  const size_t smem = sizeof(uint4) * kStages * 3 * TP * it.pitch;
  // the grid fills the SMs; the occupancy query is kept for the last
  // (device, shape)
  static int last_device = -1, last_threads = 0, sms = 0, per_sm = 0;
  static size_t last_smem = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != last_device || threads != last_threads || smem != last_smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_device = device;
    last_threads = threads;
    last_smem = smem;
  }
  const int items = batch * (it.heads / it.G);
  const int grid = std::max(1, std::min(items, per_sm * sms));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), items, it, sq, sk, sv, so, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace ccedit

// C entry point.  q/k/v/o are (B, H, T, D) with element strides (batch, head,
// token) and a unit D stride, the other strides multiples of 8, 16-byte
// aligned.  Requires 1 <= T <= 32 and D % 8 == 0, 8 <= D <= 256 (the
// wrapper checks; -1 otherwise); returns the launch's cudaError_t.
extern "C" int ccedit_temporal_attention(
    const void* q, const void* k, const void* v, void* o, int batch, int heads,
    int T, int head_dim, const long long* strides, float scale, void* stream) {
  using namespace ccedit;
  if (T < 1 || T > 32 || head_dim % 8 != 0 || head_dim < 8 || head_dim > 256 || batch < 1 ||
      heads < 1)
    return -1;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  Item it{heads, 1, T, head_dim, head_dim / 8, 0, 0, 1, 0};
  // 16-byte column vectors: at most kMaxChunks a thread, in a power of two
  // of neighbouring lanes
  while (it.parts < 8 && it.parts * kMaxChunks < it.d8) it.parts *= 2;
  it.chunks = (it.d8 + it.parts - 1) / it.parts;
  for (int g = heads; g >= 1; --g)
    if (heads % g == 0 && g * head_dim <= kMaxItemColumns && g * T * it.parts <= kMaxThreads) {
      it.G = g;
      break;
    }
  it.v8 = it.G * it.d8;
  it.pitch = it.v8 | 1;  // odd: the rows of a 16-byte column fall on distinct banks
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // T = 17 (inference) and 12 (training) without padded keys
  if (T <= 8) return launch<8>(q, k, v, o, batch, it, sq, sk, sv, so, scale, st);
  if (T <= 12) return launch<12>(q, k, v, o, batch, it, sq, sk, sv, so, scale, st);
  if (T <= 16) return launch<16>(q, k, v, o, batch, it, sq, sk, sv, so, scale, st);
  if (T <= 17) return launch<17>(q, k, v, o, batch, it, sq, sk, sv, so, scale, st);
  if (T <= 24) return launch<24>(q, k, v, o, batch, it, sq, sk, sv, so, scale, st);
  return launch<32>(q, k, v, o, batch, it, sq, sk, sv, so, scale, st);
}
