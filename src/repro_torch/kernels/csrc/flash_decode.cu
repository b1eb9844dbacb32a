// Single-token GQA decode attention over a strided KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_decode` (src/repro/kernels/flash_decode.py,
// body `_kernel`): for each row b and KV head h, the G query heads of that KV head
// attend over cache positions [0, lengths[b]) with scores q.k^T / sqrt(D) in fp32,
// an online softmax (m, l, acc), and output acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: bytes. Every live K and V row is read once
// (2 * len * D * itemsize per (b, h)) and the arithmetic is ~4 flops per byte of
// bf16, far below the card's ~295 flops/byte balance point, so the design goal is
// to keep every SM reading with enough loads in flight (flash-decoding):
//   * split T: the positions of one (b, h) are cut into n_split spans of `span`
//     positions, one CTA each, so B * KV * n_split CTAs share the card (the
//     wrapper picks n_split from the shapes only, never from `lengths`, so the
//     grid does not depend on device values). Each CTA writes a partial
//     (m, l, acc[G][D]) in fp32, and the last CTA of each (b, h) to finish
//     merges its n_split partials and writes the output once (merge_if_last).
//     A span that starts at
//     or past lengths[b] writes the sentinel partial m = -1e30, l = 0, acc = 0,
//     whose merge weight exp(-1e30 - m) is 0 beside any real span, and which
//     gives 0 / max(0, 1e-30) = 0 when every span of a row is empty;
//   * inside a span, tiles of K and V rows are copied with 16-byte cp.async
//     into a ring of kStages tiles in shared memory, so three tiles are in
//     flight while a fourth is used; all G query heads of h share each row.
//     CTAs of 4 warps keep the registers of five CTAs on an SM at qwen3's
//     serving shape, so its 512 CTAs run in one wave;
//   * a cache row is split into CH = D*itemsize/16 vectors of 16 bytes (the
//     Layout below). Where CH divides 32 (D = 64 or 128), one vector per lane:
//     a position is read by CH lanes and a warp covers 32/CH positions at a
//     time. Otherwise (D = 168, 192, 224, 320: CH = 21, 24, 28, 40 in bf16) a
//     whole warp reads one position, each lane its vectors lane, lane + 32,
//     ..., and lanes past CH hold none; the tile, the stage (2 * TILE * CH * 16
//     bytes) and the shared memory follow from D. Each lane keeps its own fp32
//     (m, l, acc), merged through warp shuffles, then across warps through
//     shared memory.
// The TPU kernel walks T sequentially over a grid axis with its state in VMEM
// scratch; here the spans run in parallel and their states merge at the end.
//
// The cache is addressed through explicit element strides (batch, position,
// head; the head dimension is contiguous) because the cache handed in is a view
// into the serving engine's one state buffer: its batch stride is the slot
// stride of the state plan, not T*KV*D.
//
// The paged variant (PAGED = true, flash_decode_paged_launch) reads the same
// cache out of a pool of fixed pages: slot b's region is a run of logical
// elements mapped page by page through row b of an int32 page table, so
// element e of the region (e = offset + t * stride_t + h * stride_h + d) lies
// at buf[table[b][e / Pe] * Pe + e % Pe], Pe the page size in elements.
// Only the address of each 16-byte chunk changes (paged_at): a chunk never
// straddles a page, since the wrapper takes only pages and offsets that are
// whole 16-byte multiples, and everything else (spans, the ring, the merge)
// is the symmetric kernel's, so the two give bit-equal outputs on the same
// cache. The page arithmetic is int64: a page index times the page size
// passes 2^31 elements in a pool over 4 GiB of bf16.
//
// With `lse` given (flash_decode_lse), the merging CTA also writes each query
// head's log-sum-exp of its scores over [0, lengths[b]), m + log(l), in fp32,
// and -1e30 for a row with no position: a cache whose T is split over ranks
// (context parallel) is attended span by span, each rank on its own span, and
// the ranks' outputs merge with weights exp(lse_r - max_r lse_r).
//
// The tensor-core path (FD_TC_PAIRS: bf16 at nemotron's (192, 12)). Above, a
// lane keeps every query head's fp32 q and acc for its chunks of D: at (192,
// 12) that is ~240 live values a thread (255 registers and spill stores), and
// each position's G dot products are summed over a 5-level shuffle tree, so
// the kernel is bound by issue and latency at 2 CTAs an SM, not by bytes.
// flash_decode_tc_kernel puts the G query heads on the M rows of
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators; rows G..15 are 0):
//   * a tile is 64 positions, 16 for each of the 4 warps. S = q K^T takes D/16
//     k-steps over the warp's two 8-position n-blocks, q held as A fragments
//     in registers for the whole span and K read from the ring by ldmatrix
//     (its rows are already the .col B operand); the scale goes onto S in fp32;
//   * the online softmax runs on S's accumulator fragment: a lane holds rows
//     g and g + 8, so a row's max and sum take 2 quad-shuffle levels. P is
//     rounded to bf16 in registers as the A fragment of P V (the only rounding
//     this path adds; l sums the fp32 p, so the lse keeps its accuracy), V is
//     read by ldmatrix.trans, and O is 16 x D fp32 accumulators (D/2 registers
//     a lane);
//   * each warp keeps its own (m, l, O) and the warps merge through shared
//     memory, then the spans through merge_if_last, as above, but four
//     elements at a time: at G * D = 2304 the element-by-element merge of the
//     last CTA waits on memory 18 times a thread (write_partial_wide,
//     merge_spans_wide);
//   * a 384-byte row stride would put the 8 rows of an ldmatrix on the same
//     banks, so the 16-byte chunk c of tile row r is stored at chunk
//     c ^ (r % 8) of that row (TcLayout: rows are whole groups of 8 chunks);
//   * a ring of kTcStages tiles of 48 KiB (K and V) is 96 KiB, and with
//     __launch_bounds__(128, 2) two CTAs share an SM: one tile of each in
//     flight while the other is used, ~96 KiB of loads an SM.
// The paged variant changes only the addresses (paged_at), so it stays
// bit-equal to the symmetric one on the gathered cache. fp32 stays on the
// CUDA-core kernel: its 1e-5 bar leaves no room for a bf16 P.
//
// Not done here (left for later work): TMA loads and wgmma.
//
// Plain C interface; the Python wrapper (kernels/flash_decode.py) loads the
// shared library with ctypes and passes pointers, strides, the split count,
// the fp32 scratch for the partials, the per-(b, h) counts and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The (D, G) pairs whose bf16 instantiations run on the tensor cores
// (flash_decode_tc_kernel); every other pair, and every fp32 one, runs on
// flash_decode_split_kernel. kernels/flash_decode.py (TC_PAIRS) and
// kernels/smem_plan.py (FD_TC_PAIRS) list the same.
#define FD_TC_PAIRS(X) X(192, 12)

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 2;             // positions per lane group per tile
constexpr int kStages = 4;             // tiles in the shared-memory ring
constexpr int kMaxSplits = 64;         // the wrapper's num_splits never exceeds it
constexpr int kTcStages = 2;           // tiles in the tensor-core kernel's ring
constexpr int kTcRows = 16;            // positions a warp takes of each of its tiles
constexpr float kNegInf = -1e30f;

constexpr int align16(int n) { return (n + 15) / 16 * 16; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int value = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int value = 8;
};

// How one CTA of the instantiation (T, D, G) lays a span out: 16-byte chunks
// per cache row, lanes per position, positions per tile, the ring, and the
// shared memory the two merges need (each array 16-byte aligned, as
// kernels/smem_plan.py plans them). The merges reuse the ring after the loop;
// the CTA requests the largest of the three.
template <typename T, int D, int G>
struct Layout {
  static constexpr int VEC = VecWidth<T>::value;  // elements per 16-byte chunk
  static constexpr int CH = D / VEC;              // chunks per cache row
  static constexpr int LANES = (CH <= 32 && 32 % CH == 0) ? CH : 32;
  static constexpr int CPL = (CH + LANES - 1) / LANES;  // chunks per lane
  static constexpr bool FULL = CH % LANES == 0;  // every lane holds CPL chunks
  static constexpr int POS_PER_WARP = 32 / LANES;
  static constexpr int GROUPS = kWarps * POS_PER_WARP;
  static constexpr int TILE = GROUPS * kUnroll;  // positions per tile
  static constexpr int CHUNKS = TILE * CH;       // 16-byte chunks of K per tile
  static constexpr int STAGE = 2 * CHUNKS * 16;  // K and V rows of one tile
  static constexpr int RING = kStages * STAGE;
  // the warps' merge: m [kWarps][G], l [kWarps][G], acc [kWarps][G][D]
  static constexpr int WARP_ML = align16(kWarps * G * 4);
  static constexpr int WARP_MERGE = 2 * WARP_ML + align16(kWarps * G * D * 4);
  // the spans' merge: m then weights [kMaxSplits][G], l [kMaxSplits][G],
  // 1 / sum [G]
  static constexpr int SPLIT_ML = align16(kMaxSplits * G * 4);
  static constexpr int SPLIT_MERGE = 2 * SPLIT_ML + align16(G * 4);
  static constexpr int SMEM = cmax(RING, cmax(WARP_MERGE, SPLIT_MERGE));
  static_assert(D % VEC == 0, "a cache row is whole 16-byte chunks");
  static_assert((LANES & (LANES - 1)) == 0, "shuffle reductions need 2^k lanes");
};

// How one CTA of the tensor-core kernel at (bf16, D, G) lays a span out:
// tiles of kTcRows positions a warp, K rows then V rows, each row CH 16-byte
// chunks stored at chunk c ^ (row % 8); the merges are Layout's, in the ring.
template <int D, int G>
struct TcLayout {
  using Merge = Layout<__nv_bfloat16, D, G>;
  static constexpr int CH = D / 8;               // 16-byte chunks per cache row
  static constexpr int ROW = D * 2;              // bytes per cache row
  static constexpr int TILE = kWarps * kTcRows;  // positions per tile
  static constexpr int HALF = TILE * ROW;        // the K (or V) rows of one tile
  static constexpr int STAGE = 2 * HALF;
  static constexpr int RING = kTcStages * STAGE;
  static constexpr int SMEM = cmax(RING, cmax(Merge::WARP_MERGE, Merge::SPLIT_MERGE));
  static constexpr int KSTEPS = D / 16;  // k-steps of S = q K^T
  static constexpr int NBLK = D / 8;     // 8-column blocks of O
  static_assert(G <= 16, "the query heads of one K/V head fill at most 16 rows");
  static_assert(CH % 8 == 0, "the swizzle keeps each chunk in its row");
  static_assert(kThreads % 8 == 0 && TILE % (kThreads / 8) == 0,
                "each thread loads whole rows' chunk columns");
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw, float* out) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Logical element e of a slot region whose table row is `row`, in a pool of
// pages of pe elements (a 16-byte chunk starting at e lies in one page).
template <typename T>
__device__ __forceinline__ const T* paged_at(const T* buf, const int* row, int64_t e,
                                            int64_t pe) {
  const int64_t page = e / pe;
  return buf + static_cast<int64_t>(__ldg(row + page)) * pe + (e - page * pe);
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// `pred` is false (then nothing is read from `src`)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix of four 8x8 bf16 matrices: lanes 8i..8i+7 give the row addresses
// of matrix i; register i of lane t then holds (row t/4, columns 2(t%4), +1)
// of matrix i, or with .trans (rows 2(t%4), +1, column t/4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b over one m16n8k16 tile, bf16 operands, fp32 accumulators. Lane t
// holds d[0], d[1] = (row t/4, columns 2(t%4), +1), d[2], d[3] = (row t/4 + 8,
// the same columns); a = A's (row t/4, k 2(t%4), +1), (row t/4 + 8, same k),
// (row t/4, k + 8), (row t/4 + 8, k + 8); b0, b1 = B's (k 2(t%4), +1, column
// t/4) and (k + 8, column t/4)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The spans' weighted sum of the tensor-core path (bf16 out): each thread
// takes four consecutive elements of one query head (D % 4 == 0) in each of
// PER passes, and the loads of a span's PER float4 are issued together, so a
// thread waits on memory about n_split / 4 times, not G * D / kThreads *
// n_split / 8 times. sm_w holds the spans' weights, sm_inv 1 / (sum of
// weighted l) per query head.
template <int D, int G>
__device__ __forceinline__ void merge_spans_wide(const float* acc, const float* sm_w,
                                                 const float* sm_inv,
                                                 __nv_bfloat16* ob, int n_split) {
  constexpr int N4 = G * D / 4;
  constexpr int PER = (N4 + kThreads - 1) / kThreads;
  static_assert(D % 4 == 0, "four elements of one query head");
  float4 o[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) o[it] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s != n_split; ++s) {
    const float4* a4 = reinterpret_cast<const float4*>(acc + s * G * D);
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i < N4) {
        const float4 a = __ldcg(a4 + i);
        const float w = sm_w[s * G + 4 * i / D];
        o[it].x += a.x * w;
        o[it].y += a.y * w;
        o[it].z += a.z * w;
        o[it].w += a.w * w;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < N4) {
      const float inv = sm_inv[4 * i / D];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(o[it].x * inv, o[it].y * inv);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(o[it].z * inv, o[it].w * inv);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(ob + 4 * i) = packed;
    }
  }
}

// Called by every thread of a CTA once it has written partial blockIdx.x of
// (b, h) = bh: counts the span in, and the CTA that counts last for its
// (b, h) merges the n_split partials, writes the output once and sets the
// count back to 0 for the next call. (A second kernel for the merge would
// cost a launch and a grid-wide wait per call; the count is one int per
// (b, h) that every call leaves at 0.) The (m, l) of every partial go to
// shared memory `sm` (2 * kMaxSplits * G + G floats) and each query head's
// weights exp(m_s - max m) are taken once; then every thread sums its
// elements' n_split partials with the loads unrolled. `lse` (may be null)
// takes each query head's max m + log(sum l), or -1e30 where sum l is 0.
// WIDE (the tensor-core path): the sum by merge_spans_wide.
template <typename T, int D, int G, bool WIDE = false>
__device__ __forceinline__ void merge_if_last(const float* part_acc,
                                              const float* part_ml, T* out,
                                              float* lse, int* counters, int bh,
                                              int n_split, float* sm) {
  __shared__ int last;
  __threadfence();  // this thread's partial is visible to the whole card
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + bh, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int ML = Layout<T, D, G>::SPLIT_ML / 4;
  float* sm_w = sm;             // [s][g]: m_s, then its weight
  float* sm_l = sm + ML;        // [s][g]: l_s
  float* sm_inv = sm + 2 * ML;  // [g]: 1 / max(sum_s l_s w_s, 1e-30)
  const float* ml = part_ml + static_cast<int64_t>(bh) * n_split * G * 2;
  const float* acc = part_acc + static_cast<int64_t>(bh) * n_split * G * D;
  T* ob = out + static_cast<int64_t>(bh) * G * D;
  for (int i = threadIdx.x; i < n_split * G; i += kThreads) {
    sm_w[i] = __ldcg(ml + 2 * i);
    sm_l[i] = __ldcg(ml + 2 * i + 1);
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, sm_w[s * G + g]);
    float lsum = 0.f;
    // a sentinel partial has l = 0 and acc = 0: it adds nothing whatever its
    // weight, and its weight is exp(-1e30 - mx) = 0 beside a real span
    for (int s = 0; s < n_split; ++s) {
      const float weight = expf(sm_w[s * G + g] - mx);
      sm_w[s * G + g] = weight;
      lsum += sm_l[s * G + g] * weight;
    }
    sm_inv[g] = 1.f / fmaxf(lsum, 1e-30f);
    if (lse != nullptr) lse[bh * G + g] = lsum > 0.f ? mx + logf(lsum) : kNegInf;
  }
  __syncthreads();
  if constexpr (WIDE) {
    merge_spans_wide<D, G>(acc, sm_w, sm_inv, ob, n_split);
  } else {
    for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
      const int g = idx / D;
      float o = 0.f;
#pragma unroll 8
      for (int s = 0; s < n_split; ++s) o += __ldcg(acc + s * G * D + idx) * sm_w[s * G + g];
      store(ob + idx, o * sm_inv[g]);
    }
  }
  if (threadIdx.x == 0) counters[bh] = 0;
}

// The warps' states in shared memory `sm` (Layout::WARP_MERGE: m [kWarps][G],
// l [kWarps][G], acc [kWarps][G][D]) merged into this span's partial, written
// once (pacc [G][D], pml [G][2] = (m, l)), for the tensor-core path: each
// query head's weights exp(m_w - max m) are taken once (by thread g, in place
// of m), then each thread sums four consecutive elements at a time.
template <int D, int G>
__device__ __forceinline__ void write_partial_wide(float* sm, float* pacc, float* pml) {
  using L = Layout<__nv_bfloat16, D, G>;
  float* sm_m = sm;
  const float* sm_l = sm + L::WARP_ML / 4;
  const float* sm_acc = sm + 2 * L::WARP_ML / 4;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * e;
      sm_m[w * G + g] = e;
    }
    pml[2 * g] = mx;
    pml[2 * g + 1] = lsum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D / 4; i += kThreads) {
    const int g = 4 * i / D;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 a = reinterpret_cast<const float4*>(sm_acc + w * G * D)[i];
      const float e = sm_m[w * G + g];
      o.x += a.x * e;
      o.y += a.y * e;
      o.z += a.z * e;
      o.w += a.w * e;
    }
    reinterpret_cast<float4*>(pacc)[i] = o;
  }
}

// One CTA per (b, h, span): the partial softmax state of span `split` of row b.
// Partial p = blockIdx.x = (b * n_kv + h) * n_split + split; part_acc holds
// [p][G][D] and part_ml [p][G][2] = (m, l). PAGED: k and v are the page pool,
// k_sb and v_sb the K and V element offsets inside a slot region, and row b
// of `table` (pps entries) maps the region's pages of page_elems elements.
template <typename T, int D, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ lengths,
                          float* __restrict__ part_acc, float* __restrict__ part_ml,
                          T* __restrict__ out, float* __restrict__ lse,
                          int* __restrict__ counters,
                          int n_kv, int t_len, int n_split, int span, int64_t k_sb,
                          int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                          int64_t v_sh, float scale, const int* __restrict__ table,
                          int pps, int64_t page_elems) {
  using L = Layout<T, D, G>;
  constexpr int VEC = L::VEC;
  constexpr int CH = L::CH;
  constexpr int LANES = L::LANES;
  constexpr int CPL = L::CPL;
  constexpr int POS_PER_WARP = L::POS_PER_WARP;
  constexpr int GROUPS = L::GROUPS;
  constexpr int TILE = L::TILE;
  constexpr int CHUNKS = L::CHUNKS;
  constexpr int STAGE = L::STAGE;

  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x % n_split;
  const int bh = blockIdx.x / n_split;
  const int b = bh / n_kv;
  const int h = bh % n_kv;
  const int len = min(max(lengths[b], 0), t_len);
  const int start = split * span;
  const int end = min(start + span, len);
  float* pacc = part_acc + static_cast<int64_t>(blockIdx.x) * G * D;
  float* pml = part_ml + static_cast<int64_t>(blockIdx.x) * G * 2;
  if (start >= end) {
    // an empty span: the sentinel partial (uniform over the CTA)
    for (int i = threadIdx.x; i < G * D; i += kThreads) pacc[i] = 0.f;
    if (threadIdx.x < G) {
      pml[2 * threadIdx.x] = kNegInf;
      pml[2 * threadIdx.x + 1] = 0.f;
    }
    merge_if_last<T, D, G>(part_acc, part_ml, out, lse, counters, bh, n_split,
                           reinterpret_cast<float*>(smem));
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LANES;  // this lane's first 16-byte chunk of a row
  const int group = warp * POS_PER_WARP + lane / LANES;
  // chunk j of this lane is sub + j * LANES, when it lies inside the row
  auto has = [&](int j) { return L::FULL || sub + j * LANES < CH; };

  // symmetric: (b, h)'s first K/V element; paged: its logical element in
  // slot b's region, and the region's table row
  const int64_t k_row0 = PAGED ? k_sb + h * k_sh : b * k_sb + h * k_sh;
  const int64_t v_row0 = PAGED ? v_sb + h * v_sh : b * v_sb + h * v_sh;
  const int* trow = PAGED ? table + static_cast<int64_t>(b) * pps : nullptr;
  const int n_tiles = (end - start + TILE - 1) / TILE;

  // tile `tile` of the span into ring slot `slot`: K rows then V rows, each
  // row D*itemsize contiguous bytes; rows past `end` are zero-filled
  auto load_tile = [&](int tile, int slot) {
    unsigned char* ks = smem + slot * STAGE;
    unsigned char* vs = ks + STAGE / 2;
    const int t0 = start + tile * TILE;
#pragma unroll
    for (int c = threadIdx.x; c < CHUNKS; c += kThreads) {
      const int t = t0 + c / CH;
      const bool ok = t < end;
      const int64_t tc = ok ? t : start;
      const int off = (c % CH) * VEC;
      const int64_t ek = k_row0 + tc * k_st + off;
      const int64_t ev = v_row0 + tc * v_st + off;
      if constexpr (PAGED) {
        cp_async16(ks + c * 16, paged_at(k, trow, ek, page_elems), ok);
        cp_async16(vs + c * 16, paged_at(v, trow, ev, page_elems), ok);
      } else {
        cp_async16(ks + c * 16, k + ek, ok);
        cp_async16(vs + c * 16, v + ev, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // this lane's chunks of every query head of KV head h, scaled, in fp32
  // (zero where the lane holds no chunk)
  float qf[CPL][G][VEC];
  const T* qb = q + static_cast<int64_t>(bh) * G * D;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (has(j)) {
        unpack<T>(*reinterpret_cast<const uint4*>(qb + g * D + (sub + j * LANES) * VEC),
                  qf[j][g]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) qf[j][g][i] *= scale;
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) qf[j][g][i] = 0.f;
      }
    }
  }

  float m[G], l[G], acc[CPL][G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[j][g][i] = 0.f;
    }
  }

  // n_tiles is the same for every thread of the CTA, so the shuffles below
  // always run with the whole warp converged
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `tile` has landed; slot (tile - 1) is free
    if (tile + kStages - 1 < n_tiles) {
      load_tile(tile + kStages - 1, (tile + kStages - 1) % kStages);
    }
    cp_async_commit();
    const unsigned char* ks = smem + (tile % kStages) * STAGE;
    const unsigned char* vs = ks + STAGE / 2;
    const int t0 = start + tile * TILE;

    bool valid[kUnroll];
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = u * GROUPS + group;
      valid[u] = t0 + row < end;
#pragma unroll
      for (int g = 0; g < G; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (!has(j)) continue;
        float kf[VEC];
        unpack<T>(*reinterpret_cast<const uint4*>(
                      ks + (row * CH + sub + j * LANES) * 16), kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = s[u][g];
#pragma unroll
          for (int i = 0; i < VEC; ++i) dot = fmaf(qf[j][g][i], kf[i], dot);
          s[u][g] = dot;
        }
      }
    }
    // sum the partial dot products over the LANES lanes of each position
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
        }
      }
    }
    // online softmax over this tile's valid positions
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      }
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[j][g][i] *= corr;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!valid[u]) continue;
      const int row = u * GROUPS + group;
      float p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        p[g] = expf(s[u][g] - m[g]);
        l[g] += p[g];
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (!has(j)) continue;
        float vf[VEC];
        unpack<T>(*reinterpret_cast<const uint4*>(
                      vs + (row * CH + sub + j * LANES) * 16), vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[j][g][i] = fmaf(p[g], vf[i], acc[j][g][i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the merge below

  // merge the position groups of this warp (lanes with the same `sub`)
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], m_o);
      const float a = expf(m[g] - mx);
      const float c = expf(m_o - mx);
      l[g] = l[g] * a + l_o * c;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float acc_o = __shfl_xor_sync(0xffffffffu, acc[j][g][i], off);
          acc[j][g][i] = acc[j][g][i] * a + acc_o * c;
        }
      }
      m[g] = mx;
    }
  }
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][G]
  float* sm_l = sm_m + L::WARP_ML / 4;           // [kWarps][G]
  float* sm_acc = sm_m + 2 * L::WARP_ML / 4;     // [kWarps][G][D]
  if (lane < LANES) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (!has(j)) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sm_acc[(warp * G + g) * D + (sub + j * LANES) * VEC + i] = acc[j][g][i];
        }
      }
      if (lane == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and write this span's partial once
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * e;
      o += sm_acc[(w * G + g) * D + d] * e;
    }
    pacc[idx] = o;
    if (d == 0) {
      pml[2 * g] = mx;
      pml[2 * g + 1] = lsum;
    }
  }
  merge_if_last<T, D, G>(part_acc, part_ml, out, lse, counters, bh, n_split,
                         reinterpret_cast<float*>(smem));
}

// One CTA per (b, h, span) of the tensor-core path (bf16, FD_TC_PAIRS): the
// arguments, the partials and the merge are flash_decode_split_kernel's.
template <int D, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ lengths, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int* __restrict__ counters, int n_kv,
                       int t_len, int n_split, int span, int64_t k_sb, int64_t k_st,
                       int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                       float scale, const int* __restrict__ table, int pps,
                       int64_t page_elems) {
  using T = __nv_bfloat16;
  using L = TcLayout<D, G>;
  constexpr int CH = L::CH;
  constexpr int ROW = L::ROW;
  constexpr int TILE = L::TILE;
  constexpr int HALF = L::HALF;
  constexpr int STAGE = L::STAGE;

  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x % n_split;
  const int bh = blockIdx.x / n_split;
  const int b = bh / n_kv;
  const int h = bh % n_kv;
  const int len = min(max(lengths[b], 0), t_len);
  const int start = split * span;
  const int end = min(start + span, len);
  float* pacc = part_acc + static_cast<int64_t>(blockIdx.x) * G * D;
  float* pml = part_ml + static_cast<int64_t>(blockIdx.x) * G * 2;
  if (start >= end) {
    // an empty span: the sentinel partial (uniform over the CTA)
    for (int i = threadIdx.x; i < G * D; i += kThreads) pacc[i] = 0.f;
    if (threadIdx.x < G) {
      pml[2 * threadIdx.x] = kNegInf;
      pml[2 * threadIdx.x + 1] = 0.f;
    }
    merge_if_last<T, D, G, true>(part_acc, part_ml, out, lse, counters, bh, n_split,
                                 reinterpret_cast<float*>(smem));
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t k_row0 = PAGED ? k_sb + h * k_sh : b * k_sb + h * k_sh;
  const int64_t v_row0 = PAGED ? v_sb + h * v_sh : b * v_sb + h * v_sh;
  const int* trow = PAGED ? table + static_cast<int64_t>(b) * pps : nullptr;
  const int n_tiles = (end - start + TILE - 1) / TILE;

  // tile `tile` of the span into ring slot `slot`, K rows then V rows; each
  // thread copies chunk columns c8, c8 + 8, ... of rows threadIdx.x / 8 + 16i.
  // Rows past `end` are zero-filled.
  auto load_tile = [&](int tile, int slot) {
    unsigned char* ks = smem + slot * STAGE;
    unsigned char* vs = ks + HALF;
    const int t0 = start + tile * TILE;
    const int c8 = threadIdx.x % 8;
#pragma unroll
    for (int i = 0; i < TILE / (kThreads / 8); ++i) {
      const int r = threadIdx.x / 8 + i * (kThreads / 8);
      const int t = t0 + r;
      const bool ok = t < end;
      const int64_t tc = ok ? t : start;
      const int64_t ek0 = k_row0 + tc * k_st;
      const int64_t ev0 = v_row0 + tc * v_st;
#pragma unroll
      for (int j = 0; j < CH / 8; ++j) {
        const int c = c8 + 8 * j;
        const int dst = r * ROW + (c ^ (r % 8)) * 16;
        if constexpr (PAGED) {
          cp_async16(ks + dst, paged_at(k, trow, ek0 + c * 8, page_elems), ok);
          cp_async16(vs + dst, paged_at(v, trow, ev0 + c * 8, page_elems), ok);
        } else {
          cp_async16(ks + dst, k + ek0 + c * 8, ok);
          cp_async16(vs + dst, v + ev0 + c * 8, ok);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // q of KV head h as the A fragments of the D/16 k-steps (rows G..15 zero)
  const int gr = lane / 4;  // this lane's rows gr and gr + 8 of a fragment
  const int qd = lane % 4;  // and its columns 2qd, 2qd + 1 (+ 8)
  const T* qb = q + static_cast<int64_t>(bh) * G * D;
  auto q2 = [&](int row, int col) -> uint32_t {
    return row < G ? __ldg(reinterpret_cast<const unsigned*>(qb + row * D + col)) : 0u;
  };
  uint32_t qa[L::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < L::KSTEPS; ++kk) {
    const int col = kk * 16 + 2 * qd;
    qa[kk][0] = q2(gr, col);
    qa[kk][1] = q2(gr + 8, col);
    qa[kk][2] = q2(gr, col + 8);
    qa[kk][3] = q2(gr + 8, col + 8);
  }

  // rows gr (index 0) and gr + 8 (index 1): running max, this lane's share
  // of the sum, and O's columns 8n + 2qd, + 1 for every block n
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[L::NBLK][4];
#pragma unroll
  for (int n = 0; n < L::NBLK; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  // ldmatrix rows: K as B of S (matrices: positions 0-7 | 8-15 x chunk
  // 2kk | 2kk + 1), V as B of P V (positions 0-7 | 8-15 x chunk 2jj | 2jj + 1)
  const int k_r = warp * kTcRows + (lane / 16) * 8 + lane % 8;
  const int k_c = (lane / 8) % 2;
  const int v_r = warp * kTcRows + ((lane / 8) % 2) * 8 + lane % 8;
  const int v_c = lane / 16;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // tile `tile` has landed; slot (tile - 1) is free
    if (tile + kTcStages - 1 < n_tiles) {
      load_tile(tile + kTcStages - 1, (tile + kTcStages - 1) % kTcStages);
    }
    cp_async_commit();
    const unsigned char* ks = smem + (tile % kTcStages) * STAGE;
    const unsigned char* vs = ks + HALF;
    const int p0 = start + tile * TILE + warp * kTcRows;  // this warp's first position
    if (p0 >= end) continue;  // none of this warp's rows is live (warp-uniform)

    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < L::KSTEPS; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + k_r * ROW + ((2 * kk + k_c) ^ (k_r % 8)) * 16);
      mma_bf16(s[0], qa[kk], kb[0], kb[1]);
      mma_bf16(s[1], qa[kk], kb[2], kb[3]);
    }
    // s[n][e] is row gr + 8(e / 2), position p0 + 8n + 2qd + e % 2
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = p0 + 8 * n + 2 * qd + e % 2 < end;
        s[n][e] = live ? s[n][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    // P as the A fragment of P V: k = the warp's 16 positions
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = p0 + 8 * n + 2 * qd + e % 2 < end;
        p[e] = live ? expf(s[n][e] - m[e / 2]) : 0.f;
        l[e / 2] += p[e];
      }
      pa[2 * n] = pack_bf16(p[0], p[1]);
      pa[2 * n + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int n = 0; n < L::NBLK; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int jj = 0; jj < L::NBLK / 2; ++jj) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vs + v_r * ROW + ((2 * jj + v_c) ^ (v_r % 8)) * 16);
      mma_bf16(o[2 * jj], pa, vb[0], vb[1]);
      mma_bf16(o[2 * jj + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the merge below

  // each row's sum over its quad, then the warps' (m, l, O) to shared memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][G]
  float* sm_l = sm_m + L::Merge::WARP_ML / 4;        // [kWarps][G]
  float* sm_acc = sm_m + 2 * L::Merge::WARP_ML / 4;  // [kWarps][G][D]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = gr + 8 * r;
    if (g >= G) continue;
#pragma unroll
    for (int n = 0; n < L::NBLK; ++n) {
      *reinterpret_cast<float2*>(sm_acc + (warp * G + g) * D + 8 * n + 2 * qd) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
    if (qd == 0) {
      sm_m[warp * G + g] = m[r];
      sm_l[warp * G + g] = l[r];
    }
  }
  __syncthreads();
  write_partial_wide<D, G>(sm_m, pacc, pml);
  merge_if_last<T, D, G, true>(part_acc, part_ml, out, lse, counters, bh, n_split,
                               reinterpret_cast<float*>(smem));
}

// the arguments of one call (table, pps and page_elems: the paged kernel's)
struct Args {
  int batch, n_kv, t_len, n_split;
  const void *q, *k, *v, *lengths;
  void* out;
  float* lse;  // null unless flash_decode_lse
  float* part;
  int* counters;
  int64_t k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  cudaStream_t stream;
  const int* table;
  int pps;
  int64_t page_elems;
};

// Whether (T, D, G) is on the tensor-core path (FD_TC_PAIRS, bf16 only)
constexpr bool tc_pair(int d, int g) {
#define FD_TC_MATCH(DD, GG) (d == DD && g == GG) ||
  return FD_TC_PAIRS(FD_TC_MATCH) false;
#undef FD_TC_MATCH
}
template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

// The kernel an instantiation launches and the shared memory it requests
template <typename T, int D, int G, bool PAGED,
          bool TC = IsBf16<T>::value && tc_pair(D, G)>
struct Pick {
  static constexpr bool tc = false;
  static constexpr int smem = Layout<T, D, G>::SMEM;
  static auto kernel() { return &flash_decode_split_kernel<T, D, G, PAGED>; }
};
template <int D, int G, bool PAGED>
struct Pick<__nv_bfloat16, D, G, PAGED, true> {
  static constexpr bool tc = true;
  static constexpr int smem = TcLayout<D, G>::SMEM;
  static auto kernel() { return &flash_decode_tc_kernel<D, G, PAGED>; }
};

// The opt-in to the instantiation's bytes of dynamic shared memory, once,
// before its first launch (a warm-up call precedes every graph capture, so
// a capture never sets it). Every instantiation takes it: the 48 KiB a
// launch gets without it include the static `last` of merge_if_last, so
// 48 KiB of dynamic memory already needs it.
template <typename T, int D, int G, bool PAGED>
cudaError_t opt_in() {
  using P = Pick<T, D, G, PAGED>;
  static const cudaError_t err = cudaFuncSetAttribute(
      P::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem);
  return err;
}

template <typename T, int D, int G, bool PAGED>
cudaError_t launch(const Args& a) {
  using P = Pick<T, D, G, PAGED>;
  constexpr int smem = P::smem;
  const auto kernel = P::kernel();
  const cudaError_t opted = opt_in<T, D, G, PAGED>();
  if (opted != cudaSuccess) return opted;
  const int span = (a.t_len + a.n_split - 1) / a.n_split;
  const int parts = a.batch * a.n_kv * a.n_split;
  float* part_acc = a.part;
  float* part_ml = a.part + static_cast<int64_t>(parts) * G * D;
  kernel<<<parts, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.lengths), part_acc,
      part_ml, static_cast<T*>(a.out), a.lse, a.counters, a.n_kv, a.t_len,
      a.n_split,
      span, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.scale, a.table,
      a.pps, a.page_elems);
  return cudaGetLastError();
}

// The (D, G) pairs built, each in fp32 and bf16: qwen3 (64, 2) and the other
// powers of two at D = 64 and 128, granite-moe (64, 3), gemma3-4b's global
// layers (320, 2), gemma3-27b's (168, 2), internvl2 (64, 7), zamba2 (224, 1),
// llama4 (128, 5) and nemotron (192, 12). On the CUDA-core kernel G sets
// only the loop counts: the Layout follows from (dtype, D), so (64, 3) reads
// a position with CH lanes as (64, 2) does. kernels/flash_decode.py (PAIRS)
// and kernels/smem_plan.py (FD_PAIRS) list the same. Each pair is built
// symmetric and paged, each on the kernel Pick names.
#define FD_PAIRS(X)                                                          \
  X(64, 1) X(64, 2) X(64, 3) X(64, 4) X(64, 7) X(64, 8) X(128, 1) X(128, 2) \
  X(128, 4) X(128, 5) X(128, 8) X(168, 2) X(192, 12) X(224, 1) X(320, 2)

template <typename T, bool PAGED>
cudaError_t dispatch(int d, int g, const Args& a) {
#define FD_LAUNCH(DD, GG) \
  if (d == DD && g == GG) return launch<T, DD, GG, PAGED>(a);
  FD_PAIRS(FD_LAUNCH)
#undef FD_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
int smem_bytes(int d, int g) {
#define FD_SMEM(DD, GG) \
  if (d == DD && g == GG) return Pick<T, DD, GG, false>::smem;
  FD_PAIRS(FD_SMEM)
#undef FD_SMEM
  return 0;
}

// CTAs of the instantiation that one SM holds at once (the occupancy API
// on its registers, shared memory and threads); -1 on an error
template <typename T, int D, int G>
int ctas_per_sm() {
  using P = Pick<T, D, G, false>;
  if (opt_in<T, D, G, false>() != cudaSuccess) return -1;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, P::kernel(), kThreads, P::smem);
  return err == cudaSuccess ? blocks : -1;
}

template <typename T>
int occupancy(int d, int g) {
#define FD_OCC(DD, GG) \
  if (d == DD && g == GG) return ctas_per_sm<T, DD, GG>();
  FD_PAIRS(FD_OCC)
#undef FD_OCC
  return -1;
}

template <typename T>
int tensor_core(int d, int g) {
#define FD_TC(DD, GG) \
  if (d == DD && g == GG) return Pick<T, DD, GG, false>::tc ? 1 : 0;
  FD_PAIRS(FD_TC)
#undef FD_TC
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and out are contiguous (B, KV, G, D);
// k and v are (B, T, KV, D) with the given element strides and a contiguous
// head dimension; lengths is int32 (B,) on the device. `part` is fp32
// scratch of B * KV * n_split * G * (D + 2) floats for the partials of the
// n_split spans; `counters` is int32 (B * KV,), all 0 before the call and
// left at 0 after it. `lse` is null, or fp32 (B, KV, G) for each query
// head's log-sum-exp (flash_decode_lse). Returns a cudaError_t.
extern "C" int flash_decode_launch(int dtype, int batch, int n_kv, int g,
                                   int d, int t_len, int n_split,
                                   const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, void* lse,
                                   void* part, void* counters, int64_t k_sb,
                                   int64_t k_st, int64_t k_sh, int64_t v_sb,
                                   int64_t v_st, int64_t v_sh, float scale,
                                   void* stream) {
  if (batch * n_kv == 0) return cudaSuccess;
  if (n_split < 1 || n_split > kMaxSplits) return cudaErrorInvalidValue;
  const Args a{batch, n_kv, t_len, n_split, q, k, v, lengths, out,
               static_cast<float*>(lse), static_cast<float*>(part), static_cast<int*>(counters), k_sb,
               k_st, k_sh, v_sb, v_st, v_sh, scale,
               static_cast<cudaStream_t>(stream), nullptr, 0, 0};
  switch (dtype) {
    case 0:
      return dispatch<float, false>(d, g, a);
    case 1:
      return dispatch<__nv_bfloat16, false>(d, g, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The paged kernel: as flash_decode_launch, with K and V read out of the page
// pool `buf` (elements of the dtype) through `table`, int32 (B, pps) on the
// device, whose row b maps slot b's region page by page (pages of page_elems
// elements; entry 0 is the pool's null page). k_off and v_off are the layer's
// K and V element offsets inside a slot region, t_st and h_st its position and
// head strides. page_elems, the offsets and the strides are whole 16-byte
// multiples (the wrapper checks them).
extern "C" int flash_decode_paged_launch(int dtype, int batch, int n_kv, int g,
                                         int d, int t_len, int n_split,
                                         const void* q, const void* buf,
                                         const void* table, const void* lengths,
                                         void* out, void* part, void* counters,
                                         int pps, int64_t page_elems,
                                         int64_t k_off, int64_t v_off,
                                         int64_t t_st, int64_t h_st, float scale,
                                         void* stream) {
  if (batch * n_kv == 0) return cudaSuccess;
  if (n_split < 1 || n_split > kMaxSplits || page_elems < 1) {
    return cudaErrorInvalidValue;
  }
  const Args a{batch, n_kv, t_len, n_split, q, buf, buf, lengths, out, nullptr,
               static_cast<float*>(part), static_cast<int*>(counters), k_off,
               t_st, h_st, v_off, t_st, h_st, scale,
               static_cast<cudaStream_t>(stream), static_cast<const int*>(table),
               pps, page_elems};
  switch (dtype) {
    case 0:
      return dispatch<float, true>(d, g, a);
    case 1:
      return dispatch<__nv_bfloat16, true>(d, g, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory one CTA of the instantiation (dtype, d, g)
// requests at launch: the largest of its ring (Layout or TcLayout) and the
// two merges that reuse it after the loop. 0 for an instantiation that does
// not exist. A size query only; kernels/smem_plan.py plans the same working
// set with the paper's planner.
extern "C" int flash_decode_smem_bytes(int dtype, int d, int g) {
  switch (dtype) {
    case 0:
      return smem_bytes<float>(d, g);
    case 1:
      return smem_bytes<__nv_bfloat16>(d, g);
    default:
      return 0;
  }
}

// Which kernel the instantiation (dtype, d, g) launches: 1 the tensor-core
// kernel, 0 the CUDA-core one, -1 an instantiation that does not exist.
extern "C" int flash_decode_tensor_core(int dtype, int d, int g) {
  switch (dtype) {
    case 0:
      return tensor_core<float>(d, g);
    case 1:
      return tensor_core<__nv_bfloat16>(d, g);
    default:
      return -1;
  }
}

// CTAs of the symmetric instantiation (dtype, d, g) one SM holds at once;
// -1 for an instantiation that does not exist or an error.
extern "C" int flash_decode_ctas_per_sm(int dtype, int d, int g) {
  switch (dtype) {
    case 0:
      return occupancy<float>(d, g);
    case 1:
      return occupancy<__nv_bfloat16>(d, g);
    default:
      return -1;
  }
}
