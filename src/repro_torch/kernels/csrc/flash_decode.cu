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
// Not done here (left for later work): TMA loads and wgmma.
//
// Plain C interface; the Python wrapper (kernels/flash_decode.py) loads the
// shared library with ctypes and passes pointers, strides, the split count,
// the fp32 scratch for the partials, the per-(b, h) counts and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 2;             // positions per lane group per tile
constexpr int kStages = 4;             // tiles in the shared-memory ring
constexpr int kMaxSplits = 64;         // the wrapper's num_splits never exceeds it
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
template <typename T, int D, int G>
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
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) o += __ldcg(acc + s * G * D + idx) * sm_w[s * G + g];
    store(ob + idx, o * sm_inv[g]);
  }
  if (threadIdx.x == 0) counters[bh] = 0;
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

template <typename T, int D, int G, bool PAGED>
cudaError_t launch(const Args& a) {
  constexpr int smem = Layout<T, D, G>::SMEM;
  auto kernel = flash_decode_split_kernel<T, D, G, PAGED>;
  // the opt-in to `smem` bytes of dynamic shared memory, once per
  // instantiation before its first launch (a warm-up call precedes every
  // graph capture, so a capture never sets it). Every instantiation takes
  // it: the 48 KiB a launch gets without it include the static `last` of
  // merge_if_last, so 48 KiB of dynamic memory already needs it.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
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
// llama4 (128, 5) and nemotron (192, 12). G sets only the loop counts: the
// Layout follows from (dtype, D), so (64, 3) reads a position with CH lanes
// as (64, 2) does. kernels/flash_decode.py (PAIRS) and kernels/smem_plan.py
// (FD_PAIRS) list the same. Each pair is built symmetric and paged.
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
  if (d == DD && g == GG) return Layout<T, DD, GG>::SMEM;
  FD_PAIRS(FD_SMEM)
#undef FD_SMEM
  return 0;
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
// requests at launch: Layout::SMEM, the largest of the kStages ring and the
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
