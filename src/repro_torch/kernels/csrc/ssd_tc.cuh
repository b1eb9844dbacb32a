// Helpers shared by the SSD chunk kernels, forward (ssd_chunk.cu) and
// backward (ssd_chunk_bwd.cu): the float64 prefix sum, and the tensor-core
// toolkit of their bf16 kernels (cp.async, ldmatrix, mma.sync.m16n8k16 with
// fp32 accumulation, the hi + mid + lo split of an fp32 operand into three
// bf16 parts, the tile loaders). kernels/build.py hashes this header into
// the digest of every library built from the sources beside it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 256;
constexpr int kMaxN = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// cum[l] = dA[0] + ... + dA[l] in float64 for l < L, over the CTA's THREADS
// threads: each thread sums kMaxL / THREADS consecutive positions, the
// threads' totals are scanned with warp shuffles, the warps' totals through
// `warp_tot` ([THREADS / 32] doubles of shared memory). Every thread calls it.
template <int THREADS>
__device__ void prefix_sum_f64(const float* dab, int64_t stride, int L,
                               double* cum, double* warp_tot) {
  constexpr int PER = kMaxL / THREADS;
  static_assert(PER * THREADS == kMaxL, "positions split evenly");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  double v[PER];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int l = tid * PER + e;
    run += l < L ? static_cast<double>(dab[l * stride]) : 0.0;
    v[e] = run;
  }
  double x = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  double base = x - run;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int l = tid * PER + e;
    if (l < L) cum[l] = base + v[e];
  }
  __syncthreads();
}

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcTile = 64;  // query rows per row tile = key positions per key tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: lanes 8q..8q+7 give the row addresses of 8x8 matrix q; register
// q of lane t then holds (row t/4, columns 2(t%4), 2(t%4)+1) of matrix q, or
// with .trans (rows 2(t%4), 2(t%4)+1, column t/4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b over one m16n8k16 tile, bf16 operands, fp32 accumulator. Lane t
// holds d[0], d[1] = (row t/4, columns 2(t%4), +1) and d[2], d[3] = (row
// t/4 + 8, the same columns); a[0..3] = A's (row t/4, k 2(t%4), +1), (row
// t/4 + 8, same k), (row t/4, k + 8), (row t/4 + 8, k + 8); b0, b1 = B's
// (k 2(t%4), +1, column t/4) and (k + 8, column t/4)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (a, b) = hi + mid + lo, three bf16 pairs: each part is the bf16 rounding of
// what the parts before it left, and each difference is exact in fp32, so the
// three carry 24 significant bits and drop at most 2**-24 of the value
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(l);
}

template <typename TS>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<bf16> {
  static constexpr bool value = true;
};

// n padded to a multiple of 16, the k of an mma
__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// rows [r0, r0 + 64) and columns [0, ncols) of a bf16 matrix (row stride
// s_row, column stride s_col) into a [64][ld] tile; rows at or past L are
// zero. Only the 16-byte chunks that hold columns below ncols are written:
// the rest of each row is zeroed once, when the kernel starts (zero_smem).
// With `vec` (contiguous 16-byte-aligned rows, ncols a multiple of 8) by
// 16-byte cp.async, else element by element. Each thread keeps one chunk
// column and walks the rows, so the loop holds no division.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int64_t s_row, int64_t s_col, int r0,
                                          int L, int ncols, bool vec) {
  const int per_row = (ncols + 7) / 8;
  if (per_row <= 0) return;
  const int step = kTcThreads / per_row;  // rows per pass of the CTA
  const int first = threadIdx.x / per_row;
  if (first >= step) return;
  const int col = (threadIdx.x % per_row) * 8;
  for (int r = first; r < kTcTile; r += step) {
    const int row = r0 + r;
    bf16* d = dst + r * ld + col;
    if (vec) {
      const bool in = row < L;
      cp_async16(d, in ? src + row * s_row + col : src, in);
    } else {
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = row < L && col + e < ncols;
        vals[e] = in ? src[row * s_row + (col + e) * s_col] : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(vals);
    }
  }
}

// zero `bytes` (a multiple of 16) of shared memory from `p`, 16-byte aligned
__device__ __forceinline__ void zero_smem(unsigned char* p, size_t bytes) {
  for (size_t i = threadIdx.x * 16; i < bytes; i += kTcThreads * 16) {
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
  }
}

// the (P, N) state into an fp32 [P][lds] tile, columns past N zero: runs of
// 8 columns, two runs per thread per round, all 16 loads issued before any
// store, so a thread waits on memory P * lds / (16 * kTcThreads) times
template <typename TS>
__device__ __forceinline__ void load_state(float* sts, int lds, const TS* sb,
                                           int64_t s_p, int64_t s_n, int P,
                                           int N) {
  constexpr int kRun = 8, kRuns = 2;
  const int per_row = lds / kRun;
  const int total = P * per_row;
  for (int c0 = threadIdx.x; c0 < total; c0 += kRuns * kTcThreads) {
    float v[kRuns][kRun];
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      const int c = c0 + k * kTcThreads;
      const int pp = c / per_row, n0 = (c % per_row) * kRun;
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const bool in = c < total && n0 + e < N;
        v[k][e] = in ? to_f32(sb[pp * s_p + (n0 + e) * s_n]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      const int c = c0 + k * kTcThreads;
      if (c >= total) break;
      float4* d = reinterpret_cast<float4*>(sts + (c / per_row) * lds + (c % per_row) * kRun);
      d[0] = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
      d[1] = make_float4(v[k][4], v[k][5], v[k][6], v[k][7]);
    }
  }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t& opted_in) {
  if (smem <= opted_in) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) opted_in = smem;
  return err;
}

// rows of a bf16 (b, l, h, n) tensor load by 16-byte cp.async when they are
// contiguous, 16-byte aligned at every (b, l, h), and `cols` is a multiple of 8
bool rows_vectorizable(const void* p, const int64_t* s, int cols) {
  return s[3] == 1 && s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0 &&
         cols % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
