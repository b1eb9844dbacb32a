// One Mamba2 SSD chunk per (batch, head), for sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_chunk` (src/repro/kernels/ssd_chunk.py,
// body `_kernel`). For one (b, h) and a chunk of L <= 256 positions, with
// cum = cumsum(dA) and total = cum[L-1]:
//   W[i][j]       = (C_i . B_j) * exp(cum_i - cum_j) * dt_j       for j <= i
//   y[i][p]       = sum_j W[i][j] x[j][p] + exp(cum_i) * sum_n C[i][n] state[p][n]
//   new_state[p][n] = state[p][n] * exp(total)
//                   + sum_j x[j][p] * B[j][n] * exp(total - cum_j) * dt_j
// accumulated in fp32, y written in x's dtype and new_state in state's dtype.
//
// What bounds it on an H100: at the prefill shape of mamba2-2.7b (L=256, H=80,
// P=64, N=128, bf16) it moves ~8.2 MB (2.4 us at 3.35 TB/s) and needs ~1.7
// GFLOP for the causal half of the L x L products: 1.7 us on bf16 tensor cores,
// 25 us on fp32 CUDA cores. This first version computes in fp32 on the CUDA
// cores (three small matrix products per (b, h), the shape later work moves
// to wgmma), so it is bound by operations.
//
// Design, against what the TPU kernel relied on:
//   * The TPU kernel holds the whole fp32 L x L tile in VMEM. An L x L fp32
//     tile at L = 256 is 256 KiB, more than the 227 KiB a block may have, so
//     each "y CTA" owns one tile of 64 query rows (grid.y < ceil(L / 64)) and
//     walks the key positions in tiles of 64 up to its diagonal, keeping its
//     64 x 64 block of W in shared memory. Each thread computes a 4 x 4
//     block of W and reads the C and B tiles 16 bytes at a time, so the
//     products are bound by the FMA pipe, not by shared-memory loads.
//   * The (P, N) new state needs every row of the chunk. "State CTAs" (the
//     last ceil(N / 32) values of grid.y) each compute 32 of its columns in
//     the same launch: at the prefill shape 80 x (4 + 4) = 640 CTAs.
//   * The decay is exp(cum_i - cum_j), taken only for j <= i: never the upper
//     triangle and never exp(cum_i) / exp(cum_j), which both under- or
//     overflow over a chunk. The prefix sum is taken in float64 by one thread
//     of each CTA, as the plain version takes its torch.cumsum in float64
//     (a parallel scan on CUDA, so in another order): in float64 the order
//     moves the sum by ~1e-14 of it, far below one float32 rounding, where
//     at |cum| ~ 180 an fp32 prefix sum would carry ~1e-5 of error into
//     every decay.
//   * B and C are read through explicit element strides, so the one group of
//     mamba2 reaches all heads through a head stride of 0 and is never copied
//     per head; x, dt, dA and the state are strided as well.
//   * Any L from 1 to 256: rows and key positions past L load as zero and are
//     never written.
//
// Plain C interface; the Python wrapper (kernels/ssd_chunk.py) loads the
// shared library with ctypes and passes pointers, strides and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileI = 64;  // query rows per y CTA
constexpr int kTileJ = 64;  // key positions per step
constexpr int kLdW = kTileJ + 4;  // row stride of the W tile (16-byte rows)
constexpr int kStateCols = 32;  // new-state columns per state CTA
constexpr int kMaxL = 256;
constexpr int kMaxN = 128;

// element strides, in this order: x (b, l, h, p), dt (b, l, h), dA (b, l, h),
// B (b, l, h, n), C (b, l, h, n), state (b, h, p, n)
constexpr int kStrides = 22;
struct Strides {
  int64_t v[kStrides];
  __device__ const int64_t* x() const { return v; }
  __device__ const int64_t* dt() const { return v + 4; }
  __device__ const int64_t* da() const { return v + 7; }
  __device__ const int64_t* b() const { return v + 10; }
  __device__ const int64_t* c() const { return v + 14; }
  __device__ const int64_t* s() const { return v + 18; }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// N padded to a multiple of 4; the row stride of the C, B and state tiles
// is an odd multiple of 4 floats, so eight lanes reading 16 bytes each from
// eight consecutive rows hit 32 distinct banks
__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int row_stride(int n) {
  const int l = pad4(n);
  return (l / 4) % 2 ? l : l + 4;
}

size_t smem_bytes(int p, int n) {
  return sizeof(double) * kMaxL + sizeof(float) * kMaxL +
         sizeof(float) * (2 * kTileI * row_stride(n) + kTileJ * p + kTileI * kLdW);
}

template <typename TX, typename TS, int P>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ dA, const TX* __restrict__ bm,
                 const TX* __restrict__ cm, const TS* __restrict__ state,
                 TX* __restrict__ y, TS* __restrict__ new_state, int L, int H,
                 int N, Strides st) {
  static_assert(kThreads % P == 0 && P % kWarps == 0 && P <= kTileJ,
                "unsupported head dim");
  constexpr int kRowStep = kThreads / P;    // rows one pass of the CTA covers
  constexpr int kOut = kTileI / kRowStep;   // y outputs per thread
  constexpr int kStateRows = P / kWarps;    // new-state rows per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = row_stride(N);
  const int n4 = pad4(N);
  double* cum = reinterpret_cast<double*>(smem_raw);  // [kMaxL]
  float* dts = reinterpret_cast<float*>(cum + kMaxL);  // [kMaxL]
  float* cs = dts + kMaxL;                             // [kTileI][ldn]
  float* bs = cs + kTileI * ldn;                       // [kTileJ][ldn]
  float* xs = bs + kTileJ * ldn;                       // [kTileJ][P]
  float* ws = xs + kTileJ * P;                         // [kTileI][kLdW]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int row_tiles = (L + kTileI - 1) / kTileI;
  const int tile = blockIdx.y;

  const TX* xb = x + b * st.x()[0] + h * st.x()[2];
  const float* dtb = dt + b * st.dt()[0] + h * st.dt()[2];
  const float* dab = dA + b * st.da()[0] + h * st.da()[2];
  const TX* bb = bm + b * st.b()[0] + h * st.b()[2];
  const TX* cb = cm + b * st.c()[0] + h * st.c()[2];
  const TS* sb = state + b * st.s()[0] + h * st.s()[1];

  for (int l = tid; l < L; l += kThreads) {
    cum[l] = static_cast<double>(dab[l * st.da()[1]]);
    dts[l] = dtb[l * st.dt()[1]];
  }
  __syncthreads();
  if (tid == 0) {
    // sequential, in float64 (see the header)
    double acc = 0.0;
#pragma unroll 8
    for (int l = 0; l < L; ++l) {
      acc += cum[l];
      cum[l] = acc;
    }
  }

  if (tile >= row_tiles) {
    // ---- kStateCols columns of the new state:
    // new_state[p][n] = state[p][n] exp(total) + sum_j x[j][p] B[j][n] rem_j
    __syncthreads();
    const double total = cum[L - 1];
    const int n = (tile - row_tiles) * kStateCols + lane;
    const int p0 = warp * kStateRows;
    float* bsc = ws;  // [kTileJ][kStateCols]: B scaled by rem_j
    float acc[kStateRows];
#pragma unroll
    for (int a = 0; a < kStateRows; ++a) acc[a] = 0.f;
    for (int j0 = 0; j0 < L; j0 += kTileJ) {
      for (int c = warp; c < kTileJ; c += kWarps) {
        const int j = j0 + c;
        for (int pp = lane; pp < P; pp += 32) {
          xs[c * P + pp] = j < L ? to_f32(xb[j * st.x()[1] + pp * st.x()[3]]) : 0.f;
        }
        float v = 0.f;
        if (j < L && n < N) {
          const float rem = expf(static_cast<float>(total - cum[j])) * dts[j];
          v = to_f32(bb[j * st.b()[1] + n * st.b()[3]]) * rem;
        }
        bsc[c * kStateCols + lane] = v;
      }
      __syncthreads();
      const int jn = min(kTileJ, L - j0);
      for (int c = 0; c < jn; ++c) {
        const float bv = bsc[c * kStateCols + lane];
#pragma unroll
        for (int a = 0; a < kStateRows; ++a) {
          acc[a] = fmaf(xs[c * P + p0 + a], bv, acc[a]);
        }
      }
      __syncthreads();
    }
    if (n < N) {
      const float decay = expf(static_cast<float>(total));
      TS* nsb = new_state + (static_cast<int64_t>(b) * H + h) * P * N;
#pragma unroll
      for (int a = 0; a < kStateRows; ++a) {
        const int idx = (p0 + a) * N + n;
        const float s0 = to_f32(sb[(p0 + a) * st.s()[2] + n * st.s()[3]]);
        store(nsb + idx, s0 * decay + acc[a]);
      }
    }
    return;
  }

  // ---- a tile of kTileI query rows: y = W x + exp(cum) * C state^T
  const int i0 = tile * kTileI;
  for (int r = warp; r < kTileI; r += kWarps) {
    const int i = i0 + r;
    for (int nn = lane; nn < n4; nn += 32) {
      cs[r * ldn + nn] = i < L && nn < N ? to_f32(cb[i * st.c()[1] + nn * st.c()[3]]) : 0.f;
    }
  }
  const int p = tid % P;
  const int r0 = tid / P;
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.f;

  const int ti = tid / 16, tj = tid % 16;  // a 4 x 4 block of W per thread
  for (int j0 = 0; j0 <= i0; j0 += kTileJ) {
    for (int c = warp; c < kTileJ; c += kWarps) {
      const int j = j0 + c;
      for (int nn = lane; nn < n4; nn += 32) {
        bs[c * ldn + nn] = j < L && nn < N ? to_f32(bb[j * st.b()[1] + nn * st.b()[3]]) : 0.f;
      }
      for (int pp = lane; pp < P; pp += 32) {
        xs[c * P + pp] = j < L ? to_f32(xb[j * st.x()[1] + pp * st.x()[3]]) : 0.f;
      }
    }
    __syncthreads();
    // W block: C_i . B_j over n, 16 bytes at a time
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int nn = 0; nn < n4; nn += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (ti + 16 * r) * ldn + nn);
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = ld4(bs + (tj + 16 * c) * ldn + nn);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dot4(cv[r], bv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + ti + 16 * r, j = j0 + tj + 16 * c;
        const bool keep = j <= i && i < L;
        float w = 0.f;
        if (keep) w = s[r][c] * expf(static_cast<float>(cum[i] - cum[j])) * dts[j];
        ws[(ti + 16 * r) * kLdW + tj + 16 * c] = w;
      }
    }
    __syncthreads();
    // y_intra += W x, four key positions at a time
    for (int c = 0; c < kTileJ; c += 4) {
      const float x0 = xs[c * P + p], x1 = xs[(c + 1) * P + p];
      const float x2 = xs[(c + 2) * P + p], x3 = xs[(c + 3) * P + p];
      const float4 xv = make_float4(x0, x1, x2, x3);
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        acc[k] = dot4(ld4(ws + (r0 + k * kRowStep) * kLdW + c), xv, acc[k]);
      }
    }
    __syncthreads();
  }

  // the incoming state, as [P][ldn] in the B tile's space
  float* sts = bs;
  for (int pp = warp; pp < P; pp += kWarps) {
    for (int nn = lane; nn < n4; nn += 32) {
      sts[pp * ldn + nn] = nn < N ? to_f32(sb[pp * st.s()[2] + nn * st.s()[3]]) : 0.f;
    }
  }
  __syncthreads();
  float inter[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) inter[k] = 0.f;
  for (int nn = 0; nn < n4; nn += 4) {
    const float4 sv = ld4(sts + p * ldn + nn);
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      inter[k] = dot4(ld4(cs + (r0 + k * kRowStep) * ldn + nn), sv, inter[k]);
    }
  }
  TX* yb = y + (static_cast<int64_t>(b) * L * H + h) * P;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int i = i0 + r0 + k * kRowStep;
    if (i < L) {
      const float v = acc[k] + expf(static_cast<float>(cum[i])) * inter[k];
      store(yb + static_cast<int64_t>(i) * H * P + p, v);
    }
  }
}

template <typename TX, typename TS, int P>
cudaError_t launch(int batch, int L, int H, int N, const void* x,
                   const float* dt, const float* dA, const void* bm,
                   const void* cm, const void* state, void* y, void* new_state,
                   const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  static size_t opted_in = 0;  // per instantiation
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<TX, TS, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int row_tiles = (L + kTileI - 1) / kTileI;
  const int state_tiles = (N + kStateCols - 1) / kStateCols;
  const dim3 grid(batch * H, row_tiles + state_tiles);
  ssd_chunk_kernel<TX, TS, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), dt, dA, static_cast<const TX*>(bm),
      static_cast<const TX*>(cm), static_cast<const TS*>(state),
      static_cast<TX*>(y), static_cast<TS*>(new_state), L, H, N, st);
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t dispatch_p(int p, int batch, int L, int H, int N, const void* x,
                       const float* dt, const float* dA, const void* bm,
                       const void* cm, const void* state, void* y,
                       void* new_state, const Strides& st, cudaStream_t stream) {
  switch (p) {
    case 8:
      return launch<TX, TS, 8>(batch, L, H, N, x, dt, dA, bm, cm, state, y,
                               new_state, st, stream);
    case 32:
      return launch<TX, TS, 32>(batch, L, H, N, x, dt, dA, bm, cm, state, y,
                                new_state, st, stream);
    case 64:
      return launch<TX, TS, 64>(batch, L, H, N, x, dt, dA, bm, cm, state, y,
                                new_state, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t dispatch_s(int state_dtype, int p, int batch, int L, int H, int N,
                       const void* x, const float* dt, const float* dA,
                       const void* bm, const void* cm, const void* state,
                       void* y, void* new_state, const Strides& st,
                       cudaStream_t stream) {
  switch (state_dtype) {
    case 0:
      return dispatch_p<TX, float>(p, batch, L, H, N, x, dt, dA, bm, cm, state,
                                   y, new_state, st, stream);
    case 1:
      return dispatch_p<TX, __nv_bfloat16>(p, batch, L, H, N, x, dt, dA, bm, cm,
                                           state, y, new_state, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16 (x/B/C share one; the state has its
// own). dt and dA are float32. `strides` holds 22 element strides: x (b,l,h,p),
// dt (b,l,h), dA (b,l,h), B (b,l,h,n), C (b,l,h,n), state (b,h,p,n). y is
// written contiguous (B, L, H, P), new_state contiguous (B, H, P, N).
// Returns a cudaError_t.
extern "C" int ssd_chunk_launch(int x_dtype, int state_dtype, int batch, int L,
                                int H, int P, int N, const void* x,
                                const void* dt, const void* dA, const void* bm,
                                const void* cm, const void* state, void* y,
                                void* new_state, const int64_t* strides,
                                void* stream) {
  if (batch * H == 0) return cudaSuccess;
  if (L < 1 || L > kMaxL || N < 1 || N > kMaxN) return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < kStrides; ++i) st.v[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(dA);
  switch (x_dtype) {
    case 0:
      return dispatch_s<float>(state_dtype, P, batch, L, H, N, x, dtf, daf, bm,
                               cm, state, y, new_state, st, s);
    case 1:
      return dispatch_s<__nv_bfloat16>(state_dtype, P, batch, L, H, N, x, dtf,
                                       daf, bm, cm, state, y, new_state, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
