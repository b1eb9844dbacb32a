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
// 25 us on fp32 CUDA cores. Two kernels share this file:
//
// * bf16 x/B/C (what the model runs): `ssd_chunk_tc_kernel`, the products on
//   the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
//   operands loaded from shared memory with ldmatrix:
//     - S = C B^T: C and B are bf16, so every product is exact in fp32. Each
//       warp owns 16 query rows and keeps its C fragments in registers for the
//       whole key loop.
//     - W: the decay exp(cum_i - cum_j) * dt_j and the causal mask are applied
//       to S's accumulator fragment in registers, for j <= i only, never as a
//       ratio of exponentials: below the diagonal tile (j < i0, its first
//       row) as exp(cum_i - cum_i0) * exp(cum_i0 - cum_j), two decays each
//       at most 1, so a key tile needs 64 exponentials, not 4096; on the
//       diagonal tile directly.
//     - W x: W's fp32 fragment becomes the A operand of the next mma, as
//       FlashAttention-2 does with P, so W never goes through shared memory.
//       A bf16 output leaves no room in its bar for a rounding of W (the one
//       rounding of y takes up to 2**-8 of it), so W is fed as the sum of
//       three bf16 parts, hi + mid + lo (split3), each against the same bf16
//       x fragment: the parts carry 24 significant bits, as fp32 does.
//     - y_inter = exp(cum_i) * (C state^T): exp(cum_i) is a per-row factor,
//       applied to the fp32 accumulator, so C enters exact. A bf16 state is
//       exact too (one mma); an fp32 state is split into three bf16 parts.
//     - new_state = (x * rem)^T B with rem_j = exp(total - cum_j) * dt_j: the
//       decay goes onto x (one fp32 A fragment per k-step, split in three and
//       used against every B fragment of the warp), B enters exact.
//   CTAs: for a chunk of R = ceil(L / 64) row tiles, ceil(R / 2) "y CTAs"
//   each take two row tiles, t and R-1-t, so every y CTA walks R+1 key tiles
//   (the diagonal balanced), and "state CTAs" compute the (P, N) new state
//   (two at P = 64, each half of its columns). 4 warps per CTA; B/x tiles
//   of 64 positions are double buffered with 16-byte cp.async where the
//   layout allows it, the key tiles of a y CTA's two row tiles as one
//   stream; a bf16 state is copied the same way, once per y CTA, and read
//   with ldmatrix like B.
// * fp32 x/B/C: `ssd_chunk_fp32_kernel`, the first version's CUDA-core kernel
//   (fp32 FMAs; the products of fp32 inputs would need three-way splits on
//   both sides).
//
// Both kernels take the prefix sum in float64 with a warp-shuffle scan, as
// the plain version takes its torch.cumsum in float64: in float64 the order
// moves the sum by ~1e-14 of it, far below one float32 rounding, where at
// |cum| ~ 180 an fp32 prefix sum would carry ~1e-5 of error into every decay.
//
// B and C are read through explicit element strides, so the one group of
// mamba2 reaches all heads through a head stride of 0 and is never copied per
// head; x, dt, dA and the state are strided as well. Any L from 1 to 256: rows
// and key positions past L load as zero and are never written.
//
// Not done here (left for later work): wgmma, and one launch per prefill (the
// chunk loop inside the kernel).
//
// Plain C interface; the Python wrapper (kernels/ssd_chunk.py) loads the
// shared library with ctypes and passes pointers, strides and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_tc.cuh"

namespace {

// element strides, in this order: x (b, l, h, p), dt (b, l, h), dA (b, l, h),
// B (b, l, h, n), C (b, l, h, n), state (b, h, p, n)
constexpr int kStrides = 22;
struct Strides {
  int64_t v[kStrides];
  __host__ __device__ const int64_t* x() const { return v; }
  __host__ __device__ const int64_t* dt() const { return v + 4; }
  __host__ __device__ const int64_t* da() const { return v + 7; }
  __host__ __device__ const int64_t* b() const { return v + 10; }
  __host__ __device__ const int64_t* c() const { return v + 14; }
  __host__ __device__ const int64_t* s() const { return v + 18; }
};

// ---------------------------------------------------------------------------
// fp32 x/B/C: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileI = 64;  // query rows per y CTA
constexpr int kTileJ = 64;  // key positions per step
constexpr int kLdW = kTileJ + 4;  // row stride of the W tile (16-byte rows)
constexpr int kStateCols = 32;  // new-state columns per state CTA

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
  return sizeof(double) * (kMaxL + kWarps) + sizeof(float) * kMaxL +
         sizeof(float) * (2 * kTileI * row_stride(n) + kTileJ * p + kTileI * kLdW);
}

template <typename TX, typename TS, int P>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_fp32_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ dA, const TX* __restrict__ bm,
                      const TX* __restrict__ cm, const TS* __restrict__ state,
                      TX* __restrict__ y, TS* __restrict__ new_state, int L,
                      int H, int N, Strides st) {
  static_assert(kThreads % P == 0 && P % kWarps == 0 && P <= kTileJ,
                "unsupported head dim");
  constexpr int kRowStep = kThreads / P;    // rows one pass of the CTA covers
  constexpr int kOut = kTileI / kRowStep;   // y outputs per thread
  constexpr int kStateRows = P / kWarps;    // new-state rows per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = row_stride(N);
  const int n4 = pad4(N);
  double* cum = reinterpret_cast<double*>(smem_raw);  // [kMaxL]
  double* warp_tot = cum + kMaxL;                      // [kWarps]
  float* dts = reinterpret_cast<float*>(warp_tot + kWarps);  // [kMaxL]
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

  for (int l = tid; l < L; l += kThreads) dts[l] = dtb[l * st.dt()[1]];
  prefix_sum_f64<kThreads>(dab, st.da()[1], L, cum, warp_tot);

  if (tile >= row_tiles) {
    // ---- kStateCols columns of the new state:
    // new_state[p][n] = state[p][n] exp(total) + sum_j x[j][p] B[j][n] rem_j
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

// ---------------------------------------------------------------------------
// bf16 x/B/C: tensor cores
// ---------------------------------------------------------------------------

// shared memory of the tensor-core kernel, in bytes from its start: cum,
// the warps' scan totals, dt, the column decays; the C tile; the state tile
// (bf16 [64][ldc] rows p, or fp32 [P][lds]); the two stages of the key ring.
// N is padded to a multiple of 16 (pad16); the bf16 row stride of the C and
// B tiles, and of the x tile, is 8 elements more, so the 8 rows that one
// ldmatrix matrix reads start 16 bytes apart in the banks; the fp32 state
// tile's row stride is npad + 8 floats, so a half-warp's 8-byte loads from 4
// rows hit 32 distinct banks
struct TcLayout {
  int npad, ldc, ldx, lds;
  size_t cs, sts, region, stage_b, stage_x, stage, total;
  __host__ __device__ TcLayout(int p, int n, bool fp32_state) {
    npad = pad16(n);
    ldc = npad + 8;
    ldx = p + 8;
    lds = npad + 8;
    cs = sizeof(double) * (kMaxL + kTcWarps) + sizeof(float) * 2 * kMaxL;
    sts = cs + sizeof(bf16) * kTcTile * ldc;
    region = sts + (fp32_state ? sizeof(float) * p * lds : sizeof(bf16) * kTcTile * ldc);
    stage_b = sizeof(bf16) * kTcTile * ldc;
    stage_x = sizeof(bf16) * kTcTile * ldx;
    stage = stage_b + stage_x;
    total = region + 2 * stage;
  }
};

// vec flags of the TC kernel: which of x, B, C and the state load by cp.async
constexpr int kVecX = 1, kVecB = 2, kVecC = 4, kVecS = 8;

// new-state CTAs per (b, h): at P = 64 the (P, N) state is split by columns
// over two CTAs, so their k-loop is as long as a y CTA's
template <int P>
struct StateCtas {
  static constexpr int value = P == 64 ? 2 : 1;
};

template <typename TS, int P>
__global__ void __launch_bounds__(kTcThreads)
ssd_chunk_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ dA, const bf16* __restrict__ bm,
                    const bf16* __restrict__ cm, const TS* __restrict__ state,
                    bf16* __restrict__ y, TS* __restrict__ new_state, int L,
                    int H, int N, int vec, Strides st) {
  static_assert(P % 8 == 0 && P <= 64, "unsupported head dim");
  constexpr int PT = P / 8;                 // n8 tiles of y along p
  constexpr int MT = (P + 15) / 16;         // m16 tiles of the new state
  constexpr int SC = StateCtas<P>::value;
  constexpr int NTC = kMaxN / 8 / SC;       // new-state n8 tiles per state CTA
  constexpr int NTW = NTC * MT / kTcWarps;  // new-state n8 tiles per warp
  constexpr int KMAX = kMaxN / 16;          // k-steps of C B^T at most
  constexpr bool kExactState = IsBf16<TS>::value;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcLayout lay(P, N, !kExactState);
  double* cum = reinterpret_cast<double*>(smem_raw);  // [kMaxL]
  double* warp_tot = cum + kMaxL;                      // [kTcWarps]
  float* dts = reinterpret_cast<float*>(warp_tot + kTcWarps);  // [kMaxL]
  float* cfac = dts + kMaxL;  // [kMaxL]: exp(cum_i0 - cum_j) dt_j, j < i0
  bf16* cs = reinterpret_cast<bf16*>(smem_raw + lay.cs);
  const bf16* sts16 = reinterpret_cast<const bf16*>(smem_raw + lay.sts);  // bf16 state
  float* sts = reinterpret_cast<float*>(smem_raw + lay.sts);              // fp32 state
  unsigned char* region = smem_raw + lay.region;
  const int ldc = lay.ldc, ldx = lay.ldx, lds = lay.lds;
  const int nk = lay.npad / 16;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;  // fragment row and column pair
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int row_tiles = (L + kTcTile - 1) / kTcTile;
  const int y_ctas = (row_tiles + 1) / 2;

  const bf16* xb = x + b * st.x()[0] + h * st.x()[2];
  const float* dtb = dt + b * st.dt()[0] + h * st.dt()[2];
  const float* dab = dA + b * st.da()[0] + h * st.da()[2];
  const bf16* bb = bm + b * st.b()[0] + h * st.b()[2];
  const bf16* cb = cm + b * st.c()[0] + h * st.c()[2];
  const TS* sb = state + b * st.s()[0] + h * st.s()[1];

  auto stage_b = [&](int s) {
    return reinterpret_cast<bf16*>(region + s * lay.stage);
  };
  auto stage_x = [&](int s) {
    return reinterpret_cast<bf16*>(region + s * lay.stage + lay.stage_b);
  };
  // key tile kt into stage s: x, and B's columns [b0, b0 + nb)
  auto load_keys = [&](int kt, int s, int b0 = 0, int nb = kMaxN) {
    load_tile(stage_b(s), ldc, bb + b0 * st.b()[3], st.b()[1], st.b()[3],
              kt * kTcTile, L, min(nb, N - b0), vec & kVecB);
    load_tile(stage_x(s), ldx, xb, st.x()[1], st.x()[3], kt * kTcTile, L, P,
              vec & kVecX);
  };
  auto load_c = [&](int rt) {
    load_tile(cs, ldc, cb, st.c()[1], st.c()[3], rt * kTcTile, L, N, vec & kVecC);
  };

  // the tiles' padding columns stay zero from here on
  zero_smem(smem_raw + lay.cs, lay.total - lay.cs);
  __syncthreads();
  // the first copies do not need the prefix sum, so they fly during it; a
  // state CTA needs B's columns of its n8 tiles [ncta0, ncta0 + NTC) only
  const int ncta0 = NTC * (blockIdx.y - y_ctas);
  if (blockIdx.y >= y_ctas) {
    load_keys(0, 0, 8 * ncta0, 8 * NTC);
  } else {
    // the first row tile's C, the state (once for both row tiles), key tile 0
    load_c(blockIdx.y);
    if constexpr (kExactState) {
      load_tile(reinterpret_cast<bf16*>(smem_raw + lay.sts), ldc, sb, st.s()[2],
                st.s()[3], 0, P, N, vec & kVecS);
    } else {
      load_state(sts, lds, sb, st.s()[2], st.s()[3], P, N);
    }
    load_keys(0, 0);
  }
  cp_async_commit();
  for (int l = tid; l < L; l += kTcThreads) dts[l] = dtb[l * st.dt()[1]];
  prefix_sum_f64<kTcThreads>(dab, st.da()[1], L, cum, warp_tot);

  if (blockIdx.y >= y_ctas) {
    // ---- the new state: new_state = state exp(total) + (x rem)^T B
    const double total = cum[L - 1];
    float* rem = dts;  // rem_j = exp(total - cum_j) dt_j in place of dt_j
    for (int l = tid; l < kMaxL; l += kTcThreads) {
      rem[l] = l < L ? expf(static_cast<float>(total - cum[l])) * dts[l] : 0.f;
    }
    const int m0 = 16 * (warp % MT);
    const int nt0 = ncta0 + NTW * (warp / MT);
    const int ntiles = lay.npad / 8;
    float acc[NTW][4];
#pragma unroll
    for (int t = 0; t < NTW; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

    for (int kt = 0; kt < row_tiles; ++kt) {
      if (kt + 1 < row_tiles) load_keys(kt + 1, (kt + 1) & 1, 8 * ncta0, 8 * NTC);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* bs = stage_b(kt & 1);
      const bf16* xs = stage_x(kt & 1);
#pragma unroll
      for (int ks = 0; ks < kTcTile / 16; ++ks) {
        const int jb = kt * kTcTile + 16 * ks;  // first key position of the step
        if (jb >= L) break;
        // A = (x rem)^T: rows p, columns j
        uint32_t a[4], ahi[4], amid[4], alo[4];
        ldsm_x4_t(a, xs + (16 * ks + (lane % 8) + 8 * (lane / 16)) * ldx + m0 +
                         8 * ((lane / 8) % 2));
        const float r0 = rem[jb + 2 * c4], r1 = rem[jb + 2 * c4 + 1];
        const float r8 = rem[jb + 2 * c4 + 8], r9 = rem[jb + 2 * c4 + 9];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = bf2_to_f2(a[q]);
          const bool upper = q >= 2;
          split3(f.x * (upper ? r8 : r0), f.y * (upper ? r9 : r1), ahi[q],
                 amid[q], alo[q]);
        }
#pragma unroll
        for (int t = 0; t < NTW; t += 2) {
          const int nt = nt0 + t;
          if (nt >= ntiles) break;
          uint32_t bfr[4];
          ldsm_x4_t(bfr, bs + (16 * ks + (lane % 8) + 8 * ((lane / 8) % 2)) * ldc +
                             8 * (nt - ncta0) + 8 * (lane / 16));
          mma(acc[t], ahi, bfr[0], bfr[1]);
          mma(acc[t + 1], ahi, bfr[2], bfr[3]);
          mma(acc[t], amid, bfr[0], bfr[1]);
          mma(acc[t + 1], amid, bfr[2], bfr[3]);
          mma(acc[t], alo, bfr[0], bfr[1]);
          mma(acc[t + 1], alo, bfr[2], bfr[3]);
        }
      }
      __syncthreads();  // stage kt & 1 is refilled next
    }
    const float decay = expf(static_cast<float>(total));
    TS* nsb = new_state + (static_cast<int64_t>(b) * H + h) * P * N;
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = m0 + g + 8 * (e / 2);
        const int n = 8 * (nt0 + t) + 2 * c4 + (e % 2);
        if (pp < P && n < N) {
          const int64_t idx = static_cast<int64_t>(pp) * N + n;
          const float s0 = to_f32(sb[pp * st.s()[2] + n * st.s()[3]]);
          store(nsb + idx, s0 * decay + acc[t][e]);
        }
      }
    }
    return;
  }

  // ---- row tiles t and row_tiles-1-t: y = exp(cum_i) C state^T + W x.
  // The key tiles of both row tiles stream through the ring as one sequence
  // (q counts them), so the first key tile and the C tile of the second row
  // tile load while the first row tile's last key tile is in use.
  const int n_pass = blockIdx.y == row_tiles - 1 - blockIdx.y ? 1 : 2;
  int q = 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int rt = pass == 0 ? blockIdx.y : row_tiles - 1 - blockIdx.y;
    const int i0 = rt * kTcTile;
    const int wr0 = i0 + 16 * warp;        // this warp's first row
    const bool live = wr0 < L;             // uniform over the warp
    const int jmax = min(wr0 + 15, L - 1);  // the last key any of its rows sees
    const int ia = wr0 + g, ib = wr0 + g + 8;

    cp_async_wait<0>();
    __syncthreads();  // this row tile's C (and the state, key tile 0) landed

    uint32_t cfr[KMAX][4];
    float acc[PT][4];
#pragma unroll
    for (int t = 0; t < PT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
        if (kk < nk) {
          ldsm_x4(cfr[kk], cs + (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * ldc +
                               16 * kk + 8 * (lane / 16));
        }
      }
      // C state^T: B fragment (k = n, column = p) from the state tile
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
        if (kk >= nk) break;
        if constexpr (kExactState && PT == 1) {
          uint32_t bfr[2];
          ldsm_x2(bfr, sts16 + (lane % 8) * ldc + 16 * kk + 8 * ((lane / 8) % 2));
          mma(acc[0], cfr[kk], bfr[0], bfr[1]);
        } else if constexpr (kExactState) {
#pragma unroll
          for (int t = 0; t < PT; t += 2) {
            uint32_t bfr[4];
            ldsm_x4(bfr, sts16 + (8 * t + (lane % 8) + 8 * (lane / 16)) * ldc + 16 * kk +
                             8 * ((lane / 8) % 2));
            mma(acc[t], cfr[kk], bfr[0], bfr[1]);
            mma(acc[t + 1], cfr[kk], bfr[2], bfr[3]);
          }
        } else {
#pragma unroll
          for (int t = 0; t < PT; ++t) {
            const float* sp = sts + (8 * t + g) * lds + 16 * kk + 2 * c4;
            const float2 lo8 = *reinterpret_cast<const float2*>(sp);
            const float2 hi8 = *reinterpret_cast<const float2*>(sp + 8);
            uint32_t b0[3], b1[3];
            split3(lo8.x, lo8.y, b0[0], b0[1], b0[2]);
            split3(hi8.x, hi8.y, b1[0], b1[1], b1[2]);
#pragma unroll
            for (int part = 0; part < 3; ++part) mma(acc[t], cfr[kk], b0[part], b1[part]);
          }
        }
      }
      const float e_top = ia < L ? expf(static_cast<float>(cum[ia])) : 0.f;
      const float e_bot = ib < L ? expf(static_cast<float>(cum[ib])) : 0.f;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] *= e < 2 ? e_top : e_bot;
      }
    }
    const double cum_a = ia < L ? cum[ia] : 0.0;
    const double cum_b = ib < L ? cum[ib] : 0.0;
    // below the diagonal (j < i0 <= i) the decay is the product of two
    // decays, exp(cum_i - cum_i0) * exp(cum_i0 - cum_j), each at most 1, so
    // the 4096 exponentials of a key tile become 64 + 2 per thread; on the
    // diagonal it is taken directly
    const float ra = ia < L ? expf(static_cast<float>(cum_a - cum[i0])) : 0.f;
    const float rb = ib < L ? expf(static_cast<float>(cum_b - cum[i0])) : 0.f;
    for (int l = tid; l < i0; l += kTcThreads) {
      cfac[l] = expf(static_cast<float>(cum[i0] - cum[l])) * dts[l];
    }
    __syncthreads();  // cfac is written; every warp holds its C fragments

    for (int kt = 0; kt <= rt; ++kt, ++q) {
      // the next key tile of the sequence, and with the first one of the
      // first pass, the second row tile's C
      if (kt < rt) {
        load_keys(kt + 1, (q + 1) & 1);
      } else if (pass + 1 < n_pass) {
        load_keys(0, (q + 1) & 1);
      }
      if (kt == 0 && pass + 1 < n_pass) load_c(row_tiles - 1 - blockIdx.y);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int j0 = kt * kTcTile;
      if (live) {
        const bf16* bs = stage_b(q & 1);
        const bf16* xs = stage_x(q & 1);
        // S = C B^T over 16 key positions (two n8 tiles) at a time
        float s[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
        // the k-loop outside, so each step has 8 independent mma; below the
        // diagonal every block of 16 keys counts, on it the first njp
        const int njp = min(4, (jmax - j0) / 16 + 1);
        auto s_block = [&](int jp, int kk) {
          uint32_t bfr[4];
          ldsm_x4(bfr, bs + (16 * jp + (lane % 8) + 8 * (lane / 16)) * ldc + 16 * kk +
                           8 * ((lane / 8) % 2));
          mma(s[2 * jp], cfr[kk], bfr[0], bfr[1]);
          mma(s[2 * jp + 1], cfr[kk], bfr[2], bfr[3]);
        };
        if (njp == 4) {
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk) {
            if (kk < nk) {
#pragma unroll
              for (int jp = 0; jp < 4; ++jp) s_block(jp, kk);
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk) {
            if (kk < nk) {
#pragma unroll
              for (int jp = 0; jp < 4; ++jp) {
                if (jp < njp) s_block(jp, kk);
              }
            }
          }
        }
        // W = S exp(cum_i - cum_j) dt_j for j <= i, in the fragment, then
        // y += W x with W as hi + mid + lo, 16 keys at a time
        auto wx_block = [&](int jp, auto diag) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = 2 * jp + half;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ia : ib;
              const int j = j0 + 8 * t + 2 * c4 + (e % 2);
              if constexpr (decltype(diag)::value) {
                const double ci = e < 2 ? cum_a : cum_b;
                const bool keep_w = j <= i && i < L;
                s[t][e] = keep_w ? s[t][e] * expf(static_cast<float>(ci - cum[j])) * dts[j]
                                 : 0.f;
              } else {
                s[t][e] *= (e < 2 ? ra : rb) * cfac[j];
              }
            }
          }
          uint32_t whi[4], wmid[4], wlo[4];
          split3(s[2 * jp][0], s[2 * jp][1], whi[0], wmid[0], wlo[0]);
          split3(s[2 * jp][2], s[2 * jp][3], whi[1], wmid[1], wlo[1]);
          split3(s[2 * jp + 1][0], s[2 * jp + 1][1], whi[2], wmid[2], wlo[2]);
          split3(s[2 * jp + 1][2], s[2 * jp + 1][3], whi[3], wmid[3], wlo[3]);
          const bf16* xrow = xs + (16 * jp + (lane % 8) + 8 * ((lane / 8) % 2)) * ldx;
          if constexpr (PT == 1) {
            uint32_t xf[2];
            ldsm_x2_t(xf, xrow);
            mma(acc[0], whi, xf[0], xf[1]);
            mma(acc[0], wmid, xf[0], xf[1]);
            mma(acc[0], wlo, xf[0], xf[1]);
          } else {
#pragma unroll
            for (int t = 0; t < PT; t += 2) {
              uint32_t xf[4];
              ldsm_x4_t(xf, xrow + 8 * t + 8 * (lane / 16));
              mma(acc[t], whi, xf[0], xf[1]);
              mma(acc[t + 1], whi, xf[2], xf[3]);
              mma(acc[t], wmid, xf[0], xf[1]);
              mma(acc[t + 1], wmid, xf[2], xf[3]);
              mma(acc[t], wlo, xf[0], xf[1]);
              mma(acc[t + 1], wlo, xf[2], xf[3]);
            }
          }
        };
        // straight-line where every block counts, so their work can overlap
        const std::true_type on_diagonal;
        const std::false_type below_diagonal;
        if (kt < rt) {
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) wx_block(jp, below_diagonal);
        } else if (njp == 4) {
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) wx_block(jp, on_diagonal);
        } else {
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (jp < njp) wx_block(jp, on_diagonal);
          }
        }
      }
      __syncthreads();  // stage q & 1 is refilled next
    }
    if (live) {
      bf16* yb = y + (static_cast<int64_t>(b) * L * H + h) * P;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int pp = 8 * t + 2 * c4;
        if (ia < L) {
          *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<int64_t>(ia) * H * P + pp) =
              __floats2bfloat162_rn(acc[t][0], acc[t][1]);
        }
        if (ib < L) {
          *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<int64_t>(ib) * H * P + pp) =
              __floats2bfloat162_rn(acc[t][2], acc[t][3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename TX, typename TS, int P>
cudaError_t launch(int batch, int L, int H, int N, const void* x,
                   const float* dt, const float* dA, const void* bm,
                   const void* cm, const void* state, void* y, void* new_state,
                   const Strides& st, cudaStream_t stream) {
  if constexpr (IsBf16<TX>::value) {
    const size_t smem = TcLayout(P, N, !IsBf16<TS>::value).total;
    static size_t opted_in = 0;  // per instantiation
    const cudaError_t err = opt_in(ssd_chunk_tc_kernel<TS, P>, smem, opted_in);
    if (err != cudaSuccess) return err;
    const int vec = (rows_vectorizable(x, st.x(), P) ? kVecX : 0) |
                    (rows_vectorizable(bm, st.b(), N) ? kVecB : 0) |
                    (rows_vectorizable(cm, st.c(), N) ? kVecC : 0) |
                    (rows_vectorizable(state, st.s(), N) ? kVecS : 0);
    const int row_tiles = (L + kTcTile - 1) / kTcTile;
    const dim3 grid(batch * H, (row_tiles + 1) / 2 + StateCtas<P>::value);
    ssd_chunk_tc_kernel<TS, P><<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(x), dt, dA, static_cast<const bf16*>(bm),
        static_cast<const bf16*>(cm), static_cast<const TS*>(state),
        static_cast<bf16*>(y), static_cast<TS*>(new_state), L, H, N, vec, st);
  } else {
    const size_t smem = smem_bytes(P, N);
    static size_t opted_in = 0;  // per instantiation
    const cudaError_t err = opt_in(ssd_chunk_fp32_kernel<TX, TS, P>, smem, opted_in);
    if (err != cudaSuccess) return err;
    const int row_tiles = (L + kTileI - 1) / kTileI;
    const int state_tiles = (N + kStateCols - 1) / kStateCols;
    const dim3 grid(batch * H, row_tiles + state_tiles);
    ssd_chunk_fp32_kernel<TX, TS, P><<<grid, kThreads, smem, stream>>>(
        static_cast<const TX*>(x), dt, dA, static_cast<const TX*>(bm),
        static_cast<const TX*>(cm), static_cast<const TS*>(state),
        static_cast<TX*>(y), static_cast<TS*>(new_state), L, H, N, st);
  }
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
      return dispatch_p<TX, bf16>(p, batch, L, H, N, x, dt, dA, bm, cm, state,
                                  y, new_state, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16 (x/B/C share one; the state has its
// own). dt and dA are float32. `strides` holds 22 element strides: x (b,l,h,p),
// dt (b,l,h), dA (b,l,h), B (b,l,h,n), C (b,l,h,n), state (b,h,p,n). y is
// written contiguous (B, L, H, P), new_state contiguous (B, H, P, N).
// bf16 x/B/C run on the tensor cores, fp32 x/B/C on the CUDA cores.
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
      return dispatch_s<bf16>(state_dtype, P, batch, L, H, N, x, dtf, daf, bm,
                              cm, state, y, new_state, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory one CTA of the instantiation (x_dtype,
// state_dtype, p) requests at launch for n state columns: TcLayout(p, n)
// for bf16 x/B/C, smem_bytes(p, n) for fp32. 0 for an instantiation that
// does not exist. A size query only; kernels/smem_plan.py plans the same
// working set with the paper's planner.
extern "C" int64_t ssd_chunk_smem_bytes(int x_dtype, int state_dtype, int p,
                                        int n) {
  if ((state_dtype != 0 && state_dtype != 1) || (p != 8 && p != 32 && p != 64) ||
      n < 1 || n > kMaxN) {
    return 0;
  }
  switch (x_dtype) {
    case 0:
      return static_cast<int64_t>(smem_bytes(p, n));
    case 1:
      return static_cast<int64_t>(TcLayout(p, n, state_dtype == 0).total);
    default:
      return 0;
  }
}
