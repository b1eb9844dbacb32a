// The backward of one Mamba2 SSD chunk per (batch, head), for sm_90a.
//
// The gradient of the Pallas TPU kernel `ssd_chunk` (src/repro/kernels/
// ssd_chunk.py, body `_kernel`), whose forward is csrc/ssd_chunk.cu. The
// reference has no backward kernel: its trainer differentiates its XLA
// chunk scan. The port's forward is a hand-written kernel, so its gradient
// is one too. For one (b, h), a chunk of L <= 256 positions, with
// cum = cumsum(dA) (float64), total = cum[L-1], S = C B^T,
// decay_ij = exp(cum_i - cum_j) for j <= i (0 above the diagonal),
// W = S * decay * dt_j, rem_j = exp(total - cum_j) * dt_j, and the upstream
// gradients dy (L, P) and dns (P, N):
//   dW = dy x^T,  dS = dW * decay * dt_j,  H = dW * S * decay
//   dx     = W^T dy + rem * (B dns^T)
//   dC     = dS B + exp(cum) * (dy state)
//   dB     = dS^T C + rem * (x dns)
//   ddt_j  = sum_i H_ij + exp(total - cum_j) * drem_j,  drem_j = x_j . (B_j dns^T)
//   dcum_i = sum_j H_ij dt_j - sum_k H_ki dt_i + exp(cum_i) dy_i . (C_i state^T)
//            - drem_i rem_i  (+ dtotal at i = L-1)
//   dtotal = sum_j drem_j rem_j + exp(total) sum(state * dns)
//   ddA    = reverse cumsum(dcum), in float64
//   dstate = exp(total) dns + sum_i exp(cum_i) dy_i^T C_i
// (kernels/ref.ssd_chunk_bwd_ref computes the same in plain PyTorch).
// Masked decays are exact zeros, never exp(+inf), so no 0 * inf reaches
// dcum. The decays are exp of float32(cum_i - cum_j), as in the forward.
//
// Design (a simple kernel, CUDA-core fp32 FMAs): one CTA of 256 threads per
// (b, h). The L x L products are walked in 64 x 64 tiles, S and dW
// recomputed from shared-memory tiles of C, dy (the row tile) and B, x (the
// key tile), in two passes:
//   pass 1, key tile J outer, row tiles I >= J inner: dx_J and dB_J in
//           registers, the column sums of H; then the dns terms of dx_J,
//           dB_J and ddt_J;
//   pass 2, row tile I outer, key tiles J <= I inner: dC_I in registers,
//           the row sums of H dt; then the state terms of dC_I and
//           dcum, and dstate += exp(cum_I) dy_I^T C_I (registers across I).
// S and dW are computed twice (once per pass), so the CTA does about
// 5N + 3P FMAs per causal (i, j) pair where 3N + 2P are needed. Everything
// is fp32 in shared memory whatever the input dtypes.
//
// What bounds it on an H100: at mamba2-2.7b's prefill chunk (L=256, H=80,
// P=64, N=128, bf16 in and out, bf16 state; B and C one group at head
// stride 0, read once; dB and dC written per head) the function moves
// ~22.7 MB (~6.8 us at 3.35 TB/s) and needs ~4.0 GFLOP for the causal half
// of its five L x L products and its four L x P x N ones (~4.1 us on bf16
// tensor cores, ~60 us on fp32 CUDA cores): launch/roofline.kernel_bound.
// This kernel is bound by its fp32 FMAs and shared-memory reads, with 80
// CTAs on 132 SMs. The tensor cores and a recompute fused into the forward
// are later work (ROADMAP B2.5).
//
// Inputs are read through explicit element strides (B and C at head stride
// 0 for one group; x, B, C views into the conv output; dy a slice of the
// concatenated gradient). Outputs are written contiguous: dx (B,L,H,P),
// dB and dC (B,L,H,N) in x's dtype, ddt and ddA (B,L,H) fp32, dstate
// (B,H,P,N) in the state's dtype.
//
// Plain C interface; the Python wrapper (kernels/ssd_chunk.py) loads the
// shared library with ctypes and passes pointers, strides and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxL = 256;
constexpr int kMaxN = 128;
constexpr int kThreads = 256;  // one position of the chunk per thread in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // rows (and keys) per tile
constexpr int kLdT = kTile + 1;  // row stride of the W, dS and H tiles
static_assert(kThreads == kMaxL, "the scans give each thread one position");

// element strides, in this order: x (b, l, h, p), dt (b, l, h), dA (b, l, h),
// B (b, l, h, n), C (b, l, h, n), state (b, h, p, n), dy (b, l, h, p),
// dns (b, h, p, n)
constexpr int kStrides = 30;
struct Strides {
  int64_t v[kStrides];
  __host__ __device__ const int64_t* x() const { return v; }
  __host__ __device__ const int64_t* dt() const { return v + 4; }
  __host__ __device__ const int64_t* da() const { return v + 7; }
  __host__ __device__ const int64_t* b() const { return v + 10; }
  __host__ __device__ const int64_t* c() const { return v + 14; }
  __host__ __device__ const int64_t* s() const { return v + 18; }
  __host__ __device__ const int64_t* dy() const { return v + 22; }
  __host__ __device__ const int64_t* dns() const { return v + 26; }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(bf16* dst, float v) { *dst = __float2bfloat16_rn(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a width padded to a multiple of 4 floats, then to an odd number of
// float4s, so eight lanes reading 16 bytes each from eight consecutive rows
// hit 32 distinct banks (the forward's rule)
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int row_stride(int n) {
  return (pad4(n) / 4) % 2 ? pad4(n) : pad4(n) + 4;
}

// Shared memory of one CTA, in bytes from the start: the per-position
// arrays, then the tiles. The key tile (B, x) comes first, then the row
// tile (C, dy) and the W, dS and H tiles; after pass 1's row loop dns
// [P][ldn] and dns^T [N][ldp] take the row tile's place, and after pass 2's
// key loop the state [P][ldn] takes the key tile's.
struct Layout {
  size_t cum, dcum, warp_tot, dts, ecum, drr, drem, inter;
  size_t bt, xt, ct, dyt, wt, dst, ht, dns, dnst, st, total;
  __host__ __device__ Layout(int p, int n) {
    const size_t ldn = row_stride(n), ldp = row_stride(p);
    cum = 0;
    dcum = cum + sizeof(double) * kMaxL;
    warp_tot = dcum + sizeof(double) * kMaxL;
    dts = warp_tot + sizeof(double) * kWarps;
    ecum = dts + sizeof(float) * kMaxL;
    drr = ecum + sizeof(float) * kMaxL;
    drem = drr + sizeof(float) * kMaxL;
    inter = drem + sizeof(float) * kTile;
    bt = inter + sizeof(float) * kTile;
    xt = bt + sizeof(float) * kTile * ldn;
    ct = xt + sizeof(float) * kTile * ldp;
    dyt = ct + sizeof(float) * kTile * ldn;
    wt = dyt + sizeof(float) * kTile * ldp;
    dst = wt + sizeof(float) * kTile * kLdT;
    ht = dst + sizeof(float) * kTile * kLdT;
    dns = ct;
    dnst = dyt;
    st = bt;
    const size_t tiles_end = ht + sizeof(float) * kTile * kLdT;
    const size_t dnst_end = dnst + sizeof(float) * n * ldp;
    total = tiles_end > dnst_end ? tiles_end : dnst_end;
  }
};

// cum[l] = dA[0] + ... + dA[l] in float64 for l < L, one position per
// thread: a warp-shuffle scan, the warps' totals through `warp_tot`
__device__ void prefix_sum_f64(const float* dab, int64_t stride, int L,
                               double* cum, double* warp_tot) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const double v = tid < L ? static_cast<double>(dab[tid * stride]) : 0.0;
  double x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  double base = 0.0;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  if (tid < L) cum[tid] = base + x;
  __syncthreads();
}

// a[l] <- a[l] + a[l+1] + ... + a[L-1] in float64, in place: thread t takes
// position L-1-t, so the prefix scan of the reversed array is the suffix sum
__device__ void suffix_sum_f64(double* a, int L, double* warp_tot) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int l = L - 1 - tid;
  double x = l >= 0 ? a[l] : 0.0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  double base = 0.0;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  if (l >= 0) a[l] = base + x;
  __syncthreads();
}

// rows r0 .. r0+63 of a (b, l, h, cols) input into a [64][ld] fp32 tile;
// rows past L and columns past `cols` (up to `pad`) as zero
template <typename T>
__device__ void load_rows(float* tile, int ld, const T* base, const int64_t* s,
                          int r0, int L, int cols, int pad) {
  for (int e = threadIdx.x; e < kTile * pad; e += kThreads) {
    const int r = e / pad, c = e % pad, l = r0 + r;
    tile[r * ld + c] = l < L && c < cols ? to_f32(base[l * s[1] + c * s[3]]) : 0.f;
  }
}

// a (b, h, p, n) input into a [P][ldn] tile and, if `trans`, a [N][ldp] one
template <typename T>
__device__ void load_pn(float* tile, int ldn, float* tile_t, int ldp,
                        const T* base, const int64_t* s, int P, int N, int n4) {
  for (int e = threadIdx.x; e < P * n4; e += kThreads) {
    const int p = e / n4, n = e % n4;
    const float v = n < N ? to_f32(base[p * s[2] + n * s[3]]) : 0.f;
    tile[p * ldn + n] = v;
    if (tile_t != nullptr && n < N) tile_t[n * ldp + p] = v;
  }
}

// The (i0, j0) tile pair: S = C_I B_J^T and dW = dy_I x_J^T, 4 x 4 entries a
// thread, then W (if `wt`), dS and H, zero where j > i or i >= L
template <int P>
__device__ void pair_tile(const float* ct, const float* bt, const float* dyt,
                          const float* xt, int ldn, int n4, const double* cum,
                          const float* dts, int i0, int j0, int L, float* wt,
                          float* dst, float* ht) {
  constexpr int ldp = row_stride(P);
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float s[4][4], dw[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dw[r][c] = 0.f;
  for (int nn = 0; nn < n4; nn += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = ld4(ct + (ti + 16 * r) * ldn + nn);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = ld4(bt + (tj + 16 * c) * ldn + nn);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dot4(cv[r], bv[c], s[r][c]);
  }
#pragma unroll 4
  for (int pp = 0; pp < P; pp += 4) {
    float4 dv[4], xv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) dv[r] = ld4(dyt + (ti + 16 * r) * ldp + pp);
#pragma unroll
    for (int c = 0; c < 4; ++c) xv[c] = ld4(xt + (tj + 16 * c) * ldp + pp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dw[r][c] = dot4(dv[r], xv[c], dw[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ri = ti + 16 * r, cj = tj + 16 * c;
      const int i = i0 + ri, j = j0 + cj;
      float w = 0.f, ds = 0.f, hv = 0.f;
      if (j <= i && i < L) {
        const float dec = expf(static_cast<float>(cum[i] - cum[j]));
        w = s[r][c] * dec * dts[j];
        ds = dw[r][c] * dec * dts[j];
        hv = dw[r][c] * s[r][c] * dec;
      }
      if (wt != nullptr) wt[ri * kLdT + cj] = w;
      dst[ri * kLdT + cj] = ds;
      ht[ri * kLdT + cj] = hv;
    }
  }
}

template <typename TX, typename TS, int P>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ dA, const TX* __restrict__ bm,
                     const TX* __restrict__ cm, const TS* __restrict__ state,
                     const TX* __restrict__ dy, const TS* __restrict__ dns,
                     TX* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ ddA, TX* __restrict__ dbm,
                     TX* __restrict__ dcm, TS* __restrict__ dstate, int L,
                     int H, int N, Strides st) {
  static_assert(P == 8 || P == 32 || P == 64, "unsupported head dim");
  constexpr int ldp = row_stride(P);
  constexpr int kColsP = (P + 31) / 32;  // p columns of a lane: lane + 32c
  constexpr int kRowsP = (P + 7) / 8;    // state rows of a warp: warp + 8a
  constexpr int kColsN = kMaxN / 32;     // n columns of a lane: lane + 32c

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay(P, N);
  double* cum = reinterpret_cast<double*>(smem_raw + lay.cum);
  double* dcum = reinterpret_cast<double*>(smem_raw + lay.dcum);
  double* warp_tot = reinterpret_cast<double*>(smem_raw + lay.warp_tot);
  float* dts = reinterpret_cast<float*>(smem_raw + lay.dts);
  float* ecum = reinterpret_cast<float*>(smem_raw + lay.ecum);
  float* drr = reinterpret_cast<float*>(smem_raw + lay.drr);
  float* drem_s = reinterpret_cast<float*>(smem_raw + lay.drem);
  float* inter_s = reinterpret_cast<float*>(smem_raw + lay.inter);
  float* bt = reinterpret_cast<float*>(smem_raw + lay.bt);
  float* xt = reinterpret_cast<float*>(smem_raw + lay.xt);
  float* ct = reinterpret_cast<float*>(smem_raw + lay.ct);
  float* dyt = reinterpret_cast<float*>(smem_raw + lay.dyt);
  float* wt = reinterpret_cast<float*>(smem_raw + lay.wt);
  float* dst = reinterpret_cast<float*>(smem_raw + lay.dst);
  float* ht = reinterpret_cast<float*>(smem_raw + lay.ht);
  float* dnss = reinterpret_cast<float*>(smem_raw + lay.dns);
  float* dnst = reinterpret_cast<float*>(smem_raw + lay.dnst);
  float* sts = reinterpret_cast<float*>(smem_raw + lay.st);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int ldn = row_stride(N), n4 = pad4(N);

  const TX* xb = x + b * st.x()[0] + h * st.x()[2];
  const TX* bb = bm + b * st.b()[0] + h * st.b()[2];
  const TX* cb = cm + b * st.c()[0] + h * st.c()[2];
  const TX* dyb = dy + b * st.dy()[0] + h * st.dy()[2];
  const TS* sb = state + b * st.s()[0] + h * st.s()[1];
  const TS* dnb = dns + b * st.dns()[0] + h * st.dns()[1];
  const float* dtb = dt + b * st.dt()[0] + h * st.dt()[2];
  const float* dab = dA + b * st.da()[0] + h * st.da()[2];
  const int64_t row = static_cast<int64_t>(H);  // contiguous outputs: (b, l, h, .)

  dts[tid] = tid < L ? dtb[tid * st.dt()[1]] : 0.f;
  prefix_sum_f64(dab, st.da()[1], L, cum, warp_tot);
  const double total = cum[L - 1];
  ecum[tid] = tid < L ? expf(static_cast<float>(cum[tid])) : 0.f;
  // sum(state * dns), for dtotal's exp(total) term
  float sdot = 0.f;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    sdot = fmaf(to_f32(sb[p * st.s()[2] + n * st.s()[3]]),
                to_f32(dnb[p * st.dns()[2] + n * st.dns()[3]]), sdot);
  }
  sdot = warp_sum(sdot);
  __syncthreads();  // prefix_sum_f64's warp_tot reads are done
  if (lane == 0) warp_tot[warp] = sdot;
  __syncthreads();
  double sdot_all = 0.0;
  for (int w = 0; w < kWarps; ++w) sdot_all += warp_tot[w];
  __syncthreads();

  // ---- pass 1: key tile J outer; dx_J, dB_J, ddt_J and the column terms
  // of dcum
  for (int j0 = 0; j0 < L; j0 += kTile) {
    float dxa[8][kColsP], dba[8][kColsN];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int c = 0; c < kColsP; ++c) dxa[a][c] = 0.f;
#pragma unroll
      for (int c = 0; c < kColsN; ++c) dba[a][c] = 0.f;
    }
    float colh = 0.f;  // thread tid < 64: sum_i H[i][j0 + tid]
    load_rows(bt, ldn, bb, st.b(), j0, L, N, n4);
    load_rows(xt, ldp, xb, st.x(), j0, L, P, P);
    for (int i0 = j0; i0 < L; i0 += kTile) {
      load_rows(ct, ldn, cb, st.c(), i0, L, N, n4);
      load_rows(dyt, ldp, dyb, st.dy(), i0, L, P, P);
      __syncthreads();
      pair_tile<P>(ct, bt, dyt, xt, ldn, n4, cum, dts, i0, j0, L, wt, dst, ht);
      __syncthreads();
      // dx_J += W^T dy_I, dB_J += dS^T C_I: rows j = warp + 8a
      for (int ii = 0; ii < kTile; ++ii) {
        float dyv[kColsP], cv[kColsN];
#pragma unroll
        for (int c = 0; c < kColsP; ++c) {
          const int p = lane + 32 * c;
          dyv[c] = p < P ? dyt[ii * ldp + p] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kColsN; ++c) cv[c] = ct[ii * ldn + min(lane + 32 * c, n4 - 1)];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float w = wt[ii * kLdT + warp + 8 * a];
          const float ds = dst[ii * kLdT + warp + 8 * a];
#pragma unroll
          for (int c = 0; c < kColsP; ++c) dxa[a][c] = fmaf(w, dyv[c], dxa[a][c]);
#pragma unroll
          for (int c = 0; c < kColsN; ++c) dba[a][c] = fmaf(ds, cv[c], dba[a][c]);
        }
      }
      if (tid < kTile) {
        for (int ii = 0; ii < kTile; ++ii) colh += ht[ii * kLdT + tid];
      }
      __syncthreads();
    }
    // the dns terms: dns and dns^T over the row tile's place
    load_pn(dnss, ldn, dnst, ldp, dnb, st.dns(), P, N, n4);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int jj = warp + 8 * a, j = j0 + jj;
      const float rem = j < L ? expf(static_cast<float>(total - cum[j])) * dts[j] : 0.f;
      // (B_j dns^T)[p] for the lane's p, and drem_j = x_j . (B_j dns^T)
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kColsP; ++c) {
        const int p = lane + 32 * c;
        if (p < P) {
          float bd = 0.f;
          for (int n = 0; n < N; ++n) bd = fmaf(bt[jj * ldn + n], dnst[n * ldp + p], bd);
          part = fmaf(xt[jj * ldp + p], bd, part);
          dxa[a][c] = fmaf(rem, bd, dxa[a][c]);
        }
      }
      part = warp_sum(part);
      if (lane == 0) drem_s[jj] = part;
      // (x_j dns)[n] for the lane's n
#pragma unroll
      for (int c = 0; c < kColsN; ++c) {
        const int n = lane + 32 * c;
        if (n < N) {
          float xd = 0.f;
          for (int p = 0; p < P; ++p) xd = fmaf(xt[jj * ldp + p], dnss[p * ldn + n], xd);
          dba[a][c] = fmaf(rem, xd, dba[a][c]);
        }
      }
      if (j < L) {
        const int64_t o = (static_cast<int64_t>(b) * L + j) * row + h;
#pragma unroll
        for (int c = 0; c < kColsP; ++c) {
          const int p = lane + 32 * c;
          if (p < P) store(dx + o * P + p, dxa[a][c]);
        }
#pragma unroll
        for (int c = 0; c < kColsN; ++c) {
          const int n = lane + 32 * c;
          if (n < N) store(dbm + o * N + n, dba[a][c]);
        }
      }
    }
    __syncthreads();
    if (tid < kTile && j0 + tid < L) {
      const int j = j0 + tid;
      const float erem = expf(static_cast<float>(total - cum[j]));
      const float rem = erem * dts[j];
      const float drem = drem_s[tid];
      ddt[(static_cast<int64_t>(b) * L + j) * row + h] = colh + drem * erem;
      drr[j] = drem * rem;
      dcum[j] = -static_cast<double>(dts[j] * colh) - static_cast<double>(drem * rem);
    }
    __syncthreads();
  }

  // ---- pass 2: row tile I outer; dC_I, the row terms of dcum, dstate
  float dsa[kRowsP][kColsN];
#pragma unroll
  for (int a = 0; a < kRowsP; ++a)
#pragma unroll
    for (int c = 0; c < kColsN; ++c) dsa[a][c] = 0.f;
  for (int i0 = 0; i0 < L; i0 += kTile) {
    float dca[8][kColsN];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < kColsN; ++c) dca[a][c] = 0.f;
    float rowg = 0.f;  // thread tid < 64: sum_j H[i0 + tid][j] dt_j
    load_rows(ct, ldn, cb, st.c(), i0, L, N, n4);
    load_rows(dyt, ldp, dyb, st.dy(), i0, L, P, P);
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      load_rows(bt, ldn, bb, st.b(), j0, L, N, n4);
      load_rows(xt, ldp, xb, st.x(), j0, L, P, P);
      __syncthreads();
      pair_tile<P>(ct, bt, dyt, xt, ldn, n4, cum, dts, i0, j0, L, nullptr, dst, ht);
      __syncthreads();
      // dC_I += dS B_J: rows i = warp + 8a
      for (int jj = 0; jj < kTile; ++jj) {
        float bv[kColsN];
#pragma unroll
        for (int c = 0; c < kColsN; ++c) bv[c] = bt[jj * ldn + min(lane + 32 * c, n4 - 1)];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float ds = dst[(warp + 8 * a) * kLdT + jj];
#pragma unroll
          for (int c = 0; c < kColsN; ++c) dca[a][c] = fmaf(ds, bv[c], dca[a][c]);
        }
      }
      if (tid < kTile) {
        for (int jj = 0; jj < kTile; ++jj) rowg = fmaf(ht[tid * kLdT + jj], dts[j0 + jj], rowg);
      }
      __syncthreads();
    }
    // the state terms, the state over the key tile's place
    load_pn(sts, ldn, nullptr, 0, sb, st.s(), P, N, n4);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int ii = warp + 8 * a, i = i0 + ii;
      const float e = i < L ? ecum[i] : 0.f;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kColsN; ++c) {
        const int n = lane + 32 * c;
        if (n < N) {
          float v = 0.f;  // (dy_i state)[n]
          for (int p = 0; p < P; ++p) v = fmaf(dyt[ii * ldp + p], sts[p * ldn + n], v);
          part = fmaf(ct[ii * ldn + n], v, part);
          dca[a][c] = fmaf(e, v, dca[a][c]);
        }
      }
      part = warp_sum(part);
      if (lane == 0) inter_s[ii] = e * part;
      if (i < L) {
        const int64_t o = (static_cast<int64_t>(b) * L + i) * row + h;
#pragma unroll
        for (int c = 0; c < kColsN; ++c) {
          const int n = lane + 32 * c;
          if (n < N) store(dcm + o * N + n, dca[a][c]);
        }
      }
    }
    // dstate += sum_i exp(cum_i) dy_i^T C_i: rows p = warp + 8a
    for (int ii = 0; ii < kTile; ++ii) {
      const float e = i0 + ii < L ? ecum[i0 + ii] : 0.f;
      float cv[kColsN];
#pragma unroll
      for (int c = 0; c < kColsN; ++c) cv[c] = ct[ii * ldn + min(lane + 32 * c, n4 - 1)];
#pragma unroll
      for (int a = 0; a < kRowsP; ++a) {
        const int p = warp + 8 * a;
        const float d = p < P ? e * dyt[ii * ldp + p] : 0.f;
#pragma unroll
        for (int c = 0; c < kColsN; ++c) dsa[a][c] = fmaf(d, cv[c], dsa[a][c]);
      }
    }
    __syncthreads();
    if (tid < kTile && i0 + tid < L) {
      dcum[i0 + tid] += static_cast<double>(rowg) + static_cast<double>(inter_s[tid]);
    }
    __syncthreads();
  }

  // ---- dstate = exp(total) dns + the accumulated sum
  const float etot = expf(static_cast<float>(total));
  TS* dsb = dstate + (static_cast<int64_t>(b) * H + h) * P * N;
#pragma unroll
  for (int a = 0; a < kRowsP; ++a) {
    const int p = warp + 8 * a;
#pragma unroll
    for (int c = 0; c < kColsN; ++c) {
      const int n = lane + 32 * c;
      if (p < P && n < N) {
        const float d0 = to_f32(dnb[p * st.dns()[2] + n * st.dns()[3]]);
        store(dsb + p * N + n, fmaf(etot, d0, dsa[a][c]));
      }
    }
  }

  // ---- dtotal at the last position, then ddA = reverse cumsum(dcum)
  if (tid == 0) {
    double dtotal = static_cast<double>(etot) * sdot_all;
    for (int j = 0; j < L; ++j) dtotal += static_cast<double>(drr[j]);
    dcum[L - 1] += dtotal;
  }
  __syncthreads();
  suffix_sum_f64(dcum, L, warp_tot);
  if (tid < L) ddA[(static_cast<int64_t>(b) * L + tid) * row + h] = static_cast<float>(dcum[tid]);
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t& opted_in) {
  if (smem <= opted_in) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) opted_in = smem;
  return err;
}

template <typename TX, typename TS, int P>
cudaError_t launch(int batch, int L, int H, int N, void* const* ptrs,
                   const Strides& st, cudaStream_t stream) {
  const size_t smem = Layout(P, N).total;
  static size_t opted_in = 0;  // per instantiation
  const cudaError_t err = opt_in(ssd_chunk_bwd_kernel<TX, TS, P>, smem, opted_in);
  if (err != cudaSuccess) return err;
  ssd_chunk_bwd_kernel<TX, TS, P><<<batch * H, kThreads, smem, stream>>>(
      static_cast<const TX*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]), static_cast<const TX*>(ptrs[3]),
      static_cast<const TX*>(ptrs[4]), static_cast<const TS*>(ptrs[5]),
      static_cast<const TX*>(ptrs[6]), static_cast<const TS*>(ptrs[7]),
      static_cast<TX*>(ptrs[8]), static_cast<float*>(ptrs[9]),
      static_cast<float*>(ptrs[10]), static_cast<TX*>(ptrs[11]),
      static_cast<TX*>(ptrs[12]), static_cast<TS*>(ptrs[13]), L, H, N, st);
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t dispatch_p(int p, int batch, int L, int H, int N, void* const* ptrs,
                       const Strides& st, cudaStream_t stream) {
  switch (p) {
    case 8:
      return launch<TX, TS, 8>(batch, L, H, N, ptrs, st, stream);
    case 32:
      return launch<TX, TS, 32>(batch, L, H, N, ptrs, st, stream);
    case 64:
      return launch<TX, TS, 64>(batch, L, H, N, ptrs, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t dispatch_s(int state_dtype, int p, int batch, int L, int H, int N,
                       void* const* ptrs, const Strides& st, cudaStream_t stream) {
  switch (state_dtype) {
    case 0:
      return dispatch_p<TX, float>(p, batch, L, H, N, ptrs, st, stream);
    case 1:
      return dispatch_p<TX, bf16>(p, batch, L, H, N, ptrs, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16 (x/B/C/dy share one; the state and dns
// have their own). dt and dA are float32. `ptrs` holds 14 device pointers:
// x, dt, dA, B, C, state, dy, dns (inputs), then dx, ddt, ddA, dB, dC,
// dstate (outputs, contiguous). `strides` holds 30 element strides: x
// (b,l,h,p), dt (b,l,h), dA (b,l,h), B (b,l,h,n), C (b,l,h,n), state
// (b,h,p,n), dy (b,l,h,p), dns (b,h,p,n). Returns a cudaError_t.
extern "C" int ssd_chunk_bwd_launch(int x_dtype, int state_dtype, int batch, int L,
                                    int H, int P, int N, void* const* ptrs,
                                    const int64_t* strides, void* stream) {
  if (batch * H == 0) return cudaSuccess;
  if (L < 1 || L > kMaxL || N < 1 || N > kMaxN) return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < kStrides; ++i) st.v[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return dispatch_s<float>(state_dtype, P, batch, L, H, N, ptrs, st, s);
    case 1:
      return dispatch_s<bf16>(state_dtype, P, batch, L, H, N, ptrs, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory one CTA of the instantiation (x_dtype,
// state_dtype, p) requests at launch for n state columns (`Layout`; the
// same for every dtype pair: the tiles are fp32). 0 for an instantiation
// that does not exist. kernels/smem_plan.py plans the same working set with
// the paper's planner.
extern "C" int64_t ssd_chunk_bwd_smem_bytes(int x_dtype, int state_dtype, int p,
                                            int n) {
  if ((x_dtype != 0 && x_dtype != 1) || (state_dtype != 0 && state_dtype != 1) ||
      (p != 8 && p != 32 && p != 64) || n < 1 || n > kMaxN) {
    return 0;
  }
  return static_cast<int64_t>(Layout(p, n).total);
}
