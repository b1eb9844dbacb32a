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
// Two kernels share this file, by the dtype of x/B/C:
//
// * bf16 x/B/C (what the model trains): `ssd_chunk_bwd_tc_kernel`, its
//   products on the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate; the forward's toolkit, ssd_tc.cuh). Operands:
//     - S = C B^T and dW = dy x^T have bf16 operands on both sides, so every
//       product is exact in fp32;
//     - W, dS, (dy exp(cum))^T and an fp32 state or dns enter as three bf16
//       parts, hi + mid + lo (split3): a bf16 output's bar,
//       1e-4 + (1e-4 + 2**-8) |want|, leaves the arithmetic ~1e-4 |want|
//       once the output's own rounding (2**-8 of it) is paid, and two parts
//       (~2**-17 a term) summed over up to 256 cancelling terms can exceed
//       that (tests/test_torch_ssd_bwd.py measures both);
//     - exp(cum_i), rem_j and the decays are per-row or per-column factors
//       applied to fp32 fragments, so C, B, x and dy enter whole; W and dS
//       go from S's and dW's accumulator fragments straight into the next
//       mma's A fragment (as FlashAttention-2 does with P), never through
//       shared memory; below the diagonal tile a decay is
//       exp(cum_i - cum_I0) exp(cum_I0 - cum_j), two decays each at most 1,
//       as the forward takes it.
//   CTAs: one (b, h) is split over 2 ceil(R / 2) + StateCtas CTAs of 4 warps
//   (R = ceil(L / 64) row tiles; 6 at L = 256, P = 64), so no CTA walks the
//   L x L square twice:
//     - key CTAs take key tiles J, t and R-1-t (so each walks R + 1 tile
//       pairs): over the row tiles I >= J they recompute S^T and dW^T for
//       their keys and accumulate dx_J = W^T dy and dB_J = dS^T C in
//       registers, and the column sums of H; then the dns terms (B dns^T,
//       x dns, drem) and ddt_J;
//     - row CTAs take row tiles I, t and R-1-t: dC_I = exp(cum_I) (dy_I
//       state) + sum over J <= I of dS B_J, and the row sums of H dt;
//     - dstate CTAs: dstate = exp(total) dns + (dy exp(cum))^T C over half
//       the columns each at P = 64, and sum(state * dns).
//   Each CTA recomputes S and dW for its own tiles on the tensor cores, which
//   costs ~8 MFLOP a (b, h) against the 256 KiB a saved S would cost. The
//   tiles are bf16 in shared memory, ring-fed by 16-byte cp.async where the
//   layout allows it (rows_vectorizable), as the forward's.
//   dcum, dtotal and ddA gather the key and row CTAs' partial sums: each CTA
//   writes its own slots of a workspace (allocated by the wrapper with
//   torch.empty, workspace_bytes: 986,240 B at train_mamba2's (2, 256, 80,
//   64, 128)), and the last CTA of a (b, h) to arrive (an int32 count per
//   (b, h), zeroed by the launch on the call's stream) adds them in a fixed
//   order and takes the reverse sum in float64. No float atomic: the result
//   is the same bits from run to run.
// * fp32 x/B/C: `ssd_chunk_bwd_kernel`, the first version's CUDA-core
//   kernel: one CTA of 256 threads per (b, h), fp32 FMAs, S and dW computed
//   in each of two passes over 64 x 64 tiles (pass 1 key tile outer: dx_J,
//   dB_J, the column sums of H and the dns terms; pass 2 row tile outer:
//   dC_I, the row sums of H dt, the state terms and dstate). The products of
//   fp32 inputs would need three-way splits on both sides.
//
// What bounds it on an H100 (launch/roofline.kernel_bound): at mamba2-2.7b's
// prefill chunk (L=256, H=80, P=64, N=128, bf16 in and out, bf16 state; B and
// C one group at head stride 0, read once; dB and dC written per head) the
// function moves 22,740,992 B, 6.79 us at 3.35 TB/s, and needs ~4.0 GFLOP for
// the causal half of its five L x L products and its four L x P x N ones
// (~4.1 us on bf16 tensor cores); at train_mamba2's call (batch 2) 45,481,984
// B, 13.58 us. So it is bound by bytes. The tensor-core kernel does ~2.6x
// the counted FLOPs (S and dW recomputed per CTA set, fp32 operands in three
// parts) on mma.sync, and -Xptxas -v gives its bf16-state instantiation at
// P = 64 255 registers and 20 bytes of spill stores (a 24-byte stack
// frame), so with 102,448 B of shared memory two CTAs (8 warps) share an SM:
// too few warps to hide the ldmatrix -> mma -> split3 chains, and it runs at
// ~19x its bound (126-132 us at mamba2's chunk on an H100, PERF.md). wgmma
// (accumulators a warpgroup shares, operands from shared memory) and TMA
// are the next step.
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

#include <type_traits>

#include "ssd_tc.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// fp32 x/B/C: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // one position of the chunk per thread in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // rows (and keys) per tile
constexpr int kLdT = kTile + 1;  // row stride of the W, dS and H tiles
static_assert(kThreads == kMaxL, "the scans give each thread one position");

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

// a[l] <- a[l] + a[l+1] + ... + a[L-1] in float64 for l < L, in place, over
// the CTA's THREADS threads: thread t takes the positions L-1-(t PER + e),
// so prefix_sum_f64's scan of the reversed array is the suffix sum
template <int THREADS>
__device__ void suffix_sum_f64(double* a, int L, double* warp_tot) {
  constexpr int PER = kMaxL / THREADS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  double v[PER];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int l = L - 1 - (tid * PER + e);
    run += l >= 0 ? a[l] : 0.0;
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
    const int l = L - 1 - (tid * PER + e);
    if (l >= 0) a[l] = base + v[e];
  }
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
  prefix_sum_f64<kThreads>(dab, st.da()[1], L, cum, warp_tot);
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
  suffix_sum_f64<kThreads>(dcum, L, warp_tot);
  if (tid < L) ddA[(static_cast<int64_t>(b) * L + tid) * row + h] = static_cast<float>(dcum[tid]);
}

// ---------------------------------------------------------------------------
// bf16 x/B/C: tensor cores
// ---------------------------------------------------------------------------

// vec flags: which inputs load by 16-byte cp.async
constexpr int kVecX = 1, kVecB = 2, kVecC = 4, kVecDy = 8, kVecS = 16, kVecDns = 32;

// dstate CTAs per (b, h): at P = 64 its (P, N) columns are split over two
// CTAs, as the forward splits its new state
template <int P>
struct StateCtas {
  static constexpr int value = P == 64 ? 2 : 1;
};

// The workspace: one int32 arrival count per (b, h) (zeroed by the launch,
// rounded up to 16 bytes), then kWsDoubles doubles per (b, h): the key CTAs'
// part of dcum, the row CTAs' part, drem_j rem_j, and each dstate CTA's
// sum(state * dns) over its columns. The last CTA of a (b, h) to arrive
// reduces them in a fixed order.
constexpr int kWsKey = 0, kWsRow = kMaxL, kWsDrr = 2 * kMaxL, kWsSdot = 3 * kMaxL;
constexpr int kWsDoubles = 3 * kMaxL + 2;
__host__ __device__ inline size_t counters_bytes(int bh) {
  return (sizeof(int) * bh + 15) / 16 * 16;
}
inline size_t workspace_bytes(int bh) {
  return counters_bytes(bh) + sizeof(double) * kWsDoubles * bh;
}

// Shared memory of one CTA, in bytes from its start: cum (float64), the
// warps' scan totals, dt, colf (exp(cum_l - cum_l0) with l0 the first
// position of l's 64-row tile), cdt (a row CTA's exp(cum_I0 - cum_j) dt_j
// for j < I0; a dstate CTA's exp(cum)), the arrival flag; then the tiles,
// zeroed once so their padding stays zero: the CTA's own pair (a key CTA's
// B and x rows, a row CTA's C and dy rows), the two stages of its ring (the
// other pair), and the state (row CTAs) or dns (key CTAs), bf16 [64][ldc]
// rows p or fp32 [pad16(P)][lds]. N-wide bf16 tiles have row stride npad + 8
// and P-wide ones pad16(P) + 8, so the 8 rows one ldmatrix matrix reads
// start 16 bytes apart in the banks; the fp32 tile's npad + 4 puts the
// lanes' column reads (rows 2 (lane % 4), column lane / 4) on 32 banks.
struct TcBwdLayout {
  int npad, ldc, ldx, lds;
  size_t cum, warp_tot, dts, colf, cdt, flag, tiles, stage_c, stage, ring, st, total;
  __host__ __device__ TcBwdLayout(int p, int n, bool fp32_state) {
    npad = pad16(n);
    ldc = npad + 8;
    ldx = pad16(p) + 8;
    lds = npad + 4;
    cum = 0;
    warp_tot = cum + sizeof(double) * kMaxL;
    dts = warp_tot + sizeof(double) * kTcWarps;
    colf = dts + sizeof(float) * kMaxL;
    cdt = colf + sizeof(float) * kMaxL;
    flag = cdt + sizeof(float) * kMaxL;
    tiles = flag + 16;
    stage_c = sizeof(bf16) * kTcTile * ldc;
    stage = stage_c + sizeof(bf16) * kTcTile * ldx;
    ring = tiles + stage;
    st = ring + 2 * stage;
    total = st + (fp32_state ? sizeof(float) * pad16(p) * lds : stage_c);
  }
};

// Fragment loads (kTcTile-row bf16 tiles, row-major, row stride ld):
// lda, the A fragment of rows r0..r0+15 and k 16kk..16kk+15 of a [row][k]
// tile; lda_t, the same of the transpose of a [k][row] tile; ldb_nk, the B
// fragments of the two n8 tiles of columns c0..c0+15 and k 16kk.. of a
// [col][k] tile (f[0], f[1] the first tile, f[2], f[3] the second); ldb_kn,
// the same of a [k][col] tile.
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int ld, int r0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, t + (r0 + (lane % 8) + 8 * ((lane / 8) % 2)) * ld + 16 * kk + 8 * (lane / 16));
}
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* t, int ld, int kk, int r0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(a, t + (16 * kk + (lane % 8) + 8 * (lane / 16)) * ld + r0 + 8 * ((lane / 8) % 2));
}
__device__ __forceinline__ void ldb_nk(uint32_t (&f)[4], const bf16* t, int ld, int c0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(f, t + (c0 + (lane % 8) + 8 * (lane / 16)) * ld + 16 * kk + 8 * ((lane / 8) % 2));
}
__device__ __forceinline__ void ldb_kn(uint32_t (&f)[4], const bf16* t, int ld, int kk, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(f, t + (16 * kk + (lane % 8) + 8 * ((lane / 8) % 2)) * ld + c0 + 8 * (lane / 16));
}

// d0 += a (f[0], f[1]) and d1 += a (f[2], f[3]): one A fragment against the
// two n8 tiles one ldsm_x4 loaded
__device__ __forceinline__ void mma_pair(float (&d0)[4], float (&d1)[4],
                                         const uint32_t (&a)[4], const uint32_t (&f)[4]) {
  mma(d0, a, f[0], f[1]);
  mma(d1, a, f[2], f[3]);
}

// an fp32 accumulator fragment pair (n8 tiles u = 0, 1 of 16 columns) as the
// A fragment of the next product (k = those 16 columns), in three bf16 parts
__device__ __forceinline__ void split_frag(const float (&v)[2][4], uint32_t (&hi)[4],
                                           uint32_t (&mid)[4], uint32_t (&lo)[4]) {
  split3(v[0][0], v[0][1], hi[0], mid[0], lo[0]);
  split3(v[0][2], v[0][3], hi[1], mid[1], lo[1]);
  split3(v[1][0], v[1][1], hi[2], mid[2], lo[2]);
  split3(v[1][2], v[1][3], hi[3], mid[3], lo[3]);
}

// d[tn..tn+3] += A (B fragments of the [k][col] tile t, k 16kk.., columns
// 8tn..8tn+31), A in three parts, for the n8 tiles below ntiles: the parts
// outermost, so four independent accumulators take consecutive mma
template <int NTILES>
__device__ __forceinline__ void mma3_kn(float (&d)[NTILES][4], const uint32_t (&hi)[4],
                                        const uint32_t (&mid)[4], const uint32_t (&lo)[4],
                                        const bf16* t, int ld, int kk, int ntiles) {
#pragma unroll
  for (int tn = 0; tn < NTILES; tn += 4) {
    if (tn >= ntiles) break;
    const bool two = tn + 2 < ntiles;
    uint32_t f0[4], f1[4];
    ldb_kn(f0, t, ld, kk, 8 * tn);
    if (two) ldb_kn(f1, t, ld, kk, 8 * tn + 16);
    mma_pair(d[tn], d[tn + 1], hi, f0);
    if (two) mma_pair(d[tn + 2], d[tn + 3], hi, f1);
    mma_pair(d[tn], d[tn + 1], mid, f0);
    if (two) mma_pair(d[tn + 2], d[tn + 3], mid, f1);
    mma_pair(d[tn], d[tn + 1], lo, f0);
    if (two) mma_pair(d[tn + 2], d[tn + 3], lo, f1);
  }
}

// the B fragment (k = p 2c4, 2c4 + 1 and + 8; column n) of an fp32 [p][lds]
// tile in three bf16 parts
__device__ __forceinline__ void split_col(const float* t, int lds, int p, int n,
                                          uint32_t (&b0)[3], uint32_t (&b1)[3]) {
  split3(t[p * lds + n], t[(p + 1) * lds + n], b0[0], b0[1], b0[2]);
  split3(t[(p + 8) * lds + n], t[(p + 9) * lds + n], b1[0], b1[1], b1[2]);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One (b, h) is split over 2 ceil(R / 2) + StateCtas CTAs (R = ceil(L / 64)
// row tiles), blockIdx.y naming the role: key CTAs, row CTAs, dstate CTAs.
template <typename TS, int P>
__global__ void __launch_bounds__(kTcThreads)
ssd_chunk_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ dA, const bf16* __restrict__ bm,
                        const bf16* __restrict__ cm, const TS* __restrict__ state,
                        const bf16* __restrict__ dy, const TS* __restrict__ dns,
                        bf16* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ ddA, bf16* __restrict__ dbm,
                        bf16* __restrict__ dcm, TS* __restrict__ dstate,
                        unsigned char* __restrict__ ws, int L, int H, int N, int vec,
                        Strides st) {
  static_assert(P == 8 || P == 32 || P == 64, "unsupported head dim");
  constexpr int PK = (P + 15) / 16;     // k-steps over p
  constexpr int PT = P / 8;             // n8 tiles over p
  constexpr int PT4 = (PT + 3) / 4 * 4;  // ... rounded up to what mma3_kn walks
  constexpr int KMAX = kMaxN / 16;      // k-steps over n at most
  constexpr int NT = kMaxN / 8;         // n8 tiles over n at most
  constexpr int SC = StateCtas<P>::value;
  constexpr bool kExact = IsBf16<TS>::value;  // a bf16 state and dns enter the mma whole

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcBwdLayout lay(P, N, !kExact);
  double* cum = reinterpret_cast<double*>(smem_raw + lay.cum);
  double* warp_tot = reinterpret_cast<double*>(smem_raw + lay.warp_tot);
  float* dts = reinterpret_cast<float*>(smem_raw + lay.dts);
  float* colf = reinterpret_cast<float*>(smem_raw + lay.colf);
  float* cdt = reinterpret_cast<float*>(smem_raw + lay.cdt);
  int* flag = reinterpret_cast<int*>(smem_raw + lay.flag);
  bf16* own_c = reinterpret_cast<bf16*>(smem_raw + lay.tiles);
  bf16* own_x = reinterpret_cast<bf16*>(smem_raw + lay.tiles + lay.stage_c);
  auto ring_c = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + lay.ring + s * lay.stage); };
  auto ring_x = [&](int s) {
    return reinterpret_cast<bf16*>(smem_raw + lay.ring + s * lay.stage + lay.stage_c);
  };
  bf16* st16 = reinterpret_cast<bf16*>(smem_raw + lay.st);
  float* st32 = reinterpret_cast<float*>(smem_raw + lay.st);
  const int ldc = lay.ldc, ldx = lay.ldx, lds = lay.lds;
  const int nk = lay.npad / 16, ntn = lay.npad / 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int R = (L + kTcTile - 1) / kTcTile;
  const int n_key = (R + 1) / 2;  // key CTAs, and as many row CTAs
  const int y = blockIdx.y;
  const bool key_cta = y < n_key, row_cta = !key_cta && y < 2 * n_key;
  const int t = key_cta ? y : row_cta ? y - n_key : y - 2 * n_key;
  const int n_pass = !key_cta && !row_cta ? 1 : t == R - 1 - t ? 1 : 2;

  const bf16* xb = x + b * st.x()[0] + h * st.x()[2];
  const float* dtb = dt + b * st.dt()[0] + h * st.dt()[2];
  const float* dab = dA + b * st.da()[0] + h * st.da()[2];
  const bf16* bb = bm + b * st.b()[0] + h * st.b()[2];
  const bf16* cb = cm + b * st.c()[0] + h * st.c()[2];
  const bf16* dyb = dy + b * st.dy()[0] + h * st.dy()[2];
  const TS* sb = state + b * st.s()[0] + h * st.s()[1];
  const TS* dnb = dns + b * st.dns()[0] + h * st.dns()[1];
  int* counters = reinterpret_cast<int*>(ws);
  double* wsd = reinterpret_cast<double*>(ws + counters_bytes(gridDim.x)) +
                static_cast<int64_t>(bh) * kWsDoubles;
  const int64_t row = static_cast<int64_t>(H);  // contiguous outputs: (b, l, h, .)

  // rows [64 tile, 64 tile + 64) of B or C (all N columns, or the dstate
  // CTA's [c0, c0 + nc)), of x or dy
  auto load_b = [&](bf16* d, int tile) {
    load_tile(d, ldc, bb, st.b()[1], st.b()[3], tile * kTcTile, L, N, vec & kVecB);
  };
  auto load_c = [&](bf16* d, int tile, int c0 = 0, int nc = kMaxN) {
    load_tile(d, ldc, cb + c0 * st.c()[3], st.c()[1], st.c()[3], tile * kTcTile, L,
              min(nc, N - c0), vec & kVecC);
  };
  auto load_x = [&](bf16* d, int tile) {
    load_tile(d, ldx, xb, st.x()[1], st.x()[3], tile * kTcTile, L, P, vec & kVecX);
  };
  auto load_dy = [&](bf16* d, int tile) {
    load_tile(d, ldx, dyb, st.dy()[1], st.dy()[3], tile * kTcTile, L, P, vec & kVecDy);
  };
  // the state (row CTAs) or dns (key CTAs) into its tile
  auto load_pn = [&](const TS* src, const int64_t* s, bool v) {
    if constexpr (kExact) {
      load_tile(st16, ldc, src, s[2], s[3], 0, P, N, v);
    } else {
      load_state(st32, lds, src, s[2], s[3], P, N);
    }
  };

  zero_smem(smem_raw + lay.tiles, lay.total - lay.tiles);
  __syncthreads();
  // the first copies fly during the prefix sum
  constexpr int NTC = NT / SC;  // a dstate CTA's n8 tiles
  if (key_cta) {
    load_b(own_c, t);
    load_x(own_x, t);
    load_pn(dnb, st.dns(), vec & kVecDns);
    load_c(ring_c(0), t);
    load_dy(ring_x(0), t);
  } else if (row_cta) {
    load_c(own_c, t);
    load_dy(own_x, t);
    load_pn(sb, st.s(), vec & kVecS);
    load_b(ring_c(0), 0);
    load_x(ring_x(0), 0);
  } else {
    load_c(ring_c(0), 0, 8 * NTC * t, 8 * NTC);
    load_dy(ring_x(0), 0);
  }
  cp_async_commit();
  for (int l = tid; l < kMaxL; l += kTcThreads) dts[l] = l < L ? dtb[l * st.dt()[1]] : 0.f;
  prefix_sum_f64<kTcThreads>(dab, st.da()[1], L, cum, warp_tot);
  const double total = cum[L - 1];
  for (int l = tid; l < kMaxL; l += kTcThreads) {
    colf[l] = l < L ? expf(static_cast<float>(cum[l] - cum[l / kTcTile * kTcTile])) : 0.f;
  }
  __syncthreads();

  if (key_cta) {
    // ---- key tiles t and R-1-t: dx_J and dB_J over the row tiles I >= J,
    // the column sums of H, then the dns terms and ddt_J. The row tiles of
    // both key tiles stream through the ring as one sequence (q counts them).
    const int jr = 16 * warp;  // the warp's first row (key) of the tile
    int q = 0;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int J = pass == 0 ? t : R - 1 - t;
      const int J0 = J * kTcTile;
      if (pass > 0) {
        load_b(own_c, J);
        load_x(own_x, J);
        load_c(ring_c(q & 1), J);
        load_dy(ring_x(q & 1), J);
        cp_async_commit();
      }
      const int jt = J0 + jr + g, jb = jt + 8;  // the thread's two keys
      const bool live = J0 + jr < L;            // uniform over the warp
      const double cum_t = jt < L ? cum[jt] : 0.0, cum_b = jb < L ? cum[jb] : 0.0;
      const float dt_t = dts[jt], dt_b = dts[jb];
      float dxa[PT4][4], dba[NT][4], colh[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < PT4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[u][e] = 0.f;
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dba[u][e] = 0.f;

      for (int I = J; I < R; ++I, ++q) {
        if (I + 1 < R) {
          load_c(ring_c((q + 1) & 1), I + 1);
          load_dy(ring_x((q + 1) & 1), I + 1);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (live) {
          const bf16* cs = ring_c(q & 1);
          const bf16* ys = ring_x(q & 1);
          const int I0 = I * kTcTile;
          const bool diag = I == J;
          // below the diagonal (j < I0 <= i) decay_ij = colf[i] exp(cum_I0 - cum_j)
          const float rf_t = diag ? 0.f : expf(static_cast<float>(cum[I0] - cum_t));
          const float rf_b = diag ? 0.f : expf(static_cast<float>(cum[I0] - cum_b));
          // the blocks of 16 columns i with an entry j <= i < L for these rows
          const int jp_lo = diag ? warp : 0;
          const int jp_hi = min(4, (L - I0 + 15) / 16);
          // a block of 16 columns i: S^T = B_J C_I^T and dW^T = x_J dy_I^T,
          // then W^T, dS^T and H in the fragment, dx_J += W^T dy_I and
          // dB_J += dS^T C_I. One block's S at a time: holding all four
          // blocks' fragments spilled 300 B a thread and ran 2-9% slower.
          auto block = [&](int jp, auto on_diagonal) {
            float s[2][4], dw[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[u][e] = dw[u][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KMAX; ++kk) {
              if (kk >= nk) break;
              uint32_t a[4], f[4];
              lda(a, own_c, ldc, jr, kk);
              ldb_nk(f, cs, ldc, 16 * jp, kk);
              mma_pair(s[0], s[1], a, f);
            }
#pragma unroll
            for (int kp = 0; kp < PK; ++kp) {
              uint32_t a[4], f[4];
              lda(a, own_x, ldx, jr, kp);
              ldb_nk(f, ys, ldx, 16 * jp, kp);
              mma_pair(dw[0], dw[1], a, f);
            }
            float w[2][4], ds[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const bool top = e < 2;
                const int i = I0 + 16 * jp + 8 * u + 2 * c4 + (e & 1);
                float dec;
                if constexpr (decltype(on_diagonal)::value) {
                  const int j = top ? jt : jb;
                  dec = j <= i && i < L
                            ? expf(static_cast<float>(cum[i] - (top ? cum_t : cum_b)))
                            : 0.f;
                } else {
                  dec = colf[i] * (top ? rf_t : rf_b);
                }
                const float sv = s[u][e], dv = dw[u][e];
                const float decdt = dec * (top ? dt_t : dt_b);
                w[u][e] = sv * decdt;
                ds[u][e] = dv * decdt;
                colh[top ? 0 : 1] += dv * sv * dec;
              }
            }
            uint32_t hi[4], mid[4], lo[4];
            split_frag(w, hi, mid, lo);
            mma3_kn(dxa, hi, mid, lo, ys, ldx, jp, PT);
            split_frag(ds, hi, mid, lo);
            mma3_kn(dba, hi, mid, lo, cs, ldc, jp, ntn);
          };
          const std::true_type on_diagonal;
          const std::false_type below_diagonal;
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (jp >= jp_lo && jp < jp_hi) {
              if (diag) {
                block(jp, on_diagonal);
              } else {
                block(jp, below_diagonal);
              }
            }
          }
        }
        __syncthreads();  // stage q & 1 is refilled next
      }

      // ---- the dns terms: dx_J += rem (B_J dns^T), dB_J += rem (x_J dns),
      // drem_j = x_j . (B_j dns^T); then ddt_J and the key part of dcum
      if (live) {
        const float erem_t = jt < L ? expf(static_cast<float>(total - cum_t)) : 0.f;
        const float erem_b = jb < L ? expf(static_cast<float>(total - cum_b)) : 0.f;
        const float rem_t = erem_t * dt_t, rem_b = erem_b * dt_b;
        float drem[2] = {0.f, 0.f};
#pragma unroll
        for (int tp = 0; tp < PT4; tp += 2) {
          if (tp >= PT) break;
          float bd[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) bd[u][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk) {
            if (kk >= nk) break;
            uint32_t a[4];
            lda(a, own_c, ldc, jr, kk);
            if constexpr (kExact) {
              uint32_t f[4];
              ldb_nk(f, st16, ldc, 8 * tp, kk);
              mma_pair(bd[0], bd[1], a, f);
            } else {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                if (tp + u < PT) {
                  const float* sp = st32 + (8 * (tp + u) + g) * lds + 16 * kk + 2 * c4;
                  const float2 k0 = *reinterpret_cast<const float2*>(sp);
                  const float2 k8 = *reinterpret_cast<const float2*>(sp + 8);
                  uint32_t b0[3], b1[3];
                  split3(k0.x, k0.y, b0[0], b0[1], b0[2]);
                  split3(k8.x, k8.y, b1[0], b1[1], b1[2]);
#pragma unroll
                  for (int part = 0; part < 3; ++part) mma(bd[u], a, b0[part], b1[part]);
                }
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (tp + u < PT) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int p = 8 * (tp + u) + 2 * c4 + (e & 1);
                const float xv = __bfloat162float(own_x[(jr + g + 8 * (e >> 1)) * ldx + p]);
                drem[e >> 1] += xv * bd[u][e];
                dxa[tp + u][e] += (e < 2 ? rem_t : rem_b) * bd[u][e];
              }
            }
          }
        }
#pragma unroll
        for (int tn = 0; tn < NT; tn += 2) {
          if (tn >= ntn) break;
          float xd[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) xd[u][e] = 0.f;
#pragma unroll
          for (int kp = 0; kp < PK; ++kp) {
            uint32_t a[4];
            lda(a, own_x, ldx, jr, kp);
            if constexpr (kExact) {
              uint32_t f[4];
              ldb_kn(f, st16, ldc, kp, 8 * tn);
              mma_pair(xd[0], xd[1], a, f);
            } else {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                uint32_t b0[3], b1[3];
                split_col(st32, lds, 16 * kp + 2 * c4, 8 * (tn + u) + g, b0, b1);
#pragma unroll
                for (int part = 0; part < 3; ++part) mma(xd[u], a, b0[part], b1[part]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) dba[tn + u][e] += (e < 2 ? rem_t : rem_b) * xd[u][e];
        }
        drem[0] = quad_sum(drem[0]);
        drem[1] = quad_sum(drem[1]);
        colh[0] = quad_sum(colh[0]);
        colh[1] = quad_sum(colh[1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = half == 0 ? jt : jb;
          if (j >= L) continue;
          const int64_t o = (static_cast<int64_t>(b) * L + j) * row + h;
#pragma unroll
          for (int u = 0; u < PT; ++u) {
            *reinterpret_cast<__nv_bfloat162*>(dx + o * P + 8 * u + 2 * c4) =
                __floats2bfloat162_rn(dxa[u][2 * half], dxa[u][2 * half + 1]);
          }
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            const int n = 8 * u + 2 * c4;
            if (n >= N) break;
            if (N % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(dbm + o * N + n) =
                  __floats2bfloat162_rn(dba[u][2 * half], dba[u][2 * half + 1]);
            } else {
              dbm[o * N + n] = __float2bfloat16_rn(dba[u][2 * half]);
              if (n + 1 < N) dbm[o * N + n + 1] = __float2bfloat16_rn(dba[u][2 * half + 1]);
            }
          }
          if (c4 == 0) {
            const float dtj = half == 0 ? dt_t : dt_b;
            const float erem = half == 0 ? erem_t : erem_b;
            const float rem = half == 0 ? rem_t : rem_b;
            ddt[o] = colh[half] + drem[half] * erem;
            wsd[kWsKey + j] = -static_cast<double>(dtj * colh[half]) -
                              static_cast<double>(drem[half] * rem);
            wsd[kWsDrr + j] = static_cast<double>(drem[half] * rem);
          }
        }
      }
      __syncthreads();  // the next pass reloads the key tile
    }
  } else if (row_cta) {
    // ---- row tiles t and R-1-t: dC_I = exp(cum_I) (dy_I state) + sum over
    // the key tiles J <= I of dS B_J, and the row part of dcum:
    // sum_j H_ij dt_j + exp(cum_i) dy_i . (C_i state^T)
    const int ir = 16 * warp;  // the warp's first row of the tile
    int q = 0;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int I = pass == 0 ? t : R - 1 - t;
      const int I0 = I * kTcTile;
      if (pass > 0) {
        load_c(own_c, I);
        load_dy(own_x, I);
        load_b(ring_c(q & 1), 0);
        load_x(ring_x(q & 1), 0);
        cp_async_commit();
      }
      for (int l = tid; l < I0; l += kTcThreads) {
        cdt[l] = expf(static_cast<float>(cum[I0] - cum[l])) * dts[l];
      }
      cp_async_wait<0>();
      __syncthreads();  // the row tile, the state, key tile 0 and cdt are in
      const int it = I0 + ir + g, ib = it + 8;
      const bool live = I0 + ir < L;
      const double cum_t = it < L ? cum[it] : 0.0, cum_b = ib < L ? cum[ib] : 0.0;
      const float rf_t = colf[it], rf_b = colf[ib];  // exp(cum_i - cum_I0), 0 past L
      float dca[NT][4], rowg[2] = {0.f, 0.f}, inter[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dca[u][e] = 0.f;
      if (live) {
        // dy_I state, then times exp(cum_i); inter_i = C_i . that
#pragma unroll
        for (int kp = 0; kp < PK; ++kp) {
          uint32_t a[4];
          lda(a, own_x, ldx, ir, kp);
#pragma unroll
          for (int tn = 0; tn < NT; tn += 2) {
            if (tn >= ntn) break;
            if constexpr (kExact) {
              uint32_t f[4];
              ldb_kn(f, st16, ldc, kp, 8 * tn);
              mma_pair(dca[tn], dca[tn + 1], a, f);
            } else {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                uint32_t b0[3], b1[3];
                split_col(st32, lds, 16 * kp + 2 * c4, 8 * (tn + u) + g, b0, b1);
#pragma unroll
                for (int part = 0; part < 3; ++part) mma(dca[tn + u], a, b0[part], b1[part]);
              }
            }
          }
        }
        const float e_t = it < L ? expf(static_cast<float>(cum_t)) : 0.f;
        const float e_b = ib < L ? expf(static_cast<float>(cum_b)) : 0.f;
#pragma unroll
        for (int tn = 0; tn < NT; ++tn) {
          if (tn >= ntn) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dca[tn][e] *= e < 2 ? e_t : e_b;
            const int n = 8 * tn + 2 * c4 + (e & 1);
            const float cv = __bfloat162float(own_c[(ir + g + 8 * (e >> 1)) * ldc + n]);
            inter[e >> 1] += cv * dca[tn][e];
          }
        }
      }

      for (int J = 0; J <= I; ++J, ++q) {
        if (J < I) {
          load_b(ring_c((q + 1) & 1), J + 1);
          load_x(ring_x((q + 1) & 1), J + 1);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (live) {
          const bf16* bs = ring_c(q & 1);
          const bf16* xs = ring_x(q & 1);
          const int J0 = J * kTcTile;
          const bool diag = J == I;
          const int jp_hi = diag ? warp + 1 : 4;  // blocks of 16 keys with j <= i
          // one block of 16 keys: S = C_I B_J^T and dW = dy_I x_J^T, dS
          // and H dt in the fragment, dC_I += dS B_J
          auto block = [&](int jp, auto on_diagonal) {
            float s[2][4], dw[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[u][e] = dw[u][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KMAX; ++kk) {
              if (kk >= nk) break;
              uint32_t a[4], f[4];
              lda(a, own_c, ldc, ir, kk);
              ldb_nk(f, bs, ldc, 16 * jp, kk);
              mma_pair(s[0], s[1], a, f);
            }
#pragma unroll
            for (int kp = 0; kp < PK; ++kp) {
              uint32_t a[4], f[4];
              lda(a, own_x, ldx, ir, kp);
              ldb_nk(f, xs, ldx, 16 * jp, kp);
              mma_pair(dw[0], dw[1], a, f);
            }
            float ds[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const bool top = e < 2;
                const int j = J0 + 16 * jp + 8 * u + 2 * c4 + (e & 1);
                float decdt;
                if constexpr (decltype(on_diagonal)::value) {
                  const int i = top ? it : ib;
                  const double ci = top ? cum_t : cum_b;
                  decdt = j <= i && i < L ? expf(static_cast<float>(ci - cum[j])) * dts[j] : 0.f;
                } else {
                  decdt = (top ? rf_t : rf_b) * cdt[j];
                }
                ds[u][e] = dw[u][e] * decdt;
                rowg[top ? 0 : 1] += dw[u][e] * s[u][e] * decdt;
              }
            }
            uint32_t hi[4], mid[4], lo[4];
            split_frag(ds, hi, mid, lo);
            mma3_kn(dca, hi, mid, lo, bs, ldc, jp, ntn);
          };
          const std::true_type on_diagonal;
          const std::false_type below_diagonal;
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (jp < jp_hi) {
              if (diag) {
                block(jp, on_diagonal);
              } else {
                block(jp, below_diagonal);
              }
            }
          }
        }
        __syncthreads();  // stage q & 1 is refilled next
      }
      if (live) {
        rowg[0] = quad_sum(rowg[0]);
        rowg[1] = quad_sum(rowg[1]);
        inter[0] = quad_sum(inter[0]);
        inter[1] = quad_sum(inter[1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half == 0 ? it : ib;
          if (i >= L) continue;
          const int64_t o = (static_cast<int64_t>(b) * L + i) * row + h;
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            const int n = 8 * u + 2 * c4;
            if (n >= N) break;
            if (N % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(dcm + o * N + n) =
                  __floats2bfloat162_rn(dca[u][2 * half], dca[u][2 * half + 1]);
            } else {
              dcm[o * N + n] = __float2bfloat16_rn(dca[u][2 * half]);
              if (n + 1 < N) dcm[o * N + n + 1] = __float2bfloat16_rn(dca[u][2 * half + 1]);
            }
          }
          if (c4 == 0) {
            wsd[kWsRow + i] = static_cast<double>(rowg[half]) + static_cast<double>(inter[half]);
          }
        }
      }
      __syncthreads();  // the next pass reloads the row tile and cdt
    }
  } else {
    // ---- dstate = exp(total) dns + (dy exp(cum))^T C over this CTA's n8
    // tiles [ncta0, ncta0 + NTC), and sum(state * dns) over them
    constexpr int MT = (P + 15) / 16;       // m16 tiles of dstate
    constexpr int NTW = NTC * MT / kTcWarps;  // n8 tiles per warp
    const int ncta0 = NTC * t;
    const int m0 = 16 * (warp % MT);
    const int nt0 = ncta0 + NTW * (warp / MT);
    float* ecum = cdt;
    for (int l = tid; l < kMaxL; l += kTcThreads) {
      ecum[l] = l < L ? expf(static_cast<float>(cum[l])) : 0.f;
    }
    float acc[NTW][4];
#pragma unroll
    for (int u = 0; u < NTW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    for (int kt = 0; kt < R; ++kt) {
      if (kt + 1 < R) {
        load_c(ring_c((kt + 1) & 1), kt + 1, 8 * ncta0, 8 * NTC);
        load_dy(ring_x((kt + 1) & 1), kt + 1);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* cs = ring_c(kt & 1);
      const bf16* ys = ring_x(kt & 1);
#pragma unroll
      for (int ks = 0; ks < kTcTile / 16; ++ks) {
        const int ib0 = kt * kTcTile + 16 * ks;  // the step's first position
        if (ib0 >= L) break;
        // A = (dy exp(cum))^T: rows p, k = i
        uint32_t a[4], hi[4], mid[4], lo[4];
        lda_t(a, ys, ldx, ks, m0);
        const float e0 = ecum[ib0 + 2 * c4], e1 = ecum[ib0 + 2 * c4 + 1];
        const float e8 = ecum[ib0 + 2 * c4 + 8], e9 = ecum[ib0 + 2 * c4 + 9];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const float2 f = bf2_to_f2(a[qq]);
          const bool upper = qq >= 2;
          split3(f.x * (upper ? e8 : e0), f.y * (upper ? e9 : e1), hi[qq], mid[qq], lo[qq]);
        }
#pragma unroll
        for (int u = 0; u < NTW; u += 2) {
          const int nt = nt0 + u;
          if (nt >= ntn) break;
          uint32_t f[4];
          ldb_kn(f, cs, ldc, ks, 8 * (nt - ncta0));
          mma_pair(acc[u], acc[u + 1], hi, f);
          mma_pair(acc[u], acc[u + 1], mid, f);
          mma_pair(acc[u], acc[u + 1], lo, f);
        }
      }
      __syncthreads();  // stage kt & 1 is refilled next
    }
    const float etot = expf(static_cast<float>(total));
    TS* dsb = dstate + (static_cast<int64_t>(b) * H + h) * P * N;
    float sdot = 0.f;
#pragma unroll
    for (int u = 0; u < NTW; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = m0 + g + 8 * (e / 2);
        const int n = 8 * (nt0 + u) + 2 * c4 + (e % 2);
        if (pp < P && n < N) {
          const float d0 = to_f32(dnb[pp * st.dns()[2] + n * st.dns()[3]]);
          sdot = fmaf(to_f32(sb[pp * st.s()[2] + n * st.s()[3]]), d0, sdot);
          store(dsb + pp * N + n, fmaf(etot, d0, acc[u][e]));
        }
      }
    }
    sdot = warp_sum(sdot);
    if (lane == 0) warp_tot[warp] = sdot;
    __syncthreads();
    if (tid == 0) {
      double v = 0.0;
      for (int w = 0; w < kTcWarps; ++w) v += warp_tot[w];
      wsd[kWsSdot + t] = v;
    }
  }

  // ---- the last CTA of this (b, h) to arrive: dcum from the key and row
  // parts, dtotal at the last position, ddA = reverse cumsum(dcum), all in
  // float64 and in a fixed order
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + bh, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  double* dcum = cum;
  for (int l = tid; l < L; l += kTcThreads) {
    dcum[l] = __ldcg(wsd + kWsKey + l) + __ldcg(wsd + kWsRow + l);
  }
  double part = 0.0;
  for (int l = tid; l < L; l += kTcThreads) part += __ldcg(wsd + kWsDrr + l);
  part = warp_sum_f64(part);
  if (lane == 0) warp_tot[warp] = part;
  __syncthreads();
  if (tid == 0) {
    double sdot = 0.0;
    for (int s = 0; s < SC; ++s) sdot += __ldcg(wsd + kWsSdot + s);
    double dtotal = static_cast<double>(expf(static_cast<float>(total))) * sdot;
    for (int w = 0; w < kTcWarps; ++w) dtotal += warp_tot[w];
    dcum[L - 1] += dtotal;
  }
  __syncthreads();
  suffix_sum_f64<kTcThreads>(dcum, L, warp_tot);
  for (int l = tid; l < L; l += kTcThreads) {
    ddA[(static_cast<int64_t>(b) * L + l) * row + h] = static_cast<float>(dcum[l]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename TX, typename TS, int P>
size_t smem_request(int n) {
  if constexpr (IsBf16<TX>::value) {
    return TcBwdLayout(P, n, !IsBf16<TS>::value).total;
  } else {
    return Layout(P, n).total;
  }
}

// the kernel of an instantiation, opted in to its shared memory at n
template <typename TX, typename TS, int P>
cudaError_t prepare(int n, size_t& smem) {
  static size_t opted_in = 0;  // per instantiation
  smem = smem_request<TX, TS, P>(n);
  if constexpr (IsBf16<TX>::value) {
    return opt_in(ssd_chunk_bwd_tc_kernel<TS, P>, smem, opted_in);
  } else {
    return opt_in(ssd_chunk_bwd_kernel<TX, TS, P>, smem, opted_in);
  }
}

template <typename TX, typename TS, int P>
cudaError_t launch(int batch, int L, int H, int N, void* const* ptrs,
                   const Strides& st, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<TX, TS, P>(N, smem);
  if (err != cudaSuccess) return err;
  if constexpr (IsBf16<TX>::value) {
    const int vec = (rows_vectorizable(ptrs[0], st.x(), P) ? kVecX : 0) |
                    (rows_vectorizable(ptrs[3], st.b(), N) ? kVecB : 0) |
                    (rows_vectorizable(ptrs[4], st.c(), N) ? kVecC : 0) |
                    (rows_vectorizable(ptrs[6], st.dy(), P) ? kVecDy : 0) |
                    (IsBf16<TS>::value && rows_vectorizable(ptrs[5], st.s(), N) ? kVecS : 0) |
                    (IsBf16<TS>::value && rows_vectorizable(ptrs[7], st.dns(), N) ? kVecDns : 0);
    unsigned char* ws = static_cast<unsigned char*>(ptrs[14]);
    err = cudaMemsetAsync(ws, 0, counters_bytes(batch * H), stream);
    if (err != cudaSuccess) return err;
    const int row_tiles = (L + kTcTile - 1) / kTcTile;
    const dim3 grid(batch * H, 2 * ((row_tiles + 1) / 2) + StateCtas<P>::value);
    ssd_chunk_bwd_tc_kernel<TS, P><<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
        static_cast<const float*>(ptrs[2]), static_cast<const bf16*>(ptrs[3]),
        static_cast<const bf16*>(ptrs[4]), static_cast<const TS*>(ptrs[5]),
        static_cast<const bf16*>(ptrs[6]), static_cast<const TS*>(ptrs[7]),
        static_cast<bf16*>(ptrs[8]), static_cast<float*>(ptrs[9]),
        static_cast<float*>(ptrs[10]), static_cast<bf16*>(ptrs[11]),
        static_cast<bf16*>(ptrs[12]), static_cast<TS*>(ptrs[13]), ws, L, H, N, vec, st);
  } else {
    ssd_chunk_bwd_kernel<TX, TS, P><<<batch * H, kThreads, smem, stream>>>(
        static_cast<const TX*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
        static_cast<const float*>(ptrs[2]), static_cast<const TX*>(ptrs[3]),
        static_cast<const TX*>(ptrs[4]), static_cast<const TS*>(ptrs[5]),
        static_cast<const TX*>(ptrs[6]), static_cast<const TS*>(ptrs[7]),
        static_cast<TX*>(ptrs[8]), static_cast<float*>(ptrs[9]),
        static_cast<float*>(ptrs[10]), static_cast<TX*>(ptrs[11]),
        static_cast<TX*>(ptrs[12]), static_cast<TS*>(ptrs[13]), L, H, N, st);
  }
  return cudaGetLastError();
}

// CTAs of the instantiation that fit on one SM at once at n state columns
// (the occupancy API on its registers, shared memory and threads)
template <typename TX, typename TS, int P>
int ctas_per_sm(int n) {
  size_t smem = 0;
  if (prepare<TX, TS, P>(n, smem) != cudaSuccess) return -1;
  int blocks = 0;
  cudaError_t err;
  if constexpr (IsBf16<TX>::value) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ssd_chunk_bwd_tc_kernel<TS, P>, kTcThreads, smem);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ssd_chunk_bwd_kernel<TX, TS, P>, kThreads, smem);
  }
  return err == cudaSuccess ? blocks : -1;
}

// F(x_dtype code, state_dtype code, p) picks the instantiation: F::run<TX, TS,
// P>(args...); cudaErrorInvalidValue (or 0) where there is none
template <typename F, typename R, typename... A>
R dispatch(int x_dtype, int state_dtype, int p, R none, A... args) {
  auto by_p = [&](auto tx, auto ts) -> R {
    using TX = decltype(tx);
    using TS = decltype(ts);
    switch (p) {
      case 8:
        return F::template run<TX, TS, 8>(args...);
      case 32:
        return F::template run<TX, TS, 32>(args...);
      case 64:
        return F::template run<TX, TS, 64>(args...);
      default:
        return none;
    }
  };
  auto by_s = [&](auto tx) -> R {
    switch (state_dtype) {
      case 0:
        return by_p(tx, 0.f);
      case 1:
        return by_p(tx, bf16());
      default:
        return none;
    }
  };
  switch (x_dtype) {
    case 0:
      return by_s(0.f);
    case 1:
      return by_s(bf16());
    default:
      return none;
  }
}

struct Launch {
  template <typename TX, typename TS, int P>
  static cudaError_t run(int batch, int L, int H, int N, void* const* ptrs,
                         const Strides* st, cudaStream_t stream) {
    return launch<TX, TS, P>(batch, L, H, N, ptrs, *st, stream);
  }
};
struct SmemBytes {
  template <typename TX, typename TS, int P>
  static int64_t run(int n) {
    return static_cast<int64_t>(smem_request<TX, TS, P>(n));
  }
};
struct CtasPerSm {
  template <typename TX, typename TS, int P>
  static int run(int n) {
    return ctas_per_sm<TX, TS, P>(n);
  }
};

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16 (x/B/C/dy share one; the state and dns
// have their own). dt and dA are float32. `ptrs` holds 15 device pointers:
// x, dt, dA, B, C, state, dy, dns (inputs), then dx, ddt, ddA, dB, dC,
// dstate (outputs, contiguous), then the workspace of
// ssd_chunk_bwd_workspace_bytes (bf16 x/B/C; unused for fp32). `strides`
// holds 30 element strides: x (b,l,h,p), dt (b,l,h), dA (b,l,h), B
// (b,l,h,n), C (b,l,h,n), state (b,h,p,n), dy (b,l,h,p), dns (b,h,p,n).
// bf16 x/B/C run on the tensor cores, fp32 on the CUDA cores. Returns a
// cudaError_t.
extern "C" int ssd_chunk_bwd_launch(int x_dtype, int state_dtype, int batch, int L,
                                    int H, int P, int N, void* const* ptrs,
                                    const int64_t* strides, void* stream) {
  if (batch * H == 0) return cudaSuccess;
  if (L < 1 || L > kMaxL || N < 1 || N > kMaxN) return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < kStrides; ++i) st.v[i] = strides[i];
  return dispatch<Launch, cudaError_t>(x_dtype, state_dtype, P, cudaErrorInvalidValue,
                                       batch, L, H, N, ptrs, &st,
                                       static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory one CTA of the instantiation (x_dtype,
// state_dtype, p) requests at launch for n state columns: TcBwdLayout for
// bf16 x/B/C, Layout for fp32. 0 for an instantiation that does not exist.
// kernels/smem_plan.py plans the same working set with the paper's planner.
extern "C" int64_t ssd_chunk_bwd_smem_bytes(int x_dtype, int state_dtype, int p,
                                            int n) {
  if (n < 1 || n > kMaxN) return 0;
  return dispatch<SmemBytes, int64_t>(x_dtype, state_dtype, p, int64_t{0}, n);
}

// Bytes of the workspace a call with `batch` x `H` (b, h) pairs needs: the
// tensor-core kernel's arrival counts and partial sums (workspace_bytes), 0
// for fp32 x/B/C. The wrapper allocates it with torch.empty; the launch
// zeroes the counts.
extern "C" int64_t ssd_chunk_bwd_workspace_bytes(int x_dtype, int batch, int H) {
  return x_dtype == 1 ? static_cast<int64_t>(workspace_bytes(batch * H)) : 0;
}

// CTAs of the instantiation resident on one SM at n state columns, from the
// occupancy API (a size query; it opts the kernel in to its shared memory
// first); -1 on an error, 0 where there is no such instantiation.
extern "C" int ssd_chunk_bwd_ctas_per_sm(int x_dtype, int state_dtype, int p, int n) {
  if (n < 1 || n > kMaxN) return 0;
  return dispatch<CtasPerSm, int>(x_dtype, state_dtype, p, 0, n);
}
