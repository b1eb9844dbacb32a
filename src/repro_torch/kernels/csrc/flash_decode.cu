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
// to keep enough loads in flight:
//   * one CTA per (b, h); all G query heads of h share each K/V row it loads;
//   * a cache row is split into 16-byte vectors, one per lane, so a position is
//     read by D*itemsize/16 lanes with one coalesced load each, and a warp covers
//     32*16/(D*itemsize) positions at a time;
//   * each lane loads kUnroll positions' K and V before using any of them;
//   * every position group keeps its own fp32 (m, l, acc); groups merge through
//     warp shuffles, warps through shared memory, and the output is written once.
// The TPU kernel walks T sequentially over a grid axis with its state in VMEM
// scratch; here the positions of one (b, h) are spread over the CTA's warps and
// the partial softmax states are merged at the end instead.
//
// The cache is addressed through explicit element strides (batch, position,
// head; the head dimension is contiguous) because the cache handed in is a view
// into the serving engine's one state buffer: its batch stride is the slot
// stride of the state plan, not T*KV*D.
//
// Not done here (left for later work): splitting T across CTAs when B*KV is
// small (flash-decoding), TMA loads and wgmma.
//
// Plain C interface; the Python wrapper (kernels/flash_decode.py) loads the
// shared library with ctypes and passes pointers, strides and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

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

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int n_kv, int t_len, int64_t k_sb,
                    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                    int64_t v_sh, float scale) {
  constexpr int VEC = VecWidth<T>::value;      // elements per 16-byte load
  constexpr int LANES = D / VEC;               // lanes reading one position
  constexpr int POS_PER_WARP = 32 / LANES;     // positions a warp reads at once
  constexpr int GROUPS = kWarps * POS_PER_WARP;
  constexpr int STEP = GROUPS * kUnroll;       // positions per CTA iteration
  static_assert(D % VEC == 0 && 32 % LANES == 0, "unsupported head size");

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int b = blockIdx.x / n_kv;
  const int h = blockIdx.x % n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LANES;                      // which 16-byte chunk of D
  const int group = warp * POS_PER_WARP + lane / LANES;
  const int len = min(max(lengths[b], 0), t_len);

  // this lane's chunk of every query head of KV head h, scaled, in fp32
  float qf[G][VEC];
  const T* qb = q + (static_cast<int64_t>(b) * n_kv + h) * G * D + sub * VEC;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unpack<T>(*reinterpret_cast<const uint4*>(qb + g * D), qf[g]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) qf[g][i] *= scale;
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const T* kb = k + b * k_sb + h * k_sh + sub * VEC;
  const T* vb = v + b * v_sb + h * v_sh + sub * VEC;

  // `base` is the same for every thread of the CTA, so the shuffles below
  // always run with the whole warp converged
  for (int base = 0; base < len; base += STEP) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * GROUPS + group;
      valid[u] = t < len;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (valid[u]) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + t * k_st));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + t * v_st));
      }
    }
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[VEC];
      unpack<T>(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qf[g][i], kf[i], dot);
        s[u][g] = dot;
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
    // online softmax over this iteration's valid positions
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
      for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!valid[u]) continue;
      float vf[VEC];
      unpack<T>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(s[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
  }

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
      for (int i = 0; i < VEC; ++i) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + acc_o * c;
      }
      m[g] = mx;
    }
  }
  if (lane < LANES) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][sub * VEC + i] = acc[g][i];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and write each output element once
  T* ob = out + (static_cast<int64_t>(b) * n_kv + h) * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * e;
      o += sm_acc[w][g][d] * e;
    }
    store(ob + idx, o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(int batch, int n_kv, int t_len, const void* q, const void* k,
                   const void* v, const void* lengths, void* out, int64_t k_sb,
                   int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                   int64_t v_sh, float scale, cudaStream_t stream) {
  flash_decode_kernel<T, D, G><<<batch * n_kv, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), n_kv, t_len, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(int g, int batch, int n_kv, int t_len, const void* q,
                       const void* k, const void* v, const void* lengths,
                       void* out, int64_t k_sb, int64_t k_st, int64_t k_sh,
                       int64_t v_sb, int64_t v_st, int64_t v_sh, float scale,
                       cudaStream_t stream) {
#define REPRO_FD_CASE(GV)                                                    \
  case GV:                                                                   \
    return launch<T, D, GV>(batch, n_kv, t_len, q, k, v, lengths, out, k_sb, \
                            k_st, k_sh, v_sb, v_st, v_sh, scale, stream);
  switch (g) {
    REPRO_FD_CASE(1)
    REPRO_FD_CASE(2)
    REPRO_FD_CASE(4)
    REPRO_FD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FD_CASE
}

template <typename T>
cudaError_t dispatch_d(int d, int g, int batch, int n_kv, int t_len,
                       const void* q, const void* k, const void* v,
                       const void* lengths, void* out, int64_t k_sb,
                       int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                       int64_t v_sh, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return dispatch_g<T, 64>(g, batch, n_kv, t_len, q, k, v, lengths, out,
                               k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale,
                               stream);
    case 128:
      return dispatch_g<T, 128>(g, batch, n_kv, t_len, q, k, v, lengths, out,
                                k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and out are contiguous (B, KV, G, D);
// k and v are (B, T, KV, D) with the given element strides and a contiguous
// head dimension; lengths is int32 (B,) on the device. Returns a cudaError_t.
extern "C" int flash_decode_launch(int dtype, int batch, int n_kv, int g,
                                   int d, int t_len, const void* q,
                                   const void* k, const void* v,
                                   const void* lengths, void* out, int64_t k_sb,
                                   int64_t k_st, int64_t k_sh, int64_t v_sb,
                                   int64_t v_st, int64_t v_sh, float scale,
                                   void* stream) {
  if (batch * n_kv == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(d, g, batch, n_kv, t_len, q, k, v, lengths, out,
                               k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(d, g, batch, n_kv, t_len, q, k, v,
                                       lengths, out, k_sb, k_st, k_sh, v_sb,
                                       v_st, v_sh, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
