// ChannelNorm (per-pixel LayerNorm over channels, affine, optional exact
// GELU), forward and backward, for Hopper (sm_90a).
//
// Forward: replaces the Pallas TPU kernel nerf_qa_tpu/ops/pallas/channelnorm.py
// (_fwd_kernel). For each row r of a (P, C) tensor x (an NHWC map seen as
// rows of channels):
//     mean = sum(x[r]) / C,  var = sum((x[r] - mean)^2) / C   (fp32)
//     y[r] = (x[r] - mean) * rsqrt(var + eps) * scale + bias
//     y[r] = 0.5 * y * (1 + erf(y / sqrt(2)))                  (if gelu)
// stored in x's dtype. The GELU is the exact (erf) one of the module path
// (models/nr/layers.py); the TPU kernel's tanh form is not carried over.
//
// Bound: device memory. The function reads and writes P*C elements once
// each and does about ten operations per element, far below the card's
// ratio of operations to bytes. The design reads each row once: one warp
// owns a row and keeps it in registers (at most 32 values a lane, so
// C <= 1024), takes the centred two-pass variance from those registers
// with warp shuffles, and writes the row once. Loads and stores are 16
// bytes a lane where C and the alignment allow (fp32: C % 4 == 0,
// bf16: C % 8 == 0), else one element a lane; neighbouring lanes touch
// neighbouring addresses either way.
//
// Backward: replaces _bwd_kernel of the same file. Given x and the output
// gradient g (both in x's dtype) it recomputes each row's mean and rstd
// from x, as the TPU kernel does, then
//     xh = (x - mean) * rstd,  t = xh * scale + bias
//     dy = g * (Phi(t) + t * phi(t))     (the erf GELU's derivative; dy = g
//                                         without the GELU)
//     gs = dy * scale
//     dx = rstd * (gs - mean(gs) - xh * mean(gs * xh))   (in x's dtype)
//     dscale = sum over rows of dy * xh,  dbias = sum over rows of dy (fp32)
// Bound: device memory again (x and g read, dx written: 3*P*C elements).
// The row work is the forward's (one warp a row, x and g in registers).
// The column sums over up to 262,144 rows cannot be carried across blocks,
// which run in no order, so they take two passes and no atomics, as the
// moments kernel does: a fixed grid of blocks walks the rows in a fixed
// stride; each lane keeps its own channels' partial sums in registers; each
// block adds its warps' sums in shared memory in warp order and writes a
// (block, 2, C) fp32 partial; a second small launch adds the blocks'
// partials in block order, in double. dscale and dbias repeat bit for bit.
//
// C interface (loaded with ctypes): nqt_channel_norm and
// nqt_channel_norm_bwd return the cudaError_t of their launches; the caller
// allocates every output and the partial buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 32;
constexpr int kMaxChannels = 32 * kMaxPerLane;
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

template <typename T, int VEC>
struct Io;

template <>
struct Io<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ __forceinline__ static void store(float* p, const float* v) { p[0] = v[0]; }
};

template <>
struct Io<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per row; lane l holds vectors l, l + 32, ... (NV of them).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
channel_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ y, int rows,
                    int c, float eps, int gelu) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int nvec = c / VEC;
  const T* xr = x + (int64_t)row * c;
  T* yr = y + (int64_t)row * c;

  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      Io<T, VEC>::load(xr + j * VEC, v[i]);
#pragma unroll
      for (int u = 0; u < VEC; ++u) sum += v[i][u];
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) v[i][u] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / c;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < nvec) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const float d = v[i][u] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / c + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      float o[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const int ch = j * VEC + u;
        float t = (v[i][u] - mean) * rstd * __ldg(scale + ch) + __ldg(bias + ch);
        if (gelu) t = 0.5f * t * (1.f + erff(t * kSqrtHalf));
        o[u] = t;
      }
      Io<T, VEC>::store(yr + j * VEC, o);
    }
  }
}

// Calls f(std::integral_constant<int, NV>) with the smallest power-of-two
// vectors-per-lane NV that covers a row of c channels.
template <int VEC, typename F>
cudaError_t with_width(int c, F&& f) {
  const int need = (c / VEC + 31) / 32;
  if (need <= 1) return f(std::integral_constant<int, 1>{});
  if (need <= 2) return f(std::integral_constant<int, 2>{});
  if (need <= 4) return f(std::integral_constant<int, 4>{});
  if constexpr (VEC * 8 <= kMaxPerLane) {
    if (need <= 8) return f(std::integral_constant<int, 8>{});
  }
  if constexpr (VEC * 16 <= kMaxPerLane) {
    if (need <= 16) return f(std::integral_constant<int, 16>{});
  }
  if constexpr (VEC * 32 <= kMaxPerLane) {
    if (need <= 32) return f(std::integral_constant<int, 32>{});
  }
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias, void* y,
                       int rows, int c, float eps, int gelu, cudaStream_t s) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  return with_width<VEC>(c, [&](auto nv) {
    channel_norm_kernel<T, VEC, decltype(nv)::value><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, c, eps, gelu);
    return cudaGetLastError();
  });
}

// Backward, pass 1. Warp w of block b takes rows b*kWarps + w, then every
// gridDim.x*kWarps-th row after it; lane l holds vectors l, l + 32, ... of
// each row (as in the forward) and the running dscale / dbias sums of those
// channels. At the end the block adds its warps' sums in warp order and
// writes partial[b][0][:] (dscale) and partial[b][1][:] (dbias).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
channel_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        T* __restrict__ dx, float* __restrict__ partial, int rows,
                        int c, float eps, int gelu) {
  __shared__ float red[kWarps][kMaxChannels];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = c / VEC;

  float acc_s[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc_s[i][u] = acc_b[i][u] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const T* xr = x + (int64_t)row * c;
    const T* gr = g + (int64_t)row * c;
    float v[NV][VEC];  // x, then xh
    float q[NV][VEC];  // g, then gs = dy * scale
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
        Io<T, VEC>::load(xr + j * VEC, v[i]);
        Io<T, VEC>::load(gr + j * VEC, q[i]);
#pragma unroll
        for (int u = 0; u < VEC; ++u) sum += v[i][u];
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) v[i][u] = q[i][u] = 0.f;
      }
    }
    const float mean = warp_sum(sum) / c;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < nvec) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const float d = v[i][u] - mean;
          sq = fmaf(d, d, sq);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / c + eps);

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const int ch = j * VEC + u;
          const float sc = __ldg(scale + ch);
          const float xh = (v[i][u] - mean) * rstd;
          float dy = q[i][u];
          if (gelu) {
            const float t = fmaf(xh, sc, __ldg(bias + ch));
            const float cdf = 0.5f * (1.f + erff(t * kSqrtHalf));
            const float pdf = kInvSqrt2Pi * expf(-0.5f * t * t);
            dy *= fmaf(t, pdf, cdf);
          }
          acc_s[i][u] = fmaf(dy, xh, acc_s[i][u]);
          acc_b[i][u] += dy;
          const float gs = dy * sc;
          v[i][u] = xh;
          q[i][u] = gs;
          s1 += gs;
          s2 = fmaf(gs, xh, s2);
        }
      }
    }
    const float m1 = warp_sum(s1) / c;
    const float m2 = warp_sum(s2) / c;
    T* dr = dx + (int64_t)row * c;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
        float o[VEC];
#pragma unroll
        for (int u = 0; u < VEC; ++u) o[u] = rstd * (q[i][u] - m1 - v[i][u] * m2);
        Io<T, VEC>::store(dr + j * VEC, o);
      }
    }
  }

  // the block's sums, dscale then dbias, each in warp order
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          red[warp][j * VEC + u] = pass == 0 ? acc_s[i][u] : acc_b[i][u];
      }
    }
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][ch];
      partial[((int64_t)blockIdx.x * 2 + pass) * c + ch] = t;
    }
    __syncthreads();
  }
}

// Backward, pass 2: one thread per (dscale | dbias, channel) adds the
// blocks' partials in block order, in double.
__global__ void channel_norm_bwd_finalize(const float* __restrict__ partial,
                                          float* __restrict__ dscale,
                                          float* __restrict__ dbias, int blocks, int c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * c) return;
  const int pass = idx / c;
  const int ch = idx - pass * c;
  double t = 0.0;
  for (int b = 0; b < blocks; ++b) t += (double)partial[((int64_t)b * 2 + pass) * c + ch];
  (pass == 0 ? dscale : dbias)[ch] = (float)t;
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* x, const void* g, const float* scale, const float* bias,
                       void* dx, float* partial, float* dscale, float* dbias, int rows,
                       int c, float eps, int gelu, int blocks, cudaStream_t s) {
  const cudaError_t err = with_width<VEC>(c, [&](auto nv) {
    channel_norm_bwd_kernel<T, VEC, decltype(nv)::value><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), scale, bias,
        static_cast<T*>(dx), partial, rows, c, eps, gelu);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const int threads = 256;
  channel_norm_bwd_finalize<<<(2 * c + threads - 1) / threads, threads, 0, s>>>(
      partial, dscale, dbias, blocks, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nqt_channel_norm(const void* x, const void* scale, const void* bias,
                                void* y, int rows, int c, float eps, int gelu,
                                int is_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (rows <= 0 || c <= 0 || c > kMaxChannels) return (int)cudaErrorInvalidValue;
  if (is_bf16 && vec == 8) return (int)launch_fwd<__nv_bfloat16, 8>(x, sc, bi, y, rows, c, eps, gelu, s);
  if (is_bf16 && vec == 1) return (int)launch_fwd<__nv_bfloat16, 1>(x, sc, bi, y, rows, c, eps, gelu, s);
  if (!is_bf16 && vec == 4) return (int)launch_fwd<float, 4>(x, sc, bi, y, rows, c, eps, gelu, s);
  if (!is_bf16 && vec == 1) return (int)launch_fwd<float, 1>(x, sc, bi, y, rows, c, eps, gelu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nqt_channel_norm_bwd(const void* x, const void* g, const void* scale,
                                    const void* bias, void* dx, void* partial,
                                    void* dscale, void* dbias, int rows, int c, float eps,
                                    int gelu, int is_bf16, int vec, int blocks,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  if (rows <= 0 || c <= 0 || c > kMaxChannels || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16 && vec == 8)
    return (int)launch_bwd<__nv_bfloat16, 8>(x, g, sc, bi, dx, part, ds, db, rows, c, eps, gelu, blocks, s);
  if (is_bf16 && vec == 1)
    return (int)launch_bwd<__nv_bfloat16, 1>(x, g, sc, bi, dx, part, ds, db, rows, c, eps, gelu, blocks, s);
  if (!is_bf16 && vec == 4)
    return (int)launch_bwd<float, 4>(x, g, sc, bi, dx, part, ds, db, rows, c, eps, gelu, blocks, s);
  if (!is_bf16 && vec == 1)
    return (int)launch_bwd<float, 1>(x, g, sc, bi, dx, part, ds, db, rows, c, eps, gelu, blocks, s);
  return (int)cudaErrorInvalidValue;
}
