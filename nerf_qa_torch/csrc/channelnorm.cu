// ChannelNorm forward (per-pixel LayerNorm over channels, affine, optional
// exact GELU) for Hopper (sm_90a).
//
// Replaces the forward Pallas TPU kernel nerf_qa_tpu/ops/pallas/channelnorm.py
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
// C interface (loaded with ctypes): nqt_channel_norm returns the
// cudaError_t of its launch; the caller allocates y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 32;

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
        if (gelu) t = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
        o[u] = t;
      }
      Io<T, VEC>::store(yr + j * VEC, o);
    }
  }
}

template <typename T, int VEC, int NV>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y,
                   int rows, int c, float eps, int gelu, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  channel_norm_kernel<T, VEC, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, c, eps, gelu);
  return cudaGetLastError();
}

// Smallest power-of-two vectors-per-lane that covers the row.
template <typename T, int VEC>
cudaError_t dispatch(const void* x, const float* scale, const float* bias, void* y,
                     int rows, int c, float eps, int gelu, cudaStream_t s) {
  const int need = (c / VEC + 31) / 32;
  if (need <= 1) return launch<T, VEC, 1>(x, scale, bias, y, rows, c, eps, gelu, s);
  if (need <= 2) return launch<T, VEC, 2>(x, scale, bias, y, rows, c, eps, gelu, s);
  if (need <= 4) return launch<T, VEC, 4>(x, scale, bias, y, rows, c, eps, gelu, s);
  if constexpr (VEC * 8 <= kMaxPerLane) {
    if (need <= 8) return launch<T, VEC, 8>(x, scale, bias, y, rows, c, eps, gelu, s);
  }
  if constexpr (VEC * 16 <= kMaxPerLane) {
    if (need <= 16) return launch<T, VEC, 16>(x, scale, bias, y, rows, c, eps, gelu, s);
  }
  if constexpr (VEC * 32 <= kMaxPerLane) {
    if (need <= 32) return launch<T, VEC, 32>(x, scale, bias, y, rows, c, eps, gelu, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int nqt_channel_norm(const void* x, const void* scale, const void* bias,
                                void* y, int rows, int c, float eps, int gelu,
                                int is_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (rows <= 0 || c <= 0 || c > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  if (is_bf16 && vec == 8) return (int)dispatch<__nv_bfloat16, 8>(x, sc, bi, y, rows, c, eps, gelu, s);
  if (is_bf16 && vec == 1) return (int)dispatch<__nv_bfloat16, 1>(x, sc, bi, y, rows, c, eps, gelu, s);
  if (!is_bf16 && vec == 4) return (int)dispatch<float, 4>(x, sc, bi, y, rows, c, eps, gelu, s);
  if (!is_bf16 && vec == 1) return (int)dispatch<float, 1>(x, sc, bi, y, rows, c, eps, gelu, s);
  return (int)cudaErrorInvalidValue;
}
