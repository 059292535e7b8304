// Fused DISTS moment sums for one feature-stage pair, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerf_qa_tpu/ops/pallas/moments.py
// (_moments_kernel): for every image n and channel c of two NHWC feature
// maps x, y it computes the five fp32 sums
//     out[n, 0, c] = sum x      out[n, 1, c] = sum y
//     out[n, 2, c] = sum x*x    out[n, 3, c] = sum y*y    out[n, 4, c] = sum x*y
// over the H*W pixels of the image.
//
// Bound: device memory. The function reads 2*N*H*W*C*itemsize bytes and
// does 5 multiply-adds per element pair, far below the card's ratio of
// operations to bytes. The design reads each input once, with 16-byte
// vector loads where the channel count allows, and keeps every intermediate
// in registers and shared memory: nothing but the small partial sums
// reaches device memory.
//
// Design. The TPU kernel carries its sums across a sequential grid axis;
// blocks on the card run in no order, so the reduction is split in two:
//   pass 1 (moments_partial_kernel): grid (pixel chunk p, channel tile,
//     image n). A block has `cgb` channel lanes times `pl` pixel lanes.
//     Neighbouring threads hold neighbouring channel groups of one NHWC
//     pixel row, so a warp's loads are contiguous. Each thread accumulates
//     the five sums of its VEC channels over a bounded run of pixels
//     (chunk / pl of them), then a fixed-order tree in shared memory sums
//     the pixel lanes and lane 0 writes partial[n, p, 5, C].
//   pass 2 (moments_finalize_kernel): one thread per (n, stat, channel)
//     sums the P partials in order, in double, and writes out[n, 5, C].
// No atomics: the result repeats bit for bit from run to run. The bounded
// per-thread run, the tree and the double final sum keep the fp32 error
// of the single-pass moments small at the 1080p stage-1 size (2.07M
// pixels per image).
//
// C interface (loaded with ctypes): nqt_moment_sums returns the
// cudaError_t of its launches; the caller allocates partial and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int VEC>
struct VecLoad;

template <>
struct VecLoad<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <>
struct VecLoad<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};

template <>
struct VecLoad<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct VecLoad<__nv_bfloat16, 8> {
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
};

constexpr int kStats = 5;

template <typename T, int VEC>
__global__ void moments_partial_kernel(const T* __restrict__ fx,
                                       const T* __restrict__ fy,
                                       float* __restrict__ partial, int hw,
                                       int c, int cgb, int pl, int chunk) {
  extern __shared__ float smem[];  // [kStats * VEC][blockDim.x]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane_c = tid % cgb;
  const int lane_p = tid / cgb;
  const int n_cg = c / VEC;
  const int cg = blockIdx.y * cgb + lane_c;
  const int p = blockIdx.x;
  const int p_count = gridDim.x;
  const int n = blockIdx.z;
  const bool active = lane_p < pl && cg < n_cg;

  float acc[kStats][VEC];
#pragma unroll
  for (int s = 0; s < kStats; ++s)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[s][v] = 0.f;

  if (active) {
    const int start = p * chunk;
    const int end = min(start + chunk, hw);
    const T* bx = fx + (int64_t)n * hw * c + (int64_t)cg * VEC;
    const T* by = fy + (int64_t)n * hw * c + (int64_t)cg * VEC;
#pragma unroll 4
    for (int px = start + lane_p; px < end; px += pl) {
      float xv[VEC], yv[VEC];
      VecLoad<T, VEC>::load(bx + (int64_t)px * c, xv);
      VecLoad<T, VEC>::load(by + (int64_t)px * c, yv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        acc[0][v] += xv[v];
        acc[1][v] += yv[v];
        acc[2][v] = fmaf(xv[v], xv[v], acc[2][v]);
        acc[3][v] = fmaf(yv[v], yv[v], acc[3][v]);
        acc[4][v] = fmaf(xv[v], yv[v], acc[4][v]);
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kStats; ++s)
#pragma unroll
    for (int v = 0; v < VEC; ++v) smem[(s * VEC + v) * nthreads + tid] = acc[s][v];
  __syncthreads();

  // fixed-order tree over the pixel lanes (pl need not be a power of two)
  int span = 1;
  while (span < pl) span <<= 1;
  for (int stride = span >> 1; stride > 0; stride >>= 1) {
    if (active && lane_p < stride && lane_p + stride < pl) {
      const int other = tid + stride * cgb;
#pragma unroll
      for (int k = 0; k < kStats * VEC; ++k)
        smem[k * nthreads + tid] += smem[k * nthreads + other];
    }
    __syncthreads();
  }

  if (active && lane_p == 0) {
    float* dst = partial + ((int64_t)n * p_count + p) * kStats * c + cg * VEC;
#pragma unroll
    for (int s = 0; s < kStats; ++s)
#pragma unroll
      for (int v = 0; v < VEC; ++v) dst[s * c + v] = smem[(s * VEC + v) * nthreads + tid];
  }
}

__global__ void moments_finalize_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int p_count,
                                        int c) {
  const int n = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // stat * c + channel
  if (idx >= kStats * c) return;
  const float* src = partial + (int64_t)n * p_count * kStats * c + idx;
  double sum = 0.0;
  for (int p = 0; p < p_count; ++p) sum += (double)src[(int64_t)p * kStats * c];
  out[(int64_t)n * kStats * c + idx] = (float)sum;
}

template <typename T, int VEC>
cudaError_t launch_partial(const void* fx, const void* fy, float* partial,
                           int n, int hw, int c, int cgb, int pl, int chunk,
                           int p_count, cudaStream_t stream) {
  const int n_cg = c / VEC;
  const dim3 grid(p_count, (n_cg + cgb - 1) / cgb, n);
  const int threads = cgb * pl;
  const size_t smem = sizeof(float) * kStats * VEC * threads;
  moments_partial_kernel<T, VEC><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(fx), static_cast<const T*>(fy), partial, hw, c,
      cgb, pl, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nqt_moment_sums(const void* fx, const void* fy, void* partial,
                               void* out, int n, int hw, int c, int is_bf16,
                               int vec, int cgb, int pl, int chunk,
                               int p_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (is_bf16 && vec == 8) {
    err = launch_partial<__nv_bfloat16, 8>(fx, fy, part, n, hw, c, cgb, pl, chunk, p_count, s);
  } else if (is_bf16 && vec == 1) {
    err = launch_partial<__nv_bfloat16, 1>(fx, fy, part, n, hw, c, cgb, pl, chunk, p_count, s);
  } else if (!is_bf16 && vec == 4) {
    err = launch_partial<float, 4>(fx, fy, part, n, hw, c, cgb, pl, chunk, p_count, s);
  } else if (!is_bf16 && vec == 1) {
    err = launch_partial<float, 1>(fx, fy, part, n, hw, c, cgb, pl, chunk, p_count, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const dim3 grid2((kStats * c + threads - 1) / threads, n);
  moments_finalize_kernel<<<grid2, threads, 0, s>>>(part, static_cast<float*>(out), p_count, c);
  return (int)cudaGetLastError();
}
