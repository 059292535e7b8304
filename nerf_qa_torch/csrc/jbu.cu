// FeatUp joint-bilateral-upsampling (JBU) adaptive filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerf_qa_tpu/ops/pallas/jbu.py (_jbu_kernel),
// which computes what the scan formulation of models/nr/featup.py computes.
// Inputs: hr (N, H, W, C), the bicubic-upsampled source; proj (N, H, W, 32),
// the learned range projection of the guidance; spatial (49,), the 7x7
// spatial Gaussian; temp (1,), the range temperature. For every output
// pixel (y, x) and shift p = (dy, dx) of the 7x7 window, with reflect
// padding (torch's mode, which excludes the edge pixel):
//     l_p  = temp * <proj[y, x], proj[y + dy - 3, x + dx - 3]>
//     r_p  = exp(l_p - max_q l_q) / sum_q exp(l_q - max_q l_q)   (softmax)
//     c_p  = r_p * spatial[p],   w_p = c_p / max(sum_q c_q, 1e-7)
//     out[y, x, :] = sum_p w_p * hr[y + dy - 3, x + dx - 3, :]    (fp32)
//
// Bound: device memory. Per pixel it reads C + 32 input values and writes
// C outputs, and does 49 * (2*32 + 2*C) operations, about 45 per byte of
// fp32 input, under the card's fp32 ratio of operations to bytes.
//
// Design. One block per 16x16 output tile of one image (256 threads):
//   1. it stages the tile's projection with its 3-pixel halo (22x22x32,
//      fp32, rows padded to 33 floats so that neighbouring pixels fall in
//      different banks) in shared memory;
//   2. one thread per pixel computes its 49 logits, the softmax, the
//      spatial product and the normalisation, and keeps the 49 weights in
//      shared memory;
//   3. the block walks over the channels 32 at a time: it stages the hr
//      halo tile of those channels (reusing the projection's space) and
//      each warp forms the weighted sums of its pixels, one channel a lane,
//      so the 49 neighbours of a pixel are read from shared memory, not 49
//      times from device memory.
// Reflect indices are computed in the kernel; no padded copy is made. The
// TPU kernel's two-view halo and its 8-row, 16-column alignment are Mosaic
// artefacts and are not carried over: any H, W > 3 works.
//
// C interface (loaded with ctypes): nqt_jbu_filter returns the cudaError_t
// of its launch; the caller allocates out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;
constexpr int kD = 2 * kR + 1;
constexpr int kTaps = kD * kD;
constexpr int kK = 32;  // FeatUp key_dim
constexpr int kTile = 16;
constexpr int kHalo = kTile + 2 * kR;
constexpr int kPos = kHalo * kHalo;
constexpr int kThreads = kTile * kTile;
constexpr int kCC = 32;  // channels per chunk: one a lane
constexpr int kStride = kK + 1;
constexpr size_t kSmemBytes = sizeof(float) * (kPos * kStride + kTaps * kThreads);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// torch's reflect padding; the clamp only guards halo rows of tile pixels
// that lie outside the image, whose results are never written.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
jbu_kernel(const T* __restrict__ hr, const T* __restrict__ proj,
           const float* __restrict__ spatial, const float* __restrict__ temp_ptr,
           float* __restrict__ out, int h, int w, int c) {
  extern __shared__ float smem[];
  float* tile = smem;                  // [kPos][kStride]: proj, then hr chunks
  float* wts = smem + kPos * kStride;  // [kTaps][kThreads]
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const int64_t img = (int64_t)blockIdx.z * h * w;

  for (int e = tid; e < kPos * kK; e += kThreads) {
    const int pos = e / kK;
    const int k = e % kK;
    const int gy = reflect(y0 - kR + pos / kHalo, h);
    const int gx = reflect(x0 - kR + pos % kHalo, w);
    tile[pos * kStride + k] = to_f(proj[(img + (int64_t)gy * w + gx) * kK + k]);
  }
  __syncthreads();

  const int py = tid / kTile;
  const int px = tid % kTile;
  if (y0 + py < h && x0 + px < w) {
    const float temp = __ldg(temp_ptr);
    float ctr[kK];
    const float* cp = tile + ((py + kR) * kHalo + px + kR) * kStride;
#pragma unroll
    for (int k = 0; k < kK; ++k) ctr[k] = cp[k];
    float m = -INFINITY;
    for (int p = 0; p < kTaps; ++p) {
      const float* sp = tile + ((py + p / kD) * kHalo + px + p % kD) * kStride;
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kK; ++k) dot = fmaf(sp[k], ctr[k], dot);
      const float l = temp * dot;
      wts[p * kThreads + tid] = l;
      m = fmaxf(m, l);
    }
    float z = 0.f;
    for (int p = 0; p < kTaps; ++p) {
      const float e = expf(wts[p * kThreads + tid] - m);
      wts[p * kThreads + tid] = e;
      z += e;
    }
    float s = 0.f;
    for (int p = 0; p < kTaps; ++p) {
      const float cw = (wts[p * kThreads + tid] / z) * __ldg(spatial + p);
      wts[p * kThreads + tid] = cw;
      s += cw;
    }
    s = fmaxf(s, 1e-7f);
    for (int p = 0; p < kTaps; ++p) wts[p * kThreads + tid] /= s;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c0 = 0; c0 < c; c0 += kCC) {
    for (int e = tid; e < kPos * kCC; e += kThreads) {
      const int pos = e / kCC;
      const int ch = e % kCC;
      float v = 0.f;
      if (c0 + ch < c) {
        const int gy = reflect(y0 - kR + pos / kHalo, h);
        const int gx = reflect(x0 - kR + pos % kHalo, w);
        v = to_f(hr[(img + (int64_t)gy * w + gx) * c + c0 + ch]);
      }
      tile[pos * kStride + ch] = v;
    }
    __syncthreads();
    if (c0 + lane < c) {
      for (int q = warp; q < kThreads; q += kThreads / 32) {
        const int qy = q / kTile;
        const int qx = q % kTile;
        if (y0 + qy >= h || x0 + qx >= w) continue;
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < kTaps; ++p) {
          const float src = tile[((qy + p / kD) * kHalo + qx + p % kD) * kStride + lane];
          acc = fmaf(src, wts[p * kThreads + q], acc);
        }
        out[(img + (int64_t)(y0 + qy) * w + x0 + qx) * c + c0 + lane] = acc;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* hr, const void* proj, const float* spatial,
                   const float* temp, float* out, int n, int h, int w, int c,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      jbu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  jbu_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(hr), static_cast<const T*>(proj), spatial, temp, out, h, w, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nqt_jbu_filter(const void* hr, const void* proj, const void* spatial,
                              const void* temp, void* out, int n, int h, int w,
                              int c, int is_bf16, void* stream) {
  if (n <= 0 || n > 65535 || h <= kR || w <= kR || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(spatial);
  const float* tp = static_cast<const float*>(temp);
  float* o = static_cast<float*>(out);
  if (is_bf16) return (int)launch<__nv_bfloat16>(hr, proj, sp, tp, o, n, h, w, c, s);
  return (int)launch<float>(hr, proj, sp, tp, o, n, h, w, c, s);
}
