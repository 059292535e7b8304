// ADISTS windowed texture/structure distortion map, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerf_qa_tpu/ops/pallas/windowed_tsd.py
// (_tsd_kernel). For one feature stage pair x, y (N, H, W, C) NHWC it
// computes, per image n and VALID output pixel (i, j) of the 21x21
// Gaussian window (Hk = H - 20, Wk = W - 20),
//     out[n, i, j] = sum_c w[n,c] * ((1 - ps[n,i,j]) * T_c + ps[n,i,j] * S_c)
// with, for the windowed moments Wf of the channel's map f,
//     xm = ix*W(x)   ym = iy*W(y)
//     xv = ix^2*(W(x^2) - W(x)^2)   yv = iy^2*(W(y^2) - W(y)^2)
//     xy = ix*iy*(W(xy) - W(x)*W(y))
//     T = (2*xm*ym + 1e-6) / (xm^2 + ym^2 + 1e-6)
//     S = (2*xy + 1e-6) / (xv + yv + 1e-6)
// ix, iy are per-(image, channel) scales (the inverse spatial L2 norms), so
// the caller passes raw features and no normalised copy is written.
//
// Bound: operations. Per (output pixel, channel) the separable window takes
// 21 taps x 5 moments in each of two passes plus T, S and the blend, about
// 440 fp32 operations on the CUDA cores, while the inputs are read once
// (2 * itemsize bytes per input pixel and channel). At the ADISTS path's
// shapes (256^2 at batch 128, 1080p at batch 2) the operations take 4-5x
// the bytes' time at the card's fp32 and memory peaks.
//
// Design. The TPU kernel carried the channel sum across a sequential grid
// axis in its output block and ran the W pass as a band matmul (which capped
// W at 512). Here one block owns an output tile of TH x TW pixels of one
// image and loops over the channels in chunks of CC, each thread keeping
// the weighted blend of its outputs in its own slots of shared memory: no
// atomics, results repeat bit for bit, and W is tiled, so there is no width
// cap (H, W >= 21 is the only precondition). The H pass holds 80 running
// sums a thread; at two blocks an SM (128 registers) they spilled, and one
// block an SM with up to 255 registers and no spills measured 1.5x faster
// on the 256^2 path (H100, chip_smoke.py's timing rows, PERF.md).
// For each chunk:
//   H pass: one thread per (input column of the tile + its 20-column halo,
//     channel) reads its column's TH + 20 input rows once from device
//     memory (in the input's dtype, accumulated in fp32), forms x^2, y^2 and
//     xy once per element and keeps the 5 x TH vertical window sums in
//     registers, then writes them to shared memory.
//   W pass: one thread per (output row, strip of SW columns, channel) reads
//     SW + 20 vertical sums per moment from shared memory, forms the SW
//     windowed moments in registers, then T, S and the blend with the
//     tile's ps and the channel's weight and scales, and adds them to its
//     SW running sums.
// At the end the CC channel lanes (neighbouring threads of a warp) are
// summed with shuffles in a fixed order and written. Rows, columns and
// channels past the edges are read as 0 and never written or summed.
//
// C interface (loaded with ctypes): nqt_windowed_tsd returns the
// cudaError_t of its launch; the caller allocates out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 21;          // window
constexpr int TH = 16;         // output rows of a tile
constexpr int SW = 11;         // output columns of a W-pass strip
constexpr int STRIPS = 4;
constexpr int TW = SW * STRIPS;  // 44 output columns of a tile
constexpr int CC = 4;          // channels of a chunk
constexpr int IW = TW + K - 1;   // 64 input columns of a tile
constexpr int THREADS = 256;     // = IW * CC = TH * STRIPS * CC
// row stride of the shared buffer in floats, padded so that the two output
// rows a warp's W pass reads fall on different banks
constexpr int ROW = IW * CC + 16;
constexpr int MOMENTS = 5;
// the vertical sums, then each thread's SW running channel sums
constexpr size_t SMEM_BYTES = sizeof(float) * (MOMENTS * TH * ROW + SW * THREADS);
constexpr float EPS = 1e-6f;

static_assert(IW * CC == THREADS, "one H-pass item per thread");
static_assert(TH * STRIPS * CC == THREADS, "one W-pass item per thread");

struct Taps {
  float g[K];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
tsd_kernel(const T* __restrict__ fx, const T* __restrict__ fy,
           const float* __restrict__ ps, const float* __restrict__ weights,
           const float* __restrict__ inv_x, const float* __restrict__ inv_y,
           float* __restrict__ out, int h, int w, int c, int tiles_w,
           const Taps taps) {
  extern __shared__ float hbuf[];  // [MOMENTS][TH][ROW], then [SW][THREADS]
  const int hk = h - K + 1;
  const int wk = w - K + 1;
  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int lane_c = tid % CC;

  // H-pass item: input column j of the tile, channel lane lane_c
  const int j = tid / CC;
  const int gx = ox0 + j;
  // W-pass item: output row o, strip s, channel lane lane_c
  const int s = (tid / CC) % STRIPS;
  const int o = tid / (CC * STRIPS);
  const int oy = oy0 + o;
  const int sx0 = ox0 + s * SW;

  // the W-pass item's running channel sums live in shared memory, not in
  // registers: the H pass needs 80 registers of its own sums
  float* acc = hbuf + MOMENTS * TH * ROW + tid;  // [SW][THREADS]
#pragma unroll
  for (int q = 0; q < SW; ++q) acc[q * THREADS] = 0.f;

  const int64_t img = (int64_t)n * h * w * c;
  for (int c0 = 0; c0 < c; c0 += CC) {
    const int gc = c0 + lane_c;
    const bool c_ok = gc < c;

    // ---- H pass: 5 x TH vertical window sums of one column and channel
    float hs[MOMENTS][TH];
#pragma unroll
    for (int m = 0; m < MOMENTS; ++m)
#pragma unroll
      for (int r = 0; r < TH; ++r) hs[m][r] = 0.f;
    const bool col_ok = c_ok && gx < w;
    const T* px = fx + img + (int64_t)gx * c + gc;
    const T* py = fy + img + (int64_t)gx * c + gc;
#pragma unroll
    for (int r = 0; r < TH + K - 1; ++r) {
      const int gy = oy0 + r;
      float xv = 0.f, yv = 0.f;
      if (col_ok && gy < h) {
        xv = to_float(px[(int64_t)gy * w * c]);
        yv = to_float(py[(int64_t)gy * w * c]);
      }
      const float v[MOMENTS] = {xv, yv, xv * xv, yv * yv, xv * yv};
#pragma unroll
      for (int q = 0; q < TH; ++q) {
        const int t = r - q;
        if (t >= 0 && t < K) {
#pragma unroll
          for (int m = 0; m < MOMENTS; ++m) hs[m][q] = fmaf(taps.g[t], v[m], hs[m][q]);
        }
      }
    }
    __syncthreads();  // the previous chunk's W pass is done with hbuf
#pragma unroll
    for (int m = 0; m < MOMENTS; ++m)
#pragma unroll
      for (int q = 0; q < TH; ++q) hbuf[(m * TH + q) * ROW + j * CC + lane_c] = hs[m][q];
    __syncthreads();

    // ---- W pass: SW outputs of one row, strip and channel
    float wm[MOMENTS][SW];
#pragma unroll
    for (int m = 0; m < MOMENTS; ++m) {
#pragma unroll
      for (int q = 0; q < SW; ++q) wm[m][q] = 0.f;
      const float* row = hbuf + (m * TH + o) * ROW + (s * SW) * CC + lane_c;
#pragma unroll
      for (int u = 0; u < SW + K - 1; ++u) {
        const float v = row[u * CC];
#pragma unroll
        for (int q = 0; q < SW; ++q) {
          const int t = u - q;
          if (t >= 0 && t < K) wm[m][q] = fmaf(taps.g[t], v, wm[m][q]);
        }
      }
    }
    if (c_ok) {
      const float ix = inv_x[(int64_t)n * c + gc];
      const float iy = inv_y[(int64_t)n * c + gc];
      const float wc = weights[(int64_t)n * c + gc];
      const float ixx = ix * ix, iyy = iy * iy, ixy = ix * iy;
#pragma unroll
      for (int q = 0; q < SW; ++q) {
        const int ox = sx0 + q;
        const float p = (oy < hk && ox < wk) ? ps[((int64_t)n * hk + oy) * wk + ox] : 0.f;
        const float mx = wm[0][q], my = wm[1][q];
        const float vx = wm[2][q] - mx * mx;
        const float vy = wm[3][q] - my * my;
        const float cov = wm[4][q] - mx * my;
        const float xm = ix * mx, ym = iy * my;
        const float t_map = (2.f * xm * ym + EPS) / (xm * xm + ym * ym + EPS);
        const float s_map = (2.f * (ixy * cov) + EPS) / (ixx * vx + iyy * vy + EPS);
        acc[q * THREADS] += ((1.f - p) * t_map + p * s_map) * wc;
      }
    }
  }

  // sum the CC channel lanes (neighbouring threads), fixed order
#pragma unroll
  for (int q = 0; q < SW; ++q) {
    float v = acc[q * THREADS];
#pragma unroll
    for (int off = 1; off < CC; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int ox = sx0 + q;
    if (lane_c == 0 && oy < hk && ox < wk) out[((int64_t)n * hk + oy) * wk + ox] = v;
  }
}

template <typename T>
cudaError_t launch(const void* fx, const void* fy, const float* ps,
                   const float* weights, const float* inv_x,
                   const float* inv_y, float* out, int n, int h, int w, int c,
                   const Taps& taps, cudaStream_t stream) {
  // above 48 KB of shared memory a kernel must opt in, once per process
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      tsd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (opt_in != cudaSuccess) return opt_in;
  const int hk = h - K + 1;
  const int wk = w - K + 1;
  const int tiles_w = (wk + TW - 1) / TW;
  const int tiles_h = (hk + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, n);
  tsd_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(fx), static_cast<const T*>(fy), ps, weights, inv_x,
      inv_y, out, h, w, c, tiles_w, taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nqt_windowed_tsd(const void* fx, const void* fy, const void* ps,
                                const void* weights, const void* inv_x,
                                const void* inv_y, void* out, int n, int h,
                                int w, int c, int is_bf16, const float* taps,
                                int window, void* stream) {
  if (window != K || h < K || w < K || n < 1 || c < 1) return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < K; ++i) t.g[i] = taps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(ps);
  const float* wt = static_cast<const float*>(weights);
  const float* ix = static_cast<const float*>(inv_x);
  const float* iy = static_cast<const float*>(inv_y);
  float* o = static_cast<float*>(out);
  cudaError_t err = is_bf16
      ? launch<__nv_bfloat16>(fx, fy, p, wt, ix, iy, o, n, h, w, c, t, s)
      : launch<float>(fx, fy, p, wt, ix, iy, o, n, h, w, c, t, s);
  return (int)err;
}
