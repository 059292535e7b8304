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
// ix, iy are per-(image, channel) scales (the inverse spatial L2 norms; 1
// when the caller passes none), so the caller passes raw features and no
// normalised copy is written.
//
// Bound: operations. Per (output pixel, channel) the separable window takes
// 21 taps x 4 moments (below) of multiply-adds in each of two passes plus
// T, S and the blend, about 380 fp32 operations on the CUDA cores, while the inputs
// are read once (2 * itemsize bytes per input pixel and channel). At the
// ADISTS path's shapes (256^2 at batch 128, 1080p at batch 2) the
// operations take 4-5x the bytes' time at the card's fp32 and memory peaks.
// The windows stay true fp32: the variances are differences of nearly
// equal window sums.
//
// Design. One block owns an output tile of TH = 8 rows x tw columns of one
// image and one group of channels, and walks that group in chunks of CCB
// channels (8 in bf16, 4 in fp32: one 16-byte copy a pixel):
//   staging: the chunk's input box, 28 rows x (tw + 20) columns x CCB
//     channels of x and of y, goes to shared memory with 16-byte cp.async
//     copies; rows and columns past the image use the zero-fill form. The
//     copy of chunk k + 1 is issued as soon as the H pass of chunk k is
//     done and runs under its W pass. Where C is not a multiple of CCB or
//     a pointer is not 16-byte aligned (stage 0, C = 3), plain loads fill
//     the same layout 4 channels at a time, zeros past C.
//   H pass: one thread per (input column, channel) of a 4-channel subpass
//     reads its column's 28 values of x and y from the box once, forms
//     ix^2 x^2 + iy^2 y^2 and xy once per element (xv and yv enter S only
//     as ix^2 var(x) + iy^2 var(y), so 4 moments do the work of 5) and
//     keeps the 4 x 8 vertical window sums in registers, then writes them
//     to shared memory.
//   W pass: one warp per strip of SW output columns, one lane per (output
//     row, channel), so a warp's loads hit 32 banks; a lane reads SW + 20
//     vertical sums per moment, forms the SW windowed moments, then
//     T, S and the blend over one common denominator (one division per
//     output and channel), and adds them to SW running sums kept in
//     registers across the chunks.
// At the end the 4 channel lanes of each output are summed in a fixed
// order through shared memory. Two compiled shapes: a wide one (512
// threads, tw <= 108, 181 KB, one block an SM) and a narrow one for stages
// at most 44 outputs wide (256 threads, tw <= 44, 93 KB, two blocks an
// SM): 16 warps an SM either way. Where a stage gives fewer than two waves
// of blocks, the wrapper splits the channels across blocks (grid z): each
// group writes its partial map and a second launch adds them in group
// order. No atomics: results repeat bit for bit. H, W >= 21 is the only
// precondition.
// What still holds it back (H100 measurements, PERF.md): about 3.2x the
// bound on the path's stages. At 256^2 stage 1 the code issues about 270
// instructions per (output, channel), counted from the source, against
// 190 FMAs' worth in the bound: the H pass recomputes the 20-column halo
// (1.25x at tw = 79), each input element costs 9 instructions of loads,
// conversions and products besides its FMAs, and the W pass loads 27
// values per 147 FMAs. At the measured time that is about half the card's
// issue rate: one block an SM, 12 of its 16 warps busy in each phase at
// tw = 79, and barriers between the FMA-bound H pass and the load-heavy
// W pass, which no other block fills.
//
// C interface (loaded with ctypes): nqt_windowed_tsd returns the
// cudaError_t of its launches; nqt_windowed_tsd_attrs reports a variant's
// registers, local memory, shared memory and blocks per SM; the caller
// allocates out and, for several channel groups, the partial maps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 21;   // window
constexpr int TH = 8;   // output rows of a tile
constexpr int BR = TH + K - 1;  // 28 input rows of a box
// the window sums of x, y, ix^2*x^2 + iy^2*y^2 and x*y: the scaled
// variances enter S only as their sum, so one moment carries both
constexpr int MOMENTS = 4;
constexpr int LANES = 4;  // channels of a subpass
constexpr float EPS = 1e-6f;

struct Taps {
  float g[K];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// The compiled shapes. IWMAX input columns of a box; VCOLS the row stride
// of the vertical sums: room for whole strips, odd, so that the 32 (row,
// channel) lanes of a W-pass warp read 32 banks, and = 9 mod 32, so that
// the H pass's 4 channel lanes x 8 columns of a warp overlap little.
template <int THREADS_, int TWMAX_, int SW_>
struct Shape {
  static constexpr int THREADS = THREADS_;
  static constexpr int TWMAX = TWMAX_;
  static constexpr int SW = SW_;
  static constexpr int IWMAX = TWMAX + K - 1;
  static constexpr int STRIPS = (TWMAX + SW - 1) / SW;
  static constexpr int VCOLS = ((STRIPS * SW + K - 1 + 22) / 32) * 32 + 9;
  static constexpr size_t BOX_BYTES = 2 * BR * IWMAX * 16;
  static constexpr size_t SMEM_BYTES =
      BOX_BYTES + sizeof(float) * MOMENTS * TH * LANES * VCOLS;
  static_assert(IWMAX * LANES <= THREADS, "one H-pass item per thread");
  static_assert(TH * LANES == 32 && STRIPS * 32 <= THREADS, "one W-pass strip a warp");
  static_assert(VCOLS >= STRIPS * SW + K - 1 && VCOLS % 32 == 9, "vsum stride");
};
using Wide = Shape<512, 108, 7>;
using Narrow = Shape<256, 44, 6>;
static_assert(Wide::SMEM_BYTES <= 227 * 1024, "one wide block an SM");
static_assert(Narrow::SMEM_BYTES <= 112 * 1024, "two narrow blocks an SM");

template <typename S>
constexpr int min_blocks() { return S::THREADS >= 512 ? 1 : 2; }

template <typename T, bool VEC>
struct Box {
  static constexpr int CCB = VEC ? 16 / (int)sizeof(T) : LANES;
};

// Stage channels [c0, c0 + CCB) of the box rows and columns of the tile.
template <typename T, bool VEC, typename S>
__device__ __forceinline__ void stage(T* box, const T* __restrict__ fx,
                                      const T* __restrict__ fy, int64_t img,
                                      int oy0, int ox0, int iw, int h, int w,
                                      int c, int c0, int tid) {
  constexpr int CCB = Box<T, VEC>::CCB;
  const int per = BR * iw;
  if constexpr (VEC) {
    for (int e = tid; e < 2 * per; e += S::THREADS) {
      const int t = e >= per;
      const int rem = e - t * per;
      const int r = rem / iw;
      const int j = rem - r * iw;
      const int gy = oy0 + r;
      const int gx = ox0 + j;
      const bool ok = gy < h && gx < w;
      const T* src = t ? fy : fx;
      const T* p = ok ? src + (img + (int64_t)gy * w + gx) * c + c0 : src;
      cp_async16_zfill(box + ((t * BR + r) * S::IWMAX + j) * CCB, p, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int e = tid; e < 2 * per; e += S::THREADS) {
      const int t = e >= per;
      const int rem = e - t * per;
      const int r = rem / iw;
      const int j = rem - r * iw;
      const int gy = oy0 + r;
      const int gx = ox0 + j;
      const bool ok = gy < h && gx < w;
      const T* src = (t ? fy : fx) + (ok ? (img + (int64_t)gy * w + gx) * c + c0 : 0);
      T* d = box + ((t * BR + r) * S::IWMAX + j) * CCB;
#pragma unroll
      for (int ch = 0; ch < CCB; ++ch) d[ch] = ok && c0 + ch < c ? src[ch] : zero_of<T>();
    }
  }
}

template <typename T, bool VEC, typename S>
__global__ void __launch_bounds__(S::THREADS, min_blocks<S>())
tsd_kernel(const T* __restrict__ fx, const T* __restrict__ fy,
           const float* __restrict__ ps, const float* __restrict__ weights,
           const float* __restrict__ inv_x, const float* __restrict__ inv_y,
           float* __restrict__ dst, int h, int w, int c, int tw, int tiles_w,
           int cg, const Taps taps) {
  constexpr int CCB = Box<T, VEC>::CCB;
  constexpr int SW = S::SW;
  constexpr int VCOLS = S::VCOLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* box = reinterpret_cast<T*>(smem_raw);  // [2][BR][IWMAX][CCB]
  float* vs = reinterpret_cast<float*>(smem_raw + S::BOX_BYTES);  // [MOMENTS][TH][LANES][VCOLS]
  const int hk = h - K + 1;
  const int wk = w - K + 1;
  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * tw;
  const int iw = tw + K - 1;
  const int cbeg = blockIdx.z * cg;
  const int cend = min(c, cbeg + cg);
  const int tid = threadIdx.x;
  const int64_t img = (int64_t)n * h * w;
  dst += (int64_t)blockIdx.z * gridDim.y * hk * wk;

  // H-pass item: input column hj of the box, channel lane hl
  const int hj = tid / LANES;
  const int hl = tid % LANES;
  const bool h_ok = hj < iw;
  // W-pass item: strip s (one a warp), output row o and channel lane wl
  // (one a lane)
  const int ns = (tw + SW - 1) / SW;
  const int s = tid / 32;
  const bool w_ok = s < ns;
  const int o = (tid % 32) / LANES;
  const int wl = tid % LANES;
  const int oy = oy0 + o;
  float p[SW], acc[SW];
#pragma unroll
  for (int q = 0; q < SW; ++q) {
    const int col = s * SW + q;
    const int ox = ox0 + col;
    p[q] = (w_ok && oy < hk && col < tw && ox < wk)
               ? ps[((int64_t)n * hk + oy) * wk + ox] : 0.f;
    acc[q] = 0.f;
  }

  const int nchunks = (cend - cbeg + CCB - 1) / CCB;
  stage<T, VEC, S>(box, fx, fy, img, oy0, ox0, iw, h, w, c, cbeg, tid);
  for (int k = 0; k < nchunks; ++k) {
    const int c0 = cbeg + k * CCB;
    if constexpr (VEC) asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the box is in; the last W pass is done with vs
    const int nsub = min(CCB / LANES, (cend - c0 + LANES - 1) / LANES);
    for (int sub = 0; sub < nsub; ++sub) {
      if (sub > 0) __syncthreads();  // the last W pass is done with vs

      // ---- H pass: 4 x TH vertical window sums of one column and channel
      const int gh = c0 + sub * LANES + hl;
      if (h_ok) {
        const int64_t nch = (int64_t)n * c + min(gh, c - 1);
        const float sx = inv_x ? inv_x[nch] : 1.f;
        const float sy = inv_y ? inv_y[nch] : 1.f;
        const float sxx = sx * sx, syy = sy * sy;
        float hs[MOMENTS][TH];
#pragma unroll
        for (int m = 0; m < MOMENTS; ++m)
#pragma unroll
          for (int q = 0; q < TH; ++q) hs[m][q] = 0.f;
        const T* bx = box + hj * CCB + sub * LANES + hl;
        const T* by = bx + BR * S::IWMAX * CCB;
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          const float xv = to_float(bx[r * S::IWMAX * CCB]);
          const float yv = to_float(by[r * S::IWMAX * CCB]);
          const float v[MOMENTS] = {xv, yv, fmaf(sxx * xv, xv, syy * yv * yv), xv * yv};
#pragma unroll
          for (int q = 0; q < TH; ++q) {
            const int t = r - q;
            if (t >= 0 && t < K) {
#pragma unroll
              for (int m = 0; m < MOMENTS; ++m) hs[m][q] = fmaf(taps.g[t], v[m], hs[m][q]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < MOMENTS; ++m)
#pragma unroll
          for (int q = 0; q < TH; ++q) vs[((m * TH + q) * LANES + hl) * VCOLS + hj] = hs[m][q];
      }
      __syncthreads();  // vs is in; the box is free after the last subpass
      if (sub == nsub - 1 && k + 1 < nchunks)
        stage<T, VEC, S>(box, fx, fy, img, oy0, ox0, iw, h, w, c, c0 + CCB, tid);

      // ---- W pass: SW outputs of one row, strip and channel
      const int gc = c0 + sub * LANES + wl;
      if (w_ok && gc < cend) {
        float wm[MOMENTS][SW];
#pragma unroll
        for (int m = 0; m < MOMENTS; ++m) {
#pragma unroll
          for (int q = 0; q < SW; ++q) wm[m][q] = 0.f;
          const float* row = vs + ((m * TH + o) * LANES + wl) * VCOLS + s * SW;
#pragma unroll
          for (int u = 0; u < SW + K - 1; ++u) {
            const float v = row[u];
#pragma unroll
            for (int q = 0; q < SW; ++q) {
              const int t = u - q;
              if (t >= 0 && t < K) wm[m][q] = fmaf(taps.g[t], v, wm[m][q]);
            }
          }
        }
        const int64_t nc = (int64_t)n * c + gc;
        const float ix = inv_x ? inv_x[nc] : 1.f;
        const float iy = inv_y ? inv_y[nc] : 1.f;
        const float wc = weights[nc];
        const float ixy = ix * iy;
#pragma unroll
        for (int q = 0; q < SW; ++q) {
          const float mx = wm[0][q], my = wm[1][q];
          const float cov = wm[3][q] - mx * my;
          const float xm = ix * mx, ym = iy * my;
          const float mm = xm * xm + ym * ym;  // ix^2 W(x)^2 + iy^2 W(y)^2
          const float tn = 2.f * xm * ym + EPS;
          const float td = mm + EPS;
          const float sn = 2.f * (ixy * cov) + EPS;
          const float sd = (wm[2][q] - mm) + EPS;  // xv + yv + eps
          const float blend = ((1.f - p[q]) * tn * sd + p[q] * sn * td) / (td * sd);
          acc[q] += blend * wc;
        }
      }
    }
  }

  // sum the 4 channel lanes of each output, in lane order
  __syncthreads();
  float* red = vs;  // [TH][4][VCOLS]
  if (w_ok) {
#pragma unroll
    for (int q = 0; q < SW; ++q) red[(o * LANES + wl) * VCOLS + s * SW + q] = acc[q];
  }
  __syncthreads();
  for (int e = tid; e < TH * tw; e += S::THREADS) {
    const int r = e / tw;
    const int col = e - r * tw;
    const int y = oy0 + r, x = ox0 + col;
    if (y >= hk || x >= wk) continue;
    const float* v = red + r * LANES * VCOLS + col;
    dst[((int64_t)n * hk + y) * wk + x] = ((v[0] + v[VCOLS]) + v[2 * VCOLS]) + v[3 * VCOLS];
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in group order
__global__ void tsd_sum_groups(const float* __restrict__ partial,
                               float* __restrict__ out, int64_t count, int groups) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = partial[i];
    for (int g = 1; g < groups; ++g) v += partial[g * count + i];
    out[i] = v;
  }
}

template <typename T, bool VEC, typename S>
cudaError_t opt_in() {
  // above 48 KB of shared memory a kernel must opt in, once per process
  static const cudaError_t err = cudaFuncSetAttribute(
      tsd_kernel<T, VEC, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM_BYTES);
  return err;
}

template <typename T, bool VEC, typename S>
cudaError_t launch(const void* fx, const void* fy, const float* ps,
                   const float* weights, const float* inv_x,
                   const float* inv_y, float* partial, float* out, int n, int h,
                   int w, int c, int tw, int groups, int cg, const Taps& taps,
                   cudaStream_t stream) {
  cudaError_t err = opt_in<T, VEC, S>();
  if (err != cudaSuccess) return err;
  const int hk = h - K + 1;
  const int wk = w - K + 1;
  const int tiles_w = (wk + tw - 1) / tw;
  const int tiles_h = (hk + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, n, groups);
  tsd_kernel<T, VEC, S><<<grid, S::THREADS, S::SMEM_BYTES, stream>>>(
      static_cast<const T*>(fx), static_cast<const T*>(fy), ps, weights, inv_x,
      inv_y, groups > 1 ? partial : out, h, w, c, tw, tiles_w, cg, taps);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const int64_t count = (int64_t)n * hk * wk;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  tsd_sum_groups<<<blocks, 256, 0, stream>>>(partial, out, count, groups);
  return cudaGetLastError();
}

template <typename T, bool VEC, typename S>
cudaError_t attrs(int* res) {
  cudaError_t err = opt_in<T, VEC, S>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, tsd_kernel<T, VEC, S>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tsd_kernel<T, VEC, S>, S::THREADS, S::SMEM_BYTES);
  res[0] = a.numRegs;
  res[1] = (int)a.localSizeBytes;
  res[2] = (int)a.sharedSizeBytes;
  res[3] = (int)S::SMEM_BYTES;
  res[4] = blocks;
  res[5] = S::THREADS;
  res[6] = min_blocks<S>();
  return err;
}

// shape 0: Wide, 1: Narrow. F has a member template operator()<T, VEC, S>.
template <typename T, bool VEC, typename F>
cudaError_t by_shape(int shape, const F& f) {
  return shape == 0 ? f.template operator()<T, VEC, Wide>()
                    : f.template operator()<T, VEC, Narrow>();
}

template <typename F>
cudaError_t dispatch(int is_bf16, int vec, int shape, const F& f) {
  if (is_bf16)
    return vec ? by_shape<__nv_bfloat16, true>(shape, f)
               : by_shape<__nv_bfloat16, false>(shape, f);
  return vec ? by_shape<float, true>(shape, f) : by_shape<float, false>(shape, f);
}

struct LaunchCall {
  const void *fx, *fy;
  const float *ps, *weights, *inv_x, *inv_y;
  float *partial, *out;
  int n, h, w, c, tw, groups, cg;
  Taps taps;
  cudaStream_t stream;
  template <typename T, bool VEC, typename S>
  cudaError_t operator()() const {
    return launch<T, VEC, S>(fx, fy, ps, weights, inv_x, inv_y, partial, out, n,
                             h, w, c, tw, groups, cg, taps, stream);
  }
};

struct AttrsCall {
  int* res;
  template <typename T, bool VEC, typename S>
  cudaError_t operator()() const { return attrs<T, VEC, S>(res); }
};

constexpr int twmax(int shape) { return shape == 0 ? Wide::TWMAX : Narrow::TWMAX; }

}  // namespace

extern "C" int nqt_windowed_tsd(const void* fx, const void* fy, const void* ps,
                                const void* weights, const void* inv_x,
                                const void* inv_y, void* partial, void* out,
                                int n, int h, int w, int c, int is_bf16, int vec,
                                int shape, int tw, int groups, int cg,
                                const float* taps, int window, void* stream) {
  const int ccb = vec ? (is_bf16 ? 8 : 4) : LANES;
  if (window != K || h < K || w < K || n < 1 || n > 65535 || c < 1 ||
      (shape != 0 && shape != 1) || tw < 1 || tw > twmax(shape) || groups < 1 ||
      groups > 65535 || cg < 1 || cg % ccb != 0 || (int64_t)(groups - 1) * cg >= c ||
      (groups > 1 && partial == nullptr) || (vec && c % ccb != 0) ||
      (inv_x == nullptr) != (inv_y == nullptr))
    return (int)cudaErrorInvalidValue;
  LaunchCall call{fx, fy, static_cast<const float*>(ps),
                  static_cast<const float*>(weights),
                  static_cast<const float*>(inv_x),
                  static_cast<const float*>(inv_y), static_cast<float*>(partial),
                  static_cast<float*>(out), n, h, w, c, tw, groups, cg, Taps{},
                  static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < K; ++i) call.taps.g[i] = taps[i];
  return (int)dispatch(is_bf16, vec, shape, call);
}

// res[0..6]: registers a thread, local memory bytes a thread, static shared
// memory, dynamic shared memory, resident blocks an SM, threads a block, the
// launch bounds' minimum blocks an SM, of the variant nqt_windowed_tsd launches for (is_bf16, vec, shape).
extern "C" int nqt_windowed_tsd_attrs(int is_bf16, int vec, int shape, int* res) {
  if (shape != 0 && shape != 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch(is_bf16, vec, shape, AttrsCall{res});
}
