// ADISTS windowed gamma sum, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's windowed_gamma_sum
// (nerf_qa_tpu/core/adists.py) is XLA band matmuls over channel blocks,
// and the port's plain version (ops/cuda/windowed_gamma.py) loops over
// blocks of 16 channels with ops/windowed.window_mean, whose VALID moment
// maps go through device memory. For one feature stage f (N, H, W, C)
// NHWC this kernel computes, per image n and VALID output pixel (i, j) of
// the 21x21 Gaussian window (Hk = H - 20, Wk = W - 20),
//     out[n, i, j] = sum_c (W(f^2) - W(f)^2) / (W(f) + 1e-12)
// and writes only that map: the moment maps never leave the chip, so no
// channel blocks are needed.
//
// Bound: operations. Per (output pixel, channel) the separable window takes
// 21 taps x 2 moments of multiply-adds in each of two passes, one square
// per input and ~5 operations of the ratio and the channel sum, about 174
// fp32 operations on the CUDA cores, while the map is read once (itemsize
// bytes per input pixel and channel). At the 1080p stages the operations
// take 2.6-4.3x the bytes' time at the card's fp32 and memory peaks. The windows
// stay true fp32 and are direct sums of the 21 taps (no prefix or running
// sums, no tensor cores): the variance is a difference of nearly equal
// window sums, and a window over zeros sums to exactly 0, so gamma is 0
// there and never a ratio of rounding residues.
//
// Design (the tiling of csrc/windowed_tsd.cu, with one map and two
// moments). One block owns an output tile of TH = 8 rows x tw columns of
// one image and one group of channels, and walks that group in chunks of
// CCB channels (8 in bf16, 4 in fp32: one 16-byte copy a pixel):
//   staging: the chunk's input box, 28 rows x (tw + 20) columns x CCB
//     channels, goes to shared memory with 16-byte cp.async copies; rows
//     and columns past the image use the zero-fill form. The copy of chunk
//     k + 1 is issued as soon as the H pass of chunk k is done and runs
//     under its W pass. Where C is not a multiple of CCB or the pointer is
//     not 16-byte aligned (stage 0, C = 3), plain loads fill the same
//     layout 4 channels at a time, zeros past C.
//   H pass: one thread per (input column, channel) of a 4-channel subpass
//     reads its column's 28 values once, squares each once and keeps the
//     2 x 8 vertical window sums in registers, then writes them to shared
//     memory.
//   W pass: one warp per strip of SW output columns, one lane per (output
//     row, channel), so a warp's loads hit 32 banks; a lane reads SW + 20
//     vertical sums per moment, forms the SW windowed moments, then the
//     ratio (rounded as the plain version rounds it: no contraction), and
//     adds it to SW running sums kept in registers across the chunks.
// At the end the 4 channel lanes of each output are summed in a fixed
// order through shared memory. 512 threads and ~90 KB a block, two blocks
// an SM (32 warps), so one block's barriers are filled by the other's
// work. Where a stage gives fewer than two waves of blocks, the wrapper
// splits the channels across blocks (grid z): each group writes its
// partial map and a second launch adds them in group order. No atomics:
// results repeat bit for bit. H, W >= 21 is the only precondition.
//
// C interface (loaded with ctypes): nqt_windowed_gamma returns the
// cudaError_t of its launches; nqt_windowed_gamma_attrs reports a variant's
// registers, local memory, shared memory and blocks per SM; the caller
// allocates out and, for several channel groups, the partial maps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 21;   // window
constexpr int TH = 8;   // output rows of a tile
constexpr int BR = TH + K - 1;  // 28 input rows of a box
constexpr int MOMENTS = 2;  // the window sums of f and f^2
constexpr int LANES = 4;  // channels of a subpass
constexpr float C0 = 1e-12f;

// The compiled tile shape. IWMAX input columns of a box; VCOLS the row
// stride of the vertical sums: room for whole strips, odd, so that the 32
// (row, channel) lanes of a W-pass warp read 32 banks, and = 9 mod 32, so
// that the H pass's 4 channel lanes x 8 columns of a warp overlap little.
constexpr int THREADS = 512;
constexpr int TWMAX = 108;
constexpr int SW = 7;
constexpr int MIN_BLOCKS = 2;
constexpr int IWMAX = TWMAX + K - 1;
constexpr int STRIPS = (TWMAX + SW - 1) / SW;
constexpr int VCOLS = ((STRIPS * SW + K - 1 + 22) / 32) * 32 + 9;
constexpr size_t BOX_BYTES = BR * IWMAX * 16;
constexpr size_t SMEM_BYTES = BOX_BYTES + sizeof(float) * MOMENTS * TH * LANES * VCOLS;
static_assert(IWMAX * LANES <= THREADS, "one H-pass item per thread");
static_assert(TH * LANES == 32 && STRIPS * 32 <= THREADS, "one W-pass strip a warp");
static_assert(VCOLS >= STRIPS * SW + K - 1 && VCOLS % 32 == 9, "vsum stride");
// the SM's 228 KB, less 1 KB the hardware keeps for each block
static_assert(MIN_BLOCKS * (SMEM_BYTES + 1024) <= 228 * 1024, "two blocks an SM");

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

template <typename T, bool VEC>
struct Box {
  static constexpr int CCB = VEC ? 16 / (int)sizeof(T) : LANES;
};

// Stage channels [c0, c0 + CCB) of the box rows and columns of the tile.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(T* box, const T* __restrict__ f,
                                      int64_t img, int oy0, int ox0, int iw,
                                      int h, int w, int c, int c0, int tid) {
  constexpr int CCB = Box<T, VEC>::CCB;
  const int per = BR * iw;
  for (int e = tid; e < per; e += THREADS) {
    const int r = e / iw;
    const int j = e - r * iw;
    const int gy = oy0 + r;
    const int gx = ox0 + j;
    const bool ok = gy < h && gx < w;
    T* d = box + (r * IWMAX + j) * CCB;
    if constexpr (VEC) {
      const T* p = ok ? f + (img + (int64_t)gy * w + gx) * c + c0 : f;
      cp_async16_zfill(d, p, ok);
    } else {
      const T* src = f + (ok ? (img + (int64_t)gy * w + gx) * c + c0 : 0);
#pragma unroll
      for (int ch = 0; ch < CCB; ++ch) d[ch] = ok && c0 + ch < c ? src[ch] : zero_of<T>();
    }
  }
  if constexpr (VEC) asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gamma_kernel(const T* __restrict__ f, float* __restrict__ dst, int h, int w,
             int c, int tw, int tiles_w, int cg, const Taps taps) {
  constexpr int CCB = Box<T, VEC>::CCB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* box = reinterpret_cast<T*>(smem_raw);  // [BR][IWMAX][CCB]
  float* vs = reinterpret_cast<float*>(smem_raw + BOX_BYTES);  // [MOMENTS][TH][LANES][VCOLS]
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
  float acc[SW];
#pragma unroll
  for (int q = 0; q < SW; ++q) acc[q] = 0.f;

  const int nchunks = (cend - cbeg + CCB - 1) / CCB;
  stage<T, VEC>(box, f, img, oy0, ox0, iw, h, w, c, cbeg, tid);
  for (int k = 0; k < nchunks; ++k) {
    const int c0 = cbeg + k * CCB;
    if constexpr (VEC) asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the box is in; the last W pass is done with vs
    const int nsub = min(CCB / LANES, (cend - c0 + LANES - 1) / LANES);
    for (int sub = 0; sub < nsub; ++sub) {
      if (sub > 0) __syncthreads();  // the last W pass is done with vs

      // ---- H pass: 2 x TH vertical window sums of one column and channel
      if (h_ok) {
        float hs[MOMENTS][TH];
#pragma unroll
        for (int m = 0; m < MOMENTS; ++m)
#pragma unroll
          for (int q = 0; q < TH; ++q) hs[m][q] = 0.f;
        const T* b = box + hj * CCB + sub * LANES + hl;
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          const float x = to_float(b[r * IWMAX * CCB]);
          const float v[MOMENTS] = {x, __fmul_rn(x, x)};
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
        stage<T, VEC>(box, f, img, oy0, ox0, iw, h, w, c, c0 + CCB, tid);

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
#pragma unroll
        for (int q = 0; q < SW; ++q) {
          const float mean = wm[0][q];
          const float var = __fsub_rn(wm[1][q], __fmul_rn(mean, mean));
          acc[q] = __fadd_rn(acc[q], __fdiv_rn(var, __fadd_rn(mean, C0)));
        }
      }
    }
  }

  // sum the 4 channel lanes of each output, in lane order
  __syncthreads();
  float* red = vs;  // [TH][LANES][VCOLS]
  if (w_ok) {
#pragma unroll
    for (int q = 0; q < SW; ++q) red[(o * LANES + wl) * VCOLS + s * SW + q] = acc[q];
  }
  __syncthreads();
  for (int e = tid; e < TH * tw; e += THREADS) {
    const int r = e / tw;
    const int col = e - r * tw;
    const int y = oy0 + r, x = ox0 + col;
    if (y >= hk || x >= wk) continue;
    const float* v = red + r * LANES * VCOLS + col;
    dst[((int64_t)n * hk + y) * wk + x] = ((v[0] + v[VCOLS]) + v[2 * VCOLS]) + v[3 * VCOLS];
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in group order
__global__ void gamma_sum_groups(const float* __restrict__ partial,
                                 float* __restrict__ out, int64_t count, int groups) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = partial[i];
    for (int g = 1; g < groups; ++g) v += partial[g * count + i];
    out[i] = v;
  }
}

template <typename T, bool VEC>
cudaError_t opt_in() {
  // above 48 KB of shared memory a kernel must opt in, once per process
  static const cudaError_t err = cudaFuncSetAttribute(
      gamma_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  return err;
}

template <typename T, bool VEC>
cudaError_t launch(const void* f, float* partial, float* out, int n, int h,
                   int w, int c, int tw, int groups, int cg, const Taps& taps,
                   cudaStream_t stream) {
  cudaError_t err = opt_in<T, VEC>();
  if (err != cudaSuccess) return err;
  const int hk = h - K + 1;
  const int wk = w - K + 1;
  const int tiles_w = (wk + tw - 1) / tw;
  const int tiles_h = (hk + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, n, groups);
  gamma_kernel<T, VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(f), groups > 1 ? partial : out, h, w, c, tw,
      tiles_w, cg, taps);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const int64_t count = (int64_t)n * hk * wk;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  gamma_sum_groups<<<blocks, 256, 0, stream>>>(partial, out, count, groups);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t attrs(int* res) {
  cudaError_t err = opt_in<T, VEC>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, gamma_kernel<T, VEC>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gamma_kernel<T, VEC>, THREADS, SMEM_BYTES);
  res[0] = a.numRegs;
  res[1] = (int)a.localSizeBytes;
  res[2] = (int)a.sharedSizeBytes;
  res[3] = (int)SMEM_BYTES;
  res[4] = blocks;
  res[5] = THREADS;
  res[6] = MIN_BLOCKS;
  return err;
}

// F has a member template operator()<T, VEC>.
template <typename F>
cudaError_t dispatch(int is_bf16, int vec, const F& fn) {
  if (is_bf16)
    return vec ? fn.template operator()<__nv_bfloat16, true>()
               : fn.template operator()<__nv_bfloat16, false>();
  return vec ? fn.template operator()<float, true>()
             : fn.template operator()<float, false>();
}

struct LaunchCall {
  const void* f;
  float *partial, *out;
  int n, h, w, c, tw, groups, cg;
  Taps taps;
  cudaStream_t stream;
  template <typename T, bool VEC>
  cudaError_t operator()() const {
    return launch<T, VEC>(f, partial, out, n, h, w, c, tw, groups, cg, taps, stream);
  }
};

struct AttrsCall {
  int* res;
  template <typename T, bool VEC>
  cudaError_t operator()() const { return attrs<T, VEC>(res); }
};

}  // namespace

extern "C" int nqt_windowed_gamma(const void* f, void* partial, void* out, int n,
                                  int h, int w, int c, int is_bf16, int vec,
                                  int tw, int groups, int cg, const float* taps,
                                  int window, void* stream) {
  const int ccb = vec ? (is_bf16 ? 8 : 4) : LANES;
  if (window != K || h < K || w < K || n < 1 || n > 65535 || c < 1 || tw < 1 ||
      tw > TWMAX || groups < 1 || groups > 65535 || cg < 1 || cg % ccb != 0 ||
      (int64_t)(groups - 1) * cg >= c || (groups > 1 && partial == nullptr) ||
      (vec && c % ccb != 0))
    return (int)cudaErrorInvalidValue;
  LaunchCall call{f, static_cast<float*>(partial), static_cast<float*>(out), n, h,
                  w, c, tw, groups, cg, Taps{}, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < K; ++i) call.taps.g[i] = taps[i];
  return (int)dispatch(is_bf16, vec, call);
}

// res[0..6]: registers a thread, local memory bytes a thread, static shared
// memory, dynamic shared memory, resident blocks an SM, threads a block, the
// launch bounds' minimum blocks an SM, of the variant nqt_windowed_gamma
// launches for (is_bf16, vec).
extern "C" int nqt_windowed_gamma_attrs(int is_bf16, int vec, int* res) {
  return (int)dispatch(is_bf16, vec, AttrsCall{res});
}
