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
// C outputs (3.2 KB at C = 384 in fp32) and does 49 * (2*32 + 2*C)
// operations, about 13 per byte, under the card's fp32 ratio of operations
// to bytes (20 per byte at 67 TFLOP/s and 3.35 TB/s). So the 49-tap sums
// must run at well over half the FMA rate while the source streams in.
//
// Design. One block of 256 threads per 16x16 output tile of one image and
// one group of channels (the wrapper splits the channels across blocks on
// the levels whose tiles fill less than a wave); two blocks fit an SM
// (110 KB of shared memory each): 16 warps.
//   1. The tile's projection with its 3-pixel halo (22x22x32 fp32) is staged
//      with 16-byte cp.async copies. Each pixel's eight float4 slots are
//      XOR-swizzled by the pixel index, so the 32 lanes of a warp, reading
//      one float4 of 32 neighbouring pixels, hit every bank evenly.
//   2. One thread per pixel forms its 49 logits (the 7 taps of a row as 7
//      independent chains, each summed over the 32 keys in order), the
//      softmax, the spatial product and the normalisation, and stores its
//      49 weights in shared memory as [tap][pixel].
//   3. The block walks over its channels 32 at a time: the cp.async copy of
//      a chunk (22x22 pixels x 32 channels, reusing the projection's space)
//      lands, then a thread sums 2 rows x 4 neighbouring pixels x 4
//      channels (one float4): each of the 8 source rows it touches is
//      loaded once as 10 float4s and serves tap row dy of the first output
//      row and dy - 1 of the second, and the 4 pixels' weights of a tap
//      come as one broadcast float4, so a source load feeds 20 FMAs on
//      average and a weight load 16. A warp's 8 slot lanes x 4 segments
//      read 4 whole 128-byte lines: no bank conflicts. Each output is
//      summed over the taps in order 0..48: results repeat bit for bit.
//      The other block on the SM computes while a chunk is in flight.
// The reflect offsets of the 22 halo rows and columns are computed once per
// block into a table. Where C is not a multiple of 4, a pointer is not
// 16-byte aligned or the inputs are bf16, the same layout is filled by
// plain loads (zeros past C) and the outputs are stored one by one. The
// TPU kernel's two-view halo and its 8-row, 16-column alignment are Mosaic
// artefacts and are not carried over: any H, W > 3 works.
// What still holds it back: the sums' shared-memory wavefronts (about one
// for every warp FMA instruction), a chunk's copy that only the other block
// on the SM hides, the 22x22 halo (the L2 delivers 1.89x the source), and
// on the small levels the weights each channel group computes again.
//
// C interface (loaded with ctypes): nqt_jbu_filter returns the cudaError_t
// of its launch; nqt_jbu_attrs reports the kernel's registers, local memory,
// shared memory and blocks per SM; the caller allocates out.

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
constexpr int kHalo = kTile + 2 * kR;  // 22
constexpr int kPos = kHalo * kHalo;    // 484
constexpr int kThreads = kTile * kTile;
constexpr int kMinBlocks = 2;  // resident blocks an SM the kernel is built for
constexpr int kCC = 32;  // channels of a chunk: 8 float4 slots a pixel
constexpr int kPx = 4;   // pixels of a thread along a row, in each of 2 rows
// shared memory in floats: weights [49][256], then one chunk buffer of
// [484][32] (the projection, also [484][32], uses it first), then the
// reflect tables
constexpr int kWtsFloats = kTaps * kThreads;
constexpr int kBufFloats = kPos * kCC;
constexpr size_t kSmemBytes =
    sizeof(float) * (kWtsFloats + kBufFloats) + sizeof(int) * 2 * kHalo;
static_assert(kK == kCC, "the projection fills the chunk buffer");
static_assert(kSmemBytes * kMinBlocks <= 230 * 1024, "two blocks an SM");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// torch's reflect padding; the clamp only guards halo rows of tile pixels
// that lie outside the image, whose results are never written.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// float4 index of slot k of halo position pos in the projection stage
__device__ __forceinline__ int proj_slot(int pos, int k) {
  return pos * (kK / 4) + (k ^ (pos & 7));
}
// float4 index of slot l (channels 4l..4l+3) of halo position pos in the
// chunk buffer: a pixel is one 128-byte line, so the 8 slot lanes of a
// warp's 4 segments read 4 whole lines
__device__ __forceinline__ int chunk_slot(int pos, int l) { return pos * (kCC / 4) + l; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy channels [c0, c0 + kCC) of the tile's halo into buf. VEC: fp32 with
// C % 4 == 0 and 16-byte aligned pointers, by cp.async; else plain loads
// (zeros past C).
template <typename T, bool VEC>
__device__ __forceinline__ void stage_chunk(float* buf, const T* __restrict__ hr,
                                            int64_t img, const int* rows,
                                            const int* cols, int w, int c,
                                            int c0, int tid) {
  if constexpr (VEC) {
    for (int e = tid; e < kPos * (kCC / 4); e += kThreads) {
      const int pos = e >> 3;
      const int l = e & 7;
      float4* dst = reinterpret_cast<float4*>(buf) + chunk_slot(pos, l);
      if (c0 + 4 * l < c) {
        const int64_t pix = img + (int64_t)rows[pos / kHalo] * w + cols[pos % kHalo];
        cp_async16(dst, hr + pix * c + c0 + 4 * l);
      } else {
        *dst = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = tid; e < kPos * (kCC / 4); e += kThreads) {
      const int pos = e >> 3;
      const int l = e & 7;
      const int64_t pix = img + (int64_t)rows[pos / kHalo] * w + cols[pos % kHalo];
      const T* src = hr + pix * c + c0 + 4 * l;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = c0 + 4 * l + q < c ? to_f(src[q]) : 0.f;
      reinterpret_cast<float4*>(buf)[chunk_slot(pos, l)] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
jbu_kernel(const T* __restrict__ hr, const T* __restrict__ proj,
           const float* __restrict__ spatial, const float* __restrict__ temp_ptr,
           float* __restrict__ out, int h, int w, int c, int groups, int cg) {
  extern __shared__ __align__(16) float smem[];
  float* wts = smem;                // [kTaps][kThreads]
  float* buf = smem + kWtsFloats;   // the projection, then the chunks
  int* rows = reinterpret_cast<int*>(buf + kBufFloats);
  int* cols = rows + kHalo;
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const int n = blockIdx.z / groups;
  const int cbeg = (blockIdx.z % groups) * cg;
  const int cend = min(c, cbeg + cg);
  const int64_t img = (int64_t)n * h * w;

  if (tid < kHalo) rows[tid] = reflect(y0 - kR + tid, h);
  else if (tid < 2 * kHalo) cols[tid - kHalo] = reflect(x0 - kR + tid - kHalo, w);
  __syncthreads();

  // 1. the projection's halo tile
  float4* pst = reinterpret_cast<float4*>(buf);
  if constexpr (VEC) {
    for (int e = tid; e < kPos * (kK / 4); e += kThreads) {
      const int pos = e >> 3;
      const int k = e & 7;
      const int64_t pix = img + (int64_t)rows[pos / kHalo] * w + cols[pos % kHalo];
      cp_async16(pst + proj_slot(pos, k), proj + pix * kK + 4 * k);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int e = tid; e < kPos * (kK / 4); e += kThreads) {
      const int pos = e >> 3;
      const int k = e & 7;
      const int64_t pix = img + (int64_t)rows[pos / kHalo] * w + cols[pos % kHalo];
      const T* src = proj + pix * kK + 4 * k;
      pst[proj_slot(pos, k)] = make_float4(to_f(src[0]), to_f(src[1]), to_f(src[2]),
                                           to_f(src[3]));
    }
  }
  __syncthreads();

  // 2. one thread per pixel: logits, softmax, spatial product, normalisation
  {
    const int py = tid / kTile;
    const int px = tid % kTile;
    const float temp = __ldg(temp_ptr);
    float ctr[kK];
    const int cpos = (py + kR) * kHalo + px + kR;
#pragma unroll
    for (int k = 0; k < kK / 4; ++k) {
      const float4 v = pst[proj_slot(cpos, k)];
      ctr[4 * k] = v.x;
      ctr[4 * k + 1] = v.y;
      ctr[4 * k + 2] = v.z;
      ctr[4 * k + 3] = v.w;
    }
    // the 7 taps of a row at once: 7 independent chains, each summed over
    // k in order
    float m = -INFINITY;
    for (int dy = 0; dy < kD; ++dy) {
      const int pos0 = (py + dy) * kHalo + px;
      float dot[kD];
#pragma unroll
      for (int dx = 0; dx < kD; ++dx) dot[dx] = 0.f;
#pragma unroll
      for (int k = 0; k < kK / 4; ++k) {
#pragma unroll
        for (int dx = 0; dx < kD; ++dx) {
          const float4 v = pst[proj_slot(pos0 + dx, k)];
          dot[dx] = fmaf(v.x, ctr[4 * k], dot[dx]);
          dot[dx] = fmaf(v.y, ctr[4 * k + 1], dot[dx]);
          dot[dx] = fmaf(v.z, ctr[4 * k + 2], dot[dx]);
          dot[dx] = fmaf(v.w, ctr[4 * k + 3], dot[dx]);
        }
      }
#pragma unroll
      for (int dx = 0; dx < kD; ++dx) {
        const float l = temp * dot[dx];
        wts[(dy * kD + dx) * kThreads + tid] = l;
        m = fmaxf(m, l);
      }
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
  __syncthreads();  // the weights are in; the projection's space is free

  // 3. the channels, kCC at a time
  const int l = tid & 7;           // float4 slot: channels 4l..4l+3 of a chunk
  const int seg = tid >> 3;        // 32 segments of 2 x kPx pixels
  const int r0 = (seg >> 2) * 2;   // rows r0, r0 + 1 of the tile
  const int sx = (seg & 3) * kPx;
  const int nch = (cend - cbeg + kCC - 1) / kCC;
  const float4* wq = reinterpret_cast<const float4*>(wts) + (r0 * kTile + sx) / 4;
  const float4* cb = reinterpret_cast<const float4*>(buf);
  for (int k = 0; k < nch; ++k) {
    const int c0 = cbeg + k * kCC;
    stage_chunk<T, VEC>(buf, hr, img, rows, cols, w, c, c0, tid);
    if constexpr (VEC) {
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk k is in
    float4 acc[2][kPx];
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
#pragma unroll
      for (int j = 0; j < kPx; ++j) acc[pr][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    // source row r0 + yy serves tap row dy = yy - pr of output row r0 + pr;
    // each output's taps are summed in order 0..48
#pragma unroll
    for (int yy = 0; yy < kD + 1; ++yy) {
      float4 v[kPx + kD - 1];
      const int base = (r0 + yy) * kHalo + sx;
#pragma unroll
      for (int u = 0; u < kPx + kD - 1; ++u) v[u] = cb[chunk_slot(base + u, l)];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int dy = yy - pr;
        if (dy < 0 || dy >= kD) continue;
#pragma unroll
        for (int dx = 0; dx < kD; ++dx) {
          const float4 g = wq[(dy * kD + dx) * (kThreads / 4) + pr * (kTile / 4)];
          const float gw[kPx] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int j = 0; j < kPx; ++j) {
            acc[pr][j].x = fmaf(v[j + dx].x, gw[j], acc[pr][j].x);
            acc[pr][j].y = fmaf(v[j + dx].y, gw[j], acc[pr][j].y);
            acc[pr][j].z = fmaf(v[j + dx].z, gw[j], acc[pr][j].z);
            acc[pr][j].w = fmaf(v[j + dx].w, gw[j], acc[pr][j].w);
          }
        }
      }
    }
    const int ch = c0 + 4 * l;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int oy = y0 + r0 + pr;
      if (oy >= h) continue;
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int ox = x0 + sx + j;
        if (ox >= w) continue;
        float* o = out + (img + (int64_t)oy * w + ox) * c + ch;
        if (VEC && ch + 3 < cend) {
          *reinterpret_cast<float4*>(o) = acc[pr][j];
        } else {
          const float a[4] = {acc[pr][j].x, acc[pr][j].y, acc[pr][j].z, acc[pr][j].w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (ch + q < cend) o[q] = a[q];
        }
      }
    }
    __syncthreads();  // every thread is done with the buffer
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* hr, const void* proj, const float* spatial,
                   const float* temp, float* out, int n, int h, int w, int c,
                   int groups, int cg, cudaStream_t stream) {
  // above 48 KB of shared memory a kernel must opt in, once per process
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      jbu_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n * groups);
  jbu_kernel<T, VEC><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(hr), static_cast<const T*>(proj), spatial, temp, out,
      h, w, c, groups, cg);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t attrs(int* res) {
  cudaError_t err = cudaFuncSetAttribute(
      jbu_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, jbu_kernel<T, VEC>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jbu_kernel<T, VEC>,
                                                      kThreads, kSmemBytes);
  res[0] = a.numRegs;
  res[1] = (int)a.localSizeBytes;
  res[2] = (int)a.sharedSizeBytes;
  res[3] = (int)kSmemBytes;
  res[4] = blocks;
  res[5] = kThreads;
  res[6] = kMinBlocks;
  return err;
}

}  // namespace

extern "C" int nqt_jbu_filter(const void* hr, const void* proj, const void* spatial,
                              const void* temp, void* out, int n, int h, int w,
                              int c, int is_bf16, int vec, int groups, int cg,
                              void* stream) {
  if (n <= 0 || h <= kR || w <= kR || c <= 0 || groups < 1 || cg < 1 ||
      cg % kCC != 0 || (int64_t)(groups - 1) * cg >= c ||
      (int64_t)n * groups > 65535 || (vec && (is_bf16 || c % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(spatial);
  const float* tp = static_cast<const float*>(temp);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, false>(hr, proj, sp, tp, o, n, h, w, c, groups, cg, s);
  if (vec) return (int)launch<float, true>(hr, proj, sp, tp, o, n, h, w, c, groups, cg, s);
  return (int)launch<float, false>(hr, proj, sp, tp, o, n, h, w, c, groups, cg, s);
}

// res[0..6]: registers a thread, local memory bytes a thread, static shared
// memory, dynamic shared memory, resident blocks an SM, threads a block, the
// launch bounds' minimum blocks an SM, of
// the variant nqt_jbu_filter launches for (is_bf16, vec).
extern "C" int nqt_jbu_attrs(int is_bf16, int vec, int* res) {
  if (is_bf16) return (int)attrs<__nv_bfloat16, false>(res);
  return (int)(vec ? attrs<float, true>(res) : attrs<float, false>(res));
}
