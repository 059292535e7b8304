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
// Bound: device memory (x and g read, dx written: 3*P*C elements); with the
// GELU, its erff and expf bring the instructions near the memory time.
// Design, for any C <= 1024 and any element alignment:
//   * Each warp walks its rows (one in every gridDim.x * 8, on a grid of
//     at most one resident wave that the wrapper sizes to the call:
//     ops/cuda/channelnorm.py _bwd_plan) through its own ring of 2-4 row
//     slots in shared memory, with the copies of the next rows in flight
//     while it reduces one; no barrier ties the block's warps together, so
//     some reduce while others wait for memory.
//   * A row is one contiguous span whatever the parity of C: it sits in its
//     slot at its own offset from a 16-byte boundary, so it is copied by
//     16-byte cp.async, with 4-byte cp.async for the words before the first
//     and after the last boundary. C = 387 moves as many bytes per
//     instruction as C = 448.
//   * Lane l reads channels l, l + 32, ... of the row: x into registers for
//     the centred two-pass statistics, then g; it keeps gs in place of x
//     for dx and adds dy * xh and dy into its lanes' column sums. dx goes
//     into the g slot at dx's own offset and leaves by 16-byte stores.
//   * Instructions bound it as soon as a row costs more than its bytes
//     allow: a 448-wide bf16 row moves 2,688 bytes, 185 cycles of an SM's
//     share of 3.35 TB/s, so ~740 warp instructions at 4 a cycle. So each
//     width C has its own variant (NJ = ceil(C / 32) values a lane, fully
//     unrolled): only the last slot is predicated, the slots' loops are
//     branch-free (the compiler issues all their shared-memory loads
//     ahead), the GELU branch sits outside them, and the copy loops run a
//     fixed number of rounds.
//   * Registers: 3 * NJ floats a lane, at most 128 a thread up to C = 704:
//     two blocks (16 warps) an SM, the rings sized to C in dynamic shared
//     memory (up to 115 KB a block). Wider rows (the decoder's C = 896
//     calls, 4,096 rows at most in a batch-4 step) take one block an SM
//     rather than spill.
//   * Column sums in a fixed order, no atomics: each lane's sums over its
//     warp's rows in row order, the block's warps added in warp order into
//     a (block, 2, C) fp32 partial, and a second launch of 2*C/32 blocks in
//     which warp w adds the partials of blocks w, w + 8, ... in double and
//     the 8 warps' sums are added in warp order. dscale and dbias repeat bit
//     for bit.
//
// C interface (loaded with ctypes): nqt_channel_norm and
// nqt_channel_norm_bwd return the cudaError_t of their launches; the caller
// allocates every output and the partial buffer. nqt_channel_norm_bwd_attrs
// reports the backward kernel's registers, local memory, shared memory,
// blocks per SM and its launch bounds' minimum blocks per SM at a width.

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

// ---- backward ----

// Widest variant (C <= 704) built for two blocks an SM; above it the 3 * NJ
// live floats a lane and the GELU's temporaries need more than 128
// registers, so C up to 1024 takes one block an SM.
constexpr int kBwdTwoBlocksNJ = 22;

template <typename T>
struct Bwd {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  // elements of one row's slot: the row at its global address's offset
  // from a 16-byte boundary (up to kVec - 1), plus the up to 2 bytes that
  // the 4-byte copy of its last element may bring, in whole vectors
  __host__ __device__ static constexpr int slot(int c) {
    return (c + 2 * kVec - 1) / kVec * kVec;
  }
  // rows in each warp's ring: as many as keep 2 blocks an SM within the
  // SM's 228 KB (115,712 bytes a block, 1 KB of it reserved) at the
  // variant's widest C, 2 to 4
  __host__ __device__ static constexpr int stages(int nj) {
    const int fit = (int)(14464 / (2 * sizeof(T) * slot(32 * nj)));
    return fit > 4 ? 4 : (fit < 2 ? 2 : fit);
  }
  // the block's rings: kWarps x stages x (x, g) slots; the block's final
  // column sums (kWarps x C floats) reuse them
  static size_t smem_bytes(int nj, int c) {
    return sizeof(T) * kWarps * stages(nj) * 2 * (size_t)slot(c);
  }
};
static_assert(Bwd<float>::stages(28) == 2 && Bwd<__nv_bfloat16>::stages(14) == 4,
              "fp32 at C = 896 keeps a ring of 2, bf16 at C <= 448 of 4");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Starts the copy of one row, n <= 32 * NJ elements at src, into its
// slot: the row's byte a lands at slot + (a & 15), so 16-byte vectors line
// up on both sides. The whole vectors go by 16-byte cp.async (a fixed
// number of rounds a lane, unrolled); the bytes before the first and after
// the last 16-byte boundary by 4-byte cp.async of the aligned words that
// hold them (lanes 0-7 and 8-15, at most 4 each). Each word copy reads
// only the bytes before the row's end (its src-size) and zero-fills the
// rest. A bf16 row that starts 2 bytes into a word shares that word with
// the previous row's last element, which lands beside the row in its slot
// and is never read; the tensor's first row (first) has no previous row,
// so lane 0 copies its first element by a plain load. No byte outside the
// tensor is read. The caller commits.
template <typename T, int NJ>
__device__ __forceinline__ void stage_row(T* slot, const T* src, int n, int lane,
                                          bool first) {
  constexpr int kRounds = (NJ * 32 * (int)sizeof(T) / 16 + 31) / 32;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a1 = a0 + (uintptr_t)n * sizeof(T);
  const uintptr_t base = a0 & ~(uintptr_t)15;  // at the slot's start
  const uintptr_t b0 = (a0 + 15) & ~(uintptr_t)15;
  const uintptr_t b1r = a1 & ~(uintptr_t)15;
  const uintptr_t b1 = b1r > b0 ? b1r : b0;  // whole vectors [b0, b1)
  const uintptr_t e1 = (a1 + 3) & ~(uintptr_t)3;
  const unsigned s0 = smem_addr(slot) - (unsigned)base;  // + a global address
  const uintptr_t u0 = b0 + 16 * (uintptr_t)lane;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const uintptr_t u = u0 + 512 * (uintptr_t)k;
    if (u < b1)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s0 + (unsigned)u),
                   "l"(u));
  }
  // lane < 8: word lane of the head [a0 & ~3, min(b0, e1)); else word
  // lane - 8 of the tail [b1, e1)
  const uintptr_t u = lane < 8 ? (a0 & ~(uintptr_t)3) + 4 * (uintptr_t)lane
                               : b1 + 4 * (uintptr_t)(lane - 8);
  const uintptr_t end = lane < 8 && b0 < e1 ? b0 : e1;
  if (sizeof(T) == 2 && first && lane == 0 && (a0 & 3)) {
    slot[(a0 - base) / sizeof(T)] = *src;
  } else if (lane < 16 && u < end) {
    const unsigned bytes = a1 - u < 4 ? (unsigned)(a1 - u) : 4u;  // u < a1
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s0 + (unsigned)u),
                 "l"(u), "r"(bytes));
  }
}

// Writes one row, n <= 32 * NJ elements that sit in slot at dst's offset
// from a 16-byte boundary, out to dst: whole vectors by 16-byte stores (a
// fixed number of rounds a lane), the head and tail element by element
// (lanes 0..2*kVec-1).
template <typename T, int NJ>
__device__ __forceinline__ void unstage_row(T* dst, const T* slot, int n, int lane) {
  constexpr int V = Bwd<T>::kVec;
  constexpr int kRounds = (NJ * 32 / V + 31) / 32;
  const int pad = (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
  const int head = pad ? min(V - pad, n) : 0;
  const int nvec = (n - head) / V;
  const T* src = slot + pad;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int v = lane + 32 * k;
    if (v < nvec)
      *reinterpret_cast<uint4*>(dst + head + v * V) =
          *reinterpret_cast<const uint4*>(src + head + v * V);
  }
  const int i = lane < V ? (lane < head ? lane : n) : head + nvec * V + lane - V;
  if (lane < 2 * V && i < n) dst[i] = src[i];
}

__device__ __forceinline__ int pad_of(const void* p, int size) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / size);
}

// One row's dy (with the GELU's derivative when GELU), its column sums and
// its row sums s1 = sum(gs), s2 = sum(gs * xh); a holds x in and gs out.
// Branch-free, so the compiler issues every slot's loads ahead; only the
// last slot (tail = lanes that hold a channel there) is predicated: a
// lane past C reads g as 0 (dy = 0 adds nothing) and the last channel's
// scale and bias.
template <bool GELU, typename T, int NJ>
__device__ __forceinline__ void row_grads(const T* gr, const float* __restrict__ scale,
                                          const float* __restrict__ bias, bool tail,
                                          int lane, float mean, float rstd, float (&a)[NJ],
                                          float (&acc_s)[NJ], float (&acc_b)[NJ],
                                          float& s1, float& s2) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const bool ok = j < NJ - 1 || tail;
    const int ch = j < NJ - 1 || tail ? j * 32 + lane : (NJ - 1) * 32;
    const float sc = __ldg(scale + ch);
    const float xh = (a[j] - mean) * rstd;
    float dy = ok ? to_f(gr[ch]) : 0.f;
    if (GELU) {
      const float t = fmaf(xh, sc, __ldg(bias + ch));
      const float cdf = 0.5f * (1.f + erff(t * kSqrtHalf));
      const float pdf = kInvSqrt2Pi * expf(-0.5f * t * t);
      dy *= fmaf(t, pdf, cdf);
    }
    acc_s[j] = fmaf(dy, xh, acc_s[j]);
    acc_b[j] += dy;
    const float gs = dy * sc;
    a[j] = gs;
    s1 += gs;
    s2 = fmaf(gs, xh, s2);
  }
}

// Backward, pass 1. Warp w of block b takes rows b * kWarps + w, then every
// gridDim.x * kWarps-th row after it, through its own ring of stages() row
// slots: the copies of the next stages() - 1 rows are in flight while it
// reduces one, and no barrier ties it to the other warps. Lane l holds
// channels l + 32 j (j < NJ = ceil(C / 32): only the last slot can be
// partial) and their running dscale / dbias sums. At the end the block
// adds its warps' sums in warp order and writes partial[b][0][:] (dscale)
// and partial[b][1][:] (dbias).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, NJ <= kBwdTwoBlocksNJ ? 2 : 1)
channel_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        T* __restrict__ dx, float* __restrict__ partial, int rows,
                        int c, float eps, int gelu) {
  constexpr int S = Bwd<T>::stages(NJ);
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = Bwd<T>::slot(c);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* const ring = reinterpret_cast<T*>(smem) + (size_t)warp * S * 2 * slot;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  const float inv_c = 1.f / c;
  const bool tail = lane < c - (NJ - 1) * 32;  // this lane has a channel in the last slot

  float acc_s[NJ], acc_b[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc_s[j] = acc_b[j] = 0.f;

  // stage i of the ring: x at ring + 2 * i * slot, g (then dx) after it;
  // one commit group a row, empty past the last row
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    const int r = first + i * stride;
    if (r < rows) {
      stage_row<T, NJ>(ring + 2 * i * slot, x + (int64_t)r * c, c, lane, r == 0);
      stage_row<T, NJ>(ring + (2 * i + 1) * slot, g + (int64_t)r * c, c, lane, r == 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  int st = 0;  // the stage of row r
  for (int r = first; r < rows; r += stride) {
    const int64_t rn = (int64_t)r + (S - 1) * stride;
    const int sn = st == 0 ? S - 1 : st - 1;  // the stage freed by the last row
    if (rn < rows) {
      stage_row<T, NJ>(ring + 2 * sn * slot, x + rn * c, c, lane, false);
      stage_row<T, NJ>(ring + (2 * sn + 1) * slot, g + rn * c, c, lane, false);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");
    __syncwarp();  // row r is in

    const int64_t e0 = (int64_t)r * c;
    T* const gsl = ring + (2 * st + 1) * slot;
    const T* const xr = ring + 2 * st * slot + pad_of(x + e0, sizeof(T));
    const T* const gr = gsl + pad_of(g + e0, sizeof(T));
    float a[NJ];  // x, then gs
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      a[j] = j < NJ - 1 || tail ? to_f(xr[j * 32 + lane]) : 0.f;
      sum += a[j];
    }
    const float mean = warp_sum(sum) * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float d = j < NJ - 1 || tail ? a[j] - mean : 0.f;
      sq = fmaf(d, d, sq);
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_c + eps);
    float s1 = 0.f, s2 = 0.f;
    if (gelu)
      row_grads<true>(gr, scale, bias, tail, lane, mean, rstd, a, acc_s, acc_b, s1, s2);
    else
      row_grads<false>(gr, scale, bias, tail, lane, mean, rstd, a, acc_s, acc_b, s1, s2);
    const float m1 = warp_sum(s1) * inv_c;
    const float m2 = warp_sum(s2) * inv_c;
    __syncwarp();  // every lane has read g: dx may take its slot
    T* const dr = gsl + pad_of(dx + e0, sizeof(T));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {  // predicated only in the last slot
      const bool ok = j < NJ - 1 || tail;
      const float xh = ((ok ? to_f(xr[j * 32 + lane]) : 0.f) - mean) * rstd;
      const T o = from_f<T>(rstd * (a[j] - m1 - xh * m2));
      if (ok) dr[j * 32 + lane] = o;
    }
    __syncwarp();
    unstage_row<T, NJ>(dx + e0, gsl, c, lane);
    __syncwarp();  // the stage is free for the copy of a later row
    st = st == S - 1 ? 0 : st + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the block's sums, dscale then dbias, each in warp order
  float* const red = reinterpret_cast<float*>(smem);  // [kWarps][c]
  __syncthreads();
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < NJ - 1 || tail) red[warp * c + j * 32 + lane] = pass == 0 ? acc_s[j] : acc_b[j];
    }
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * c + ch];
      partial[((int64_t)blockIdx.x * 2 + pass) * c + ch] = s;
    }
    __syncthreads();
  }
}

// Backward, pass 2: the 2*C outputs [dscale; dbias], 32 a block: lane l
// takes output blockIdx.x * 32 + l, warp w adds the partials of blocks w,
// w + 8, ... in order, in double, and warp 0 adds the 8 warps' sums in warp
// order.
__global__ void __launch_bounds__(kThreads)
channel_norm_bwd_finalize(const float* __restrict__ partial, float* __restrict__ dscale,
                          float* __restrict__ dbias, int blocks, int c) {
  __shared__ double red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane;
  double t = 0.0;
  if (o < 2 * c) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kWarps) t += (double)partial[(int64_t)b * 2 * c + o];
  }
  red[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && o < 2 * c) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][lane];
    if (o < c)
      dscale[o] = (float)s;
    else
      dbias[o - c] = (float)s;
  }
}

// Calls f(std::integral_constant<int, NJ>) with NJ = ceil(c / 32), the
// values a lane holds for a row of c channels.
template <int NJ = 1, typename F>
cudaError_t with_slots(int c, F&& f) {
  if constexpr (NJ > kMaxPerLane) {
    return cudaErrorInvalidValue;
  } else {
    if ((c + 31) / 32 == NJ) return f(std::integral_constant<int, NJ>{});
    return with_slots<NJ + 1>(c, f);
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, and the SM must
// give shared memory its largest carve-out for two 115 KB blocks: once per
// variant and process.
template <typename T, int NJ>
cudaError_t bwd_opt_in() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(channel_norm_bwd_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Bwd<T>::smem_bytes(NJ, 32 * NJ));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(channel_norm_bwd_kernel<T, NJ>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  return err;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const float* scale, const float* bias,
                       void* dx, float* partial, float* dscale, float* dbias, int rows,
                       int c, float eps, int gelu, int blocks, cudaStream_t s) {
  const cudaError_t err = with_slots(c, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    const cudaError_t e = bwd_opt_in<T, NJ>();
    if (e != cudaSuccess) return e;
    channel_norm_bwd_kernel<T, NJ><<<blocks, kThreads, Bwd<T>::smem_bytes(NJ, c), s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), scale, bias,
        static_cast<T*>(dx), partial, rows, c, eps, gelu);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  channel_norm_bwd_finalize<<<(2 * c + 31) / 32, kThreads, 0, s>>>(partial, dscale, dbias,
                                                                  blocks, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_attrs(int c, int* res) {
  return with_slots(c, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    cudaError_t err = bwd_opt_in<T, NJ>();
    if (err != cudaSuccess) return err;
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, channel_norm_bwd_kernel<T, NJ>);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, channel_norm_bwd_kernel<T, NJ>, kThreads, Bwd<T>::smem_bytes(NJ, c));
    res[0] = a.numRegs;
    res[1] = (int)a.localSizeBytes;
    res[2] = (int)a.sharedSizeBytes;
    res[3] = (int)Bwd<T>::smem_bytes(NJ, c);
    res[4] = blocks;
    res[5] = kThreads;
    res[6] = NJ <= kBwdTwoBlocksNJ ? 2 : 1;  // the launch bounds' minimum
    return err;
  });
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
                                    int gelu, int is_bf16, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  if (rows <= 0 || c <= 0 || c > kMaxChannels || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_bwd<__nv_bfloat16>(x, g, sc, bi, dx, part, ds, db, rows, c, eps, gelu, blocks, s);
  return (int)launch_bwd<float>(x, g, sc, bi, dx, part, ds, db, rows, c, eps, gelu, blocks, s);
}

extern "C" int nqt_channel_norm_bwd_attrs(int is_bf16, int c, int* res) {
  if (c <= 0 || c > kMaxChannels) return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? bwd_attrs<__nv_bfloat16>(c, res) : bwd_attrs<float>(c, res));
}
