// The VGG pyramid's elementwise epilogues, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fused the bias add, the ReLU,
// the L2 pool's square and its sqrt(. + 1e-12) into the convolutions around
// them. On the card the convolutions are cuDNN's, and PyTorch ran each of
// those elementwise ops as its own pass over device memory. Two passes here
// take their place:
//   nqt_bias_relu  h = relu(round(y + b)) in place over a conv output y, and
//                  optionally sq = round(h * h) into a second buffer (the
//                  squares the next stage's L2 pool convolves);
//   nqt_pool_root  p = round(sqrt(round(p + 1e-12))) in place over the
//                  pool's depthwise conv output.
// "round" is the flow dtype's rounding (bf16 round-to-nearest-even, or
// none in fp32), taken where PyTorch's add_, relu_, mul, add_ and sqrt_
// took it, so the results equal theirs bit for bit: fp32 arithmetic,
// clamp_min's NaN rule, sqrtf correctly rounded (no fast-math flags).
//
// Bound: device memory. A pass reads and writes each element once and does
// one or two operations on it. A 1080p batch of 8 pairs (16 images through
// the pyramid) moves 47.8 GB: 35.8 GB over the 13 conv outputs, 7.96 GB of
// squares written at the ends of stages 1-4, and 3.98 GB over the pooled
// maps; 14.3 ms at 3.35 TB/s.
//
// Design for that bound:
//   - 16-byte vector loads and stores (8 bf16 or 4 fp32 values) along the
//     contiguous buffer, with a scalar path for an unaligned pointer or a
//     channel count that is not a multiple of the vector;
//   - a grid-stride loop whose stride (blocks x threads) is a multiple of
//     the channel vectors of one channels_last row, so a thread's channels
//     never change and it loads its bias into registers once;
//   - kUnroll independent vectors in flight per thread before any store;
//   - streaming (evict-first) loads and stores: a stage-1 map of the 1080p
//     batch is 4.25 GB against the 50 MB L2;
//   - 64-bit offsets (stage 1 of that batch is 2.12 G elements).
// An NCHW-contiguous map (ST-LPIPS's blur pool hands the conv one) takes a
// plane path: the vector stays inside one channel plane and its bias is
// looked up per vector.
//
// C interface (loaded with ctypes): each function returns the cudaError_t
// of its launch and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// The flow dtypes, stored as raw bits (bf16) or floats, computed in fp32.
struct Bf16 {
  using S = unsigned short;
  __device__ __forceinline__ static float load(S s) {
    return __uint_as_float(static_cast<unsigned int>(s) << 16);
  }
  __device__ __forceinline__ static S store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F32 {
  using S = float;
  __device__ __forceinline__ static float load(S s) { return s; }
  __device__ __forceinline__ static S store(float f) { return f; }
};

template <int BYTES>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

// VEC values of one access, seen as raw bits for the streaming load/store.
template <class D, int VEC>
union Pack {
  typename Raw<sizeof(typename D::S) * VEC>::type raw;
  typename D::S v[VEC];
};

template <class D, int VEC>
__device__ __forceinline__ Pack<D, VEC> load_cs(const typename D::S* p) {
  using R = typename Raw<sizeof(typename D::S) * VEC>::type;
  Pack<D, VEC> out;
  out.raw = __ldcs(reinterpret_cast<const R*>(p));
  return out;
}

template <class D, int VEC>
__device__ __forceinline__ void store_cs(typename D::S* p, const Pack<D, VEC>& v) {
  using R = typename Raw<sizeof(typename D::S) * VEC>::type;
  __stcs(reinterpret_cast<R*>(p), v.raw);
}

// h = clamp_min(round(y + b), 0) as PyTorch's add_ then relu_: the sum
// rounded once to the flow dtype; NaN passes unchanged, else fmaxf.
// With SQUARE also sq = round(h * h).
template <class D, int VEC, bool SQUARE>
__device__ __forceinline__ void bias_relu_pack(Pack<D, VEC>& p, const float* b,
                                               Pack<D, VEC>& sq) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const typename D::S s = D::store(D::load(p.v[k]) + b[k]);
    const float sf = D::load(s);
    const typename D::S h = isnan(sf) ? s : D::store(fmaxf(sf, 0.0f));
    p.v[k] = h;
    if (SQUARE) {
      const float hf = D::load(h);
      sq.v[k] = D::store(hf * hf);
    }
  }
}

// channels_last (row) path: element i has channel i % C. nvec = numel /
// VEC, cv = C / VEC, and gridDim.x * kThreads is a multiple of cv.
template <class D, int VEC, bool SQUARE>
__global__ void __launch_bounds__(kThreads)
    bias_relu_rows_kernel(typename D::S* __restrict__ y,
                          const typename D::S* __restrict__ bias,
                          typename D::S* __restrict__ sq, int64_t nvec, int cv) {
  using P = Pack<D, VEC>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int c0 = static_cast<int>(v % cv) * VEC;
  float b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) b[k] = D::load(bias[c0 + k]);
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    P p[kUnroll], s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p[u] = load_cs<D, VEC>(y + (v + u * stride) * VEC);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bias_relu_pack<D, VEC, SQUARE>(p[u], b, s[u]);
      store_cs<D, VEC>(y + (v + u * stride) * VEC, p[u]);
      if (SQUARE) store_cs<D, VEC>(sq + (v + u * stride) * VEC, s[u]);
    }
  }
  for (; v < nvec; v += stride) {
    P p = load_cs<D, VEC>(y + v * VEC), s;
    bias_relu_pack<D, VEC, SQUARE>(p, b, s);
    store_cs<D, VEC>(y + v * VEC, p);
    if (SQUARE) store_cs<D, VEC>(sq + v * VEC, s);
  }
}

// NCHW (plane) path: element i has channel (i / inner) % C; a vector lies
// inside one plane (inner % VEC == 0), plane_vecs = inner / VEC.
template <class D, int VEC, bool SQUARE>
__global__ void __launch_bounds__(kThreads)
    bias_relu_planes_kernel(typename D::S* __restrict__ y,
                            const typename D::S* __restrict__ bias,
                            typename D::S* __restrict__ sq, int64_t nvec, int c,
                            int64_t plane_vecs) {
  using P = Pack<D, VEC>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < nvec; v += stride) {
    float b[VEC];
    const float bc = D::load(bias[(v / plane_vecs) % c]);
#pragma unroll
    for (int k = 0; k < VEC; ++k) b[k] = bc;
    P p = load_cs<D, VEC>(y + v * VEC), s;
    bias_relu_pack<D, VEC, SQUARE>(p, b, s);
    store_cs<D, VEC>(y + v * VEC, p);
    if (SQUARE) store_cs<D, VEC>(sq + v * VEC, s);
  }
}

// p = round(sqrtf(round(p + 1e-12f))), as add_(1e-12) then sqrt_.
template <class D, int VEC>
__device__ __forceinline__ void pool_root_pack(Pack<D, VEC>& p) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float t = D::load(D::store(D::load(p.v[k]) + 1e-12f));
    p.v[k] = D::store(sqrtf(t));
  }
}

template <class D, int VEC>
__global__ void __launch_bounds__(kThreads)
    pool_root_kernel(typename D::S* __restrict__ p, int64_t nvec) {
  using P = Pack<D, VEC>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    P q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = load_cs<D, VEC>(p + (v + u * stride) * VEC);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pool_root_pack<D, VEC>(q[u]);
      store_cs<D, VEC>(p + (v + u * stride) * VEC, q[u]);
    }
  }
  for (; v < nvec; v += stride) {
    P q = load_cs<D, VEC>(p + v * VEC);
    pool_root_pack<D, VEC>(q);
    store_cs<D, VEC>(p + v * VEC, q);
  }
}

template <class D, int VEC>
cudaError_t launch_bias_relu(void* y, const void* bias, void* sq, int64_t numel,
                             int c, int64_t inner, int blocks, cudaStream_t s) {
  using S = typename D::S;
  S* yp = static_cast<S*>(y);
  const S* bp = static_cast<const S*>(bias);
  S* sp = static_cast<S*>(sq);
  const int64_t nvec = numel / VEC;
  if (inner == 1) {
    if (sp)
      bias_relu_rows_kernel<D, VEC, true><<<blocks, kThreads, 0, s>>>(yp, bp, sp, nvec, c / VEC);
    else
      bias_relu_rows_kernel<D, VEC, false><<<blocks, kThreads, 0, s>>>(yp, bp, sp, nvec, c / VEC);
  } else {
    if (sp)
      bias_relu_planes_kernel<D, VEC, true><<<blocks, kThreads, 0, s>>>(yp, bp, sp, nvec, c,
                                                                        inner / VEC);
    else
      bias_relu_planes_kernel<D, VEC, false><<<blocks, kThreads, 0, s>>>(yp, bp, sp, nvec, c,
                                                                         inner / VEC);
  }
  return cudaGetLastError();
}

template <class D, int VEC>
cudaError_t launch_pool_root(void* p, int64_t numel, int blocks, cudaStream_t s) {
  pool_root_kernel<D, VEC><<<blocks, kThreads, 0, s>>>(static_cast<typename D::S*>(p),
                                                       numel / VEC);
  return cudaGetLastError();
}

}  // namespace

// y: the conv output, (N, C, H, W) contiguous in channels_last memory
// (inner = 1) or in NCHW memory (inner = H * W); bias: C values of y's
// dtype; sq: a buffer like y for the squares, or null. vec is the values
// per access (8 or 1 for bf16, 4 or 1 for fp32); the caller's launch plan
// makes C (rows) or inner (planes) a multiple of it and, on the row path,
// blocks * 256 a multiple of C / vec.
extern "C" int nqt_bias_relu(void* y, const void* bias, void* sq, long long numel, int c,
                             long long inner, int is_bf16, int vec, int blocks,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && vec == 8) return (int)launch_bias_relu<Bf16, 8>(y, bias, sq, numel, c, inner, blocks, s);
  if (is_bf16 && vec == 1) return (int)launch_bias_relu<Bf16, 1>(y, bias, sq, numel, c, inner, blocks, s);
  if (!is_bf16 && vec == 4) return (int)launch_bias_relu<F32, 4>(y, bias, sq, numel, c, inner, blocks, s);
  if (!is_bf16 && vec == 1) return (int)launch_bias_relu<F32, 1>(y, bias, sq, numel, c, inner, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// p: the pool's depthwise conv output, any dense layout; numel % vec == 0.
extern "C" int nqt_pool_root(void* p, long long numel, int is_bf16, int vec, int blocks,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && vec == 8) return (int)launch_pool_root<Bf16, 8>(p, numel, blocks, s);
  if (is_bf16 && vec == 1) return (int)launch_pool_root<Bf16, 1>(p, numel, blocks, s);
  if (!is_bf16 && vec == 4) return (int)launch_pool_root<F32, 4>(p, numel, blocks, s);
  if (!is_bf16 && vec == 1) return (int)launch_pool_root<F32, 1>(p, numel, blocks, s);
  return (int)cudaErrorInvalidValue;
}
