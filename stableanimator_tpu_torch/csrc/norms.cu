// Fused GroupNorm and LayerNorm forwards for Hopper (sm_90a), bf16 / fp16.
//
// Replaces no TPU kernel: the JAX package writes these norms in jnp
// (stableanimator_tpu/ops/norms.py) and leaves them to XLA, which fuses the
// statistics and the affine into its own loops. The port's plain version
// (ops/norms.py::group_norm_reference, layer_norm_reference) runs them as
// six or seven PyTorch passes (an fp32 copy, two fp32 reductions, a square,
// two broadcast 16-bit binaries, and the caller's SiLU): about 30 bytes of
// traffic per element. These kernels compute
//     y = x * a + b,   a = rstd * weight,   b = bias - mean * a
// with the statistics, a, b and the multiply-add in fp32, SiLU where asked,
// and one rounding to the 16-bit type on the way out.
//
// Both are bound by device memory. A GroupNorm reads its input twice (once
// for the statistics, once to normalise) and writes once: 6 bytes per
// element at 3.35 TB/s. A LayerNorm keeps its row in registers and reads it
// once: 4 bytes per element.
//
// GroupNorm, channels-last x [N, rows, C] with G groups of C / G contiguous
// channels. N runs from 32 (one sample a frame) down to 1 or 2 (one sample a
// whole video), so one sample spreads over many CTAs:
//  - gn_stats: a grid of (split, sample) CTAs, each over one range of whole
//    rows. Thread (ty, col) owns the V contiguous channels of vector col (16
//    bytes at V = 8) and every rpb-th row of the range, so a CTA's loads are
//    one flat coalesced run. It sums x - s and (x - s)^2 in fp32, s being
//    the first value of the channel it read (a shift that keeps the sums
//    from cancelling when |mean| >> std), and turns them into (count, mean,
//    M2). A warp per group merges the CTA's rows and channels of the group
//    by Chan's pairwise formula and writes one (count, mean, M2) partial;
//  - gn_finalize: a CTA per (group, sample) merges the splits' partials the
//    same way: mean and rstd = rsqrt(M2 / count + eps);
//  - gn_apply: the stats kernel's grid again, in reverse, so that the ranges
//    read last, which L2 may still hold, are read first; each thread folds a
//    and b of its channels in fp32 and streams its rows, 16-byte loads and
//    stores.
// The host sizes the splits from the shape (ops/norms.py::
// group_norm_geometry), so that every launch fills the card whatever N is.
//
// LayerNorm over the last axis, width C: a warp a row, the row in registers
// (K vectors of V elements a lane): the mean, then the centred variance from
// the registers, then the affine and one store. The CTAs (up to 32 an SM)
// stride over the rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a GroupNorm CTA's threads at most; its statistics' shared memory holds a
// (mean, M2) per channel of each of its rows: rpb * C <= kGnMaxThreads * 8
// floats, 2 x 16 KB and the counts, under the 48 KB a launch may ask
constexpr int kGnMaxThreads = 512;
constexpr int kGnMaxFloats = kGnMaxThreads * 8;
constexpr int kGnFinalizeThreads = 256;
constexpr int kLnWarps = 8;  // rows (one a warp) of a LayerNorm CTA
constexpr int kLnMaxVectors = 8;

template <int V> struct Raw;
template <> struct Raw<8> { using type = uint4; };
template <> struct Raw<4> { using type = uint2; };
template <> struct Raw<2> { using type = unsigned int; };
template <> struct Raw<1> { using type = unsigned short; };

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// V elements at p (aligned to 2 V bytes) in one load, widened to fp32
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  const typename Raw<V>::type r = *reinterpret_cast<const typename Raw<V>::type*>(p);
  const T* h = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_float(h[i]);
}

// f rounded once to T, stored in one store
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  typename Raw<V>::type r;
  T* h = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) h[i] = from_float<T>(f[i]);
  *reinterpret_cast<typename Raw<V>::type*>(p) = r;
}

// y = x * a + b in fp32, then SiLU y / (1 + exp(-y)) where asked
template <int V, bool kSilu>
__device__ __forceinline__ void affine(float (&f)[V], const float (&a)[V], const float (&b)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float y = fmaf(f[i], a[i], b[i]);
    f[i] = kSilu ? y / (1.0f + __expf(-y)) : y;
  }
}

// the shifted sums of one row's V channels
template <int V>
__device__ __forceinline__ void accumulate(const float (&f)[V], const float (&shift)[V],
                                           float (&s1)[V], float (&s2)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = f[i] - shift[i];
    s1[i] += d;
    s2[i] = fmaf(d, d, s2[i]);
  }
}

// (count, mean, M2) of a set of values: M2 is the sum of squared deviations
struct Moments {
  float n, mean, m2;
};

// Chan's pairwise update: a becomes the moments of a's and b's values. An
// empty a (0, 0, 0) takes b's exactly.
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.0f) return;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  a.mean += d * f;
  a.m2 += b.m2 + d * d * a.n * f;
  a.n = n;
}

// the moments of the warp's 32 lanes' sets, in every lane
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o{__shfl_xor_sync(0xffffffffu, m.n, off),
                    __shfl_xor_sync(0xffffffffu, m.mean, off),
                    __shfl_xor_sync(0xffffffffu, m.m2, off)};
    merge(m, o);
  }
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct GnArgs {
  long long rows;            // rows of a sample (the axes between N and C)
  long long rows_per_split;  // rows of a CTA (the last split's may be fewer)
  int c;                     // channels
  int groups;
  int cg;      // channels a group, c / groups
  int vpr;     // vectors a row, c / V
  int rpb;     // rows a CTA step; threads rpb * vpr, padded to whole warps
  int splits;  // CTAs a sample
};

template <typename T, int V>
__global__ void __launch_bounds__(kGnMaxThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, const GnArgs a) {
  // a (mean, M2) a channel of each of the CTA's rows, and a count a row:
  // gn_stats_smem(a) bytes
  extern __shared__ float smem[];
  float* s_mean = smem;
  float* s_m2 = smem + a.rpb * a.c;
  float* s_n = smem + 2 * a.rpb * a.c;
  const int tid = threadIdx.x;
  const int ty = tid / a.vpr, col = tid - ty * a.vpr;
  const long long n = blockIdx.y, split = blockIdx.x;
  const long long r0 = split * a.rows_per_split;
  const long long r1 = min(a.rows, r0 + a.rows_per_split);
  if (ty < a.rpb) {
    const T* base = x + n * a.rows * a.c + col * V;
    const long long step = a.rpb;
    float shift[V], s1[V], s2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) shift[i] = s1[i] = s2[i] = 0.0f;
    float cnt = 0.0f;
    long long r = r0 + ty;
    if (r < r1) {  // the first row is the shift and adds 0 to both sums
      load<T, V>(base + r * a.c, shift);
      cnt = 1.0f;
      r += step;
    }
    for (; r + 3 * step < r1; r += 4 * step) {  // 4 rows' loads in flight
      float f[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) load<T, V>(base + (r + u * step) * a.c, f[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate<V>(f[u], shift, s1, s2);
      cnt += 4.0f;
    }
    for (; r < r1; r += step) {
      float f[V];
      load<T, V>(base + r * a.c, f);
      accumulate<V>(f, shift, s1, s2);
      cnt += 1.0f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float mean = 0.0f, m2 = 0.0f;
      if (cnt > 0.0f) {
        const float q = s1[i] / cnt;
        mean = shift[i] + q;
        m2 = fmaxf(s2[i] - s1[i] * q, 0.0f);
      }
      s_mean[ty * a.c + col * V + i] = mean;
      s_m2[ty * a.c + col * V + i] = m2;
    }
    if (col == 0) s_n[ty] = cnt;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, warps = blockDim.x >> 5;
  const int items = a.rpb * a.cg;
  for (int g = warp; g < a.groups; g += warps) {
    Moments m{0.0f, 0.0f, 0.0f};
    for (int i = lane; i < items; i += 32) {
      const int row = i / a.cg;
      const int at = row * a.c + g * a.cg + (i - row * a.cg);
      merge(m, Moments{s_n[row], s_mean[at], s_m2[at]});
    }
    m = warp_merge(m);
    if (lane == 0) {
      float* p = part + ((n * a.groups + g) * a.splits + split) * 3;
      p[0] = m.n;
      p[1] = m.mean;
      p[2] = m.m2;
    }
  }
}

// one CTA per (group, sample): the splits' partials merged, then
// stats[sample, group] = (mean, rsqrt(M2 / count + eps))
__global__ void __launch_bounds__(kGnFinalizeThreads)
    gn_finalize_kernel(const float* __restrict__ part, float* __restrict__ stats, int groups,
                       int splits, float eps) {
  __shared__ Moments s_warp[kGnFinalizeThreads / 32];
  const int g = blockIdx.x;
  const long long n = blockIdx.y;
  const float* p = part + (n * groups + g) * splits * 3;
  Moments m{0.0f, 0.0f, 0.0f};
  for (int s = threadIdx.x; s < splits; s += kGnFinalizeThreads)
    merge(m, Moments{p[s * 3], p[s * 3 + 1], p[s * 3 + 2]});
  m = warp_merge(m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    Moments t{0.0f, 0.0f, 0.0f};
    for (int w = 0; w < kGnFinalizeThreads / 32; ++w) merge(t, s_warp[w]);
    const float var = t.n > 0.0f ? t.m2 / t.n : 0.0f;
    stats[(n * groups + g) * 2] = t.mean;
    stats[(n * groups + g) * 2 + 1] = rsqrtf(var + eps);
  }
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(kGnMaxThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ stats,
                    const float* __restrict__ weight, const float* __restrict__ bias,
                    const GnArgs a) {
  const int tid = threadIdx.x;
  const int ty = tid / a.vpr, col = tid - ty * a.vpr;
  if (ty >= a.rpb) return;
  // the stats kernel's CTAs in reverse: the ranges it read last, which L2
  // may still hold, are read first
  const long long n = gridDim.y - 1 - blockIdx.y;
  const long long r0 = (gridDim.x - 1 - blockIdx.x) * static_cast<long long>(a.rows_per_split);
  const long long r1 = min(a.rows, r0 + a.rows_per_split);
  float sa[V], sb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = col * V + i;
    const float* st = stats + (n * a.groups + ch / a.cg) * 2;
    sa[i] = st[1] * (weight != nullptr ? weight[ch] : 1.0f);
    sb[i] = (bias != nullptr ? bias[ch] : 0.0f) - st[0] * sa[i];
  }
  const long long off = n * a.rows * a.c + col * V;
  const T* xb = x + off;
  T* yb = y + off;
  const long long step = a.rpb;
  long long r = r0 + ty;
  for (; r + 3 * step < r1; r += 4 * step) {  // 4 rows' loads in flight
    float f[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) load<T, V>(xb + (r + u * step) * a.c, f[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      affine<V, kSilu>(f[u], sa, sb);
      store<T, V>(yb + (r + u * step) * a.c, f[u]);
    }
  }
  for (; r < r1; r += step) {
    float f[V];
    load<T, V>(xb + r * a.c, f);
    affine<V, kSilu>(f, sa, sb);
    store<T, V>(yb + r * a.c, f);
  }
}

// V fp32 values at p (16-byte aligned where V is a multiple of 4)
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 q = reinterpret_cast<const float4*>(p)[j];
      f[4 * j] = q.x;
      f[4 * j + 1] = q.y;
      f[4 * j + 2] = q.z;
      f[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = p[i];
  }
}

// each warp takes every (gridDim.x * kLnWarps)-th row; weight and bias
// (16-byte aligned) come through L1 beside the row
template <typename T, int V, int K>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ weight,
              const float* __restrict__ bias, long long rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int vpr = c / V;
  const long long stride = static_cast<long long>(gridDim.x) * kLnWarps;
  // the row is the warp's: the loop and the shuffles run on whole warps
  for (long long row = static_cast<long long>(blockIdx.x) * kLnWarps + (threadIdx.x >> 5);
       row < rows; row += stride) {
    const T* xr = x + row * c;
    float f[K][V];
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + k * 32 < vpr) {
        load<T, V>(xr + (lane + k * 32) * V, f[k]);
#pragma unroll
        for (int i = 0; i < V; ++i) sum += f[k][i];
      }
    }
    const float mean = warp_sum(sum) / c;
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + k * 32 < vpr) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = f[k][i] - mean;
          sq = fmaf(d, d, sq);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / c + eps);
    T* yr = y + row * c;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = lane + k * 32;
      if (v < vpr) {
        float sa[V], sb[V];
        if (weight != nullptr) {
          load_f32<V>(weight + v * V, sa);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) sa[i] = 1.0f;
        }
        if (bias != nullptr) {
          load_f32<V>(bias + v * V, sb);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) sb[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          sa[i] *= rstd;
          sb[i] -= mean * sa[i];
        }
        affine<V, false>(f[k], sa, sb);
        store<T, V>(yr + v * V, f[k]);
      }
    }
  }
}

inline size_t gn_stats_smem(const GnArgs& a) {
  return sizeof(float) * (2 * static_cast<size_t>(a.rpb) * a.c + a.rpb);
}

template <typename T, int V>
cudaError_t group_norm(const void* x, void* y, const float* weight, const float* bias,
                       float* part, float* stats, bool silu, long long n, const GnArgs& a,
                       int threads, float eps, cudaStream_t s) {
  const dim3 grid(a.splits, static_cast<unsigned>(n));
  gn_stats_kernel<T, V><<<grid, threads, gn_stats_smem(a), s>>>(static_cast<const T*>(x),
                                                                 part, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<dim3(a.groups, static_cast<unsigned>(n)), kGnFinalizeThreads, 0, s>>>(
      part, stats, a.groups, a.splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (silu)
    gn_apply_kernel<T, V, true><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), stats, weight, bias, a);
  else
    gn_apply_kernel<T, V, false><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), stats, weight, bias, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t group_norm_vec(int vec, const void* x, void* y, const float* weight,
                           const float* bias, float* part, float* stats, bool silu, long long n,
                           const GnArgs& a, int threads, float eps, cudaStream_t s) {
  switch (vec) {
    case 8: return group_norm<T, 8>(x, y, weight, bias, part, stats, silu, n, a, threads, eps, s);
    case 4: return group_norm<T, 4>(x, y, weight, bias, part, stats, silu, n, a, threads, eps, s);
    case 2: return group_norm<T, 2>(x, y, weight, bias, part, stats, silu, n, a, threads, eps, s);
    case 1: return group_norm<T, 1>(x, y, weight, bias, part, stats, silu, n, a, threads, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int V, int K>
cudaError_t layer_norm(const void* x, void* y, const float* weight, const float* bias,
                       long long rows, int c, int blocks, float eps, cudaStream_t s) {
  ln_kernel<T, V, K><<<blocks, kLnWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), weight, bias, rows, c, eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t layer_norm_k(int k, const void* x, void* y, const float* weight, const float* bias,
                         long long rows, int c, int blocks, float eps, cudaStream_t s) {
  switch (k) {
    case 1: return layer_norm<T, V, 1>(x, y, weight, bias, rows, c, blocks, eps, s);
    case 2: return layer_norm<T, V, 2>(x, y, weight, bias, rows, c, blocks, eps, s);
    case 3: return layer_norm<T, V, 3>(x, y, weight, bias, rows, c, blocks, eps, s);
    case 4: return layer_norm<T, V, 4>(x, y, weight, bias, rows, c, blocks, eps, s);
    case 5: return layer_norm<T, V, 5>(x, y, weight, bias, rows, c, blocks, eps, s);
    case 6: return layer_norm<T, V, 6>(x, y, weight, bias, rows, c, blocks, eps, s);
    case 7: return layer_norm<T, V, 7>(x, y, weight, bias, rows, c, blocks, eps, s);
    case 8: return layer_norm<T, V, 8>(x, y, weight, bias, rows, c, blocks, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t layer_norm_vec(int vec, int k, const void* x, void* y, const float* weight,
                           const float* bias, long long rows, int c, int blocks, float eps,
                           cudaStream_t s) {
  switch (vec) {
    case 8: return layer_norm_k<T, 8>(k, x, y, weight, bias, rows, c, blocks, eps, s);
    case 4: return layer_norm_k<T, 4>(k, x, y, weight, bias, rows, c, blocks, eps, s);
    case 2: return layer_norm_k<T, 2>(k, x, y, weight, bias, rows, c, blocks, eps, s);
    case 1: return layer_norm_k<T, 1>(k, x, y, weight, bias, rows, c, blocks, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// GroupNorm of x [n, rows, c] (16-bit, contiguous, 2 * vec-byte aligned)
// into y: weight and bias fp32 [c] or null; part fp32 [n, groups, splits, 3]
// and stats fp32 [n, groups, 2] scratch. The geometry (vec, threads, rpb,
// splits, rows_per_split) is ops/norms.py::group_norm_geometry's. dtype 0
// bf16, 1 fp16. Returns the launches' cudaError.
extern "C" int sa_group_norm_fwd(const void* x, void* y, const void* weight, const void* bias,
                                 void* part, void* stats, int dtype, int vec, int silu,
                                 long long n, long long rows, int c, int groups, int threads,
                                 int rpb, int splits, long long rows_per_split, float eps,
                                 void* stream) {
  if (groups <= 0 || c % groups != 0 || vec <= 0 || c % vec != 0 || threads <= 0 ||
      threads % 32 != 0 || threads > kGnMaxThreads || rpb <= 0 || rpb * (c / vec) > threads ||
      rpb * c > kGnMaxFloats ||
      n <= 0 || n > 65535 || groups > 65535 || splits <= 0 || rows_per_split <= 0)
    return cudaErrorInvalidValue;
  GnArgs a;
  a.rows = rows;
  a.rows_per_split = rows_per_split;
  a.c = c;
  a.groups = groups;
  a.cg = c / groups;
  a.vpr = c / vec;
  a.rpb = rpb;
  a.splits = splits;
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  float* sp = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)group_norm_vec<__nv_bfloat16>(vec, x, y, w, b, pp, sp, silu != 0, n, a, threads,
                                              eps, s);
  if (dtype == 1)
    return (int)group_norm_vec<__half>(vec, x, y, w, b, pp, sp, silu != 0, n, a, threads, eps, s);
  return (int)cudaErrorInvalidValue;
}

// LayerNorm over the last axis of x [rows, c] (16-bit, contiguous, 2 *
// vec-byte aligned) into y; weight and bias fp32 [c], 16-byte aligned, or
// null; k vectors of
// vec elements a lane hold a row: c <= 32 * k * vec, k <= 8; `blocks` CTAs
// of kLnWarps warps stride over the rows.
extern "C" int sa_layer_norm_fwd(const void* x, void* y, const void* weight, const void* bias,
                                 int dtype, int vec, int k, long long rows, int c, int blocks,
                                 float eps, void* stream) {
  if (vec <= 0 || c % vec != 0 || k < 1 || k > kLnMaxVectors || c > 32 * k * vec || rows <= 0 ||
      blocks <= 0)
    return cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)layer_norm_vec<__nv_bfloat16>(vec, k, x, y, w, b, rows, c, blocks, eps, s);
  if (dtype == 1) return (int)layer_norm_vec<__half>(vec, k, x, y, w, b, rows, c, blocks, eps, s);
  return (int)cudaErrorInvalidValue;
}
