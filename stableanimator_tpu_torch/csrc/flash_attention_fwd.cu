// Streamed flash-attention forward for Hopper (sm_90a), bf16 / fp16.
//
// Replaces the TPU kernel stableanimator_tpu/ops/flash_attention.py::_fwd_kernel
// (driven there by _flash_fwd_bshd). Computes, per (batch, head),
//     o = softmax((q * scale) k^T) v      and optionally  lse = m + log(l),
// with the TPU kernel's rounding: q is scaled in fp32 and rounded to the
// input type, the logits, running max m, normaliser l and accumulator stay
// fp32, P = exp(s - m) is rounded to the input type before P.V while l sums
// the unrounded P, and the kv tail is masked with -inf. Inputs are read in
// the model's [B, S, H, D] layout through their strides (last dim
// contiguous), so no transposes surround the call. Two kernels, chosen by
// the head dim:
//
// d = 64, the UNet's attentions (flash_fwd_sm90_kernel, whose CTA program,
// csrc/flash_fwd_d64.cuh, the resident kernel shares). At the main path's
// shapes (4096 / 1024 tokens) the work is 4*B*H*Sq*Sk*d operations on a few
// MB of inputs, far above the card's ~295 operations per byte: the bytes are
// no limit. Two units are, about equally: the tensor cores (256 operations
// per logit at 989 TFLOP/s) and the MUFU unit, which takes one exponential
// per logit at 16 per clock per SM (at UNet level 0, 2.7 G exponentials are
// ~0.64 ms on 132 SMs at 1.98 GHz against ~0.70 ms of tensor-core time).
// The design:
//  - one CTA per (192-row q tile, head, batch), four warpgroups: a producer,
//    whose one thread issues the TMA loads and whose registers setmaxnreg
//    hands to the others, and three consumers of 64 q rows each;
//  - TMA loads through 4-D tensor maps (D, S, H, B) built on the host over
//    the strided tensors, 128-byte swizzled: Q once, then 128-key K and V
//    tiles into a ring of 4 stages with full / empty mbarriers, so the
//    producer keeps the next tiles in flight while the consumers work. TMA
//    fills rows past the end with zeros, which give logits of 0, so the kv
//    tail is still masked;
//  - S = Q K^T by wgmma m64n128k16 from shared memory (each consumer first
//    scales and rounds its Q rows in place); the online softmax on the
//    accumulator fragment in registers, exp(x) as exp2(x * log2 e) with
//    log2 e folded into one FFMA, quad shuffles for the row max, l kept per
//    thread and summed across the quad at the end; P packed to 16 bits in
//    registers is the A operand of O += P V, wgmma m64n64k16 with V read
//    MN-major. No logits or P pass through shared memory and no block-wide
//    barrier runs inside the kv loop;
//  - the exponentials overlap the products twice over: a consumer issues
//    tile j's Q K^T and tile j-1's P V before it waits for the first, so
//    tile j's softmax runs while the tensor cores do that P V; and the
//    consumers take turns (ping-pong on named barriers) to issue their
//    products, so one's softmax runs under the others' products (three
//    consumers with ping-pong beat two without at every UNet shape on the
//    H100; PERF.md section 6);
//  - epilogue: O / l, rounded, is staged in the swizzled layout into the
//    warpgroup's own Q rows (no longer read) and written by one TMA store,
//    which drops the rows past the q tail; lse goes straight from registers.
//
// d = 512, the VAE decoder's mid attention (flash_fwd_kernel): mma.sync
// m16n8k16 from ldmatrix'd shared-memory tiles padded against bank
// conflicts and loaded with cp.async, one block of 8 warps per (32-row q
// tile, head, batch), the V tile prefetched while Q.K^T runs, logits through
// shared memory (107 KB of dynamic shared memory): a 64 x 512 fp32 wgmma
// accumulator per warpgroup does not fit the d = 64 scheme.
//
// C interface (bound with ctypes): sa_flash_attention_fwd returns the
// cudaError_t of the launch (cudaGetLastError), 0 on success, and
// cudaErrorInvalidValue for a head dim it does not take or a layout whose
// tensor map the CUDA driver refuses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_d64.cuh"
#include "sm90.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Sq, H] fp32, or null
  int sq, sk, h;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
};

template <typename T>
struct Ops;

// the conversions, and the mma.sync of the d = 512 kernel
template <>
struct Ops<__nv_bfloat16> : sm90::Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<__half> : sm90::Cvt<__half> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  // sQ, sK, sV rows of D + 8 (padding keeps ldmatrix conflict-free), sP rows
  // of BK + 8, sS rows of BK + 4 floats, then m, l, alpha per q row.
  return (size_t)(BQ * (D + 8) + 2 * BK * (D + 8) + BQ * (BK + 8)) * 2 +
         (size_t)(BQ * (BK + 4) + 3 * BQ) * 4;
}

// Loads a [ROWS, D] tile of x (rows r0.., zero past `rows_valid`) into smem
// with cp.async, 16 bytes per copy.
template <typename T, int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long row_stride,
                                                int r0, int rows_valid, int tid) {
  constexpr int CPR = D / 8;
  constexpr int LDT = D + 8;
  for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool valid = r0 + r < rows_valid;
    const T* s = src + (valid ? (long long)(r0 + r) * row_stride : 0) + c;
    cp_async16(dst + r * LDT + c, s, valid);
  }
}

template <typename T, int D, int BQ, int BK, int NW>
__global__ void __launch_bounds__(NW * 32) flash_fwd_kernel(const Params p) {
  constexpr int NTHREADS = NW * 32;
  constexpr int LDT = D + 8;
  constexpr int LDS = BK + 4;
  constexpr int LDP = BK + 8;
  constexpr int CPR = D / 8;
  // Q.K^T output tiles (16 x 8) per warp, and P.V output tiles per warp.
  constexpr int MT = BQ / 16;
  constexpr int NT_S = BK / 8;
  constexpr int TS = MT * NT_S / NW;
  constexpr int NT_O = D / 8;
  constexpr int TO = MT * NT_O / NW;
  // softmax: TPR consecutive lanes share one q row
  constexpr int TPR = NTHREADS / BQ;
  constexpr int CPT = BK / TPR;
  static_assert(D % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tile shapes");
  static_assert(TS >= 1 && (MT * NT_S) % NW == 0 && NT_S % TS == 0, "S tiles per warp");
  static_assert(TO >= 1 && (MT * NT_O) % NW == 0 && NT_O % TO == 0, "O tiles per warp");
  static_assert(TPR >= 1 && TPR <= 32 && 32 % TPR == 0 && BK % TPR == 0, "softmax split");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * LDT;
  T* sV = sK + BK * LDT;
  T* sP = sV + BK * LDT;
  float* sS = reinterpret_cast<float*>(sP + BQ * LDP);
  float* sM = sS + BQ * LDS;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row
  const int t4 = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;

  const T* qg = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* vg = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  T* og = reinterpret_cast<T*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  // q scaled in fp32 and rounded to T, as the TPU kernel does
  for (int i = tid; i < BQ * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.sq) raw = *reinterpret_cast<const uint4*>(qg + (long long)(q0 + r) * p.q_ss + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* outv = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) outv[j] = Ops<T>::from_f(Ops<T>::to_f(e[j]) * p.scale);
    *reinterpret_cast<uint4*>(sQ + r * LDT + c) = packed;
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

  const int s_first = warp * TS;
  const int s_mt = s_first / NT_S;
  const int s_nt0 = s_first % NT_S;
  const int o_first = warp * TO;
  const int o_mt = o_first / NT_O;
  const int o_nt0 = o_first % NT_O;
  // ldmatrix address roles: x4 = four 8x8 matrices (lanes 8i..8i+7 address
  // matrix i), x2 = two matrices (lanes 0..15)
  const int mi = lane / 8;
  const int rr = lane % 8;
  const int l16 = lane % 16;

  float acc[TO][4];
#pragma unroll
  for (int t = 0; t < TO; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const int n_kv = (p.sk + BK - 1) / BK;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    load_tile_async<T, D, BK, NTHREADS>(sK, kg, p.k_ss, k0, p.sk, tid);
    cp_async_commit();
    load_tile_async<T, D, BK, NTHREADS>(sV, vg, p.v_ss, k0, p.sk, tid);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    // S = Q K^T for this warp's tiles (all in one 16-row band)
    float s_acc[TS][4];
#pragma unroll
    for (int t = 0; t < TS; ++t) s_acc[t][0] = s_acc[t][1] = s_acc[t][2] = s_acc[t][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sQ + (s_mt * 16 + rr + (mi & 1) * 8) * LDT + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int t = 0; t < TS; ++t) {
        uint32_t b[2];
        ldsm_x2(b, sK + ((s_nt0 + t) * 8 + (l16 % 8)) * LDT + kk * 16 + (l16 / 8) * 8);
        Ops<T>::mma(s_acc[t], a, b);
      }
    }
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      const int col = (s_nt0 + t) * 8 + t4 * 2;
      const int row = s_mt * 16 + g;
      float v0 = s_acc[t][0], v1 = s_acc[t][1], v2 = s_acc[t][2], v3 = s_acc[t][3];
      if (k0 + col >= p.sk) v0 = v2 = -INFINITY;
      if (k0 + col + 1 >= p.sk) v1 = v3 = -INFINITY;
      sS[row * LDS + col] = v0;
      sS[row * LDS + col + 1] = v1;
      sS[(row + 8) * LDS + col] = v2;
      sS[(row + 8) * LDS + col + 1] = v3;
    }
    __syncthreads();

    // online softmax over this kv tile; P rounded to T for P.V, l summed
    // from the unrounded fp32 P
    {
      const int r = tid / TPR;
      const int part = tid % TPR;
      const float* srow = sS + r * LDS + part * CPT;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      T* prow = sP + r * LDP + part * CPT;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float e = expf(srow[c] - m_new);
        sum += e;
        prow[c] = Ops<T>::from_f(e);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // acc = acc * alpha + P V
    const float al_lo = sA[o_mt * 16 + g];
    const float al_hi = sA[o_mt * 16 + g + 8];
#pragma unroll
    for (int t = 0; t < TO; ++t) {
      acc[t][0] *= al_lo;
      acc[t][1] *= al_lo;
      acc[t][2] *= al_hi;
      acc[t][3] *= al_hi;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sP + (o_mt * 16 + rr + (mi & 1) * 8) * LDP + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int t = 0; t < TO; ++t) {
        uint32_t b[2];
        ldsm_x2_trans(b, sV + (kk * 16 + (l16 / 8) * 8 + (l16 % 8)) * LDT + (o_nt0 + t) * 8);
        Ops<T>::mma(acc[t], a, b);
      }
    }
    __syncthreads();  // sK, sV, sS, sP are rewritten by the next tile
  }

  const float l_lo = sL[o_mt * 16 + g];
  const float l_hi = sL[o_mt * 16 + g + 8];
  const int r_lo = q0 + o_mt * 16 + g;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int t = 0; t < TO; ++t) {
    const int col = (o_nt0 + t) * 8 + t4 * 2;
    if (r_lo < p.sq)
      *reinterpret_cast<uint32_t*>(og + (long long)r_lo * p.o_ss + col) =
          Ops<T>::pack(acc[t][0] / l_lo, acc[t][1] / l_lo);
    if (r_hi < p.sq)
      *reinterpret_cast<uint32_t*>(og + (long long)r_hi * p.o_ss + col) =
          Ops<T>::pack(acc[t][2] / l_hi, acc[t][3] / l_hi);
  }
  if (p.lse != nullptr) {
    for (int r = tid; r < BQ; r += NTHREADS) {
      if (q0 + r < p.sq) p.lse[((long long)bb * p.sq + q0 + r) * p.h + hh] = sM[r] + logf(sL[r]);
    }
  }
}

template <typename T, int D, int BQ, int BK, int NW>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  auto kernel = flash_fwd_kernel<T, D, BQ, BK, NW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, b);
  kernel<<<grid, NW * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// d = 64: wgmma, TMA, warp specialisation (csrc/flash_fwd_d64.cuh)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(d64::NTHREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o, const d64::Params p) {
  extern __shared__ unsigned char smem_raw[];
  d64::attend<T, 1>(smem_raw, &tm_q, &tm_k, &tm_v, &tm_o, p);
}

template <typename T>
cudaError_t launch_d64(const Params& a, int b, cudaStream_t stream) {
  using sm90::make_map;
  constexpr bool is_half = std::is_same<T, __half>::value;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, a.q, is_half, a.sq, a.h, b, a.q_sb, a.q_ss, a.q_sh, d64::BQ) ||
      !make_map(&tm_k, a.k, is_half, a.sk, a.h, b, a.k_sb, a.k_ss, a.k_sh, d64::BK) ||
      !make_map(&tm_v, a.v, is_half, a.sk, a.h, b, a.v_sb, a.v_ss, a.v_sh, d64::BK) ||
      !make_map(&tm_o, a.o, is_half, a.sq, a.h, b, a.o_sb, a.o_ss, a.o_sh, 64))
    return cudaErrorInvalidValue;
  const d64::Params p{a.lse, a.sq, a.sk, a.h, a.scale};
  auto kernel = flash_fwd_sm90_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d64::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + d64::BQ - 1) / d64::BQ, a.h, b);
  kernel<<<grid, d64::NTHREADS, d64::SMEM, stream>>>(tm_q, tm_k, tm_v, tm_o, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int b, int d, cudaStream_t stream) {
  if (d == 64) return launch_d64<T>(p, b, stream);
  if (d == 512) return launch<T, 512, 32, 32, 8>(p, b, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sa_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                      int dtype, int b, int sq, int sk, int h, int d,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      long long o_sb, long long o_ss, long long o_sh,
                                      float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<__nv_bfloat16>(p, b, d, s);
  if (dtype == 1) return (int)dispatch<__half>(p, b, d, s);
  return (int)cudaErrorInvalidValue;
}
