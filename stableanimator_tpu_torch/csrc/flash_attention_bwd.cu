// Flash-attention backward for Hopper (sm_90a), bf16 / fp16, head dim 64.
//
// Replaces the TPU kernels stableanimator_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel and ::_bwd_dq_kernel (driven there by _flash_bwd). From
// q, k, v, dO (the model's [B, S, H, D] layout, read through their strides)
// and the fp32 vectors lse and delta = sum(dO * o) ([B, Sq, H], contiguous)
// the two kernels compute, in fp32,
//     S = scale q k^T, P = exp(S - lse), dP = dO v^T, dS = P (dP - delta),
//     dV = P^T dO, dK = scale dS^T q, dQ = scale dS k,
// and write dQ, dK, dV in the input type.
//
//   flash_bwd_dkv: one block per (kv tile, head, batch). Its K and V tiles
//     and fp32 dK, dV accumulators stay on chip while it loops over every
//     q tile; rows of q past the sequence's end get P = 0.
//   flash_bwd_dq: one block per (q tile, head, batch), looping over every kv
//     tile (the kv tail masked to P = 0); it recomputes S and dP.
// Two kernels rather than one with atomics: each output element is summed by
// one block in a fixed order, so the result is the same from run to run. A
// loop inside each block takes the place of the TPU's sequential fori_loop
// over the other axis.
//
// What bounds it: at the training shapes (S = 4096 / 1024, d = 64) the work,
// 8 B H Sq Sk d operations for dK/dV and 6 B H Sq Sk d for dQ, is far above
// the card's ~295 operations per byte, so the tensor-core rate bounds both.
// The design keeps every product on the tensor cores (mma.sync m16n8k16,
// fp32 accumulation) and keeps P and dS in registers: each warp computes
// S^T and dP^T (dkv) or S and dP (dq) for its own 16 rows, and the fp32 C
// fragment of those products is, repacked, the A fragment of the next
// product, so nothing passes through shared memory between them. P and dS
// are fp32; they enter the 16-bit tensor cores as two parts, hi = round(x)
// and lo = round(x - hi), so the products keep about 16 bits of them (this
// doubles the dV, dK and dQ products' mma count). Q.K^T and dO.V^T have
// 16-bit operands on both sides and are exact. Tiles are 64 x 64 with 4
// warps, loaded once per step with cp.async into padded shared memory (no
// double buffering): wgmma, TMA and a pipelined design are later work.
//
// C interface (bound with ctypes): sa_flash_attention_bwd_dkv and
// sa_flash_attention_bwd_dq return the cudaError_t of the launch
// (cudaGetLastError), 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int LDT = D + 8;     // padded shared-memory row: ldmatrix without bank conflicts
constexpr int NW = 4;          // warps per block
constexpr int NTHREADS = NW * 32;
constexpr int BM = 16 * NW;    // rows a block owns: 16 per warp (kv in dkv, q in dq)
constexpr int BN = 64;         // rows of the tiles it loops over

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Sq, H]
  const float* delta;  // [B, Sq, H]
  void* dq;
  void* dk;
  void* dv;
  int sq, sk, h;
  // strides (batch, seq, head) of q, k, v, dO, dQ, dK, dV
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;
};

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
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

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Loads rows r0 .. r0+ROWS-1 of a [S, D] slice (row stride `row_stride`)
// into a padded [ROWS, LDT] shared tile, zero past `rows_valid`.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long row_stride,
                                                int r0, int rows_valid, int tid) {
  constexpr int CPR = D / 8;
  for (int i = tid; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool valid = r0 + r < rows_valid;
    const T* s = src + (valid ? (long long)(r0 + r) * row_stride : 0) + c;
    cp_async16(dst + r * LDT + c, s, valid);
  }
}

// A fragments (m16n8k16, row-major 16 x 64) of rows row0 .. row0+15 of a
// shared tile, one per 16-wide k step.
template <typename T>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const T* tile, int row0,
                                             int lane) {
  const int mi = lane / 8;
  const int rr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a[kk], tile + (row0 + rr + (mi & 1) * 8) * LDT + kk * 16 + (mi >> 1) * 8);
}

// C[16 x BN] += A[16 x 64] . tile^T, with tile a [BN, 64] shared tile whose
// rows are the output's columns ("col" B operand, ldmatrix without .trans).
template <typename T>
__device__ __forceinline__ void mma_abt(float (&c)[BN / 8][4], const uint32_t (&a)[D / 16][4],
                                        const T* tile, int lane) {
  const int l16 = lane % 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      uint32_t b[2];
      ldsm_x2(b, tile + (t * 8 + (l16 % 8)) * LDT + kk * 16 + (l16 / 8) * 8);
      Ops<T>::mma(c[t], a[kk], b);
    }
  }
}

// acc[16 x 64] += X[16 x BN] . tile, with X the fp32 C fragments `x` and
// tile a [BN, 64] shared tile (ldmatrix .trans). X enters the tensor cores
// as hi + lo, two 16-bit parts.
template <typename T>
__device__ __forceinline__ void mma_split_ab(float (&acc)[D / 8][4], const float (&x)[BN / 8][4],
                                             const T* tile, int lane) {
  const int l16 = lane % 16;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // the C fragment of n tiles 2kk, 2kk+1 is the A fragment of k step kk:
      // reg 0: (row g, tile 2kk), 1: (row g+8, tile 2kk), 2: (g, 2kk+1), 3: (g+8, 2kk+1)
      const float* src = x[2 * kk + (r >> 1)] + (r & 1) * 2;
      const float h0 = Ops<T>::to_f(Ops<T>::from_f(src[0]));
      const float h1 = Ops<T>::to_f(Ops<T>::from_f(src[1]));
      hi[r] = Ops<T>::pack(h0, h1);
      lo[r] = Ops<T>::pack(src[0] - h0, src[1] - h1);
    }
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      uint32_t b[2];
      ldsm_x2_trans(b, tile + (kk * 16 + l16) * LDT + t * 8);
      Ops<T>::mma(acc[t], hi, b);
      Ops<T>::mma(acc[t], lo, b);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(T* base, long long row_stride, int rows_valid, int row0,
                                           const float (&acc)[D / 8][4], float mul, int lane) {
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int r_lo = row0 + g;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int col = t * 8 + t4 * 2;
    if (r_lo < rows_valid)
      *reinterpret_cast<uint32_t*>(base + (long long)r_lo * row_stride + col) =
          Ops<T>::pack(acc[t][0] * mul, acc[t][1] * mul);
    if (r_hi < rows_valid)
      *reinterpret_cast<uint32_t*>(base + (long long)r_hi * row_stride + col) =
          Ops<T>::pack(acc[t][2] * mul, acc[t][3] * mul);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const Params p) {
  __shared__ __align__(16) T sK[BM * LDT];
  __shared__ __align__(16) T sV[BM * LDT];
  __shared__ __align__(16) T sQ[BN * LDT];
  __shared__ __align__(16) T sdO[BN * LDT];
  __shared__ float sLse[BN];
  __shared__ float sDelta[BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t4 = lane % 4;
  const int k0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;

  const T* qg = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* vg = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const T* dog = reinterpret_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const float* lseg = p.lse + (long long)bb * p.sq * p.h + hh;
  const float* deltag = p.delta + (long long)bb * p.sq * p.h + hh;

  load_tile_async<T, BM>(sK, kg, p.k_ss, k0, p.sk, tid);
  load_tile_async<T, BM>(sV, vg, p.v_ss, k0, p.sk, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_frags(ka, sK, warp * 16, lane);
  load_a_frags(va, sV, warp * 16, lane);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  const int n_q = (p.sq + BN - 1) / BN;
  for (int i = 0; i < n_q; ++i) {
    const int q0 = i * BN;
    __syncthreads();  // the previous q tile is no longer read
    load_tile_async<T, BN>(sQ, qg, p.q_ss, q0, p.sq, tid);
    load_tile_async<T, BN>(sdO, dog, p.do_ss, q0, p.sq, tid);
    cp_async_commit();
    for (int r = tid; r < BN; r += NTHREADS) {
      const bool valid = q0 + r < p.sq;
      sLse[r] = valid ? lseg[(long long)(q0 + r) * p.h] : 0.f;
      sDelta[r] = valid ? deltag[(long long)(q0 + r) * p.h] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows
    float st[BN / 8][4], dpt[BN / 8][4];
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
    mma_abt<T>(st, ka, sQ, lane);
    mma_abt<T>(dpt, va, sdO, lane);

    // P^T and dS^T in place; the fragment's columns are q rows
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * 8 + t4 * 2 + (e & 1);
        const float pv = q0 + col < p.sq ? expf(st[t][e] * p.scale - sLse[col]) : 0.f;
        st[t][e] = pv;
        dpt[t][e] = pv * (dpt[t][e] - sDelta[col]);
      }
    }
    mma_split_ab<T>(dv, st, sdO, lane);   // dV += P^T dO
    mma_split_ab<T>(dk, dpt, sQ, lane);   // dK += dS^T Q
  }

  T* dkg = reinterpret_cast<T*>(p.dk) + bb * p.dk_sb + hh * p.dk_sh;
  T* dvg = reinterpret_cast<T*>(p.dv) + bb * p.dv_sb + hh * p.dv_sh;
  store_rows<T>(dkg, p.dk_ss, p.sk, k0 + warp * 16, dk, p.scale, lane);
  store_rows<T>(dvg, p.dv_ss, p.sk, k0 + warp * 16, dv, 1.f, lane);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
  __shared__ __align__(16) T sQ[BM * LDT];
  __shared__ __align__(16) T sdO[BM * LDT];
  __shared__ __align__(16) T sK[BN * LDT];
  __shared__ __align__(16) T sV[BN * LDT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;

  const T* qg = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* vg = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const T* dog = reinterpret_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;

  load_tile_async<T, BM>(sQ, qg, p.q_ss, q0, p.sq, tid);
  load_tile_async<T, BM>(sdO, dog, p.do_ss, q0, p.sq, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a_frags(qa, sQ, warp * 16, lane);
  load_a_frags(doa, sdO, warp * 16, lane);

  // lse and delta of the two q rows this thread's fragments hold
  const int r_lo = q0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const long long base = (long long)bb * p.sq * p.h + hh;
  const float lse_lo = r_lo < p.sq ? p.lse[base + (long long)r_lo * p.h] : 0.f;
  const float lse_hi = r_hi < p.sq ? p.lse[base + (long long)r_hi * p.h] : 0.f;
  const float dl_lo = r_lo < p.sq ? p.delta[base + (long long)r_lo * p.h] : 0.f;
  const float dl_hi = r_hi < p.sq ? p.delta[base + (long long)r_hi * p.h] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;

  const int n_kv = (p.sk + BN - 1) / BN;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous kv tile is no longer read
    load_tile_async<T, BN>(sK, kg, p.k_ss, k0, p.sk, tid);
    load_tile_async<T, BN>(sV, vg, p.v_ss, k0, p.sk, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
    mma_abt<T>(s, qa, sK, lane);    // S = Q K^T
    mma_abt<T>(dp, doa, sV, lane);  // dP = dO V^T

    // dS in place of S; the fragment's columns are kv rows
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + t * 8 + t4 * 2 + (e & 1);
        const float lse = e < 2 ? lse_lo : lse_hi;
        const float delta = e < 2 ? dl_lo : dl_hi;
        const float pv = col < p.sk ? expf(s[t][e] * p.scale - lse) : 0.f;
        s[t][e] = pv * (dp[t][e] - delta);
      }
    }
    mma_split_ab<T>(dq, s, sK, lane);  // dQ += dS K
  }

  T* dqg = reinterpret_cast<T*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh;
  store_rows<T>(dqg, p.dq_ss, p.sq, q0 + warp * 16, dq, p.scale, lane);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   int sq, int sk, int h, const long long* st, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  long long* dst[21] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,  &p.v_sb,
                        &p.v_ss,  &p.v_sh,  &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss,
                        &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 21; ++i) *dst[i] = st[i];
  p.scale = scale;
  return p;
}

template <typename T>
cudaError_t launch(const Params& p, int b, bool dkv, cudaStream_t stream) {
  if (dkv) {
    const dim3 grid((p.sk + BM - 1) / BM, p.h, b);
    flash_bwd_dkv_kernel<T><<<grid, NTHREADS, 0, stream>>>(p);
  } else {
    const dim3 grid((p.sq + BM - 1) / BM, p.h, b);
    flash_bwd_dq_kernel<T><<<grid, NTHREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dq, void* dk, void* dv, int dtype, int b, int sq, int sk, int h,
        int d, const void* strides, float scale, void* stream) {
  if (d != D || b > 65535 || h > 65535 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, static_cast<const float*>(lse),
                               static_cast<const float*>(delta), dq, dk, dv, sq, sk, h,
                               static_cast<const long long*>(strides), scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<__nv_bfloat16>(p, b, dkv, s);
  if (dtype == 1) return (int)launch<__half>(p, b, dkv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sa_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, void* dk, void* dv, int dtype, int b, int sq,
                                          int sk, int h, int d, const void* strides, float scale,
                                          void* stream) {
  return run(true, q, k, v, dout, lse, delta, dq, dk, dv, dtype, b, sq, sk, h, d, strides, scale,
             stream);
}

extern "C" int sa_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int dtype, int b, int sq,
                                         int sk, int h, int d, const void* strides, float scale,
                                         void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, dk, dv, dtype, b, sq, sk, h, d, strides, scale,
             stream);
}
