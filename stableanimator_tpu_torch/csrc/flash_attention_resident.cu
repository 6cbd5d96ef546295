// Resident-K/V flash-attention forward for Hopper (sm_90a), bf16 / fp16, d = 64.
//
// Replaces the TPU kernel stableanimator_tpu/ops/flash_attention.py::
// _fwd_kernel_resident (driven there by _flash_fwd_resident). It computes the
// streamed kernel's function (csrc/flash_attention_fwd.cu), with its rounding:
//     o = softmax((q * scale) k^T) v      and optionally  lse = m + log(l),
// q scaled in fp32 and rounded to the input type, the logits, running max m,
// normaliser l and accumulator in fp32, P rounded to the input type before
// P.V while l sums the unrounded P, and the kv tail masked with -inf.
//
// What makes it its own kernel is the TPU kernel's defining property: the K
// and V of one (batch, head) are read from device memory once and reused by
// every q tile. On the TPU they sit in VMEM; here they sit in the shared
// memory of a thread-block cluster. One cluster of C CTAs (C = 1, 2, 4 or 8,
// chosen by the caller) serves one (batch, head): CTA r loads kv chunks
// [r * cpc, (r + 1) * cpc) of K and V once with cp.async (64-row chunks,
// cpc <= 8 chunks = 128 KiB per CTA), the cluster synchronises, and every CTA
// then sweeps its share of the 128-row q tiles (r, r + C, ...) over all the
// chunks of all C CTAs with the online softmax. ldmatrix reads only the CTA's
// own shared memory, so each chunk is first staged into a local, padded
// buffer with 16-byte loads through distributed shared memory
// (cluster.map_shared_rank): the next chunk's loads are issued into registers
// before the current chunk's products and stored after them, so their latency
// hides behind the tensor cores. A last cluster.sync() keeps every slice alive
// until all readers are done.
//
// What bounds it: the same work as the streamed kernel, 4*B*H*Sq*Sk*d
// operations on a few MB of inputs, so the tensor-core rate. The design keeps
// S and P in registers (the fp32 C fragment of Q.K^T, repacked, is the A
// fragment of P.V), 8 warps of 16 q rows each, mma.sync m16n8k16. wgmma and
// TMA multicast into the cluster are left for later work.
//
// C interface (bound with ctypes): sa_flash_attention_resident returns the
// cudaError_t of the launch (cudaGetLastError), 0 on success, and
// cudaErrorInvalidValue for a shape it does not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;             // head dim
constexpr int BQ = 128;           // q rows per tile: 8 warps x 16
constexpr int BK = 64;            // kv rows per chunk
constexpr int NW = BQ / 16;
constexpr int NTHREADS = NW * 32;
constexpr int LDT = D + 8;        // staged rows padded against ldmatrix bank conflicts
constexpr int MAX_CHUNKS_PER_CTA = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int CHUNK_ELEMS = BK * D;  // one resident chunk, dense rows

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Sq, H] fp32, or null
  int sq, sk, h;
  int cluster;  // CTAs per (batch, head)
  int cpc;      // resident chunks per CTA
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
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

// 16-byte async copy global -> shared; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// 16-byte pieces of one chunk (K or V) that each thread moves when staging
constexpr int PIECES = CHUNK_ELEMS / 8 / NTHREADS;
static_assert(PIECES * NTHREADS * 8 == CHUNK_ELEMS, "staging split");

template <typename T>
__device__ __forceinline__ void fetch_chunk(uint4* regs, const T* k_res, const T* v_res,
                                            cg::cluster_group& cluster, int chunk, int cpc,
                                            int tid) {
  const unsigned owner = chunk / cpc;
  const int off = (chunk % cpc) * CHUNK_ELEMS;
  const T* k_src = cluster.map_shared_rank(const_cast<T*>(k_res), owner) + off;
  const T* v_src = cluster.map_shared_rank(const_cast<T*>(v_res), owner) + off;
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int e = (tid + i * NTHREADS) * 8;
    regs[i] = *reinterpret_cast<const uint4*>(k_src + e);
    regs[PIECES + i] = *reinterpret_cast<const uint4*>(v_src + e);
  }
}

template <typename T>
__device__ __forceinline__ void stage_chunk(const uint4* regs, T* k_st, T* v_st, int tid) {
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int e = (tid + i * NTHREADS) * 8;
    const int r = e / D;
    const int c = e % D;
    *reinterpret_cast<uint4*>(k_st + r * LDT + c) = regs[i];
    *reinterpret_cast<uint4*>(v_st + r * LDT + c) = regs[PIECES + i];
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) flash_resident_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_res = reinterpret_cast<T*>(smem);            // [cpc * BK, D] dense
  T* v_res = k_res + p.cpc * CHUNK_ELEMS;           // [cpc * BK, D] dense
  T* sQ = v_res + p.cpc * CHUNK_ELEMS;              // [BQ, LDT]
  T* k_st = sQ + BQ * LDT;                          // 2 stages of [BK, LDT]
  T* v_st = k_st + 2 * BK * LDT;                    // 2 stages of [BK, LDT]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row
  const int t4 = lane % 4;  // fragment column pair
  const int mi = lane / 8;  // ldmatrix x4: lanes 8i..8i+7 address matrix i
  const int rr = lane % 8;
  const int l16 = lane % 16;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;

  const T* qg = reinterpret_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = reinterpret_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* vg = reinterpret_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  T* og = reinterpret_cast<T*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  // 1. this CTA's slice of K and V, read from device memory once
  const int n_chunks = (p.sk + BK - 1) / BK;
  const int first = rank * p.cpc;
  const int mine = max(0, min(p.cpc, n_chunks - first));
  for (int i = tid; i < mine * BK * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int row = first * BK + r;
    const bool valid = row < p.sk;
    const long long src_row = valid ? row : 0;
    cp_async16(k_res + r * D + c, kg + src_row * p.k_ss + c, valid);
    cp_async16(v_res + r * D + c, vg + src_row * p.v_ss + c, valid);
  }
  cp_async_wait_all();
  cluster.sync();  // every slice is in place (release / acquire across the cluster)

  // 2. this CTA's q tiles, each over every chunk of the cluster
  const int n_qt = (p.sq + BQ - 1) / BQ;
  for (int qt = rank; qt < n_qt; qt += p.cluster) {
    const int q0 = qt * BQ;
    // q scaled in fp32 and rounded to T, as the TPU kernel does
    for (int i = tid; i < BQ * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < p.sq) raw = *reinterpret_cast<const uint4*>(qg + (long long)(q0 + r) * p.q_ss + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* outv = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) outv[j] = Ops<T>::from_f(Ops<T>::to_f(e[j]) * p.scale);
      *reinterpret_cast<uint4*>(sQ + r * LDT + c) = packed;
    }
    uint4 regs[2 * PIECES];
    fetch_chunk<T>(regs, k_res, v_res, cluster, 0, p.cpc, tid);
    stage_chunk<T>(regs, k_st, v_st, tid);
    __syncthreads();

    // this warp's 16 q rows as mma A fragments, for the whole sweep
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qa[kk], sQ + (warp * 16 + rr + (mi & 1) * 8) * LDT + kk * 16 + (mi >> 1) * 8);

    float acc[D / 8][4];
#pragma unroll
    for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

    for (int j = 0; j < n_chunks; ++j) {
      const int stage = j & 1;
      const T* sK = k_st + stage * BK * LDT;
      const T* sV = v_st + stage * BK * LDT;
      if (j + 1 < n_chunks) fetch_chunk<T>(regs, k_res, v_res, cluster, j + 1, p.cpc, tid);

      // S = Q K^T: 16 rows x 64 kv columns per warp, fp32 in registers
      float s[BK / 8][4];
#pragma unroll
      for (int t = 0; t < BK / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int t = 0; t < BK / 8; ++t) {
          uint32_t b[2];
          ldsm_x2(b, sK + (t * 8 + (l16 % 8)) * LDT + kk * 16 + (l16 / 8) * 8);
          Ops<T>::mma(s[t], qa[kk], b);
        }
      }
      const int k0 = j * BK;
      if (k0 + BK > p.sk) {
#pragma unroll
        for (int t = 0; t < BK / 8; ++t) {
          const int col = k0 + t * 8 + t4 * 2;
          if (col >= p.sk) s[t][0] = s[t][2] = -INFINITY;
          if (col + 1 >= p.sk) s[t][1] = s[t][3] = -INFINITY;
        }
      }

      // online softmax; rows g and g + 8 of the warp's band live in the 4
      // lanes of a quad
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int t = 0; t < BK / 8; ++t) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[t][0], s[t][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[t][2], s[t][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo);
      const float mn_hi = fmaxf(m_hi, mx_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int t = 0; t < BK / 8; ++t) {
        s[t][0] = expf(s[t][0] - mn_lo);
        s[t][1] = expf(s[t][1] - mn_lo);
        s[t][2] = expf(s[t][2] - mn_hi);
        s[t][3] = expf(s[t][3] - mn_hi);
        sum_lo += s[t][0] + s[t][1];
        sum_hi += s[t][2] + s[t][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
      }
      const float al_lo = expf(m_lo - mn_lo);
      const float al_hi = expf(m_hi - mn_hi);
      l_lo = l_lo * al_lo + sum_lo;
      l_hi = l_hi * al_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        acc[t][0] *= al_lo;
        acc[t][1] *= al_lo;
        acc[t][2] *= al_hi;
        acc[t][3] *= al_hi;
      }

      // acc += P V, P rounded to T: two S tiles (16 kv columns) form one A fragment
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = Ops<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        a[1] = Ops<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        a[2] = Ops<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = Ops<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int t = 0; t < D / 8; ++t) {
          uint32_t b[2];
          ldsm_x2_trans(b, sV + (kk * 16 + (l16 / 8) * 8 + (l16 % 8)) * LDT + t * 8);
          Ops<T>::mma(acc[t], a, b);
        }
      }

      // the other stage was last read in chunk j - 1, before the barrier below
      if (j + 1 < n_chunks) {
        const int nxt = stage ^ 1;
        stage_chunk<T>(regs, k_st + nxt * BK * LDT, v_st + nxt * BK * LDT, tid);
      }
      __syncthreads();
    }

    const int r_lo = q0 + warp * 16 + g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      const int col = t * 8 + t4 * 2;
      if (r_lo < p.sq)
        *reinterpret_cast<uint32_t*>(og + (long long)r_lo * p.o_ss + col) =
            Ops<T>::pack(acc[t][0] / l_lo, acc[t][1] / l_lo);
      if (r_hi < p.sq)
        *reinterpret_cast<uint32_t*>(og + (long long)r_hi * p.o_ss + col) =
            Ops<T>::pack(acc[t][2] / l_hi, acc[t][3] / l_hi);
    }
    if (p.lse != nullptr && t4 == 0) {
      if (r_lo < p.sq) p.lse[((long long)bb * p.sq + r_lo) * p.h + hh] = m_lo + logf(l_lo);
      if (r_hi < p.sq) p.lse[((long long)bb * p.sq + r_hi) * p.h + hh] = m_hi + logf(l_hi);
    }
  }

  cluster.sync();  // no CTA leaves while another may still read its slice
}

size_t smem_bytes(int cpc) {
  return (size_t)(2 * cpc * CHUNK_ELEMS + BQ * LDT + 4 * BK * LDT) * 2;
}

template <typename T>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  auto kernel = flash_resident_kernel<T>;
  const size_t smem = smem_bytes(p.cpc);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(MAX_CHUNKS_PER_CTA));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.h, b);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int sa_flash_attention_resident(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int dtype, int b, int sq, int sk, int h,
                                           int d, int cluster,
                                           long long q_sb, long long q_ss, long long q_sh,
                                           long long k_sb, long long k_ss, long long k_sh,
                                           long long v_sb, long long v_ss, long long v_sh,
                                           long long o_sb, long long o_ss, long long o_sh,
                                           float scale, void* stream) {
  const int n_chunks = (sk + BK - 1) / BK;
  if (d != D || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 || b <= 0 || b > 65535 ||
      cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int cpc = (n_chunks + cluster - 1) / cluster;
  if (cpc > MAX_CHUNKS_PER_CTA) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.cluster = cluster;
  p.cpc = cpc;
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
  if (dtype == 0) return (int)launch<__nv_bfloat16>(p, b, s);
  if (dtype == 1) return (int)launch<__half>(p, b, s);
  return (int)cudaErrorInvalidValue;
}
