// Exact re-rank distances: gather candidate rows by id, squared L2 to the
// query, fresh-leaf log-probability.
//
// Replaces: the row-gather + squared-L2 Pallas kernel of
// scripts/gather_probe.py (make_pallas.body), the kernel behind
// rag_cobweb_tpu/core/index.py::exact_rerank.  For every (b, j):
//   d2 = sum_d (q[b, d] - emb[cand[b, j], d])^2          (diff form)
//   lp = -0.5 * (d2 / prior_var + D * log(prior_var)),  -inf where
//        cand_scores[b, j] is not finite.
// The diff form is kept on purpose: near-duplicate margins are tiny next
// to ||x||^2, and the dot form's cancellation loses them.  The top-k over
// the C candidates stays outside the kernel (torch.topk), as lax.top_k sat
// outside the Pallas kernel.  Duplicate ids within a list are allowed.
//
// What bounds it on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"): the
// gather.  Pair by pair it reads B C D 4 bytes of rows (3.2 GB at the c=10k
// main path, B = C = 1024, D = 768) for 3 operations an element; there the
// 31 MB store sits in the 50 MB L2, so the rows come out of L2 at ~9 TB/s,
// and at 1M rows from HBM (~0.96 ms at 3.35 TB/s).  Only reading a row once
// for several queries could go below that.  Grouping a query tile's pairs
// by row in shared memory did so on uniform candidates but lost on served
// pools: their rows come in runs of the store's order that L2 already
// serves, and every pair still read its query row from shared memory.
//
// What this design does: a warp a pair, the query row in shared memory,
// 16-byte row loads (768 f32 = 6 a lane, contiguous 512-byte warp reads)
// and a shuffle reduction; a block of 8 warps takes 64 pairs of one query,
// or 8 when 64 would leave SMs idle (a small batch: B = 1 runs 128 blocks
// instead of 16).  The (B, C, D) gather is never materialised, so callers
// need no byte-budget chunking.  D not a multiple of a load's elements (or
// an unaligned row) takes scalar loads.
//
// The row type is a template parameter: f32 rows, or bf16 rows (the
// compressed re-rank store, emb_store_dtype = "bfloat16" in the JAX
// package's wrapper).  A bf16 row's 16-byte load brings 8 values, each
// widened to f32 (a shift of its bits) before the diff, so the distance is
// f32 arithmetic on the rounded row, as the JAX package's promotion
// computes it; the query stays f32.  The gather reads half the bytes: at
// 1M rows, B = C = 1024, D = 768, 1.61 GB against 3.2 GB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                  // pairs in flight a block

typedef uint16_t bf16_bits;               // a bf16 value's bits

// elements of one 16-byte row load
template <typename T> struct Load;
template <> struct Load<float> { static constexpr int N = 4; };
template <> struct Load<bf16_bits> { static constexpr int N = 8; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
// the low and high bf16 of a 32-bit word, widened
__device__ __forceinline__ float lo16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float sq(float a, float v, float acc) {
  const float t = a - v;
  return fmaf(t, t, acc);
}

// chunk i (16 bytes) of row x against the query in shared memory
__device__ __forceinline__ float sq_chunk(const float* qr, const float* x,
                                          int i, float acc) {
  const float4 v = reinterpret_cast<const float4*>(x)[i];
  const float4 a = reinterpret_cast<const float4*>(qr)[i];
  acc = sq(a.x, v.x, acc);
  acc = sq(a.y, v.y, acc);
  acc = sq(a.z, v.z, acc);
  return sq(a.w, v.w, acc);
}
__device__ __forceinline__ float sq_chunk(const float* qr,
                                          const bf16_bits* x, int i,
                                          float acc) {
  const uint4 w = reinterpret_cast<const uint4*>(x)[i];
  const float4 a = reinterpret_cast<const float4*>(qr)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(qr)[2 * i + 1];
  acc = sq(a.x, lo16(w.x), acc);
  acc = sq(a.y, hi16(w.x), acc);
  acc = sq(a.z, lo16(w.y), acc);
  acc = sq(a.w, hi16(w.y), acc);
  acc = sq(b.x, lo16(w.z), acc);
  acc = sq(b.y, hi16(w.z), acc);
  acc = sq(b.z, lo16(w.w), acc);
  return sq(b.w, hi16(w.w), acc);
}

// T: the row type.  PER_BLOCK: the pairs of a block.  VEC: 16-byte loads
// (the launcher checks the alignment); the test of D against the load
// width stays in the kernel, since without it the row addresses cost 3%
// at B = 1024
template <typename T, int PER_BLOCK, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
rerank_l2_kernel(const T* __restrict__ emb, const float* __restrict__ q,
                 const int* __restrict__ cand,
                 const float* __restrict__ cand_scores,
                 float* __restrict__ out, int C, int D, float pv,
                 float dlog) {
  constexpr int N = Load<T>::N;
  extern __shared__ __align__(16) float qr[];   // [D]
  const int b = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    qr[d] = q[(size_t)b * D + d];
  }
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j_end = min(C, (blockIdx.y + 1) * PER_BLOCK);
  for (int j = blockIdx.y * PER_BLOCK + w; j < j_end; j += WARPS) {
    const size_t o = (size_t)b * C + j;
    float lp = __int_as_float(0xff800000);   // -inf
    if (isfinite(cand_scores[o])) {          // uniform across the warp
      const T* x = emb + (size_t)cand[o] * D;
      float acc = 0.f;
      if (VEC && D % N == 0) {
#pragma unroll 4
        for (int i = lane; i < D / N; i += 32) {
          acc = sq_chunk(qr, x, i, acc);
        }
      } else {
        for (int d = lane; d < D; d += 32) {
          acc = sq(qr[d], widen(x[d]), acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      lp = -0.5f * (acc / pv + dlog);
    }
    if (lane == 0) out[o] = lp;
  }
}

template <typename T>
int launch(const void* emb, const void* q, const void* cand,
           const void* cand_scores, void* out, int B, int C, int D,
           float prior_var, float d_log_pv, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const bool vec = D % Load<T>::N == 0 &&
                   (reinterpret_cast<uintptr_t>(emb) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 64 pairs a block; 8 (one a warp) when that leaves SMs idle
  const bool small = (long long)B * ((C + 63) / 64) < 2 * sms;
  auto kernel = small ? (vec ? rerank_l2_kernel<T, 8, true>
                             : rerank_l2_kernel<T, 8, false>)
                      : (vec ? rerank_l2_kernel<T, 64, true>
                             : rerank_l2_kernel<T, 64, false>);
  const int per_block = small ? 8 : 64;
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, (C + per_block - 1) / per_block), WARPS * 32, smem,
           reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const T*>(emb), reinterpret_cast<const float*>(q),
      reinterpret_cast<const int*>(cand),
      reinterpret_cast<const float*>(cand_scores),
      reinterpret_cast<float*>(out), C, D, prior_var, d_log_pv);
  return (int)cudaGetLastError();
}

}  // namespace

// emb (S, D) f32 (rerank_l2) or bf16 (rerank_l2_bf16), q (B, D) f32;
// cand (B, C) int32 in [0, S) where cand_scores (B, C) is finite;
// out (B, C) f32.
extern "C" int rerank_l2(const void* emb, const void* q, const void* cand,
                         const void* cand_scores, void* out, int B, int C,
                         int D, float prior_var, float d_log_pv,
                         void* stream) {
  return launch<float>(emb, q, cand, cand_scores, out, B, C, D, prior_var,
                       d_log_pv, stream);
}

extern "C" int rerank_l2_bf16(const void* emb, const void* q,
                              const void* cand, const void* cand_scores,
                              void* out, int B, int C, int D,
                              float prior_var, float d_log_pv,
                              void* stream) {
  return launch<bf16_bits>(emb, q, cand, cand_scores, out, B, C, D,
                           prior_var, d_log_pv, stream);
}
