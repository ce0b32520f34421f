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
// outside the Pallas kernel.
//
// What bounds it on an H100: bytes.  It reads B * C * D * 4 bytes of
// gathered rows (3.2 GB for B = C = 1024, D = 768) for 3 operations per
// element.  At the c=10k main path the 31 MB store sits in the 50 MB L2;
// at 1M rows it streams from HBM, ~0.96 ms at 3.35 TB/s.
//
// What this design does: one warp per candidate row, the query row in
// shared memory, 16-byte float4 loads (768 f32 = 6 loads a lane) so each
// row is read as contiguous 512-byte warp transactions, and a shuffle
// reduction.  The (B, C, D) gather is never materialised, so callers need
// no byte-budget chunking.  D not divisible by 4 takes a scalar loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // candidates in flight per block
constexpr int PER_BLOCK = 64;     // candidates per block (8 per warp)

__global__ void __launch_bounds__(WARPS * 32)
rerank_l2_kernel(const float* __restrict__ emb, const float* __restrict__ q,
                 const int* __restrict__ cand,
                 const float* __restrict__ cand_scores,
                 float* __restrict__ out, int C, int D, float prior_var,
                 float d_log_pv) {
  extern __shared__ __align__(16) float qs[];   // [D]
  const int b = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    qs[d] = q[(size_t)b * D + d];
  }
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j_end = min(C, (blockIdx.y + 1) * PER_BLOCK);
  for (int j = blockIdx.y * PER_BLOCK + w; j < j_end; j += WARPS) {
    const size_t o = (size_t)b * C + j;
    const float s = cand_scores[o];
    float lp = __int_as_float(0xff800000);   // -inf
    if (isfinite(s)) {                       // uniform across the warp
      const float* x = emb + (size_t)cand[o] * D;
      float acc = 0.f;
      if ((D & 3) == 0) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
        for (int d = lane; d < (D >> 2); d += 32) {
          const float4 a = q4[d], v = x4[d];
          float t;
          t = a.x - v.x; acc = fmaf(t, t, acc);
          t = a.y - v.y; acc = fmaf(t, t, acc);
          t = a.z - v.z; acc = fmaf(t, t, acc);
          t = a.w - v.w; acc = fmaf(t, t, acc);
        }
      } else {
        for (int d = lane; d < D; d += 32) {
          const float t = qs[d] - x[d];
          acc = fmaf(t, t, acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      lp = -0.5f * (acc / prior_var + d_log_pv);
    }
    if (lane == 0) out[o] = lp;
  }
}

}  // namespace

extern "C" int rerank_l2(const void* emb, const void* q, const void* cand,
                         const void* cand_scores, void* out, int B, int C,
                         int D, float prior_var, float d_log_pv,
                         void* stream) {
  const dim3 grid(B, (C + PER_BLOCK - 1) / PER_BLOCK);
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rerank_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rerank_l2_kernel<<<grid, WARPS * 32, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(emb), reinterpret_cast<const float*>(q),
      reinterpret_cast<const int*>(cand),
      reinterpret_cast<const float*>(cand_scores),
      reinterpret_cast<float*>(out), C, D, prior_var, d_log_pv);
  return (int)cudaGetLastError();
}
