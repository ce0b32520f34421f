// Blocked-index sweep with a per-block top-kk pool.
//
// Replaces: rag_cobweb_tpu/ops/pallas_query.py::_kernel (behind
// pallas_blocked_topk) and ::_kernel_v2 (behind pallas_blocked_topk_tiled),
// whose body is _kernel.  For every sentence block s and query b:
//   nlp[b, m]    = q[b] . movt[s, m] - 0.5 q^2[b] . ivt[s, m] + const[s, m]
//   score[b, t]  = sum_m round_W(nlp[b, m]) * W[s, m, t]   (f32 accumulation)
// invalid slots score NEG = -3e38, then kk rounds of max/argmax with the
// taken slot set to NEG: ties go to the lower slot, and once every slot is
// NEG a round returns NEG at the lowest slot, as JAX's argmax does.
// Out: (NB, B, kk) f32 scores and int32 slots within the block.
//
// What bounds it on an H100: 2 * B * NB * M * (2D + TS) operations on an
// index of NB * M * (2D + TS) elements.  At the 100k cell (B = 1024, NB =
// 196, M = 896, D = 128, TS = 512, bf16) that is ~276 GFLOP against
// ~270 MB: operations bound it, ~0.28 ms at 989 TFLOP/s (~1.1 ms at
// B = 4096).  Each index element feeds 2B operations, far above the card's
// ~295 operations per byte.
//
// What this design does.  The TPU kernel held a whole block in VMEM: at
// M = 896 its two (M, D) slabs and W are ~1.4 MB, far over the 227 KB a
// block may use.  So one CUDA block owns (a tile of TQ queries, one
// sentence block) and streams M in chunks of MC = 64 nodes:
//   1. nlp chunk (TQ x 64) on the tensor cores (WMMA m16n16k16 bf16, f32
//      accumulation) over D, from q/q^2 and the movt/ivt chunk staged
//      zero-padded in shared memory (D need not be a multiple of 16);
//   2. subtract, add const, ROUND TO THE W DTYPE (pallas_query.py:69) into
//      a bf16 tile in shared memory;
//   3. scores (TQ x TS) += nlp chunk @ W[chunk, :] on the tensor cores, W
//      fragments read straight from device memory, the f32 accumulator
//      kept in WMMA fragments spread over the 8 warps.
// Node rows past M are never multiplied in (M is a multiple of 16; the
// chunk's k-steps stop at M), and pad nodes inside M have zero W rows.
// The query tile is TQ = 32 for TS <= 512 and 16 for TS <= 1024, so the
// TQ x TS accumulator is at most 64 fragments over 8 warps; every batch
// size fits (the JAX package's VMEM sizing and query chunking have no
// counterpart).  After the M loop the scores go to shared memory (over the
// staging buffers) and each warp runs the kk rounds of one query at a time
// with a warp-shuffle argmax.  The kernel grid is (query tiles, blocks)
// with the query tile fastest, so the tiles of one sentence block run
// together and its index slabs come from L2 after the first.  An f32
// index runs on the CUDA cores at full f32 (fmaf), with the score tile in
// shared memory.  cp.async/TMA pipelining and wgmma are left for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;              // 8 warps
constexpr int NWARP = THREADS / 32;
constexpr int MC = 64;                    // nodes per M chunk
constexpr int DC = 128;                   // depth staged at a time (bf16)
constexpr int LDS = DC + 8;               // staged row stride (elements)
constexpr int LDF = MC + 4;               // f32 nlp tile stride
constexpr int LDB = MC + 8;               // bf16 nlp tile stride
constexpr float NEG = -3e38f;

template <int MT>
constexpr size_t staging_bytes() {
  return (size_t)2 * 16 * MT * LDS * sizeof(bf16)     // q, q^2 tiles
       + (size_t)2 * MC * LDS * sizeof(bf16)          // movt, ivt chunk
       + (size_t)16 * MT * LDF * sizeof(float)        // nlp f32
       + (size_t)16 * MT * LDB * sizeof(bf16);        // nlp rounded
}

// Rows [0, rows_dst) x depth [d0, d0 + DC) of a row-major (rows, D) bf16
// matrix into dst (stride LDS), zero past rows_valid and past D.  ``vec``:
// D % 8 == 0, so 16-byte loads stay inside a row.
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src,
                                      int rows_dst, int rows_valid, int D,
                                      int d0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int VPR = DC / 8;
    for (int e = tid; e < rows_dst * VPR; e += THREADS) {
      const int r = e / VPR, v = e % VPR, d = d0 + v * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid && d < D) {
        x = *reinterpret_cast<const uint4*>(src + (size_t)r * D + d);
      }
      *reinterpret_cast<uint4*>(dst + r * LDS + v * 8) = x;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < rows_dst * DC; e += THREADS) {
      const int r = e / DC, c = e % DC, d = d0 + c;
      dst[r * LDS + c] = (r < rows_valid && d < D) ? src[(size_t)r * D + d]
                                                   : zero;
    }
  }
}

// Mask invalid slots to NEG, then per query (one warp at a time) kk rounds
// of max/argmax over the TS staged scores: ties to the lower slot; the
// taken slot becomes NEG.
__device__ __forceinline__ void select_topk(float* sc, const uint8_t* vb,
                                            float* __restrict__ out_s,
                                            int* __restrict__ out_t, int B,
                                            int q0, int qv, int nb, int TS,
                                            int kk, int TQ) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < TQ * TS; e += THREADS) {
    if (!vb[e % TS]) sc[e] = NEG;
  }
  __syncthreads();
  const unsigned int full = 0xffffffffu;
  for (int r = warp; r < qv; r += NWARP) {
    float* row = sc + r * TS;
    const size_t ob = ((size_t)nb * B + q0 + r) * kk;
    for (int i = 0; i < kk; ++i) {
      float best = __int_as_float(0xff800000);   // -inf
      int bi = 0x7fffffff;
      for (int t = lane; t < TS; t += 32) {       // ascending: first max
        const float v = row[t];
        if (v > best) { best = v; bi = t; }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(full, best, off);
        const int oi = __shfl_xor_sync(full, bi, off);
        if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
      }
      if (lane == 0) {
        out_s[ob + i] = best;
        out_t[ob + i] = bi;
        row[bi] = NEG;
      }
      __syncwarp();
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 2)
blocked_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ q2,
                    const bf16* __restrict__ ivt,
                    const bf16* __restrict__ movt,
                    const float* __restrict__ cst,
                    const bf16* __restrict__ W,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ out_s, int* __restrict__ out_t,
                    int B, int M, int D, int TS, int kk, int vec) {
  using namespace nvcuda;
  constexpr int TQ = 16 * MT;
  constexpr int NJ = 8 / MT;            // 16-column tiles a warp owns
  constexpr int NNT = MC / 16;          // nlp tiles per query row-tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                 // [TQ][LDS]
  bf16* q2s = qs + TQ * LDS;                                // [TQ][LDS]
  bf16* mvs = q2s + TQ * LDS;                               // [MC][LDS]
  bf16* ivs = mvs + MC * LDS;                               // [MC][LDS]
  float* nlpf = reinterpret_cast<float*>(ivs + MC * LDS);   // [TQ][LDF]
  bf16* nlpb = reinterpret_cast<bf16*>(nlpf + TQ * LDF);    // [TQ][LDB]
  float* sc = reinterpret_cast<float*>(smem);  // [TQ][TS] after the M loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ, nb = blockIdx.y;
  const int qv = min(TQ, B - q0);
  const int NT = TS / 16;
  const int nD = (D + DC - 1) / DC;
  const bool nlp_tile = warp < MT * NNT;
  const int tm = warp / NNT, tn = warp % NNT;

  const bf16* mv_blk = movt + (size_t)nb * M * D;
  const bf16* iv_blk = ivt + (size_t)nb * M * D;
  const float* c_blk = cst + (size_t)nb * M;
  const bf16* w_blk = W + (size_t)nb * M * TS;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][NJ];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[m][j], 0.f);

  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mn = min(MC, M - m0);       // a multiple of 16
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fa, fb;
    wmma::fill_fragment(fa, 0.f);
    wmma::fill_fragment(fb, 0.f);
    for (int dc = 0; dc < nD; ++dc) {
      const int d0 = dc * DC;
      __syncthreads();                    // staging buffers free again
      if (nD > 1 || m0 == 0) {
        stage(qs, q + (size_t)q0 * D, TQ, qv, D, d0, vec);
        stage(q2s, q2 + (size_t)q0 * D, TQ, qv, D, d0, vec);
      }
      stage(mvs, mv_blk + (size_t)m0 * D, MC, mn, D, d0, vec);
      stage(ivs, iv_blk + (size_t)m0 * D, MC, mn, D, d0, vec);
      __syncthreads();
      if (nlp_tile) {
        const int kmax = min(DC, (D - d0 + 15) / 16 * 16);
        for (int k = 0; k < kmax; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              a, a2;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              b, b2;
          wmma::load_matrix_sync(a, qs + tm * 16 * LDS + k, LDS);
          wmma::load_matrix_sync(a2, q2s + tm * 16 * LDS + k, LDS);
          wmma::load_matrix_sync(b, mvs + tn * 16 * LDS + k, LDS);
          wmma::load_matrix_sync(b2, ivs + tn * 16 * LDS + k, LDS);
          wmma::mma_sync(fa, a, b, fa);
          wmma::mma_sync(fb, a2, b2, fb);
        }
      }
    }
    if (nlp_tile) {
#pragma unroll
      for (int i = 0; i < fa.num_elements; ++i) fa.x[i] -= 0.5f * fb.x[i];
      wmma::store_matrix_sync(nlpf + tm * 16 * LDF + tn * 16, fa, LDF,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < TQ * MC; e += THREADS) {
      const int r = e / MC, c = e % MC;
      const float v = c < mn ? nlpf[r * LDF + c] + c_blk[m0 + c] : 0.f;
      nlpb[r * LDB + c] = __float2bfloat16(v);      // round to the W dtype
    }
    __syncthreads();
    for (int k = 0; k < mn; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        wmma::load_matrix_sync(a[m], nlpb + m * 16 * LDB + k, LDB);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = warp + NWARP * j;
        if (n < NT) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w_blk + (size_t)(m0 + k) * TS + n * 16,
                                 TS);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            wmma::mma_sync(acc[m][j], a[m], b, acc[m][j]);
          }
        }
      }
    }
  }
  __syncthreads();                        // the score tile aliases staging
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = warp + NWARP * j;
    if (n < NT) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        wmma::store_matrix_sync(sc + m * 16 * TS + n * 16, acc[m][j], TS,
                                wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  select_topk(sc, valid + (size_t)nb * TS, out_s, out_t, B, q0, qv, nb, TS,
              kk, TQ);
}

// f32 index: exact f32 FMAs on the CUDA cores; the TQ x TS score tile
// accumulates in shared memory, one M chunk at a time.
template <int MT>
__global__ void __launch_bounds__(THREADS)
blocked_f32_kernel(const float* __restrict__ q, const float* __restrict__ q2,
                   const float* __restrict__ ivt,
                   const float* __restrict__ movt,
                   const float* __restrict__ cst,
                   const float* __restrict__ W,
                   const uint8_t* __restrict__ valid,
                   float* __restrict__ out_s, int* __restrict__ out_t,
                   int B, int M, int D, int TS, int kk) {
  constexpr int TQ = 16 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);     // [TQ][TS]
  float* nlpf = sc + TQ * TS;                     // [TQ][MC]
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ, nb = blockIdx.y;
  const int qv = min(TQ, B - q0);
  const float* c_blk = cst + (size_t)nb * M;
  const float* w_blk = W + (size_t)nb * M * TS;

  for (int e = tid; e < TQ * TS; e += THREADS) sc[e] = 0.f;
  for (int m0 = 0; m0 < M; m0 += MC) {
    const int mn = min(MC, M - m0);
    __syncthreads();
    for (int e = tid; e < TQ * MC; e += THREADS) {
      const int r = e / MC, c = e % MC;
      float v = 0.f;
      if (r < qv && c < mn) {
        const float* qr = q + (size_t)(q0 + r) * D;
        const float* q2r = q2 + (size_t)(q0 + r) * D;
        const size_t node = ((size_t)nb * M + m0 + c) * D;
        float a = 0.f, b = 0.f;
        for (int d = 0; d < D; ++d) {
          a = fmaf(qr[d], movt[node + d], a);
          b = fmaf(q2r[d], ivt[node + d], b);
        }
        v = (a - 0.5f * b) + c_blk[m0 + c];
      }
      nlpf[e] = v;
    }
    __syncthreads();
    for (int e = tid; e < TQ * TS; e += THREADS) {
      const int r = e / TS, t = e % TS;
      float acc = sc[e];
      for (int c = 0; c < mn; ++c) {
        acc = fmaf(nlpf[r * MC + c], w_blk[(size_t)(m0 + c) * TS + t], acc);
      }
      sc[e] = acc;
    }
  }
  __syncthreads();
  select_topk(sc, valid + (size_t)nb * TS, out_s, out_t, B, q0, qv, nb, TS,
              kk, TQ);
}

template <int MT>
int launch_bf16(const void* q, const void* q2, const void* ivt,
                const void* movt, const void* cst, const void* W,
                const void* valid, void* out_s, void* out_t, int B, int NB,
                int M, int D, int TS, int kk, cudaStream_t stream) {
  constexpr int TQ = 16 * MT;
  size_t smem = staging_bytes<MT>();
  const size_t tile = (size_t)TQ * TS * sizeof(float);
  if (tile > smem) smem = tile;
  cudaError_t e = cudaFuncSetAttribute(
      blocked_bf16_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TQ - 1) / TQ, NB);
  blocked_bf16_kernel<MT><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(q2),
      reinterpret_cast<const bf16*>(ivt), reinterpret_cast<const bf16*>(movt),
      reinterpret_cast<const float*>(cst), reinterpret_cast<const bf16*>(W),
      reinterpret_cast<const uint8_t*>(valid),
      reinterpret_cast<float*>(out_s), reinterpret_cast<int*>(out_t), B, M,
      D, TS, kk, D % 8 == 0 ? 1 : 0);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_f32(const void* q, const void* q2, const void* ivt,
               const void* movt, const void* cst, const void* W,
               const void* valid, void* out_s, void* out_t, int B, int NB,
               int M, int D, int TS, int kk, cudaStream_t stream) {
  constexpr int TQ = 16 * MT;
  const size_t smem = (size_t)TQ * (TS + MC) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      blocked_f32_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TQ - 1) / TQ, NB);
  blocked_f32_kernel<MT><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(q2),
      reinterpret_cast<const float*>(ivt),
      reinterpret_cast<const float*>(movt),
      reinterpret_cast<const float*>(cst), reinterpret_cast<const float*>(W),
      reinterpret_cast<const uint8_t*>(valid),
      reinterpret_cast<float*>(out_s), reinterpret_cast<int*>(out_t), B, M,
      D, TS, kk);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes: q, q2 (B, D); ivt, movt (NB, M, D); cst (NB, M) f32; W (NB, M, TS);
// valid (NB, TS) bool; out_s/out_t (NB, B, kk).  The caller guarantees
// M % 16 == 0, TS % 16 == 0, TS <= 1024, 1 <= kk <= TS, NB <= 65535.
extern "C" int blocked_topk_bf16(const void* q, const void* q2,
                                 const void* ivt, const void* movt,
                                 const void* cst, const void* W,
                                 const void* valid, void* out_s, void* out_t,
                                 int B, int NB, int M, int D, int TS, int kk,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (TS <= 512) {
    return launch_bf16<2>(q, q2, ivt, movt, cst, W, valid, out_s, out_t, B,
                          NB, M, D, TS, kk, s);
  }
  return launch_bf16<1>(q, q2, ivt, movt, cst, W, valid, out_s, out_t, B, NB,
                        M, D, TS, kk, s);
}

extern "C" int blocked_topk_f32(const void* q, const void* q2,
                                const void* ivt, const void* movt,
                                const void* cst, const void* W,
                                const void* valid, void* out_s, void* out_t,
                                int B, int NB, int M, int D, int TS, int kk,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (TS <= 512) {
    return launch_f32<2>(q, q2, ivt, movt, cst, W, valid, out_s, out_t, B,
                         NB, M, D, TS, kk, s);
  }
  return launch_f32<1>(q, q2, ivt, movt, cst, W, valid, out_s, out_t, B, NB,
                       M, D, TS, kk, s);
}
