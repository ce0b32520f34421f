// Fused path-score sweep with a per-slab top-kappa pool.
//
// Replaces: rag_cobweb_tpu/ops/pallas_query.py::_fused_kernel (the Pallas
// kernel behind pallas_fused_topk).  For every 2048-row slab s and query b:
//   scores[b, t] = sum_d qq[b, d] * GT[d, t] + c[t]   (invalid rows: -inf)
// and the slab's top-kappa (score, global row id), ties to the lower id,
// in no particular order (the caller's merge takes a top-k over them).
// The (B, Sp) score matrix never reaches device memory: it lives in shared
// memory for one (slab, 16-query tile) block at a time.
//
// What bounds it on an H100: the sweep is 2 * B * 2D * Sp operations on
// 2D * Sp GT elements.  At the c=10k main path (2D ~ 496, Sp = 10240,
// B = 1024) that is 10.4 GFLOP, ~11 us at 989 TFLOP/s bf16, on a 10 MB GT;
// at 1M rows it is 1.07 TFLOP, ~1.1 ms, on a 1.04 GB GT.  Operations, not
// bytes, bound it: each 2-byte GT element feeds 2B operations, B per byte
// (1024 at B = 1024), far above the card's ~295 operations per byte.
//
// What this design does: it is right and simple first.  One block per
// (slab, 16-query tile), 512 threads.  A bf16 GT goes through the tensor
// cores with WMMA (mma.sync m16n16k16, f32 accumulation): the 16 queries
// are one m16 tile, each warp owns 128 slab columns as eight n16 tiles
// read straight from GT, and a last depth chunk that 2D does not fill is
// staged zero-padded in shared memory, so the ragged depth (2D need not be
// a multiple of anything) reads nothing past GT.  An f32 GT keeps exact
// f32 FMAs on the CUDA cores (each thread 16 queries x 4 adjacent
// columns).  The 16 x 2048 scores are staged in 128 KB of dynamic shared
// memory; each warp then selects one query's top-kappa exactly with a
// radix select on order-preserving 32-bit keys (4 passes of 8 bits, a
// 256-bin histogram per warp), writing every row above the kappa-th key
// plus the lowest-id rows equal to it.  (A full bitonic sort of the 2048
// scores cost about as much as a CUDA-core sweep.)  The ragged query tile
// is zero-filled and never written out.  wgmma, TMA and warp
// specialisation are left for a later change.
//
// Second entry, the group-max pool (fused_group_topk_*): replaces
// rag_cobweb_tpu/ops/pallas_query.py::_fused_group_kernel (behind
// pallas_fused_group_topk).  The same sweep and score tile, invalid rows
// NEG = -3e38 as in the TPU kernel; then, instead of the radix select, each
// warp takes its query's 16 groups of 128 adjacent rows and runs
// ``per_group`` rounds of max/argmax per group (ties to the lower row, the
// taken row set to NEG; once every row is NEG a round returns NEG at the
// group's lowest row, as JAX's argmax does).  Column i * 16 + g of the
// (NS, B, per_group * 16) output holds round i of group g, with the global
// row slab * 2048 + g * 128 + argmax.  Its bound is the sweep's (~10.4
// GFLOP at the flagship shape, ~11 us): the selection is 4 registers a
// lane and a 5-step shuffle per round, cheap next to the radix select.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int SLAB = 2048;                   // rows per slab (= row bucket)
constexpr int TQ = 16;                       // queries per block
constexpr int THREADS = 512;                 // 16 warps, one query each
constexpr int CPT = SLAB / THREADS;          // 4 adjacent columns a thread
constexpr int DCH = 64;                      // qq depth chunk in shared
constexpr int BINS = 256;                    // radix digit: 8 bits
constexpr int GROUP = 128;                   // rows per group (group pool)
constexpr int NG = SLAB / GROUP;             // groups per slab
constexpr float NEG = -3e38f;                // the TPU kernels' mask value
constexpr size_t SMEM = (size_t)TQ * SLAB * sizeof(float)
                      + (size_t)TQ * BINS * sizeof(unsigned int)
                      + (size_t)TQ * DCH * sizeof(float);

// Order-preserving key: a larger score gives a larger key, and -0 == +0
// (they compare equal as floats, so they must tie here too).
__device__ __forceinline__ unsigned int score_key(float x) {
  const unsigned int u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// f32 GT: exact f32 FMAs on the CUDA cores (the path-score ORDER contract
// of an f32 index).  Each thread accumulates 16 queries x 4 adjacent
// columns and stages the raw sums in sc.
__device__ __forceinline__ void sweep_fma(const float* __restrict__ qq,
                                          const float* __restrict__ gt,
                                          float* sc, float* qs, int B,
                                          int twoD, int Sp, int q0,
                                          size_t gcol, int col) {
  const int tid = threadIdx.x;
  float acc[TQ][CPT];
#pragma unroll
  for (int q = 0; q < TQ; ++q)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[q][j] = 0.f;

  for (int d0 = 0; d0 < twoD; d0 += DCH) {
    const int dn = min(DCH, twoD - d0);
    __syncthreads();
    for (int e = tid; e < TQ * DCH; e += THREADS) {
      const int q = e / DCH, d = e % DCH;
      float v = 0.f;
      if (q0 + q < B && d < dn) {
        v = qq[(size_t)(q0 + q) * twoD + d0 + d];
      }
      qs[e] = v;
    }
    __syncthreads();
    const float* gp = gt + (size_t)d0 * Sp + gcol;
#pragma unroll 2
    for (int d = 0; d < dn; ++d) {
      const float4 g4 = *reinterpret_cast<const float4*>(gp + (size_t)d * Sp);
      const float g[CPT] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        const float a = qs[q * DCH + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[q][j] = fmaf(a, g[j], acc[q][j]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
    *reinterpret_cast<float4*>(sc + q * SLAB + col) =
        make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
  }
}

// bf16 GT: tensor cores (mma.sync through WMMA, m16n16k16, f32
// accumulation).  The block's 16 queries are one m16 tile; warp w owns the
// slab's columns [128w, 128w + 128) as eight n16 tiles, read straight from
// GT.  A last depth chunk that 2D does not fill is staged zero-padded in
// the (still unused) score buffer, so no row past 2D is read.
__device__ __forceinline__ void sweep_mma(const __nv_bfloat16* __restrict__ qq,
                                          const __nv_bfloat16* __restrict__ gt,
                                          float* sc, float* qs, int B,
                                          int twoD, int Sp, int q0,
                                          int slab) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int wcol = (tid >> 5) * 128;
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(qs);  // [TQ][DCH]
  __nv_bfloat16* tail = reinterpret_cast<__nv_bfloat16*>(sc); // [16][SLAB]
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const __nv_bfloat16* gslab = gt + (size_t)slab * SLAB;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int d0 = 0; d0 < twoD; d0 += DCH) {
    const int dn = min(DCH, twoD - d0);
    __syncthreads();
    for (int e = tid; e < TQ * DCH; e += THREADS) {
      const int q = e / DCH, d = e % DCH;
      qb[e] = (q0 + q < B && d < dn) ? qq[(size_t)(q0 + q) * twoD + d0 + d]
                                     : zero;
    }
    __syncthreads();
    for (int k0 = 0; k0 < dn; k0 += 16) {
      const int dk = d0 + k0;
      const bool ragged = dk + 16 > twoD;               // block-uniform
      if (ragged) {
        for (int e = tid; e < 16 * SLAB; e += THREADS) {
          const int r = e / SLAB;
          tail[e] = (dk + r < twoD) ? gslab[(size_t)(dk + r) * Sp + e % SLAB]
                                    : zero;
        }
        __syncthreads();
      }
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, qb + k0, DCH);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        if (ragged) {
          wmma::load_matrix_sync(b, tail + wcol + t * 16, SLAB);
        } else {
          wmma::load_matrix_sync(b, gslab + (size_t)dk * Sp + wcol + t * 16,
                                 Sp);
        }
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
  }
  __syncthreads();                      // the ragged staging aliased sc
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    wmma::store_matrix_sync(sc + wcol + t * 16, acc[t], SLAB,
                            wmma::mem_row_major);
  }
}

// Group pool of one query (warp-uniform): per 128-row group, ``per_group``
// rounds of max/argmax over the four rows each lane holds in registers.
__device__ __forceinline__ void group_select(const float* rs, float* out_s,
                                             int* out_i, size_t base,
                                             int slab, int per_group) {
  const int lane = threadIdx.x & 31;
  const unsigned int full = 0xffffffffu;
  for (int g = 0; g < NG; ++g) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = rs[g * GROUP + j * 32 + lane];
    for (int i = 0; i < per_group; ++i) {
      float best = v[0];
      int bi = lane;
#pragma unroll
      for (int j = 1; j < 4; ++j) {         // rows ascend with j: first max
        if (v[j] > best) { best = v[j]; bi = j * 32 + lane; }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(full, best, off);
        const int oi = __shfl_xor_sync(full, bi, off);
        if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
      }
      if (lane == 0) {
        out_s[base + (size_t)i * NG + g] = best;
        out_i[base + (size_t)i * NG + g] = slab * SLAB + g * GROUP + bi;
      }
      if ((bi & 31) == lane) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j == (bi >> 5)) v[j] = NEG;
        }
      }
    }
  }
}

// One block per (slab, 16-query tile).  GROUP_POOL = false: per-slab
// top-kappa by radix select (``sel`` = kappa, invalid rows -inf); true:
// the group pool (``sel`` = per_group, invalid rows NEG).
template <typename T, bool GROUP_POOL>
__global__ void __launch_bounds__(THREADS, 1)
fused_topk_kernel(const T* __restrict__ qq, const T* __restrict__ gt,
                  const float* __restrict__ c,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int B, int twoD, int Sp, int sel) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                    // [TQ][SLAB]
  unsigned int* hs =
      reinterpret_cast<unsigned int*>(sc + TQ * SLAB);           // [TQ][BINS]
  float* qs = reinterpret_cast<float*>(hs + TQ * BINS);          // [TQ][DCH]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int slab = blockIdx.y;
  const int col = tid * CPT;                          // within the slab
  const size_t gcol = (size_t)slab * SLAB + col;      // within GT

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    sweep_mma(qq, gt, sc, qs, B, twoD, Sp, q0, slab);
  } else {
    sweep_fma(qq, gt, sc, qs, B, twoD, Sp, q0, gcol, col);
  }
  __syncthreads();

  // bias and validity mask on the staged scores
  const float masked = GROUP_POOL ? NEG : __int_as_float(0xff800000);
  float cb[CPT];
  bool ok[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    cb[j] = c[gcol + j];
    ok[j] = valid[gcol + j] != 0;
  }
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
    float4* p = reinterpret_cast<float4*>(sc + q * SLAB + col);
    float4 v = *p;
    v.x = ok[0] ? v.x + cb[0] : masked;
    v.y = ok[1] ? v.y + cb[1] : masked;
    v.z = ok[2] ? v.z + cb[2] : masked;
    v.w = ok[3] ? v.w + cb[3] : masked;
    *p = v;
  }
  __syncthreads();

  // exact selection: warp w handles query w (warp-uniform branch)
  const int w = tid >> 5, lane = tid & 31;
  const int qg = q0 + w;
  if (qg >= B) return;
  const float* rs = sc + w * SLAB;
  if constexpr (GROUP_POOL) {
    group_select(rs, out_s, out_i, ((size_t)slab * B + qg) * sel * NG, slab,
                 sel);
    return;
  }
  const int kappa = sel;
  unsigned int* hist = hs + w * BINS;
  const unsigned int full = 0xffffffffu;
  // radix select: after pass p, `prefix` holds the top 8(p+1) bits of the
  // kappa-th largest key and `remaining` how many keys sharing them are
  // still to take
  unsigned int prefix = 0u, pmask = 0u;
  int remaining = kappa;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < BINS; b += 32) hist[b] = 0u;
    __syncwarp();
    for (int i = lane; i < SLAB; i += 32) {
      const unsigned int k = score_key(rs[i]);
      if ((k & pmask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
    }
    __syncwarp();
    // lane l owns digits 255-8l down to 248-8l: a scan over lanes counts
    // the keys at or above each lane's lowest digit
    unsigned int own[8];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      own[j] = hist[BINS - 1 - 8 * lane - j];
      sum += (int)own[j];
    }
    int cum = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(full, cum, off);
      if (lane >= off) cum += t;
    }
    const int L = __ffs(__ballot_sync(full, cum >= remaining)) - 1;
    int digit = 0, above = 0;
    if (lane == L) {
      int acc = cum - sum, j = 0;
      for (; j < 7; ++j) {
        if (acc + (int)own[j] >= remaining) break;
        acc += (int)own[j];
      }
      digit = BINS - 1 - 8 * lane - j;
      above = acc;
    }
    digit = __shfl_sync(full, digit, L);
    above = __shfl_sync(full, above, L);
    remaining -= above;
    prefix |= (unsigned int)digit << shift;
    pmask |= 255u << shift;
    __syncwarp();                 // histogram read before the next clear
  }

  // write the keys above the kappa-th, then the `remaining` lowest-id
  // rows equal to it, in row order
  const unsigned int lt = (1u << lane) - 1u;
  const size_t base = ((size_t)slab * B + qg) * kappa;
  int taken = 0, eq_seen = 0;
  for (int i0 = 0; i0 < SLAB && taken < kappa; i0 += 32) {
    const int i = i0 + lane;
    const float v = rs[i];
    const unsigned int k = score_key(v);
    const unsigned int eqb = __ballot_sync(full, k == prefix);
    const bool take = k > prefix ||
        (k == prefix && eq_seen + __popc(eqb & lt) < remaining);
    const unsigned int tb = __ballot_sync(full, take);
    if (take) {
      const int pos = taken + __popc(tb & lt);
      out_s[base + pos] = v;
      out_i[base + pos] = slab * SLAB + i;
    }
    taken += __popc(tb);
    eq_seen += __popc(eqb);
  }
}

template <typename T, bool GROUP_POOL>
int launch(const void* qq, const void* gt, const void* c, const void* valid,
           void* out_s, void* out_i, int B, int twoD, int Sp, int sel,
           void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_topk_kernel<T, GROUP_POOL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TQ - 1) / TQ, Sp / SLAB);
  fused_topk_kernel<T, GROUP_POOL><<<grid, THREADS, SMEM,
                                     reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const T*>(qq), reinterpret_cast<const T*>(gt),
      reinterpret_cast<const float*>(c),
      reinterpret_cast<const uint8_t*>(valid),
      reinterpret_cast<float*>(out_s), reinterpret_cast<int*>(out_i), B,
      twoD, Sp, sel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_topk_bf16(const void* qq, const void* gt, const void* c,
                               const void* valid, void* out_s, void* out_i,
                               int B, int twoD, int Sp, int kappa,
                               void* stream) {
  return launch<__nv_bfloat16, false>(qq, gt, c, valid, out_s, out_i, B,
                                      twoD, Sp, kappa, stream);
}

extern "C" int fused_topk_f32(const void* qq, const void* gt, const void* c,
                              const void* valid, void* out_s, void* out_i,
                              int B, int twoD, int Sp, int kappa,
                              void* stream) {
  return launch<float, false>(qq, gt, c, valid, out_s, out_i, B, twoD, Sp,
                              kappa, stream);
}

// Group pool: out_s/out_i (NS, B, per_group * 16), 1 <= per_group <= 128.
extern "C" int fused_group_topk_bf16(const void* qq, const void* gt,
                                     const void* c, const void* valid,
                                     void* out_s, void* out_i, int B,
                                     int twoD, int Sp, int per_group,
                                     void* stream) {
  return launch<__nv_bfloat16, true>(qq, gt, c, valid, out_s, out_i, B,
                                     twoD, Sp, per_group, stream);
}

extern "C" int fused_group_topk_f32(const void* qq, const void* gt,
                                    const void* c, const void* valid,
                                    void* out_s, void* out_i, int B,
                                    int twoD, int Sp, int per_group,
                                    void* stream) {
  return launch<float, true>(qq, gt, c, valid, out_s, out_i, B, twoD, Sp,
                             per_group, stream);
}
