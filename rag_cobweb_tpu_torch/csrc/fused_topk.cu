// Fused path-score sweep with a per-slab top-kappa pool.
//
// Replaces: rag_cobweb_tpu/ops/pallas_query.py::_fused_kernel (the Pallas
// kernel behind pallas_fused_topk).  For every 2048-row slab s and query b:
//   scores[b, t] = sum_d qq[b, d] * GT[d, t] + c[t]   (invalid rows: -inf)
// and the slab's top-kappa (score, global row id), ties to the lower id,
// in no particular order (the caller's merge takes a top-k over them).
// The (B, Sp) score matrix never reaches device memory: it lives in shared
// memory, a (slab, query tile) at a time.
//
// What bounds it on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"): at the
// c=10k main path (2D = 496, Sp = 10240, kappa = 1024) the sweep is 2 B 2D
// Sp operations (10.4 GFLOP at B = 1024, 11 us at 989 TFLOP/s bf16) on a
// 10 MB GT, and the pool it writes is NS B kappa (score, id) pairs (42 MB
// at B = 1024, 12.5 us at 3.35 TB/s): bytes bound it, 16 us at B = 1024
// and 3 us at B <= 32 (GT alone).  At 1M rows (kappa = 16) the operations
// do: 1.07 TFLOP, 1.1 ms.
//
// What the bf16 design does (slab_topk_wgmma, the serving path):
//   * one CUDA block (CTA) owns 64 queries (one wgmma M) and 256 columns of
//     one slab, and the 8 CTAs of a slab form a cluster, so B = 1 runs 8
//     CTAs a slab (40 at the main path, 5 before) and the 64 x 2048 f32
//     score tile (512 KB) is spread over 8 shared memories;
//   * a producer warpgroup streams GT in 64-row chunks of the CTA's 256
//     columns (four 128-byte swizzled TMA boxes, zero fill past 2D: the
//     ragged depth needs no staging) through a ring of 2-4 mbarrier stages;
//     GT is (2D, Sp) row-major, so the chunk is wgmma's B operand MN-major.
//     The 64 x 2D query tile is wgmma's A operand in shared memory: the
//     producer stores it swizzled itself (any 2D, zero past B and 2D); up
//     to 2D = 512 it is stored once and stays, a wider one comes with each
//     chunk through the ring (a template parameter);
//   * two consumer warpgroups each run m64n128k16 wgmma over 128 columns,
//     one chunk's group in flight while the next is issued;
//   * the scores (+ c, invalid rows -inf) go to shared memory over the
//     drained ring, and an exact radix select on order-preserving 32-bit
//     keys (up to 4 passes of 8 bits) runs over the cluster: every CTA
//     counts the digits of its columns for its 64 queries (16-bit counts,
//     one thread a query, 4 keys a 16-byte load), pushes each query's
//     counts by 16-byte stores into the inbox of the CTA that owns it
//     (query q: CTA q % 8), and the owner sums them, picks the digit and
//     pushes the decision to every CTA.  Pulling the counts instead (4-byte
//     loads of distributed shared memory) took 4x longer.  It stops once
//     every query's chosen bin is taken whole (3 passes on random scores);
//   * the tie rule across CTAs: the owner also keeps each CTA's count of
//     keys above the kappa-th key T and in its bin, and hands each CTA its
//     offsets: the keys above T of the CTAs to its left, and their keys
//     equal to T.  A CTA writes its keys above T there and its keys equal
//     to T in row order after all keys above T, up to the count to take:
//     the lowest-id rows equal to T, as one warp a slab did before, with
//     no exchange after the last pass.
// The f32 path (the exact f32 index) keeps exact f32 FMAs on the CUDA cores
// in d order: one block per (slab, 16-query tile), 512 threads, each 16
// queries x 4 adjacent columns, the 16 x 2048 scores in 128 KB of shared
// memory, then one warp a query selects with the same radix select
// (fused_topk_kernel).

// Second entry, the group-max pool (fused_group_topk_*): replaces
// rag_cobweb_tpu/ops/pallas_query.py::_fused_group_kernel (behind
// pallas_fused_group_topk).  fused_topk_kernel's sweep (a bf16 GT on WMMA,
// mma.sync m16n16k16, B fragments read from GT) and score tile, invalid
// rows NEG = -3e38 as in the TPU kernel; then, instead of the radix select,
// each warp takes its query's 16 groups of 128 adjacent rows and runs
// ``per_group`` rounds of max/argmax per group (ties to the lower row, the
// taken row set to NEG; once every row is NEG a round returns NEG at the
// group's lowest row, as JAX's argmax does).  Column i * 16 + g of the
// (NS, B, per_group * 16) output holds round i of group g, with the global
// row slab * 2048 + g * 128 + argmax.  Its bound is the sweep's (~10.4
// GFLOP at the flagship shape, ~11 us): the selection is 4 registers a
// lane and a 5-step shuffle per round, cheap next to the radix select.

#include <mma.h>

#include "hopper.cuh"

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

// -- bf16 top-kappa: wgmma on a TMA ring, radix select over a cluster -------

using bf16 = __nv_bfloat16;

constexpr int SPLIT = 8;                  // CTAs of a slab: one cluster
constexpr int NTC = SLAB / SPLIT;         // 256 slab columns a CTA
constexpr int WTQ = 64;                   // queries a CTA (wgmma M)
constexpr int KC = BOXC;                  // GT rows a ring stage = a query box
constexpr int WG = 128;                   // threads of a warpgroup
constexpr int W_CONSUMERS = 2 * WG;       // 128 columns each
constexpr int W_THREADS = W_CONSUMERS + WG;   // + the producer warpgroup
constexpr int W_MAX_STAGES = 4;
constexpr int W_RESIDENT = 8;             // query boxes that stay: 2D <= 512
constexpr int LDS = NTC + 4;              // 16-byte rows, conflict-free
constexpr int HW = BINS / 2 + 1;         // histogram row: words, padded

// Shared memory of slab_topk_wgmma.  During the sweep: the resident query
// tile (KB boxes of 64 rows x 64 columns; none when carried) and the
// ring, each stage the carried query box (if any) and four GT boxes of
// KC rows x 64 columns.  After it, over the same bytes: the score tile
// [WTQ][LDS] f32, the histograms [WTQ][HW] and the per-query decisions.
// Then, apart (other CTAs write it while the sweep runs), the inbox of the
// owned queries' counts, and the mbarriers:
// the query tile's, ``stages`` full, ``stages`` empty.
struct WLayout {
  int KB, qres, abytes, stage_bytes, epi, inbox, bars, total;
  __host__ __device__ WLayout(int twoD, int stages) {
    KB = (twoD + BOXC - 1) / BOXC;
    const bool carried = KB > W_RESIDENT;
    qres = carried ? 0 : KB * WTQ * ROWB;
    abytes = carried ? WTQ * ROWB : 0;
    stage_bytes = abytes + (NTC / BOXC) * KC * ROWB;
    const int main_bytes = qres + stages * stage_bytes;
    epi = WTQ * LDS * 4 + WTQ * HW * 4 + WTQ * 16;
    inbox = ((main_bytes > epi ? main_bytes : epi) + 15) / 16 * 16;
    bars = inbox + WTQ * BINS * 2;
    total = 1024 + bars + 8 * (1 + 2 * stages);   // 1024: alignment slack
  }
};

// Query rows q0 .. q0 + 63, depth boxes [kb0, kb0 + nb), into 128-byte
// swizzled boxes at ``dst`` as TMA would write them, zero past B and 2D;
// by the producer warpgroup's thread ``pt``.
__device__ __forceinline__ void stage_query(uint8_t* dst,
                                            const bf16* __restrict__ qq,
                                            int B, int twoD, int q0, int kb0,
                                            int nb, int pt) {
  const bool vec = (twoD & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(qq) & 15) == 0;
  constexpr int U = 8;                    // loads in flight a thread
  const int n = nb * WTQ * 8;             // 16-byte chunks
  for (int e0 = pt; e0 < n; e0 += U * WG) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * WG;
      const int box = e / (WTQ * 8), r = (e >> 3) % WTQ, ch = e & 7;
      const int k = (kb0 + box) * BOXC + ch * 8, q = q0 + r;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < n && q < B && k < twoD) {
        const bf16* src = qq + (size_t)q * twoD + k;
        if (vec) {
          v[u] = *reinterpret_cast<const uint4*>(src);
        } else {
          uint32_t h[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            h[t] = k + t < twoD ? __bfloat16_as_ushort(src[t]) : 0u;
          }
          v[u] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                            h[4] | h[5] << 16, h[6] | h[7] << 16);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * WG;
      if (e < n) {
        *reinterpret_cast<uint4*>(dst + e / (WTQ * 8) * WTQ * ROWB +
                                  swizzle128((e >> 3) % WTQ, e & 7)) = v[u];
      }
    }
  }
}

template <bool CARRIED>
__global__ void __launch_bounds__(W_THREADS, 1)
slab_topk_wgmma(const __grid_constant__ CUtensorMap tg,
                const bf16* __restrict__ qq, const float* __restrict__ c,
                const uint8_t* __restrict__ valid,
                float* __restrict__ out_s, int* __restrict__ out_i, int B,
                int twoD, int kappa, int stages) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned for the swizzled boxes; an offset of the shared array, so
  // that the compiler keeps shared (not generic) loads, stores and atomics
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const WLayout lay(twoD, stages);
  const uint32_t qs = smem_u32(base);
  const uint32_t ring = qs + lay.qres;
  const uint32_t bar_q = qs + lay.bars;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * stages;
  const int rank = blockIdx.x;            // the CTA's rank in its cluster
  const int q0 = blockIdx.y * WTQ, slab = blockIdx.z;
  const int col0 = slab * SLAB + rank * NTC;   // the CTA's first GT column
  const int nk = lay.KB;                  // depth chunks (KC = BOXC)
  const int qv = min(WTQ, B - q0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(bar_q, WG);
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, CARRIED ? WG + 1 : 1);
      mbar_init(bar_empty + 8 * s, W_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the inbox starts empty: the other CTAs push into it only after the
  // cluster barrier this arrives at
  uint32_t* inbox = reinterpret_cast<uint32_t*>(base + lay.inbox);
  for (int e = tid; e < WTQ * BINS / 8; e += W_THREADS) {
    reinterpret_cast<uint4*>(inbox)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  cluster_arrive();
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (tid >= W_CONSUMERS) {
    // -- producer warpgroup: the query tile by hand, GT by TMA -------------
    const int pt = tid - W_CONSUMERS;
    auto load_gt = [&](int k) {           // chunk k's GT boxes, by thread 0
      const int s = k % stages;
      const uint32_t full = bar_full + 8 * s;
      mbar_expect_tx(full, (NTC / BOXC) * KC * ROWB);
      for (int b = 0; b < NTC / BOXC; ++b) {
        tma_2d(ring + s * lay.stage_bytes + lay.abytes + b * KC * ROWB, &tg,
               col0 + b * BOXC, k * KC, full);
      }
    };
    // the first stages' GT in flight while the resident tile is stored
    const int first = CARRIED ? 0 : min(stages, nk);
    if (pt == 0) {
      for (int k = 0; k < first; ++k) load_gt(k);
    }
    if (!CARRIED) {
      stage_query(base, qq, B, twoD, q0, 0, nk, pt);
      fence_async_smem();
      mbar_arrive(bar_q);
    }
    for (int k = first; k < nk; ++k) {
      const int s = k % stages, n = k / stages;
      const uint32_t st = ring + s * lay.stage_bytes;
      const uint32_t full = bar_full + 8 * s;
      if ((CARRIED || pt == 0) && n > 0) {
        mbar_wait(bar_empty + 8 * s, (n - 1) & 1);
      }
      if (pt == 0) load_gt(k);
      if (CARRIED) {
        stage_query(base + (st - qs), qq, B, twoD, q0, k, 1, pt);
        fence_async_smem();
        mbar_arrive(full);
      }
    }
  } else {
    // -- consumer warpgroups: 64 queries x 128 columns each -----------------
    const int wg = tid >> 7;
    if (!CARRIED) mbar_wait(bar_q, 0);
    for (int k = 0; k < nk; ++k) {
      const int s = k % stages;
      mbar_wait(bar_full + 8 * s, (k / stages) & 1);
      const uint32_t st = ring + s * lay.stage_bytes;
      const uint32_t a = CARRIED ? st : qs + k * WTQ * ROWB;
      const uint32_t b = st + lay.abytes + wg * 2 * KC * ROWB;
      fence_regs<64>(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        wgmma_ss_tb_n128(acc, smem_desc(a + ks * 32, 16),
                         smem_desc(b + ks * 16 * ROWB, KC * ROWB));
      }
      wgmma_commit();
      wgmma_wait<1>();                    // chunk k - 1 is read
      if (k > 0) mbar_arrive(bar_empty + 8 * ((k - 1) % stages));
    }
    wgmma_wait<0>();
    fence_regs<64>(acc);
  }
  __syncthreads();                        // the ring is drained

  // -- the score tile over the ring: + c, invalid rows -inf ------------------
  float* sc = reinterpret_cast<float*>(base);
  // [WTQ][HW] words of two 16-bit digit counts (a CTA has 256 columns)
  uint32_t* hist = reinterpret_cast<uint32_t*>(sc + WTQ * LDS);
  // [WTQ]: the prefix of T; the rows equal to T still to take, | 1 << 16
  // once they are the whole chosen bin; then this CTA's offsets, the keys
  // above T and the keys equal to T of the CTAs to its left
  uint4* dec = reinterpret_cast<uint4*>(hist + WTQ * HW);
  // inbox: [SPLIT source CTAs][WTQ / SPLIT owned queries][BINS / 2] words
  const float ninf = __int_as_float(0xff800000);
  if (tid < W_CONSUMERS) {
    const int wg = tid >> 7, r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int cq = lane & 3;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wg * 128 + 8 * j + 2 * cq + e;
        const bool ok = valid[col0 + col] != 0;
        const float cb = c[col0 + col];
        sc[r0 * LDS + col] = ok ? acc[4 * j + e] + cb : ninf;
        sc[(r0 + 8) * LDS + col] = ok ? acc[4 * j + 2 + e] + cb : ninf;
      }
    }
  }
  if (tid < WTQ) dec[tid] = make_uint4(0u, (uint32_t)kappa, 0u, 0u);

  // -- radix select over the cluster: up to 4 passes of 8 bits ---------------
  // Each CTA counts its columns' digits per query (a thread a query and QS
  // columns, read 4 at a time: 64 columns at 64 queries), pushes each
  // query's counts to the CTA that owns it (query q: CTA q % SPLIT) by
  // 16-byte stores into that CTA's inbox (those that are not zero: the
  // owner clears what it has read; the histogram is cleared as it is
  // pushed), and the owner sums them,
  // picks the digit, keeps each CTA's count of keys above T and pushes the
  // decision with each CTA's offsets to that CTA.  The select stops once
  // every query's chosen bin is taken whole.
  int QS = 1;
  while (QS < qv) QS <<= 1;
  const int hq = tid % QS, hg = tid / QS;
  const unsigned full = 0xffffffffu, lt = (1u << lane) - 1u;
  uint32_t pm = 0u;                       // the key bits fixed so far
  int abv[SPLIT];                         // the owner's: keys above, by CTA
#pragma unroll
  for (int m = 0; m < SPLIT; ++m) abv[m] = 0;
  for (int e = tid; e < WTQ * HW; e += W_THREADS) hist[e] = 0u;
  cluster_wait();                         // every inbox is empty
  __syncthreads();
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < W_CONSUMERS && hq < qv) {
      const uint32_t prefix = dec[hq].x;
      const float* row = sc + hq * LDS + hg * QS;
      uint32_t* h = hist + hq * HW;
      if (QS >= 4) {
#pragma unroll 2
        for (int i = 0; i < QS; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(row + i);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t k = score_key(xs[j]);
            const uint32_t d = (k >> shift) & 255u;
            if ((k & pm) == prefix) {
              atomicAdd(&h[d >> 1], 1u << ((d & 1u) << 4));
            }
          }
        }
      } else {
        for (int i = 0; i < QS; ++i) {
          const uint32_t k = score_key(row[i]);
          const uint32_t d = (k >> shift) & 255u;
          if ((k & pm) == prefix) atomicAdd(&h[d >> 1], 1u << ((d & 1u) << 4));
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < qv * (BINS / 8); e += W_THREADS) {
      const int q = e / (BINS / 8), w4 = e % (BINS / 8) * 4;
      uint32_t* h = hist + q * HW + w4;   // read, and cleared for the next
      const uint4 v = make_uint4(h[0], h[1], h[2], h[3]);
      h[0] = h[1] = h[2] = h[3] = 0u;
      if (v.x | v.y | v.z | v.w) {
        st_cluster_v4(cluster_addr(smem_u32(inbox + (rank * (WTQ / SPLIT) +
                                                     q / SPLIT) * (BINS / 2) +
                                            w4),
                                   q % SPLIT),
                      v);
      }
    }
    cluster_sync();                       // every owner has its counts
    const int q = rank + SPLIT * w;       // warp w decides query q
    if (w < WTQ / SPLIT && q < qv) {
      // lane l owns digits 255-8l down to 248-8l: bin_of(v, j) is digit
      // 255-8l-j of the counts v
      uint4 v[SPLIT];
#pragma unroll
      for (int m = 0; m < SPLIT; ++m) {
        uint4* at = reinterpret_cast<uint4*>(
            inbox + (m * (WTQ / SPLIT) + w) * (BINS / 2) + BINS / 2 - 4 -
            4 * lane);
        v[m] = *at;
        *at = make_uint4(0u, 0u, 0u, 0u);
      }
      auto bin_of = [](const uint4& x, int j) {
        const uint32_t wd = j < 2 ? x.w : j < 4 ? x.z : j < 6 ? x.y : x.x;
        return (int)((j & 1) ? wd & 0xffffu : wd >> 16);
      };
      int own[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        own[j] = 0;
#pragma unroll
        for (int m = 0; m < SPLIT; ++m) own[j] += bin_of(v[m], j);
        sum += own[j];
      }
      const uint4 d = dec[q];
      int remaining = (int)(d.y & 0xffffu);
      int cum = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(full, cum, off);
        if (lane >= off) cum += t;
      }
      const int L = __ffs(__ballot_sync(full, cum >= remaining)) - 1;
      int digit = 0, above = 0, sel = 0;
      if (lane == L) {
        int at = cum - sum, j = 0;
        for (; j < 7; ++j) {
          if (at + own[j] >= remaining) break;
          at += own[j];
        }
        digit = BINS - 1 - 8 * lane - j;
        above = at;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i == j) sel = own[i];
        }
      }
      digit = __shfl_sync(full, digit, L);
      above = __shfl_sync(full, above, L);
      sel = __shfl_sync(full, sel, L);
      remaining -= above;
      // each CTA's keys above the digit and in its bin, this pass
      int gl = 0, el = 0;
#pragma unroll
      for (int m = 0; m < SPLIT; ++m) {
        int a = 0, eq = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int bin = BINS - 1 - 8 * lane - j;
          a += bin > digit ? bin_of(v[m], j) : 0;
          eq += bin == digit ? bin_of(v[m], j) : 0;
        }
        abv[m] += __reduce_add_sync(full, a);
        eq = __reduce_add_sync(full, eq);
        if (m < lane) {
          gl += abv[m];
          el += eq;
        }
      }
      if (lane < SPLIT) {
        st_cluster_v4(cluster_addr(smem_u32(dec + q), lane),
                      make_uint4(d.x | (uint32_t)digit << shift,
                                 (uint32_t)remaining |
                                     (sel == remaining ? 1u << 16 : 0u),
                                 (uint32_t)gl, (uint32_t)el));
      }
    }
    cluster_sync();                       // every CTA has every decision
    pm |= 255u << shift;
    if (__syncthreads_and(tid >= qv || (dec[tid].y >> 16) != 0u)) break;
  }

  // -- the pool: keys above T, then the lowest-id rows equal to T ------------
  // On the key bits the select fixed (pm): this CTA's keys above T go after
  // those of the CTAs to its left; its keys equal to T, in row order, after
  // all kappa - R keys above T and the equal keys of the CTAs to its left,
  // up to R.
  for (int q = w; q < qv; q += W_THREADS / 32) {
    const uint4 d = dec[q];
    const uint32_t T = d.x;
    const int R = (int)(d.y & 0xffffu), G = kappa - R;
    int taken = (int)d.z, eq_seen = (int)d.w;
    const float* row = sc + q * LDS;
    const size_t ob = ((size_t)slab * B + q0 + q) * kappa;
    float v[NTC / 32];
    unsigned gb[NTC / 32], eb[NTC / 32];
#pragma unroll
    for (int t = 0; t < NTC / 32; ++t) {
      v[t] = row[32 * t + lane];
      const uint32_t k = score_key(v[t]) & pm;
      gb[t] = __ballot_sync(full, k > T);
      eb[t] = __ballot_sync(full, k == T);
    }
#pragma unroll
    for (int t = 0; t < NTC / 32; ++t) {
      int pos = -1;
      if ((gb[t] >> lane) & 1u) {
        pos = taken + __popc(gb[t] & lt);
      } else if ((eb[t] >> lane) & 1u) {
        const int r = eq_seen + __popc(eb[t] & lt);
        if (r < R) pos = G + r;
      }
      if (pos >= 0) {
        out_s[ob + pos] = v[t];
        out_i[ob + pos] = col0 + 32 * t + lane;
      }
      taken += __popc(gb[t]);
      eq_seen += __popc(eb[t]);
    }
  }
}

int launch_wgmma(const void* qq, const void* gt, const void* c,
                 const void* valid, void* out_s, void* out_i, int B,
                 int twoD, int Sp, int kappa, cudaStream_t stream) {
  CUtensorMap tg;
  const cuuint64_t dims[2] = {(cuuint64_t)Sp, (cuuint64_t)twoD};
  if (!tensor_map(&tg, gt, 2, dims, KC)) return (int)cudaErrorInvalidValue;
  const bool carried = (twoD + BOXC - 1) / BOXC > W_RESIDENT;
  int stages = 2;
  while (stages < W_MAX_STAGES &&
         WLayout(twoD, stages + 1).total <= SMEM_LIMIT) {
    ++stages;
  }
  const int smem = WLayout(twoD, stages).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = carried ? slab_topk_wgmma<true> : slab_topk_wgmma<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLIT, (B + WTQ - 1) / WTQ, Sp / SLAB);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tg, reinterpret_cast<const bf16*>(qq),
                         reinterpret_cast<const float*>(c),
                         reinterpret_cast<const uint8_t*>(valid),
                         reinterpret_cast<float*>(out_s),
                         reinterpret_cast<int*>(out_i), B, twoD, kappa,
                         stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" int fused_topk_bf16(const void* qq, const void* gt, const void* c,
                               const void* valid, void* out_s, void* out_i,
                               int B, int twoD, int Sp, int kappa,
                               void* stream) {
  return launch_wgmma(qq, gt, c, valid, out_s, out_i, B, twoD, Sp, kappa,
                      reinterpret_cast<cudaStream_t>(stream));
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
