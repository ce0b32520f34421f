// Blocked-index sweep with a per-block top-kk pool.
//
// Replaces: rag_cobweb_tpu/ops/pallas_query.py::_kernel (behind
// pallas_blocked_topk) and ::_kernel_v2 (behind pallas_blocked_topk_tiled),
// whose body is _kernel.  For every sentence block s and query b:
//   nlp[b, m]    = q[b] . movt[s, m] - 0.5 q^2[b] . ivt[s, m] + const[s, m]
//   score[b, t]  = sum_m round_W(nlp[b, m]) * W[s, m, t]   (f32 accumulation)
// invalid slots score NEG = -3e38, then kk rounds of max/argmax with the
// taken slot set to NEG: ties go to the lower slot, and once every slot is
// NEG a round returns NEG at slot 0, as JAX's argmax does.
// Out: (NB, B, kk) f32 scores and int32 slots within the block.
//
// What bounds it on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"): 2 B NB M
// (2D + TS) operations on an index of NB M (2D + TS) elements.  On the
// 100k cell's served index (NB = 196, M = 768, D = 128, TS = 512, bf16)
// that is 236.7 GFLOP at B = 1024, 0.239 ms at 989 TFLOP/s (0.958 ms at
// B = 4096), and 231 MB of index: at B <= 32 the bytes bound it, 0.069 ms
// at 3.35 TB/s.
//
// The design reads the kernel as attention without a softmax: Q = [q |
// -0.5 q^2] (the factor is exact in bf16), K = [movt | ivt] of the block,
// P = bf16(Q K^T + const), V = W, and the epilogue is the mask and the kk
// argmax rounds.  One CUDA block (CTA) owns 64 queries (one wgmma M), one
// sentence block and a slice of 2 NT of its TS slots (NT = 64, 128 or 256):
//   * a producer warpgroup (one thread issues) streams M in chunks of MC =
//     64 nodes through a ring of 2-4 stages, each holding the chunk's
//     [movt | ivt] rows and its W rows of the slice, by TMA (128-byte
//     swizzle, zero fill past M, D, TS and B) on mbarriers.  Up to 2D =
//     512 columns the 64 x 2D query tile is loaded once and stays beside
//     the ring.  A wider one does not fit: then a chunk's [movt | ivt]
//     comes in segments of 128 columns (256 when NT < 256), one a stage,
//     each stage carries the query tile's matching segment, and the
//     chunk's W rows come with its last segment (a template parameter, so
//     the resident kernel has no segment loop);
//   * two consumer warpgroups (240 registers each by setmaxnreg; the
//     producer keeps 24) each run GEMM1 (nlp chunk, 64 x 64, K = 2D, both
//     operands in shared memory, one wgmma group a segment) with wgmma,
//     add const and round to bf16 in
//     registers exactly where the TPU kernel rounds (pallas_query.py:
//     67-69), and feed that as wgmma's register A operand to GEMM2 into
//     their own NT slots (64 x NT f32 in registers: 128 a thread at NT =
//     256).  Both compute the same nlp chunk: a third more tensor work, and
//     no exchange between them (at NT = 256 the ring leaves no room for one);
//   * after the M loop the scores go to shared memory over the ring (a
//     64 x 2 NT tile, invalid slots NEG), and four threads select each
//     query row's first kk: for kk <= 16 with sorting networks in registers
//     (blocks of 16 slots, merged, then across the four by shuffles), at NT
//     = 256 after a filter (the 16th largest maximum of 32 groups of slots
//     32 apart bounds the row's 16th score from below; only slots at or
//     above it are sorted, and a row with more than 64 takes the full
//     sort); for a larger kk a warp a row runs the rounds;
//   * with one CTA a block (2 NT >= TS) that is the output.  Else the CTAs
//     of one query tile and block form a cluster, one per slice, and merge
//     their sorted lists through distributed shared memory, exactly: each
//     candidate's rank is the number before it in all lists (score
//     descending, ties to the lower slot), and (NEG, 0) fills the rest.
// The query tile is 64 (the WMMA kernel had 32), so the L2 re-reads of
// each block's index halve.  The launcher chooses NT from TS and shared
// memory alone: the widest slice that covers TS (or 256, with more CTAs in
// the cluster for TS > 512), halved while shared memory does not fit.  A
// split of TS = 512 over a cluster when query tiles x blocks leave SMs
// idle lost to one CTA a block at B <= 64 on the served index, so there
// is none.  D must be a multiple of 8 (16-byte TMA rows;
// build_blocked_index pads it).  An f32 index runs on the CUDA cores at
// full f32 (fmaf), with the score tile in shared memory.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -3e38f;
constexpr int MC = 64;                    // nodes per M chunk

// -- bf16 kernel: TMA ring, wgmma, cluster merge ---------------------------

constexpr int TQ = 64;                    // queries per CTA (wgmma M)
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int BF16_THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int MAX_STAGES = 4;
constexpr int MAX_SPLIT = 8;              // portable cluster size
constexpr int RESIDENT_BOXES = 8;         // a query tile of 2D <= 512 stays

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
}

template <int NT>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (NT == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (NT == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

// GEMM1, issued and committed: nlp (64 queries x MC nodes) += the query
// boxes at ``qs`` . the [movt | ivt] boxes at ``kc``, K = 64 KB columns.
__device__ __forceinline__ void gemm1(float* nlp, uint32_t qs, uint32_t kc,
                                      int KB) {
  fence_regs<32>(nlp);
  wgmma_fence();
  for (int ks = 0; ks < KB * 4; ++ks) {
    const uint32_t kb = ks >> 2, kin = (ks & 3) * 32;   // 16 columns
    wgmma_ss_n64(nlp, smem_desc(qs + kb * TQ * ROWB + kin, 16),
                 smem_desc(kc + kb * MC * ROWB + kin, 16));
  }
  wgmma_commit();
}

// nlp + const, rounded to bf16: GEMM2's A fragments.  Accumulator block j
// holds columns 8j + 2cq + {0, 1} of rows r0 ({0, 1}) and r0 + 8 ({2, 3});
// A step kt takes blocks 2kt (a0 = r0, a1 = r0 + 8) and 2kt + 1 (a2, a3).
__device__ __forceinline__ void round_nlp(const float* nlp, uint32_t* a,
                                          const float* cb, int m0, int M,
                                          int cq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = m0 + 8 * j + 2 * cq;
    const float c0 = m < M ? __ldg(cb + m) : 0.f;
    const float c1 = m + 1 < M ? __ldg(cb + m + 1) : 0.f;
    a[4 * (j >> 1) + 2 * (j & 1)] = pack_bf16(nlp[4 * j] + c0,
                                              nlp[4 * j + 1] + c1);
    a[4 * (j >> 1) + 2 * (j & 1) + 1] = pack_bf16(nlp[4 * j + 2] + c0,
                                                  nlp[4 * j + 3] + c1);
  }
}

// Candidates in the order of the rounds: the higher score first, then the
// lower slot.
__device__ __forceinline__ bool before(float va, int ca, float vb, int cb) {
  return va > vb || (va == vb && ca < cb);
}

// Compare-exchange: the earlier pair ends at (va, ca).
__device__ __forceinline__ void cex(float& va, int& ca, float& vb, int& cb) {
  const bool sw = before(vb, cb, va, ca);
  const float tv = va;
  const int tc = ca;
  va = sw ? vb : va;
  ca = sw ? cb : ca;
  vb = sw ? tv : vb;
  cb = sw ? tc : cb;
}

constexpr int TOP = 16;                   // the sorting-network path's kk
constexpr int CAND = 4 * TOP;             // a row's filtered candidates

// Bitonic sort of TOP pairs into round order.
__device__ __forceinline__ void sort_top(float* v, int* c) {
#pragma unroll
  for (int k = 2; k <= TOP; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < TOP; ++i) {
        const int l = i ^ j;
        if (l > i) {
          if ((i & k) == 0) {
            cex(v[i], c[i], v[l], c[l]);
          } else {
            cex(v[l], c[l], v[i], c[i]);
          }
        }
      }
    }
  }
}

// (v, c) := the first TOP of two lists in round order, (v, c) and (w, d):
// the better of v[i] and w[TOP-1-i] is a bitonic sequence of them, which
// a half-cleaner cascade sorts.
__device__ __forceinline__ void keep_top(float* v, int* c, const float* w,
                                         const int* d) {
#pragma unroll
  for (int i = 0; i < TOP; ++i) {
    if (before(w[TOP - 1 - i], d[TOP - 1 - i], v[i], c[i])) {
      v[i] = w[TOP - 1 - i];
      c[i] = d[TOP - 1 - i];
    }
  }
#pragma unroll
  for (int j = TOP >> 1; j > 0; j >>= 1) {
#pragma unroll
    for (int i = 0; i < TOP; ++i) {
      if ((i ^ j) > i) cex(v[i], c[i], v[i ^ j], c[i ^ j]);
    }
  }
}

// Block ``b`` of TOP slots of a score-tile row, with their columns.
__device__ __forceinline__ void load_block(const float* row, int b, float* w,
                                           int* d) {
#pragma unroll
  for (int i = 0; i < TOP; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + b * TOP + i);
    w[i] = x.x;
    w[i + 1] = x.y;
    w[i + 2] = x.z;
    w[i + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < TOP; ++i) d[i] = b * TOP + i;
}

// Value-only compare-exchange: the larger ends at a.
__device__ __forceinline__ void cexv(float& a, float& b) {
  const float hi = fmaxf(a, b);
  b = fminf(a, b);
  a = hi;
}

// Half-cleaner cascade: a bitonic sequence of 16 values -> descending.
__device__ __forceinline__ void clean16(float* t) {
#pragma unroll
  for (int j = 8; j > 0; j >>= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if ((i ^ j) > i) cexv(t[i], t[i ^ j]);
    }
  }
}

// A lower bound of a score-tile row's TOP-th largest score (NT = 256: 512
// slots in 32 groups of TOP slots 32 apart, eight groups in each of the
// row's four threads): the TOP-th largest group maximum, since TOP groups
// hold a score at least as large.  Slots 32 apart, not blocks of adjacent
// ones: a block's sentences are neighbours in the tree, so its high scores
// come in runs, which strided groups spread over many maxima.  Every
// thread of the quad ``quad`` gets the same bound.
__device__ __forceinline__ float top_bound(const float* row, int qd,
                                           unsigned quad) {
  float m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float mx = __int_as_float(0xff800000);
#pragma unroll
    for (int i = 0; i < TOP; ++i) mx = fmaxf(mx, row[qd + 4 * k + 32 * i]);
    m[k] = mx;
  }
#pragma unroll
  for (int k = 2; k <= 8; k <<= 1) {      // bitonic sort, descending
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int l = i ^ j;
        if (l > i) {
          if ((i & k) == 0) {
            cexv(m[i], m[l]);
          } else {
            cexv(m[l], m[i]);
          }
        }
      }
    }
  }
  float t[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = m[i];
    t[8 + i] = __shfl_xor_sync(quad, m[7 - i], 1);
  }
  clean16(t);                             // the pair's 16, descending
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    t[i] = fmaxf(t[i], __shfl_xor_sync(quad, t[15 - i], 2));
  }
  clean16(t);                             // the quad's first 16
  return t[15];
}

// Query boxes (64 rows) of q^2 -> -0.5 q^2, exact in bf16, by the
// consumers; then seen by wgmma and by both warpgroups.
__device__ __forceinline__ void halve_neg(uint8_t* p, int boxes) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  const int n = boxes * TQ * ROWB / 4;
  for (int e = threadIdx.x; e < n; e += CONSUMERS) {
    const float2 v = __bfloat1622float2(h[e]);
    h[e] = __floats2bfloat162_rn(-0.5f * v.x, -0.5f * v.y);
  }
  fence_async_smem();
  consumers_sync();
}

#ifdef BLOCKED_PHASES
// bench/blocked_phases.py builds with -DBLOCKED_PHASES: the first consumer
// thread of every CTA stamps clock64() at the phase boundaries, and the
// rows that fail the selection's filter are counted.
__device__ long long g_stamps[65536 * 8];
__device__ unsigned long long g_full_rows;
#define STAMP(k)                                                            \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      g_stamps[((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + \
                blockIdx.x) * 8 + (k)] = clock64();                         \
    }                                                                       \
  } while (0)
#define COUNT_FULL_ROW() atomicAdd(&g_full_rows, 1ull)
#else
#define STAMP(k) do {} while (0)
#define COUNT_FULL_ROW() do {} while (0)
#endif

// Shared memory of the bf16 kernel.  During the M loop: the resident
// query tile (KB boxes of 64 rows; none when it is carried) and
// ``stages`` ring stages.  A stage holds, each in boxes of 64 rows: the
// carried query segment (SB boxes; none when resident), SB boxes of the
// [movt | ivt] chunk and 2 NT / 64 boxes of W.  After the loop, over the
// same bytes: the score tile [TQ][LDT] f32, the lists of the
// cluster merge, scores [TQ][L] and u16 slots [TQ][L], and at NT = 256 the
// filtered candidates: counts [TQ], scores [TQ][CAND], slots [TQ][CAND].
// Then the mbarriers: the query tile's, ``stages`` full, ``stages`` empty.
struct Layout {
  int KB, SB, NS, WB, qres, qbytes, wofs, stage_bytes, ldt, bars, total;
  __host__ __device__ Layout(int Dp, int NT, int stages, int L) {
    KB = 2 * Dp / BOXC;
    // boxes of a segment: 256 columns, 128 at NT = 256 (two stages fit)
    SB = KB <= RESIDENT_BOXES ? KB : NT == 256 ? 2 : 4;
    NS = (KB + SB - 1) / SB;              // segments of a chunk
    WB = 2 * NT / BOXC;
    qres = NS == 1 ? KB * TQ * ROWB : 0;  // the resident query tile
    qbytes = NS == 1 ? 0 : SB * TQ * ROWB;    // a stage's query segment
    wofs = qbytes + SB * MC * ROWB;
    stage_bytes = wofs + WB * MC * ROWB;
    ldt = 2 * NT + 8;                     // padded: fewer bank conflicts
    const int main_bytes = qres + stages * stage_bytes;
    const int epi_bytes = TQ * ldt * 4 + (TQ * L * 6 + 15) / 16 * 16
                        + (NT == 256 ? TQ * 4 + TQ * CAND * 8 : 0);
    bars = ((main_bytes > epi_bytes ? main_bytes : epi_bytes) + 7) / 8 * 8;
    total = 1024 + bars + 8 * (1 + 2 * stages);   // 1024: alignment slack
  }
};

// CARRIED: the query tile comes through the ring in segments (2D > 512);
// a template parameter, so that the resident kernel has no segment loop.
template <int NT, bool CARRIED>
__global__ void __launch_bounds__(BF16_THREADS, 1)
blocked_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tq2,
                    const __grid_constant__ CUtensorMap tmv,
                    const __grid_constant__ CUtensorMap tiv,
                    const __grid_constant__ CUtensorMap tw,
                    const float* __restrict__ cst,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ out_s, int* __restrict__ out_t,
                    int B, int M, int Dp, int TS, int kk, int stages) {
  constexpr int NACC = NT / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int L = min(kk, 2 * NT);          // a list's length
  const Layout lay(Dp, NT, stages, L);
  const int NS = CARRIED ? lay.NS : 1, SB = CARRIED ? lay.SB : lay.KB;
  const int qbytes = CARRIED ? lay.qbytes : 0;
  const uint32_t qs = smem_u32(base);
  const uint32_t ring = qs + lay.qres;
  const uint32_t bar_q = qs + lay.bars;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * stages;

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int q0 = blockIdx.y * TQ, nb = blockIdx.z;
  const int ts0 = split * 2 * NT;
  const int nchunks = (M + MC - 1) / MC;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // -- producer warpgroup: one thread issues every TMA load --------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == CONSUMERS) {
      const int db = lay.KB / 2;          // boxes of q (and of movt)
      if (!CARRIED) {
        mbar_expect_tx(bar_q, lay.qres);
        for (int kb = 0; kb < lay.KB; ++kb) {
          tma_2d(qs + kb * TQ * ROWB, kb < db ? &tq : &tq2,
                 (kb % db) * BOXC, q0, bar_q);
        }
      }
      // ring item i: segment g of chunk c
      for (int i = 0; i < nchunks * NS; ++i) {
        const int c = i / NS, g = i % NS;
        const int s = i % stages, n = i / stages;
        if (n > 0) mbar_wait(bar_empty + 8 * s, (n - 1) & 1);
        const uint32_t st = ring + s * lay.stage_bytes;
        const uint32_t full = bar_full + 8 * s;
        const int k0 = g * SB, nk = min(SB, lay.KB - k0);
        const bool last = g == NS - 1;
        mbar_expect_tx(full, nk * ((CARRIED ? TQ : 0) + MC) * ROWB +
                                 (last ? lay.WB * MC * ROWB : 0));
        for (int j = 0; j < nk; ++j) {
          const int kb = k0 + j;
          if (CARRIED) {
            tma_2d(st + j * TQ * ROWB, kb < db ? &tq : &tq2,
                   (kb % db) * BOXC, q0, full);
          }
          tma_3d(st + qbytes + j * MC * ROWB, kb < db ? &tmv : &tiv,
                 (kb % db) * BOXC, c * MC, nb, full);
        }
        for (int wb = 0; last && wb < lay.WB; ++wb) {
          tma_3d(st + lay.wofs + wb * MC * ROWB, &tw, ts0 + wb * BOXC,
                 c * MC, nb, full);
        }
      }
    }
    __syncwarp();
    if (nsplit > 1) {
      cluster_sync();                     // every list is written
      cluster_sync();                     // every merge has read them
    }
    return;
  }

  // -- consumer warpgroups ---------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cq = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);   // this thread's rows: r0, r0 + 8

  // this thread's valid slots: bit 2j + e for column 8j + 2cq + e
  const uint8_t* vb = valid + (size_t)nb * TS;
  uint64_t vbits = 0;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = ts0 + wg * NT + 8 * j + 2 * cq + e;
      if (t < TS && vb[t]) vbits |= 1ull << (2 * j + e);
    }
  }

  // the query tile: [q | q^2] -> [q | -0.5 q^2], exact in bf16; a carried
  // one segment by segment in the M loop
  const int db = lay.KB / 2;
  STAMP(0);
  if (!CARRIED) {
    mbar_wait(bar_q, 0);
    halve_neg(base + db * TQ * ROWB, db);
  }
  STAMP(1);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const float* cb = cst + (size_t)nb * M;

  float nlp[32];
  uint32_t a[16];
  for (int c = 0; c < nchunks; ++c) {
    uint32_t st = 0;
    int s = 0;
    for (int g = 0; g < NS; ++g) {
      const int i = c * NS + g;
      s = i % stages;
      mbar_wait(bar_full + 8 * s, (i / stages) & 1);
      st = ring + s * lay.stage_bytes;
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 32; ++j) nlp[j] = 0.f;
      }
      const int k0 = g * SB, nk = min(SB, lay.KB - k0);
      if (CARRIED && k0 + nk > db) {
        const int h = max(db - k0, 0);    // the segment's first q^2 box
        halve_neg(base + (st - qs) + h * TQ * ROWB, nk - h);
      }
      gemm1(nlp, CARRIED ? st : qs + k0 * TQ * ROWB, st + qbytes, nk);
      wgmma_wait<0>();
      if (g + 1 < NS) mbar_arrive(bar_empty + 8 * s);
    }
    fence_regs<32>(nlp);
    round_nlp(nlp, a, cb, c * MC, M, cq);
    // GEMM2: this warpgroup's NT slots += P (64 x MC) . W chunk (MC x NT)
    const uint32_t wbase = st + lay.wofs + (wg * NT / BOXC) * MC * ROWB;
    fence_regs<NACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < MC / 16; ++kt) {
      wgmma_rs<NT>(acc, a + 4 * kt,
                   smem_desc(wbase + kt * 16 * ROWB, MC * ROWB));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NACC>(acc);
    mbar_arrive(bar_empty + 8 * s);
  }

  // -- the score tile over the ring, invalid slots NEG ----------------------
  STAMP(2);
  fence_async_smem();
  consumers_sync();                       // both warpgroups are done with it
  float* tile = reinterpret_cast<float*>(base);
  const int ldt = lay.ldt;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int col = wg * NT + 8 * j + 2 * cq;
    const bool u0 = (vbits >> (2 * j)) & 1, u1 = (vbits >> (2 * j + 1)) & 1;
    *reinterpret_cast<float2*>(tile + r0 * ldt + col) =
        make_float2(u0 ? acc[4 * j] : NEG, u1 ? acc[4 * j + 1] : NEG);
    *reinterpret_cast<float2*>(tile + (r0 + 8) * ldt + col) =
        make_float2(u0 ? acc[4 * j + 2] : NEG, u1 ? acc[4 * j + 3] : NEG);
  }
  float* ls = tile + TQ * ldt;
  uint16_t* lt = reinterpret_cast<uint16_t*>(ls + TQ * L);
  int* cand_n = reinterpret_cast<int*>(
      reinterpret_cast<uint8_t*>(ls) + (TQ * L * 6 + 15) / 16 * 16);
  float* cand_s = reinterpret_cast<float*>(cand_n + TQ);
  int* cand_t = reinterpret_cast<int*>(cand_s + TQ * CAND);
  if (NT == 256 && tid < TQ) cand_n[tid] = 0;
  consumers_sync();
  STAMP(3);

  // -- the first L candidates of each query row of the slice ----------------
  // With one CTA a block (nsplit == 1) they are the output; else lists for
  // the cluster merge.  A real candidate goes out as (score, slot), an
  // exhausted place as (NEG, 0).
  const int qv = min(TQ, B - q0);
  const int W2 = 2 * NT;
  auto emit = [&](int r, int i, float v, int slot) {
    if (nsplit == 1) {
      const size_t o = ((size_t)nb * B + q0 + r) * kk + i;
      const bool real = v > NEG;
      out_s[o] = real ? v : NEG;
      out_t[o] = real ? slot : 0;
    } else {
      ls[r * L + i] = v;
      lt[r * L + i] = static_cast<uint16_t>(slot);
    }
  };
  const int cw = tid >> 5;                // consumer warp 0..7
  if (kk <= TOP) {
    // four threads a row (warp cw: rows 8cw .. 8cw + 7), merging their
    // sorted lists by shuffles within the quad
    const int r = cw * 8 + (lane >> 2), qd = lane & 3;
    const unsigned quad = 0xfu << (lane & ~3);
    if (cw * 8 < qv) {
      const float* row = tile + r * ldt;
      float v[TOP];
      int c[TOP];
      bool done = false;
      if constexpr (NT == 256) {
        // Only slots at or above the bound can be among the first TOP:
        // gather them and sort those.  A row with more than CAND of them
        // (ties, or few valid slots) takes the full sort below.
        const float tau = top_bound(row, qd, quad);
#pragma unroll 1
        for (int b = qd; b < W2 / TOP; b += 4) {
#pragma unroll
          for (int i = 0; i < TOP; i += 4) {
            const float4 x = *reinterpret_cast<const float4*>(row + b * TOP +
                                                              i);
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (xs[k] >= tau) {
                const int at = atomicAdd(cand_n + r, 1);
                if (at < CAND) {
                  cand_s[r * CAND + at] = xs[k];
                  cand_t[r * CAND + at] = b * TOP + i + k;
                }
              }
            }
          }
        }
        __syncwarp();
        const int n = *reinterpret_cast<volatile int*>(cand_n + r);
        if (n <= CAND) {
#pragma unroll
          for (int i = 0; i < TOP; ++i) {
            const int at = qd * TOP + i;
            v[i] = at < n ? cand_s[r * CAND + at] : __int_as_float(0xff800000);
            c[i] = at < n ? cand_t[r * CAND + at] : 0x7fffffff;
          }
          sort_top(v, c);
          done = true;
        }
      }
      if (!done) {
        if (qd == 0) COUNT_FULL_ROW();
        // each thread sorts its blocks of TOP slots, keeping the first TOP
#pragma unroll 1
        for (int b = qd; b < W2 / TOP; b += 4) {
          float w[TOP];
          int d[TOP];
          load_block(row, b, w, d);
          sort_top(w, d);
          if (b == qd) {
#pragma unroll
            for (int i = 0; i < TOP; ++i) {
              v[i] = w[i];
              c[i] = d[i];
            }
          } else {
            keep_top(v, c, w, d);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        float w[TOP];
        int d[TOP];
#pragma unroll
        for (int i = 0; i < TOP; ++i) {
          w[i] = __shfl_xor_sync(quad, v[i], off);
          d[i] = __shfl_xor_sync(quad, c[i], off);
        }
        keep_top(v, c, w, d);
      }
      if (qd == 0 && r < qv) {
#pragma unroll
        for (int i = 0; i < TOP; ++i) {
          if (i < L) emit(r, i, v[i], ts0 + c[i]);
        }
      }
    }
  } else {
    // a warp a row: L rounds of max/argmax, the taken slot set to NEG
    for (int r = cw; r < qv; r += CONSUMERS / 32) {
      float* row = tile + r * ldt;
      for (int i = 0; i < L; ++i) {
        float best = __int_as_float(0xff800000);   // -inf
        int bi = 0x7fffffff;
        for (int t = lane; t < W2; t += 32) {       // ascending: first max
          if (row[t] > best) { best = row[t]; bi = t; }
        }
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (before(ov, oi, best, bi)) { best = ov; bi = oi; }
        }
        if (lane == 0) {
          emit(r, i, best, ts0 + bi);
          row[bi] = NEG;
        }
        __syncwarp();
      }
    }
  }
  STAMP(4);
  if (nsplit == 1) return;

  // -- merge the cluster's lists of each query row --------------------------
  // This CTA writes the rows r = split (mod nsplit): first (NEG, 0) in all
  // kk places, then every real candidate of the cluster's lists at its
  // rank, the number of candidates before it in all lists (each list is in
  // round order, so a binary search counts them).
  const int nrows = qv > split ? (qv - split + nsplit - 1) / nsplit : 0;
  for (int x = tid; x < nrows * kk; x += CONSUMERS) {
    const int r = split + nsplit * (x / kk);
    const size_t o = ((size_t)nb * B + q0 + r) * kk + x % kk;
    out_s[o] = NEG;
    out_t[o] = 0;
  }
  cluster_sync();                         // every list is written
  consumers_sync();                       // the (NEG, 0) places are written
  const uint32_t ls_a = smem_u32(ls), lt_a = smem_u32(lt);
  for (int x = tid; x < nrows * nsplit * L; x += CONSUMERS) {
    const int p = x % L, l = (x / L) % nsplit;
    const int r = split + nsplit * (x / (L * nsplit));
    const uint32_t at = r * L + p;
    const float v = ld_cluster_f32(cluster_addr(ls_a + at * 4, l));
    if (!(v > NEG)) continue;             // an exhausted place
    const int t = ld_cluster_u16(cluster_addr(lt_a + at * 2, l));
    int rank = p;
    for (int m = 0; m < nsplit && rank < kk; ++m) {
      if (m == l) continue;
      const uint32_t ms = cluster_addr(ls_a + r * L * 4, m);
      const uint32_t mt = cluster_addr(lt_a + r * L * 2, m);
      int lo = 0, hi = L;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(ld_cluster_f32(ms + 4 * mid),
                   ld_cluster_u16(mt + 2 * mid), v, t)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rank += lo;
    }
    if (rank < kk) {
      const size_t o = ((size_t)nb * B + q0 + r) * kk + rank;
      out_s[o] = v;
      out_t[o] = t;
    }
  }
  cluster_sync();                         // no CTA leaves while read
}

// -- f32 kernel: CUDA cores --------------------------------------------------

constexpr int THREADS = 256;              // 8 warps
constexpr int NWARP = THREADS / 32;

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

// -- bf16 launch -------------------------------------------------------------

template <int NT, bool CARRIED>
int launch_bf16(const CUtensorMap* maps, const void* cst, const void* valid,
                void* out_s, void* out_t, int B, int NB, int M, int Dp,
                int TS, int kk, cudaStream_t stream) {
  const int L = kk < 2 * NT ? kk : 2 * NT;
  int stages = 2;
  while (stages < MAX_STAGES &&
         Layout(Dp, NT, stages + 1, L).total <= SMEM_LIMIT) {
    ++stages;
  }
  const int smem = Layout(Dp, NT, stages, L).total;
  auto kernel = blocked_bf16_kernel<NT, CARRIED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nsplit = (TS + 2 * NT - 1) / (2 * NT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, (B + TQ - 1) / TQ, NB);
  cfg.blockDim = dim3(BF16_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3],
                         maps[4],
                         reinterpret_cast<const float*>(cst),
                         reinterpret_cast<const uint8_t*>(valid),
                         reinterpret_cast<float*>(out_s),
                         reinterpret_cast<int*>(out_t), B, M, Dp, TS, kk,
                         stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes: q, q2 (B, D); ivt, movt (NB, M, D); cst (NB, M) f32; W (NB, M, TS);
// valid (NB, TS) bool; out_s/out_t (NB, B, kk).  The caller guarantees
// M % 16 == 0, TS % 16 == 0, TS <= 1024, 1 <= kk <= TS, NB <= 65535, and
// for bf16 D % 8 == 0.
extern "C" int blocked_topk_bf16(const void* q, const void* q2,
                                 const void* ivt, const void* movt,
                                 const void* cst, const void* W,
                                 const void* valid, void* out_s, void* out_t,
                                 int B, int NB, int M, int D, int TS, int kk,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || TS > 1024) return (int)cudaErrorInvalidValue;
  const int Dp = (D + BOXC - 1) / BOXC * BOXC;
  CUtensorMap maps[5];
  const cuuint64_t dq[2] = {(cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t dn[3] = {(cuuint64_t)D, (cuuint64_t)M, (cuuint64_t)NB};
  const cuuint64_t dw[3] = {(cuuint64_t)TS, (cuuint64_t)M, (cuuint64_t)NB};
  if (!tensor_map(&maps[0], q, 2, dq, TQ) ||
      !tensor_map(&maps[1], q2, 2, dq, TQ) ||
      !tensor_map(&maps[2], movt, 3, dn, MC) ||
      !tensor_map(&maps[3], ivt, 3, dn, MC) ||
      !tensor_map(&maps[4], W, 3, dw, MC)) {
    return (int)cudaErrorInvalidValue;
  }
  // The widest slice that covers TS (two warpgroups of NT slots each),
  // narrowed while shared memory does not fit.
  int nt = 64;
  while (nt < 256 && 2 * nt < TS) nt *= 2;
  auto smem = [&](int n) {
    return Layout(Dp, n, 2, kk < 2 * n ? kk : 2 * n).total;
  };
  while (nt > 64 && smem(nt) > SMEM_LIMIT) nt /= 2;
  if (smem(nt) > SMEM_LIMIT ||
      (TS + 2 * nt - 1) / (2 * nt) > MAX_SPLIT) {
    return (int)cudaErrorInvalidValue;
  }
  if (2 * Dp / BOXC > RESIDENT_BOXES) {
    if (nt == 256) {
      return launch_bf16<256, true>(maps, cst, valid, out_s, out_t, B, NB, M,
                                    Dp, TS, kk, s);
    }
    if (nt == 128) {
      return launch_bf16<128, true>(maps, cst, valid, out_s, out_t, B, NB, M,
                                    Dp, TS, kk, s);
    }
    return launch_bf16<64, true>(maps, cst, valid, out_s, out_t, B, NB, M,
                                 Dp, TS, kk, s);
  }
  if (nt == 256) {
    return launch_bf16<256, false>(maps, cst, valid, out_s, out_t, B, NB, M,
                                   Dp, TS, kk, s);
  }
  if (nt == 128) {
    return launch_bf16<128, false>(maps, cst, valid, out_s, out_t, B, NB, M,
                                   Dp, TS, kk, s);
  }
  return launch_bf16<64, false>(maps, cst, valid, out_s, out_t, B, NB, M, Dp,
                                TS, kk, s);
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

#ifdef BLOCKED_PHASES
extern "C" int read_stamps(void* host, unsigned long long* full) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (e == cudaSuccess) {
    e = cudaMemcpyFromSymbol(full, g_full_rows, sizeof(*full));
  }
  return (int)e;
}

extern "C" int clear_stamps() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_stamps);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_stamps));
  const unsigned long long zero = 0;
  if (e == cudaSuccess) {
    e = cudaMemcpyToSymbol(g_full_rows, &zero, sizeof(zero));
  }
  return (int)e;
}
#endif
