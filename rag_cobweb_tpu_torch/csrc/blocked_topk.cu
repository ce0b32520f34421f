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
// full f32 (fmaf) in register-tiled products, below.

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

// -- f32 kernel: register-tiled SGEMMs on the CUDA cores ---------------------
//
// The same TPU kernels on an f32 index: _kernel at Precision.HIGHEST
// (pallas_query.py:59-71), whose products are full f32, and so are these
// (fmaf on the CUDA cores: TF32 on wgmma keeps ~3 decimal digits, too few
// for the single tree's sums of large cancelling terms).  What bounds it
// on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"): 2 B NB M (2D + TS)
// operations at the 67 TFLOP/s f32 peak, or the 4 NB M (2D + TS + 1)
// bytes of the index at 3.35 TB/s.  On the single tree's f32 index (NB =
// 20, M = 768, D = 248, TS = 512) the operations bound it at B = 1000
// (0.46 ms), the bytes at B <= 32 (61 MB, 0.018 ms).
//
// The design is the register-tiled SGEMM, twice.  One CTA (256 threads,
// 8 warps) owns TQ queries (8, 16, 32 or 64, the least that holds the
// batch), one sentence block and a range of M.  M streams in chunks of
// MC = 64 nodes, each as items of a ring of 6 equal stages (32 KB) that
// one thread fills by TMA, five items ahead, each stage on its own
// mbarrier (zero fill past B, M, D and TS):
//   * the chunk's D slices, 32 columns of the query tile's q and q^2 rows
//     and the chunk's movt and ivt rows, in 128-byte rows swizzled by TMA,
//     so that the 8 rows a warp's 16-byte load reads fall in distinct
//     banks.  GEMM1: each thread holds a (TQ/16) x 4 tile (1 x 2 at TQ =
//     8) of both products, q . movt and q^2 . ivt, in registers; after the
//     chunk's last slice it writes nlp = (a - 0.5 b) + const, transposed
//     (a node a row), to a 64 x TQ tile;
//   * the chunk's W rows, 16 at a time (8 at TS > 512), in boxes of 256
//     slots.  GEMM2: each thread keeps a (TQ/8) x 16 tile (x 32 at TS >
//     512) of the TQ x TS scores in registers across all of M (128 floats
//     at TQ = 64) and takes outer products of nlp rows and W rows.
// A warp covers 4 query groups x 8 node (slot) groups, so each of its
// 16-byte loads of a stage reads 128 distinct bytes at most: one
// wavefront.  Then the scores go to shared memory over the ring.  Where
// query tiles x blocks leave SMs idle (B <= 32 on the served index: 20
// CTAs for 132 SMs) the CTAs of a cluster split M and each keeps the
// partial scores of its chunks.  The launcher takes the split whose waves
// of clusters (cudaOccupancyMaxActiveClusters) cost least: on the served
// index 2 at B = 1000 (5 waves of half CTAs against 3 waves of whole
// ones), 4 at B <= 32 (20 clusters of 6 do not fit the card's GPCs at
// once).  Each CTA of a cluster then owns every ns-th query row: it sums
// that row of the partial tiles in rank order through distributed shared
// memory and selects it.  The selection runs kk rounds of max/argmax in
// registers, a warp on 4 rows at once (a lane holds 16 slots: a max tree,
// its lowest slot, then 5 shuffles), one row a warp where a CTA selects
// no more rows than it has warps.  At B <= 32 a tile of 8 to 32 queries
// computes mostly padding, and its small register tiles leave the FMA
// pipes waiting on shared-memory latency.  D must be a multiple of 4 and
// q, q2, ivt, movt and W 16-byte aligned (TMA's strides; the wrapper pads
// and copies where they are not).

constexpr int THREADS = 256;              // 8 warps
constexpr int NWARP = THREADS / 32;
constexpr int FDC = 32;                   // columns of a D slice (128 B)
constexpr int WBOX = 256;                 // W columns of a TMA box
constexpr int MAX_STAGES_F32 = 6;         // ring stages (items ahead + 1)
constexpr int MAX_DEVICES = 16;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

// GEMM1 runs on a QG1 x NG1 grid of R1 x RN tiles (queries g1q + QG1 i,
// nodes g1n + NG1 j), GEMM2 on an 8 x 32 grid of (TQ/8) x 4 NV tiles.
template <int TQ, int NV>
struct F32Tile {
  static constexpr int QG1 = TQ < 16 ? TQ : 16, NG1 = THREADS / QG1;
  static constexpr int R1 = TQ / QG1, RN = MC / NG1;
  static constexpr int TSP = 128 * NV;            // slots held (TS padded)
  static constexpr int KW = NV <= 4 ? 16 : 8;     // W rows an item
  static constexpr int NWI = MC / KW;             // W items a chunk
  static constexpr int AROWS = 2 * TQ + 2 * MC;   // q, q^2, movt, ivt
  static constexpr int AF = AROWS * FDC;          // floats of a D slice
  static constexpr int WF = KW * TSP;             // floats of a W item
  static constexpr int LDN = TQ + 4;              // nlp tile: a node a row
  static constexpr int NLP = MC * LDN;
  static constexpr int STAGE = AF > WF ? AF : WF; // floats a ring stage
  static constexpr int FIT = (SMEM_LIMIT / 4 - NLP - 2 * MAX_STAGES_F32) /
                             STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES_F32 ? FIT : MAX_STAGES_F32;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = (RING + NLP) * 4 + STAGES * 8;  // + mbarriers
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static_assert(TQ * TSP <= RING, "the score tile lies over the ring");
  static_assert(STAGE % 256 == 0 && TQ * FDC % 256 == 0,
                "boxes of swizzled rows start 1024-byte aligned");
};

// The rows of the score tile (``ld`` floats apart) that this CTA selects,
// rank, rank + ns, ... below qv: kk rounds of max/argmax in registers, a
// warp on RR rows at once (lane l holds slots l + 32 m).  Invalid slots
// are NEG; ties go to the lower slot; a taken slot becomes NEG, so once
// every slot is NEG a round gives NEG at slot 0, as JAX's argmax does.
template <int NPL, int RR>
__device__ __forceinline__ void select_topk(const float* sc, int ld,
                                            const uint8_t* vb,
                                            float* __restrict__ out_s,
                                            int* __restrict__ out_t, int B,
                                            int q0, int qv, int nb, int TS,
                                            int kk, int rank, int ns) {
  constexpr int LOG_NPL = NPL == 32 ? 5 : 4;
  static_assert(NPL == 1 << LOG_NPL, "16 or 32 slots a lane");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrows = qv > rank ? (qv - rank + ns - 1) / ns : 0;
  const float ninf = __int_as_float(0xff800000);
  for (int j0 = warp * RR; j0 < nrows; j0 += NWARP * RR) {
    float v[RR][NPL];
    int row[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      row[r] = j0 + r < nrows ? rank + ns * (j0 + r) : -1;
    }
#pragma unroll
    for (int m = 0; m < NPL; ++m) {
      const int t = lane + 32 * m;
      const bool in = t < TS, ok = in && vb[t];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        v[r][m] = !in ? ninf : ok && row[r] >= 0 ? sc[row[r] * ld + t] : NEG;
      }
    }
    for (int i = 0; i < kk; ++i) {
      float best[RR];
      int bi[RR];
#pragma unroll
      for (int r = 0; r < RR; ++r) {              // each lane's first max
        float x[NPL];
#pragma unroll
        for (int m = 0; m < NPL; ++m) x[m] = v[r][m];
#pragma unroll
        for (int l = 1; l <= LOG_NPL; ++l) {      // the max, by a tree
#pragma unroll
          for (int m = 0; m < NPL / 2; ++m) {
            if (m < (NPL >> l)) x[m] = fmaxf(x[m], x[m + (NPL >> l)]);
          }
        }
        int bm = 0;
#pragma unroll
        for (int m = NPL - 1; m >= 0; --m) {      // its lowest slot
          if (v[r][m] == x[0]) bm = m;
        }
        best[r] = x[0];
        bi[r] = x[0] > ninf ? lane + 32 * bm : 0x7fffffff;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {        // the warp's, every row
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const float ov = __shfl_xor_sync(0xffffffffu, best[r], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[r], off);
          if (ov > best[r] || (ov == best[r] && oi < bi[r])) {
            best[r] = ov;
            bi[r] = oi;
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          if (row[r] < 0) continue;
          const size_t o = ((size_t)nb * B + q0 + row[r]) * kk + i;
          out_s[o] = best[r];
          out_t[o] = bi[r];
        }
      }
#pragma unroll
      for (int r = 0; r < RR; ++r) {              // the taken slot: NEG
#pragma unroll
        for (int m = 0; m < NPL; ++m) {
          if (bi[r] == lane + 32 * m) v[r][m] = NEG;
        }
      }
    }
  }
}

// GEMM1 over one D slice: fa += q . movt, fb += q^2 . ivt for this
// thread's queries g1q + QG1 i and nodes g1n + NG1 j, in ascending d.  Rows
// are 128 bytes, their 16-byte chunks swizzled by TMA (chunk c of row r at
// c ^ (r % 8)), so the eight rows of a warp's load fall in distinct banks.
template <int TQ, int QG1, int R1, int RN>
__device__ __forceinline__ void gemm1_slice(const float* st,
                                            float (&fa)[R1][RN],
                                            float (&fb)[R1][RN],
                                            int g1q, int g1n) {
  constexpr int NG1 = MC / RN;
  const float* sq = st + g1q * FDC;
  const float* sn = st + (2 * TQ + g1n) * FDC;
  const int zq = g1q & 7, zn = g1n & 7;
#pragma unroll
  for (int k = 0; k < FDC / 4; ++k) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {               // q . movt, q^2 . ivt
      float (&f)[R1][RN] = p ? fb : fa;
      float4 x[R1];
#pragma unroll
      for (int i = 0; i < R1; ++i) {
        x[i] = ld4(sq + (p * TQ + QG1 * i) * FDC + 4 * (k ^ zq));
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {            // a node row at a time
        const float4 y = ld4(sn + (p * MC + NG1 * j) * FDC + 4 * (k ^ zn));
#pragma unroll
        for (int i = 0; i < R1; ++i) {
          f[i][j] = fmaf(x[i].x, y.x, f[i][j]);
          f[i][j] = fmaf(x[i].y, y.y, f[i][j]);
          f[i][j] = fmaf(x[i].z, y.z, f[i][j]);
          f[i][j] = fmaf(x[i].w, y.w, f[i][j]);
        }
      }
    }
  }
}

// GEMM2 over one W item: acc += nlp rows . W rows, for this thread's
// queries (``nl`` points at its first in the item's first nlp row) and
// slots g2s + 128 v (``w`` points at slot g2s of the item's first row; the
// item holds boxes of KW rows x 256 slots).
template <int TQ, int NV>
__device__ __forceinline__ void gemm2_rows(const float* nl, const float* w,
                                           float (&acc)[TQ / 8][NV][4]) {
  using L = F32Tile<TQ, NV>;
  constexpr int R2 = TQ / 8;
#pragma unroll
  for (int k = 0; k < L::KW; ++k) {
    float a[R2];
    if constexpr (R2 >= 4) {
#pragma unroll
      for (int i = 0; i < R2; i += 4) {
        const float4 t = ld4(nl + k * L::LDN + i);
        a[i] = t.x; a[i + 1] = t.y; a[i + 2] = t.z; a[i + 3] = t.w;
      }
    } else if constexpr (R2 == 2) {
      const float2 t = *reinterpret_cast<const float2*>(nl + k * L::LDN);
      a[0] = t.x; a[1] = t.y;
    } else {
      a[0] = nl[k * L::LDN];
    }
    float4 b[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      b[v] = ld4(w + (v >> 1) * L::KW * WBOX + k * WBOX + (v & 1) * 128);
    }
#pragma unroll
    for (int i = 0; i < R2; ++i) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        acc[i][v][0] = fmaf(a[i], b[v].x, acc[i][v][0]);
        acc[i][v][1] = fmaf(a[i], b[v].y, acc[i][v][1]);
        acc[i][v][2] = fmaf(a[i], b[v].z, acc[i][v][2]);
        acc[i][v][3] = fmaf(a[i], b[v].w, acc[i][v][3]);
      }
    }
  }
}

// Grid (split, query tiles, blocks), the split a cluster along M.
template <int TQ, int NV>
__global__ void __launch_bounds__(THREADS, 1)
blocked_f32_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tq2,
                   const __grid_constant__ CUtensorMap tmv,
                   const __grid_constant__ CUtensorMap tiv,
                   const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ cst,
                   const uint8_t* __restrict__ valid,
                   float* __restrict__ out_s, int* __restrict__ out_t,
                   int B, int M, int D, int TS, int kk) {
  using L = F32Tile<TQ, NV>;
  constexpr int R1 = L::R1, RN = L::RN, QG1 = L::QG1, R2 = TQ / 8;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(1024) float fsm[];
  float* nlp = fsm + L::RING;                     // [MC][LDN]
  const uint32_t bars = smem_u32(nlp + L::NLP);   // a full barrier a stage
  const int tid = threadIdx.x;
  const int rank = blockIdx.x, ns = gridDim.x;
  const int q0 = blockIdx.y * TQ, nb = blockIdx.z;
  const int qv = min(TQ, B - q0);
  const int nch = (M + MC - 1) / MC, cpr = (nch + ns - 1) / ns;
  const int c0 = min(nch, rank * cpr), c1 = min(nch, c0 + cpr);
  const int ND = (D + FDC - 1) / FDC;             // D slices a chunk
  const int per = ND + L::NWI;                    // items a chunk
  const int N = (c1 - c0) * per;

  // Item i of this CTA, by TMA into ring stage i % S (thread 0): chunk
  // c0 + i / per; its first ND items are the D slices, the rest its W rows.
  auto issue = [&](int i) {
    const int ci = i / per, r = i - ci * per;
    const int m0 = (c0 + ci) * MC;
    const uint32_t st = smem_u32(fsm + i % S * L::STAGE);
    const uint32_t bar = bars + 8 * (i % S);
    if (r < ND) {
      const int d0 = r * FDC;
      mbar_expect_tx(bar, L::AF * 4);
      tma_2d(st, &tq, d0, q0, bar);
      tma_2d(st + TQ * FDC * 4, &tq2, d0, q0, bar);
      tma_3d(st + 2 * TQ * FDC * 4, &tmv, d0, m0, nb, bar);
      tma_3d(st + (2 * TQ + MC) * FDC * 4, &tiv, d0, m0, nb, bar);
    } else {
      const int k0 = m0 + (r - ND) * L::KW;
      mbar_expect_tx(bar, L::WF * 4);
#pragma unroll
      for (int x = 0; x < L::TSP / WBOX; ++x) {
        tma_3d(st + x * L::KW * WBOX * 4, &tw, x * WBOX, k0, nb, bar);
      }
    }
  };

  // A warp covers 4 query groups x 8 node (slot) groups, so each of its
  // 16-byte loads reads at most 128 distinct bytes: one wavefront.
  const int warp = tid >> 5, lane = tid & 31;
  const int g1q = (lane >> 3) + 4 * (warp % (QG1 / 4));  // GEMM1: QG1
  const int g1n = (lane & 7) + 8 * (warp / (QG1 / 4));   //   x NG1
  const int g2q = ((lane >> 3) + 4 * (warp & 1)) * R2;  // GEMM2: 8 query
  const int g2s = 4 * ((lane & 7) + 8 * (warp >> 1));   //   x 32 slot groups
  float acc[R2][NV][4];
#pragma unroll
  for (int i = 0; i < R2; ++i) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][v][x] = 0.f;
    }
  }

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < S - 1 && i < N; ++i) issue(i);   // S - 1 ahead
  }
  __syncthreads();
  // Item i: wait for it, then (every thread being done with item i - 1)
  // thread 0 loads item i + S - 1 into item i - 1's stage.
  auto next = [&](int i) {
    mbar_wait(bars + 8 * (i % S), (i / S) & 1);
    __syncthreads();
    if (tid == 0 && i + S - 1 < N) {
      fence_async_smem();
      issue(i + S - 1);
    }
    return fsm + i % S * L::STAGE;
  };
  for (int i = 0, m0 = c0 * MC; i < N; m0 += MC) {
    float fa[R1][RN], fb[R1][RN];                 // GEMM1: this chunk only
#pragma unroll
    for (int x = 0; x < R1; ++x) {
#pragma unroll
      for (int j = 0; j < RN; ++j) fa[x][j] = fb[x][j] = 0.f;
    }
    for (int r = 0; r < ND; ++r, ++i) {
      gemm1_slice<TQ, QG1, R1, RN>(next(i), fa, fb, g1q, g1n);
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {                // the chunk's nlp tile
      const int n = g1n + L::NG1 * j;
      const bool ok = m0 + n < M;
      const float cv = ok ? cst[(size_t)nb * M + m0 + n] : 0.f;
#pragma unroll
      for (int x = 0; x < R1; ++x) {
        nlp[n * L::LDN + g1q + QG1 * x] =
            ok ? (fa[x][j] - 0.5f * fb[x][j]) + cv : 0.f;
      }
    }
    for (int r = 0; r < L::NWI; ++r, ++i) {
      const float* st = next(i);                  // also orders the nlp tile
      gemm2_rows<TQ, NV>(nlp + r * L::KW * L::LDN + g2q, st + g2s, acc);
    }
  }
  __syncthreads();                                // the ring is free

  float* sc = fsm;                                // [TQ][TSP] scores
#pragma unroll
  for (int i = 0; i < R2; ++i) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      *reinterpret_cast<float4*>(sc + (g2q + i) * L::TSP + g2s + 128 * v) =
          make_float4(acc[i][v][0], acc[i][v][1], acc[i][v][2],
                      acc[i][v][3]);
    }
  }
  __syncthreads();
  if (ns > 1) {
    // Each CTA sums, in rank order, the partial tiles' rows that it
    // selects (rank, rank + ns, ...) into its own tile.
    cluster_sync();
    const int nrows = qv > rank ? (qv - rank + ns - 1) / ns : 0;
    const uint32_t base = smem_u32(sc);
    for (int e = tid; e < nrows * L::TSP / 4; e += THREADS) {
      const int j = e / (L::TSP / 4), c = 4 * (e % (L::TSP / 4));
      float* dst = sc + (rank + ns * j) * L::TSP + c;
      const uint32_t a = base + 4 * (uint32_t)(dst - sc);
      float4 s = ld_cluster_f32x4(cluster_addr(a, 0));
      for (int p = 1; p < ns; ++p) {
        const float4 o = ld_cluster_f32x4(cluster_addr(a, p));
        s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
      }
      *reinterpret_cast<float4*>(dst) = s;
    }
    __syncthreads();
  }
  // a warp on 4 rows at once (2 at TS > 512) where this CTA selects more
  // rows than it has warps, else on one
  if (qv > rank && (qv - rank + ns - 1) / ns > NWARP) {
    select_topk<L::TSP / 32, NV <= 4 ? 4 : 2>(
        sc, L::TSP, valid + (size_t)nb * TS, out_s, out_t, B, q0, qv, nb,
        TS, kk, rank, ns);
  } else {
    select_topk<L::TSP / 32, 1>(sc, L::TSP, valid + (size_t)nb * TS, out_s,
                                out_t, B, q0, qv, nb, TS, kk, rank, ns);
  }
  if (ns > 1) cluster_sync();           // no CTA leaves while others read
}

template <int TQ, int NV>
int launch_f32(const void* q, const void* q2, const void* ivt,
               const void* movt, const void* cst, const void* W,
               const void* valid, void* out_s, void* out_t, int B, int NB,
               int M, int D, int TS, int kk, cudaStream_t stream) {
  using L = F32Tile<TQ, NV>;
  auto kernel = blocked_f32_kernel<TQ, NV>;
  CUtensorMap maps[5];
  const cuuint64_t dq[2] = {(cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t dn[3] = {(cuuint64_t)D, (cuuint64_t)M, (cuuint64_t)NB};
  const cuuint64_t dw[3] = {(cuuint64_t)TS, (cuuint64_t)M, (cuuint64_t)NB};
  if (!tensor_map_f32(&maps[0], q, 2, dq, FDC, TQ, true) ||
      !tensor_map_f32(&maps[1], q2, 2, dq, FDC, TQ, true) ||
      !tensor_map_f32(&maps[2], movt, 3, dn, FDC, MC, true) ||
      !tensor_map_f32(&maps[3], ivt, 3, dn, FDC, MC, true) ||
      !tensor_map_f32(&maps[4], W, 3, dw, WBOX, L::KW, false)) {
    return (int)cudaErrorInvalidValue;
  }
  // clusters of each size resident at once, by device (0: not asked yet)
  static int active[MAX_DEVICES][MAX_SPLIT + 1] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active[dev][1] == 0) {
    for (int n = 1; n <= MAX_SPLIT; ++n) {
      cfg.gridDim = dim3(n);
      attr[0].val.clusterDim.x = n;
      int a = 0;
      e = cudaOccupancyMaxActiveClusters(&a, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      active[dev][n] = a > 0 ? a : -1;
    }
    if (active[dev][1] < 0) return (int)cudaErrorInvalidConfiguration;
  }
  // The split of M whose waves of clusters cost least, in chunks a CTA
  // (a split's sum of the partial tiles counted as a quarter chunk); no
  // rank without a chunk.
  const int tiles = (B + TQ - 1) / TQ, items = tiles * NB;
  const int nch = (M + MC - 1) / MC;
  int ns = 1;
  double best = (double)((items + active[dev][1] - 1) / active[dev][1]) *
                nch;
  for (int n = 2; n <= MAX_SPLIT && n <= nch; ++n) {
    const int cpr = (nch + n - 1) / n, a = active[dev][n];
    if ((nch + cpr - 1) / cpr != n || a <= 0) continue;
    const double cost = (double)((items + a - 1) / a) * (cpr + 0.25);
    if (cost < best) {
      best = cost;
      ns = n;
    }
  }
  cfg.gridDim = dim3(ns, tiles, NB);
  attr[0].val.clusterDim.x = ns;
  e = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3],
                         maps[4], reinterpret_cast<const float*>(cst),
                         reinterpret_cast<const uint8_t*>(valid),
                         reinterpret_cast<float*>(out_s),
                         reinterpret_cast<int*>(out_t), B, M, D, TS, kk);
  if (e != cudaSuccess) return (int)e;
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
// for bf16 D % 8 == 0; for f32 D % 4 == 0 and q, q2, ivt, movt and W
// 16-byte aligned (else the entry returns cudaErrorInvalidValue).
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
  const uintptr_t rows = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(q2) |
                         reinterpret_cast<uintptr_t>(ivt) |
                         reinterpret_cast<uintptr_t>(movt) |
                         reinterpret_cast<uintptr_t>(W);
  if (D % 4 != 0 || TS > 1024 || (rows & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (TS <= 512) {
    if (B <= 8) {
      return launch_f32<8, 4>(q, q2, ivt, movt, cst, W, valid, out_s, out_t,
                              B, NB, M, D, TS, kk, s);
    }
    if (B <= 16) {
      return launch_f32<16, 4>(q, q2, ivt, movt, cst, W, valid, out_s,
                               out_t, B, NB, M, D, TS, kk, s);
    }
    if (B <= 32) {
      return launch_f32<32, 4>(q, q2, ivt, movt, cst, W, valid, out_s,
                               out_t, B, NB, M, D, TS, kk, s);
    }
    return launch_f32<64, 4>(q, q2, ivt, movt, cst, W, valid, out_s, out_t,
                             B, NB, M, D, TS, kk, s);
  }
  if (B <= 8) {
    return launch_f32<8, 8>(q, q2, ivt, movt, cst, W, valid, out_s, out_t, B,
                            NB, M, D, TS, kk, s);
  }
  if (B <= 16) {
    return launch_f32<16, 8>(q, q2, ivt, movt, cst, W, valid, out_s, out_t,
                             B, NB, M, D, TS, kk, s);
  }
  return launch_f32<32, 8>(q, q2, ivt, movt, cst, W, valid, out_s, out_t, B,
                           NB, M, D, TS, kk, s);
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
