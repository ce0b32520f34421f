// Fused path-score sweep with a per-slab top-kappa pool (kernel 1), its
// pruned pool at scale (kernel 1's second design, below), and with a
// per-group max/argmax pool (kernel 2).
//
// Kernel 1 replaces rag_cobweb_tpu/ops/pallas_query.py::_fused_kernel (the
// Pallas kernel behind pallas_fused_topk).  For every 2048-row slab s and
// query b:
//   scores[b, t] = sum_d qq[b, d] * GT[d, t] + c[t]   (invalid rows: -inf)
// and the slab's top-kappa (score, global row id), ties to the lower id,
// in no particular order (the caller's merge takes a top-k over them).
// The (B, Sp) score matrix never reaches device memory: it lives in shared
// memory, a (slab, query tile) at a time.
//
// Kernel 2 replaces _fused_group_kernel (behind pallas_fused_group_topk):
// the same sweep, invalid rows NEG = -3e38 as in the TPU kernel, then for
// each 128-row group ``per_group`` rounds of max/argmax (ties to the lower
// row, the taken row set to NEG; once every row is NEG a round returns NEG
// at the group's lowest row, as JAX's argmax does).  Column i * 16 + g of
// the (NS, B, per_group * 16) output holds round i of group g, with the
// global row slab * 2048 + g * 128 + argmax.
//
// What bounds them on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"): at the
// c=10k main path (2D = 496, Sp = 10240) the sweep is 2 B 2D Sp operations
// (10.4 GFLOP at B = 1024, 11 us at 989 TFLOP/s bf16) on a 10 MB GT; kernel
// 1's pool (kappa = 1024) is NS B kappa (score, id) pairs (42 MB at B =
// 1024, 12.5 us at 3.35 TB/s): bytes bound it, 16 us at B = 1024 and 3 us
// at B <= 32 (GT alone).  Kernel 2's pool is per_group * 16 pairs a slab
// and query, so operations bound it at B = 1024 (11 us).
//
// At 1M rows the served pool is kappa = c = 512 over NS = 512 slabs (the
// MS MARCO batch cell: B = 1024, 2D = 256 for the path scores and 128 for
// the backstop's whitened store).  One sweep is then 0.55 and 0.28 TFLOP
// (0.56 and 0.28 ms at the bf16 peak) on 0.5 and 0.3 GB of GT, so
// operations bound the function; but the per-slab pools keep a quarter of
// the score matrix, NS B kappa = 268M (score, id) pairs (2.1 GB a pool),
// and the cluster select that takes them costs 3 passes of two cluster
// barriers and a histogram an item: 18.3 ms a pool, 1.9% of the bound,
// and their merge 5 ms more.  The pruned path (below) writes none of it:
// two sweeps and 1.06-1.36 c survivors a query over the path-score index
// (1.00-1.04 c over the store; measured on the cell's rows, a buffer of 4
// c), 3.1 and 2.4 ms a pool (random rows of the cell's shapes).
//
// What the bf16 design does (slab_topk_wgmma, group_topk_wgmma):
//   * an item is 64 queries (one wgmma M) x 256 columns of one slab; a CTA
//     is persistent and walks its items in turn, so the loads of the next
//     item overlap the epilogue of this one;
//   * a producer thread streams each 64-row chunk of the item by TMA into
//     a ring of mbarrier stages: the query box (64 queries x 64 depths;
//     qq's rows are padded to 16-byte multiples) and four 128-byte
//     swizzled GT boxes of the item's 256 columns (zero fill past 2D and B:
//     ragged shapes need no staging).  GT is (2D, Sp) row-major, so a chunk
//     is wgmma's B operand MN-major;
//   * two consumer warpgroups each run m64n128k16 wgmma over 128 columns,
//     one chunk's group in flight while the next is issued;
//   * kernel 2: a warpgroup's 128 columns are one group, so the group pool
//     is taken from the accumulators in registers: a quad of lanes holds
//     one query's 128 columns (32 each, column 8j + 2cq + e), a round is a
//     32-register max, two shuffles across the quad (ties to the lower
//     column) and a compare-and-select that masks the taken column; no
//     score tile, no exchange between CTAs.  The ring takes the rest of
//     shared memory (5 stages);
//   * kernel 1: the 8 CTAs of a slab form a cluster, and the clusters that
//     fit the card (cudaOccupancyMaxActiveClusters) walk the (slab, query
//     tile) items in the same order on all 8 CTAs.  The scores (+ c,
//     invalid rows -inf) go to a score tile beside the 2-stage ring, so the
//     producer loads the next item's first chunks while the CTA selects
//     this one.  An exact radix select on order-preserving 32-bit keys runs
//     over the cluster, a pass splitting each query's window of keys (at
//     first all 2^32) into 256 bins: every CTA counts the bins of its
//     columns for its 64 queries (16-bit counts, one thread a query, 4 keys
//     a 16-byte load), pushes each query's counts by 16-byte stores into
//     the inbox of the CTA that owns it (query q: CTA q % 8), and the owner
//     sums them (clearing the inbox as it reads, so it is empty for the
//     next pass and item), picks the bin of the kappa-th key and pushes the
//     decision to every CTA.  Pulling the counts instead (4-byte loads of
//     distributed shared memory) took 4x longer.  A query's select stops
//     once its bin is taken whole or holds one key (3 passes on random
//     scores), and the item's on the same pass in every CTA, since all read
//     the same decisions.  A pass costs two cluster barriers and a
//     histogram, so an item of the same query tile as the cluster's last
//     one (B <= 64) starts from a guessed window of 2^24 keys around each
//     query's last kappa-th key (a query's slabs give it scores of one
//     scale; on the 100k cell's index a window spans +-256 around scores
//     of -350): its first pass also counts the keys above the window, and
//     the owner checks that the kappa-th key is in it (2 passes where it
//     is; else the query starts over, one pass more);
//   * kernel 1's tie rule across CTAs: the owner also keeps each CTA's
//     count of keys above the kappa-th key T and in its bin, and hands each
//     CTA its offsets: the keys above T of the CTAs to its left, and their
//     keys equal to T.  A CTA writes its keys above T there and its keys
//     equal to T in row order after all keys above T, up to the count to
//     take: the lowest-id rows equal to T, with no exchange after the last
//     pass.
// The f32 entries (an exact f32 index, the TPU kernels at
// Precision.HIGHEST) keep full f32 FMAs on the CUDA cores, in ascending
// depth, no TF32.  What bounds them on the single tree's f32 index (2D =
// 496, Sp = 10240, 20.3 MB): the bytes at B <= 32 (6.1 us at 3.35 TB/s),
// the operations at B = 1000 (10.2 GFLOP, 0.152 ms at 67 TFLOP/s).  Both
// run one sweep (f32_tile, below): a CTA a 256-column block of a slab and
// a query tile, a register-tiled SGEMM fed by TMA through an mbarrier
// ring, the depth split over thread groups at small query tiles so that
// few queries still keep 8 x 8 register tiles (a shared-memory load must
// feed 16 FMAs to keep pace with the FMA pipes), the scores left in a
// tile of shared memory.  Kernel 1's (slab_topk_f32) CTAs form the bf16
// kernel's 8-CTA clusters a slab: kappa <= 32 by rounds in registers and
// a merge across the cluster, larger kappa by the cluster radix select.
// Kernel 2's (group_topk_f32) CTAs form no cluster, since a 256-column
// block is two whole groups: a warp takes a (query, group) pair and runs
// its rounds on keys in registers, the taken row's key set to NEG's.

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr int SLAB = 2048;                   // rows per slab (= row bucket)
constexpr int BINS = 256;                    // radix digit: 8 bits
constexpr int GROUP = 128;                   // rows per group (group pool)
constexpr int NG = SLAB / GROUP;             // groups per slab
constexpr float NEG = -3e38f;                // the TPU kernels' mask value

// Order-preserving key: a larger score gives a larger key, and -0 == +0
// (they compare equal as floats, so they must tie here too).
__device__ __forceinline__ unsigned int score_key(float x) {
  const unsigned int u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// -- bf16: wgmma on a TMA ring, persistent CTAs -------------------------------

constexpr int SPLIT = 8;                  // CTAs of a slab (kernel 1: cluster)
constexpr int NTC = SLAB / SPLIT;         // 256 slab columns an item
constexpr int WTQ = 64;                   // queries an item (wgmma M)
constexpr int KC = BOXC;                  // depth of a chunk = a query box
constexpr int WG = 128;                   // threads of a warpgroup
constexpr int W_CONSUMERS = 2 * WG;       // 128 columns each
constexpr int W_THREADS = W_CONSUMERS + WG;   // + the producer warpgroup
constexpr int QBOX = WTQ * ROWB;                  // a chunk's query box
constexpr int GBOXES = (NTC / BOXC) * KC * ROWB;  // its four GT boxes
constexpr int STAGE = QBOX + GBOXES;              // 40 KB, 1024-aligned
constexpr int LDS = NTC + 4;              // 16-byte rows, conflict-free
constexpr int HW = BINS / 2 + 1;          // histogram row: words, padded
constexpr int IW = BINS / 2 + 4;          // inbox row: counts, keys above
// kernel 1's score tile [WTQ][LDS] f32, histograms [WTQ][HW], decisions
// [WTQ] uint4 and keys above a guessed window [WTQ]; its inbox [SPLIT][WTQ
// / SPLIT][IW] words
constexpr int EPI = WTQ * LDS * 4 + WTQ * HW * 4 + WTQ * 16 + WTQ * 4;
constexpr int INBOX = WTQ * IW * 4;
// A decision (uint4): .x the first key of the window [.x, .x + 2^wb) that
// holds the kappa-th key T; .y the rows equal to T still to take in bits
// 0-15, whether the select of the query is done, whether its next pass
// checks a guessed window, and wb in bits 24-31; .z, .w the CTA's offsets
constexpr uint32_t DONE = 1u << 16, GUESS = 1u << 17;
constexpr int GUESS_BITS = 24;            // a guessed window: 2^24 keys
constexpr int TOPK_STAGES = 2;            // what fits beside EPI and INBOX

#ifdef FUSED_GUESS_STATS
// Guessed windows (a query's first pass of an item) that held the kappa-th
// key, and that missed it (bench/fused_guess.py reads them)
__device__ unsigned long long g_guess[2];
#endif

// Shared memory: the ring (``stages`` stages of STAGE bytes), then kernel
// 1's epilogue and inbox, then the mbarriers: ``stages`` full, ``stages``
// empty.
struct Layout {
  int stages, epi, inbox, bars, total;
  __host__ __device__ Layout(bool select, int s)
      : stages(s), epi(s * STAGE), inbox(epi + (select ? EPI : 0)),
        bars(inbox + (select ? INBOX : 0)),
        total(1024 + bars + 16 * s) {}      // 1024: alignment slack
};

// The ring's g-th chunk (counted over all items of the CTA, so the
// mbarrier parities carry from item to item): its stage and barriers.
struct Ring {
  uint32_t stage0, full0, empty0;
  int stages;
  __device__ Ring(uint32_t base, const Layout& lay)
      : stage0(base), full0(base + lay.bars),
        empty0(base + lay.bars + 8 * lay.stages), stages(lay.stages) {}
  __device__ uint32_t stage(uint32_t g) const {
    return stage0 + g % stages * STAGE;
  }
  __device__ uint32_t full(uint32_t g) const {
    return full0 + 8 * (g % stages);
  }
  __device__ uint32_t empty(uint32_t g) const {
    return empty0 + 8 * (g % stages);
  }
  __device__ uint32_t parity(uint32_t g) const { return g / stages & 1u; }
};

// Producer (one thread): chunk k of the item (q0, col0), the ring's g-th,
// into its stage by TMA once the consumers have released it: the query
// box, then the GT boxes.
__device__ __forceinline__ void produce(const Ring& ring, uint32_t g,
                                        const CUtensorMap* tg,
                                        const CUtensorMap* tq, int q0,
                                        int col0, int k) {
  if (g >= (uint32_t)ring.stages) {
    mbar_wait(ring.empty(g), ring.parity(g) ^ 1u);
  }
  const uint32_t st = ring.stage(g), full = ring.full(g);
  mbar_expect_tx(full, STAGE);
  tma_2d(st, tq, k * BOXC, q0, full);
  for (int b = 0; b < NTC / BOXC; ++b) {
    tma_2d(st + QBOX + b * KC * ROWB, tg, col0 + b * BOXC, k * KC, full);
  }
}

// Consumer warpgroup ``wg``: its 64 queries x 128 columns of one item from
// the ring's chunks g0 .. g0 + nk - 1, each stage released once read.
__device__ __forceinline__ void sweep(float* acc, const Ring& ring,
                                      uint32_t g0, int nk, int wg) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const uint32_t g = g0 + k;
    mbar_wait(ring.full(g), ring.parity(g));
    const uint32_t a = ring.stage(g);
    const uint32_t b = a + QBOX + wg * 2 * KC * ROWB;
    fence_regs<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      wgmma_ss_tb_n128(acc, smem_desc(a + ks * 32, 16),
                       smem_desc(b + ks * 16 * ROWB, KC * ROWB));
    }
    wgmma_commit();
    wgmma_wait<1>();                      // chunk g - 1 is read
    if (k > 0) mbar_arrive(ring.empty(g - 1));
  }
  wgmma_wait<0>();
  fence_regs<64>(acc);
  mbar_arrive(ring.empty(g0 + nk - 1));
}

__device__ __forceinline__ uint8_t* aligned_base(uint8_t* smem_raw) {
  // 1024-aligned for the swizzled boxes; an offset of the shared array, so
  // that the compiler keeps shared (not generic) loads, stores and atomics
  return smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void init_ring(const Ring& ring) {
  for (int s = 0; s < ring.stages; ++s) {
    mbar_init(ring.full0 + 8 * s, 1);
    mbar_init(ring.empty0 + 8 * s, W_CONSUMERS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// -- kernel 1's select: a radix select over the cluster -----------------------
//
// The score tile ``sc`` ([WTQ][LDS]) holds this CTA's NTC columns of each
// query below qv; ``dec`` each query's first window (the whole key range,
// or a guessed one).  NT threads, the first NTC of which count.
//
// Each CTA counts its columns' digits per query (a thread a query and
// QS columns, read 4 at a time: 64 columns at 64 queries), pushes each
// query's counts to the CTA that owns it (query q: CTA q % SPLIT) by
// 16-byte stores into that CTA's inbox (those that are not zero: the
// owner clears what it has read; the histogram is cleared as it is
// pushed), and the owner sums them, picks the digit, keeps each CTA's
// count of keys above T and pushes the decision with each CTA's
// offsets to that CTA.  A pass splits the query's window of 2^wb keys
// into 256 bins (the last pass into 2^wb), and the query's select is
// done once its chosen bin is taken whole or holds one key.  A guessed
// first pass also counts the keys above its window; if the kappa-th
// key is not in it, the query starts over from the whole key range (5
// passes at most).
template <int NT>
__device__ __forceinline__ void cluster_select(const float* sc,
                                               uint32_t* hist, uint4* dec,
                                               uint32_t* upc,
                                               uint32_t* inbox, int rank,
                                               int qv) {
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const unsigned full = 0xffffffffu;
  int QS = 1;
  while (QS < qv) QS <<= 1;
  const int hq = tid % QS, hg = tid / QS;
  int abv[SPLIT];                       // the owner's: keys above, by CTA
#pragma unroll
  for (int m = 0; m < SPLIT; ++m) abv[m] = 0;
  for (;;) {
    if (tid < NTC && hq < qv && !(dec[hq].y & DONE)) {
      const uint4 d = dec[hq];
      const uint32_t lo = d.x, wb = d.y >> 24;
      const int shift = max((int)wb - 8, 0);
      const bool guessed = d.y & GUESS;
      const float* row = sc + hq * LDS + hg * QS;
      uint32_t* h = hist + hq * HW;
      int up = 0;
      auto count = [&](float x) {
        const uint32_t k = score_key(x), o = k - lo;
        if (wb == 32 || o < 1u << wb) {
          const uint32_t dg = o >> shift;
          atomicAdd(&h[dg >> 1], 1u << ((dg & 1u) << 4));
        } else {
          up += k > lo;
        }
      };
      if (QS >= 4) {
#pragma unroll 2
        for (int i = 0; i < QS; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(row + i);
          count(x.x);
          count(x.y);
          count(x.z);
          count(x.w);
        }
      } else {
        for (int i = 0; i < QS; ++i) count(row[i]);
      }
      if (guessed && up) atomicAdd(&upc[hq], (uint32_t)up);
    }
    __syncthreads();
    for (int e = tid; e < qv * (IW / 4); e += NT) {
      const int q = e / (IW / 4), w4 = e % (IW / 4) * 4;
      uint4 v;
      if (w4 < BINS / 2) {
        uint32_t* h = hist + q * HW + w4;   // read, cleared for the next
        v = make_uint4(h[0], h[1], h[2], h[3]);
        h[0] = h[1] = h[2] = h[3] = 0u;
      } else {
        v = make_uint4(upc[q], 0u, 0u, 0u);
        upc[q] = 0u;
      }
      if (v.x | v.y | v.z | v.w) {
        st_cluster_v4(cluster_addr(smem_u32(inbox + (rank * (WTQ / SPLIT) +
                                                     q / SPLIT) * IW +
                                            w4),
                                   q % SPLIT),
                      v);
      }
    }
    cluster_sync();                     // every owner has its counts
    const int q = rank + SPLIT * w;     // warp w decides query q
    if (w < WTQ / SPLIT && q < qv && !(dec[q].y & DONE)) {
      // lane l owns digits 255-8l down to 248-8l: bin_of(v, j) is digit
      // 255-8l-j of the counts v
      const uint4 d = dec[q];
      uint4 v[SPLIT];
      int up[SPLIT], upt = 0;
#pragma unroll
      for (int m = 0; m < SPLIT; ++m) {
        uint32_t* row = inbox + (m * (WTQ / SPLIT) + w) * IW;
        uint4* at = reinterpret_cast<uint4*>(row + BINS / 2 - 4 - 4 * lane);
        v[m] = *at;
        *at = make_uint4(0u, 0u, 0u, 0u);
        up[m] = (int)row[BINS / 2];
        upt += up[m];
      }
      __syncwarp();
      if (lane < SPLIT) {
        inbox[(lane * (WTQ / SPLIT) + w) * IW + BINS / 2] = 0u;
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
      int cum = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(full, cum, off);
        if (lane >= off) cum += t;
      }
      const int total = __shfl_sync(full, cum, 31);   // in the window
      const int shift = max((int)(d.y >> 24) - 8, 0);
      int remaining = (int)(d.y & 0xffffu);
      uint4 out;
      const bool held = upt < remaining && remaining <= upt + total;
#ifdef FUSED_GUESS_STATS
      if ((d.y & GUESS) && lane == 0) {
        atomicAdd(&g_guess[held ? 0 : 1], 1ull);
      }
#endif
      if ((d.y & GUESS) && !held) {
        // the kappa-th key is not in the guessed window: start over
        out = make_uint4(0u, (uint32_t)remaining | 32u << 24, 0u, 0u);
      } else {
        if (d.y & GUESS) {
          remaining -= upt;
#pragma unroll
          for (int m = 0; m < SPLIT; ++m) abv[m] += up[m];
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
        out = make_uint4(d.x + ((uint32_t)digit << shift),
                         (uint32_t)remaining | (uint32_t)shift << 24 |
                             (sel == remaining || shift == 0 ? DONE : 0u),
                         (uint32_t)gl, (uint32_t)el);
      }
      if (lane < SPLIT) {
        st_cluster_v4(cluster_addr(smem_u32(dec + q), lane), out);
      }
    }
    cluster_sync();                     // every CTA has every decision
    // the same decisions in every CTA: the same pass ends the select
    if (__syncthreads_and(tid >= qv || (dec[tid].y & DONE))) break;
  }
}

// The pool of each query (row ``row0 + q`` of out_s/out_i, kappa wide):
// keys above T, then the lowest-id rows equal to T.  Keys in T's window count as equal to T: this CTA's keys above T go
// after those of the CTAs to its left; its keys equal to T, in row
// order, after all kappa - R keys above T and the equal keys of the
// CTAs to its left, up to R.
template <int NT>
__device__ __forceinline__ void write_pool(const float* sc, const uint4* dec,
                                           int qv, int kappa, int col0,
                                           size_t row0,
                                           float* __restrict__ out_s,
                                           int* __restrict__ out_i) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu, lt = (1u << lane) - 1u;
  for (int q = w; q < qv; q += NT / 32) {
    const uint4 d = dec[q];
    const uint32_t lo = d.x, hi = lo + ((1u << (d.y >> 24)) - 1u);
    const int R = (int)(d.y & 0xffffu), G = kappa - R;
    int taken = (int)d.z, eq_seen = (int)d.w;
    const float* row = sc + q * LDS;
    const size_t ob = (row0 + q) * kappa;
    float v[NTC / 32];
    unsigned gb[NTC / 32], eb[NTC / 32];
#pragma unroll
    for (int t = 0; t < NTC / 32; ++t) {
      v[t] = row[32 * t + lane];
      const uint32_t k = score_key(v[t]);
      gb[t] = __ballot_sync(full, k > hi);
      eb[t] = __ballot_sync(full, k >= lo && k <= hi);
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

// Kernel 1: a cluster of 8 CTAs (rank = the slab's 256-column block) walks
// the items (slab, query tile), tiles of a slab in turn.
__global__ void __launch_bounds__(W_THREADS, 1)
slab_topk_wgmma(const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tq,
                const float* __restrict__ c,
                const uint8_t* __restrict__ valid,
                float* __restrict__ out_s, int* __restrict__ out_i, int B,
                int twoD, int NS, int kappa) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  const Layout lay(true, TOPK_STAGES);
  const Ring ring(smem_u32(base), lay);
  const int rank = blockIdx.x;            // the CTA's rank in its cluster
  const int ntiles = (B + WTQ - 1) / WTQ, items = NS * ntiles;
  const int nk = (twoD + KC - 1) / KC;    // chunks an item
  const int tid = threadIdx.x, lane = tid & 31;
  float* sc = reinterpret_cast<float*>(base + lay.epi);
  // [WTQ][HW] words of two 16-bit digit counts (a CTA has 256 columns)
  uint32_t* hist = reinterpret_cast<uint32_t*>(sc + WTQ * LDS);
  // [WTQ]: the decisions above; the offsets are this CTA's: the keys above
  // T and the keys equal to T of the CTAs to its left
  uint4* dec = reinterpret_cast<uint4*>(hist + WTQ * HW);
  // [WTQ]: this CTA's keys above a guessed window
  uint32_t* upc = reinterpret_cast<uint32_t*>(dec + WTQ);
  // inbox: [SPLIT source CTAs][WTQ / SPLIT owned queries][IW] words
  uint32_t* inbox = reinterpret_cast<uint32_t*>(base + lay.inbox);

  if (tid == 0) init_ring(ring);
  // the inbox and histograms start empty; the select leaves them so
  for (int e = tid; e < INBOX / 16; e += W_THREADS) {
    reinterpret_cast<uint4*>(inbox)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = tid; e < WTQ * HW; e += W_THREADS) hist[e] = 0u;
  if (tid < WTQ) upc[tid] = 0u;
  cluster_sync();

  const float ninf = __int_as_float(0xff800000);
  float acc[64];
  uint32_t g = 0;                         // the ring's chunks so far
  int pre = 0;                            // chunks of this item loaded ahead
  for (int it = blockIdx.y; it < items; it += gridDim.y) {
    const int slab = it / ntiles, q0 = it % ntiles * WTQ;
    const int col0 = slab * SLAB + rank * NTC;   // the CTA's first column
    const int qv = min(WTQ, B - q0);
    if (tid >= W_CONSUMERS) {
      // -- producer: this item's chunks, then the next item's first ones,
      // which load while this item is selected
      const int nx = it + gridDim.y;
      const int npre = nx < items ? min(TOPK_STAGES, nk) : 0;
      if (tid == W_CONSUMERS) {
        for (int k = pre; k < nk; ++k) {
          produce(ring, g + k, &tg, &tq, q0, col0, k);
        }
        for (int k = 0; k < npre; ++k) {
          produce(ring, g + nk + k, &tg, &tq, nx % ntiles * WTQ,
                  nx / ntiles * SLAB + rank * NTC, k);
        }
      }
      pre = npre;
    } else {
      // -- consumers: the sweep, then the score tile: + c, invalid -inf
      const int wg = tid >> 7, r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);
      const int cq = lane & 3;
      sweep(acc, ring, g, nk, wg);
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
      // the same query tile as the last item (always at B <= 64): guess a
      // window of keys around the kappa-th key of its last slab (a query's
      // slabs give it scores of one scale); else the whole key range
      if (tid < WTQ) {
        uint4 d = make_uint4(0u, (uint32_t)kappa | 32u << 24, 0u, 0u);
        if (it != (int)blockIdx.y && gridDim.y % ntiles == 0) {
          constexpr uint32_t half = 1u << (GUESS_BITS - 1);
          const uint32_t t = dec[tid].x & 0xffff0000u;
          d.x = min(t > half ? t - half : 0u, 0u - (1u << GUESS_BITS));
          d.y = (uint32_t)kappa | GUESS | (uint32_t)GUESS_BITS << 24;
        }
        dec[tid] = d;
      }
    }
    g += nk;
    __syncthreads();

    cluster_select<W_THREADS>(sc, hist, dec, upc, inbox, rank, qv);
    write_pool<W_THREADS>(sc, dec, qv, kappa, col0, (size_t)slab * B + q0,
                          out_s, out_i);
    __syncthreads();                      // the tile is read: next scores
  }
}

// Kernel 2: each CTA walks the items (slab, 256-column block, query tile),
// query tiles of a block in turn; warpgroup wg's 128 columns are group
// 2 * block + wg of the slab.
__global__ void __launch_bounds__(W_THREADS, 1)
group_topk_wgmma(const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tq,
                 const float* __restrict__ c,
                 const uint8_t* __restrict__ valid,
                 float* __restrict__ out_s, int* __restrict__ out_i, int B,
                 int twoD, int NS, int per_group, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const Layout lay(false, stages);
  const Ring ring(smem_u32(aligned_base(smem_raw)), lay);
  const int ntiles = (B + WTQ - 1) / WTQ, items = NS * SPLIT * ntiles;
  const int nk = (twoD + KC - 1) / KC;
  const int tid = threadIdx.x;
  if (tid == 0) init_ring(ring);
  __syncthreads();

  uint32_t g = 0;
  if (tid >= W_CONSUMERS) {
    // -- producer: every item's chunks, as far ahead as the ring allows
    if (tid != W_CONSUMERS) return;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int q0 = it % ntiles * WTQ, col0 = it / ntiles * NTC;
      for (int k = 0; k < nk; ++k, ++g) {
        produce(ring, g, &tg, &tq, q0, col0, k);
      }
    }
    return;
  }

  // -- consumers: the item's scores in registers, then the group rounds
  const int wg = tid >> 7, lane = tid & 31, cq = lane & 3;
  const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int KO = per_group * NG;
  const unsigned full = 0xffffffffu;
  float acc[64];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int q0 = it % ntiles * WTQ, blk = it / ntiles;
    const int slab = blk / SPLIT;
    const int gi = blk % SPLIT * 2 + wg;            // the group in its slab
    const int gc0 = slab * SLAB + gi * GROUP;       // its first row
    sweep(acc, ring, g, nk, wg);
    g += nk;
    // + c, invalid rows NEG; this lane's column 8j + 2cq + e of the group
    // is acc[4j + e] for row r0, acc[4j + 2 + e] for row r0 + 8
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * cq + e;
        const bool ok = valid[gc0 + col] != 0;
        const float cb = c[gc0 + col];
        acc[4 * j + e] = ok ? acc[4 * j + e] + cb : NEG;
        acc[4 * j + 2 + e] = ok ? acc[4 * j + 2 + e] + cb : NEG;
      }
    }
    const int qa = q0 + r0, qb = qa + 8;
    const size_t oa = ((size_t)slab * B + qa) * KO + gi;
    const size_t ob = oa + (size_t)8 * KO;
    for (int i = 0; i < per_group; ++i) {
      // the first maximum in column order, in the lane, then in the quad
      float va = acc[0], vb = acc[2];
      int ca = 2 * cq, cb = 2 * cq;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * cq + e;
          if (acc[4 * j + e] > va) { va = acc[4 * j + e]; ca = col; }
          if (acc[4 * j + 2 + e] > vb) { vb = acc[4 * j + 2 + e]; cb = col; }
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ova = __shfl_xor_sync(full, va, off);
        const float ovb = __shfl_xor_sync(full, vb, off);
        const int oca = __shfl_xor_sync(full, ca, off);
        const int ocb = __shfl_xor_sync(full, cb, off);
        if (ova > va || (ova == va && oca < ca)) { va = ova; ca = oca; }
        if (ovb > vb || (ovb == vb && ocb < cb)) { vb = ovb; cb = ocb; }
      }
      if (cq == 0 && qa < B) {
        out_s[oa + (size_t)i * NG] = va;
        out_i[oa + (size_t)i * NG] = gc0 + ca;
      }
      if (cq == 1 && qb < B) {
        out_s[ob + (size_t)i * NG] = vb;
        out_i[ob + (size_t)i * NG] = gc0 + cb;
      }
      // the taken columns to NEG: a compare-and-select on every register
      // (an indexed write would move the accumulators to local memory)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * cq + e;
          acc[4 * j + e] = col == ca ? NEG : acc[4 * j + e];
          acc[4 * j + 2 + e] = col == cb ? NEG : acc[4 * j + 2 + e];
        }
      }
    }
  }
}

// The tensor maps of GT (2D rows) and of qq, whose rows are padded to a
// multiple of 8 (16 bytes, as TMA needs), the pad zero; zero fill past
// both, so the chunks past 2D add nothing.
bool wgmma_maps(CUtensorMap* tg, CUtensorMap* tq, const void* qq,
                const void* gt, int B, int twoD, int Sp) {
  const cuuint64_t gdims[2] = {(cuuint64_t)Sp, (cuuint64_t)twoD};
  const cuuint64_t qdims[2] = {(cuuint64_t)(twoD + 7) / 8 * 8,
                               (cuuint64_t)B};
  return tensor_map(tg, gt, 2, gdims, KC) &&
         tensor_map(tq, qq, 2, qdims, WTQ);
}

int launch_topk(const void* qq, const void* gt, const void* c,
                const void* valid, void* out_s, void* out_i, int B, int twoD,
                int Sp, int kappa, cudaStream_t stream) {
  CUtensorMap tg, tq;
  if (!wgmma_maps(&tg, &tq, qq, gt, B, twoD, Sp)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = Layout(true, TOPK_STAGES).total;
  cudaLaunchConfig_t cfg = {};
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
  // the clusters that fit the card at once, asked once per device
  static int fit[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& n = fit[dev & 63];
  if (n == 0) {
    e = cudaFuncSetAttribute(slab_topk_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3(SPLIT);
    e = cudaOccupancyMaxActiveClusters(&n, slab_topk_wgmma, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int items = Sp / SLAB * ((B + WTQ - 1) / WTQ);
  cfg.gridDim = dim3(SPLIT, items < n ? items : n);
  e = cudaLaunchKernelEx(&cfg, slab_topk_wgmma, tg, tq,
                         reinterpret_cast<const float*>(c),
                         reinterpret_cast<const uint8_t*>(valid),
                         reinterpret_cast<float*>(out_s),
                         reinterpret_cast<int*>(out_i), B, twoD, Sp / SLAB,
                         kappa);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_group(const void* qq, const void* gt, const void* c,
                 const void* valid, void* out_s, void* out_i, int B,
                 int twoD, int Sp, int per_group, cudaStream_t stream) {
  CUtensorMap tg, tq;
  if (!wgmma_maps(&tg, &tq, qq, gt, B, twoD, Sp)) {
    return (int)cudaErrorInvalidValue;
  }
  int stages = 2;
  while (Layout(false, stages + 1).total <= SMEM_LIMIT) ++stages;
  const int smem = Layout(false, stages).total;
  cudaError_t e = cudaFuncSetAttribute(
      group_topk_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  static int sms[64] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (sms[dev & 63] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev & 63], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int items = Sp / SLAB * SPLIT * ((B + WTQ - 1) / WTQ);
  const int grid = items < sms[dev & 63] ? items : sms[dev & 63];
  group_topk_wgmma<<<grid, W_THREADS, smem, stream>>>(
      tg, tq, reinterpret_cast<const float*>(c),
      reinterpret_cast<const uint8_t*>(valid),
      reinterpret_cast<float*>(out_s), reinterpret_cast<int*>(out_i), B,
      twoD, Sp / SLAB, per_group, stages);
  return (int)cudaGetLastError();
}


// -- the f32 entries: register-tiled products on the CUDA cores --------------
//
// Both f32 entries share one sweep (f32_tile): a CTA owns a 256-column block
// of a slab and a query tile of TQ = 1, 8, 16, 32 or 64 queries.  The depth
// streams in chunks of FDK through a ring of mbarrier stages that one
// thread fills by TMA: the chunk's qq box (TQ x FDK, 128-byte swizzle) and
// its GT box (FDK x 256 columns).  Each of the 256 threads keeps full-f32
// sums (fmaf in ascending depth) of an RQ x 8 tile of queries and columns
// over its depth group's steps; below TQ = 64 the depth is split over DG =
// 64 / TQ groups (8 at TQ <= 8) so that the tile stays 8 x 8, and the
// groups' sums are added in group order.  The score tile (+ c, invalid rows
// -inf for kernel 1, NEG for kernel 2) then lies over the ring.
//
// Kernel 1 (slab_topk_f32): the SPLIT = 8 CTAs of a (slab, query tile) form
// a cluster, as in the bf16 kernel.  kappa <= ROUNDS: each CTA takes its
// columns' top-kappa by max/argmax rounds on order-preserving keys in
// registers (a redux for the max, one for its lowest column), pushes them
// to the inbox of the CTA that merges the query (q % 8), and after one
// cluster barrier that CTA runs kappa rounds over the 8 CTAs' candidates
// (ties to the lower row).  Larger kappa: the cluster radix select and tie
// offsets above, on the same tile.
//
// Kernel 2 (group_topk_f32): a CTA's 256 columns are two whole 128-row
// groups, so the 8 CTAs of a (slab, query tile) need nothing from each
// other and form no cluster; each runs the per_group rounds of its two
// groups on keys in registers, a warp a (query, group) pair.
//
// launch_f32 picks TQ by a model of waves (of clusters for kernel 1, of
// CTAs for kernel 2): 1 at B = 1, 8 at B = 8, 16 at B = 32, 64 at B = 1000.

constexpr int F_THREADS = 256;            // 8 warps
constexpr int FDK = 32;                   // depth of a chunk: 128-byte rows
constexpr int ROUNDS = 32;                // kappa up to this: rounds
constexpr int F_MAX_STAGES = 6;
constexpr int F_TILES = 5;                // query tiles 1, 8, 16, 32, 64
constexpr int F_FIXED = 18;               // a CTA's fixed part, in queries
constexpr int MAX_DEVICES = 16;

constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Shared memory at query tile TQ (1024-aligned): the ring's stages (the qq
// box, then the GT box), a full mbarrier a stage, the inbox where the
// cluster's CTAs push the candidates of the queries this CTA merges
// ([SPLIT][QO][ROUNDS] (key, row)), then c and the validity of the CTA's
// columns.  After the sweep the ring holds the score tile [TQ][LDS] and
// this CTA's candidates [TQ][ROUNDS], or the radix select's tiles (EPI,
// INBOX), and past them the depth groups' partial sums (DG > 2; two groups
// add in place on the score tile).  Kernel 2 leaves the inbox unused (a CTA
// a SM either way).
template <int TQ>
struct F32Layout {
  static constexpr int RQ = TQ < 8 ? TQ : 8;      // queries a thread
  static constexpr int QG = TQ / RQ, DG = 8 / QG;  // query, depth groups
  static constexpr int BOX = TQ * FDK * 4 + FDK * NTC * 4;  // a chunk's
  static constexpr int QB = (TQ * FDK * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGE = QB + FDK * NTC * 4;
  static constexpr int QO = (TQ + 7) / 8;         // queries a CTA merges
  static constexpr int INB = SPLIT * QO * ROUNDS * 8;  // their candidates
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - 8 * F_MAX_STAGES - INB) / STAGE;
  static constexpr int STAGES = FIT < F_MAX_STAGES ? FIT : F_MAX_STAGES;
  static constexpr int PART = EPI + INBOX;        // the depth groups' sums
  static constexpr int RING = max3(STAGES * STAGE,
                                   TQ * LDS * 4 + TQ * ROUNDS * 8,
                                   PART + (DG > 2 ? DG * TQ * NTC * 4 : 0));
  static constexpr int INBOX_AT = RING + 8 * F_MAX_STAGES;
  static constexpr int CV_AT = INBOX_AT + INB;    // c, validity: NTC each
  static constexpr int SMEM = 1024 + CV_AT + NTC * 5;
  static_assert(STAGES >= 3 && SMEM <= SMEM_LIMIT, "the ring fits");
  static_assert(PART % 16 == 0 && QG * DG == 8 && (FDK / 4) % DG == 0,
                "the thread groups");
};

// score_key's inverse (-0 comes back as +0)
__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// The f32 sweep of one CTA (both f32 entries): the score tile [TQ][LDS]
// at ``base`` of queries q0 .. q0 + TQ - 1 and the 256 columns from col0,
// + c, invalid rows ``fill``; every thread may read it on return.
template <int TQ>
__device__ __forceinline__ void f32_tile(uint8_t* base,
                                         const CUtensorMap* tg,
                                         const CUtensorMap* tq,
                                         const float* __restrict__ c,
                                         const uint8_t* __restrict__ valid,
                                         int q0, int col0, int twoD,
                                         float fill) {
  using L = F32Layout<TQ>;
  constexpr int RQ = L::RQ, QG = L::QG, DG = L::DG, S = L::STAGES;
  const uint32_t ring = smem_u32(base), bars = ring + L::RING;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = (twoD + FDK - 1) / FDK;          // depth chunks

  // chunk i into stage i % S by TMA (thread 0); zero fill past 2D and B
  auto issue = [&](int i) {
    const uint32_t st = ring + i % S * L::STAGE, bar = bars + 8 * (i % S);
    mbar_expect_tx(bar, L::BOX);
    tma_2d(st, tq, i * FDK, q0, bar);
    tma_2d(st + L::QB, tg, col0, i * FDK, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < S - 1 && i < N; ++i) issue(i);   // S - 1 ahead
  }
  __syncthreads();

  // c and the validity of this CTA's columns, loaded while the sweep runs
  float* cs = reinterpret_cast<float*>(base + L::CV_AT);
  uint8_t* vs = reinterpret_cast<uint8_t*>(cs + NTC);
  cs[tid] = c[col0 + tid];
  vs[tid] = valid[col0 + tid];

  // Thread (gq, dg, gc): queries gq + QG r (r < RQ), the 4-depth steps dg
  // + DG j of every chunk, columns 4 gc + e + 128 v (e < 4, v < 2): from
  // TQ = 8 on an 8 x 8 tile, 16 loads of 16 bytes to 256 fmaf.  The 8
  // lanes of a quarter warp share (gq, dg) and read one 16-byte qq word or
  // 128 adjacent bytes of a GT row; at TQ = 64 the 4 quarter warps of a
  // warp read the same GT bytes, which the shared memory serves at once
  // (a warp of 32 column groups, 512 bytes a GT load, was slower).
  constexpr int NV = 2;
  const int qd = (lane >> 3) + 4 * (warp >> 2);  // (gq, dg)
  const int gc = (lane & 7) + 8 * (warp & 3), gq = qd % QG, dg = qd / QG;
  float acc[RQ][4 * NV];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
#pragma unroll
    for (int e = 0; e < 4 * NV; ++e) acc[r][e] = 0.f;
  }
  for (int i = 0; i < N; ++i) {
    mbar_wait(bars + 8 * (i % S), (i / S) & 1);
    __syncthreads();                      // every thread is done with i - 1
    if (tid == 0 && i + S - 1 < N) {      // ... so its stage takes i + S - 1
      fence_async_smem();
      issue(i + S - 1);
    }
    const float* sq =
        reinterpret_cast<const float*>(base + i % S * L::STAGE);
    const float* sg = sq + L::QB / 4 + 4 * gc;
#pragma unroll
    for (int j = 0; j < FDK / 4 / DG; ++j) {
      const int k = dg + DG * j;
      float4 a[RQ];                       // 4 depths of each query
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int row = gq + QG * r;      // swizzled: chunk k ^ (row % 8)
        a[r] = *reinterpret_cast<const float4*>(sq + row * FDK +
                                                4 * (k ^ (row & 7)));
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float4 b[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          b[v] = *reinterpret_cast<const float4*>(sg + (4 * k + d) * NTC +
                                                  128 * v);
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float x = d == 0 ? a[r].x : d == 1 ? a[r].y
                        : d == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            acc[r][4 * v] = fmaf(x, b[v].x, acc[r][4 * v]);
            acc[r][4 * v + 1] = fmaf(x, b[v].y, acc[r][4 * v + 1]);
            acc[r][4 * v + 2] = fmaf(x, b[v].z, acc[r][4 * v + 2]);
            acc[r][4 * v + 3] = fmaf(x, b[v].w, acc[r][4 * v + 3]);
          }
        }
      }
    }
  }
  __syncthreads();                        // the ring is free

  // the score tile: the depth groups' sums in order, + c, invalid: fill
  float* sc = reinterpret_cast<float*>(base);    // [TQ][LDS]
  auto bias = [&](float4 x, int col) {
    return make_float4(vs[col] ? x.x + cs[col] : fill,
                       vs[col + 1] ? x.y + cs[col + 1] : fill,
                       vs[col + 2] ? x.z + cs[col + 2] : fill,
                       vs[col + 3] ? x.w + cs[col + 3] : fill);
  };
  if constexpr (DG <= 2) {
    // group 0 writes its sums to the tile, then group 1 adds its own
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      if (dg == g) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int col = 4 * gc + 128 * v;
#pragma unroll
          for (int r = 0; r < RQ; ++r) {
            float4* p = reinterpret_cast<float4*>(sc + (gq + QG * r) * LDS +
                                                  col);
            float4 x = make_float4(acc[r][4 * v], acc[r][4 * v + 1],
                                   acc[r][4 * v + 2], acc[r][4 * v + 3]);
            if (g > 0) {
              const float4 y = *p;
              x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
            }
            *p = g == DG - 1 ? bias(x, col) : x;
          }
        }
      }
      if (g + 1 < DG) __syncthreads();
    }
  } else {
    float* part = reinterpret_cast<float*>(base + L::PART);  // [DG][TQ][NTC]
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        *reinterpret_cast<float4*>(part + (dg * TQ + gq + QG * r) * NTC +
                                   4 * gc + 128 * v) =
            make_float4(acc[r][4 * v], acc[r][4 * v + 1], acc[r][4 * v + 2],
                        acc[r][4 * v + 3]);
      }
    }
    __syncthreads();
    for (int e = tid; e < TQ * NTC / 4; e += F_THREADS) {
      const int q = e / (NTC / 4), col = 4 * (e % (NTC / 4));
      float4 x = *reinterpret_cast<const float4*>(part + q * NTC + col);
#pragma unroll
      for (int p = 1; p < DG; ++p) {
        const float4 y = *reinterpret_cast<const float4*>(
            part + (p * TQ + q) * NTC + col);
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      *reinterpret_cast<float4*>(sc + q * LDS + col) = bias(x, col);
    }
  }
  __syncthreads();
}

template <int TQ>
__global__ void __launch_bounds__(F_THREADS, 1)
slab_topk_f32(const __grid_constant__ CUtensorMap tg,
              const __grid_constant__ CUtensorMap tq,
              const float* __restrict__ c,
              const uint8_t* __restrict__ valid,
              float* __restrict__ out_s, int* __restrict__ out_i, int B,
              int twoD, int kappa) {
  using L = F32Layout<TQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x;            // the CTA's rank in its cluster
  const int q0 = blockIdx.y * TQ, slab = blockIdx.z;
  const int qv = min(TQ, B - q0);
  const int col0 = slab * SLAB + rank * NTC;     // the CTA's first column
  cluster_arrive_relaxed();               // this CTA runs (waited below)
  f32_tile<TQ>(base, &tg, &tq, c, valid, q0, col0, twoD,
               __int_as_float(0xff800000));     // invalid rows -inf
  float* sc = reinterpret_cast<float*>(base);    // [TQ][LDS]

  const unsigned full = 0xffffffffu;
  cluster_wait();                         // every CTA of the cluster runs
  if (kappa <= ROUNDS) {
    // Each CTA's top-kappa of every query by rounds on keys (lane l holds
    // columns l + 32 m), a warp on queries warp + 8 j at once: the max by
    // redux, then its lowest column by redux; a taken key becomes 0, below
    // every score's key.  Then the warp pushes each query's candidates
    // (key, row) to the inbox of the CTA that merges it (q % 8).
    uint2* cand = reinterpret_cast<uint2*>(sc + TQ * LDS);  // [TQ][ROUNDS]
    uint2* inbox = reinterpret_cast<uint2*>(base + L::INBOX_AT);
    constexpr int QO = L::QO;
    uint32_t key[QO][NTC / 32];
#pragma unroll
    for (int j = 0; j < QO; ++j) {
      const int q = warp + 8 * j;
#pragma unroll
      for (int m = 0; m < NTC / 32; ++m) {
        key[j][m] = q < qv ? score_key(sc[q * LDS + 32 * m + lane]) : 0u;
      }
    }
    for (int r = 0; r < kappa; ++r) {
#pragma unroll
      for (int j = 0; j < QO; ++j) {
        uint32_t lm = key[j][0];
#pragma unroll
        for (int m = 1; m < NTC / 32; ++m) lm = max(lm, key[j][m]);
        const uint32_t wm = __reduce_max_sync(full, lm);
        int lc = 0x7fffffff;
#pragma unroll
        for (int m = NTC / 32 - 1; m >= 0; --m) {
          if (key[j][m] == wm) lc = 32 * m + lane;
        }
        const int bc = __reduce_min_sync(full, lc);
        if (lane == 0) {
          cand[(warp + 8 * j) * ROUNDS + r] =
              make_uint2(wm, (uint32_t)(col0 + bc));
        }
#pragma unroll
        for (int m = 0; m < NTC / 32; ++m) {
          if (bc == 32 * m + lane) key[j][m] = 0u;
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < QO; ++j) {
      const int q = warp + 8 * j;
      if (q < qv && lane < kappa) {
        st_cluster_v2(cluster_addr(smem_u32(inbox + (rank * QO + q / 8) *
                                                        ROUNDS + lane),
                                   q % 8),
                      cand[q * ROUNDS + lane]);
      }
    }
    cluster_sync();                       // every CTA's candidates are in
    // CTA rank merges query rank + 8 w: kappa rounds over the 8 kappa
    // candidates (lane l holds l + 32 m), ties to the lower row
    const int q = rank + SPLIT * warp;
    if (q < qv) {
      const int n = SPLIT * kappa;
      uint32_t k2[NTC / 32];
      int row[NTC / 32];
#pragma unroll
      for (int m = 0; m < NTC / 32; ++m) {
        const int j = 32 * m + lane;
        k2[m] = 0u;
        row[m] = 0x7fffffff;
        if (j < n) {
          const uint2 v = inbox[((j / kappa) * QO + warp) * ROUNDS +
                                j % kappa];
          k2[m] = v.x;
          row[m] = (int)v.y;
        }
      }
      const size_t ob = ((size_t)slab * B + q0 + q) * kappa;
      for (int r = 0; r < kappa; ++r) {
        uint32_t lm = k2[0];
#pragma unroll
        for (int m = 1; m < NTC / 32; ++m) lm = max(lm, k2[m]);
        const uint32_t wm = __reduce_max_sync(full, lm);
        int lr = 0x7fffffff;
#pragma unroll
        for (int m = 0; m < NTC / 32; ++m) {
          if (k2[m] == wm) lr = min(lr, row[m]);
        }
        const int br = __reduce_min_sync(full, lr);
        if (lane == 0) {
          out_s[ob + r] = key_score(wm);
          out_i[ob + r] = br;
        }
#pragma unroll
        for (int m = 0; m < NTC / 32; ++m) {
          if (row[m] == br) k2[m] = 0u;
        }
      }
    }
    return;                               // no CTA reads another's memory
  }

  // kappa > ROUNDS: the radix select over the cluster, its tiles over the
  // ring, empty at the start
  uint32_t* hist = reinterpret_cast<uint32_t*>(sc + WTQ * LDS);
  uint4* dec = reinterpret_cast<uint4*>(hist + WTQ * HW);
  uint32_t* upc = reinterpret_cast<uint32_t*>(dec + WTQ);
  uint32_t* inbox = reinterpret_cast<uint32_t*>(base + EPI);
  for (int e = tid; e < INBOX / 16; e += F_THREADS) {
    reinterpret_cast<uint4*>(inbox)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = tid; e < WTQ * HW; e += F_THREADS) hist[e] = 0u;
  if (tid < WTQ) {
    upc[tid] = 0u;
    dec[tid] = make_uint4(0u, (uint32_t)kappa | 32u << 24, 0u, 0u);
  }
  cluster_sync();                         // every CTA's tile, empty inbox
  cluster_select<F_THREADS>(sc, hist, dec, upc, inbox, rank, qv);
  write_pool<F_THREADS>(sc, dec, qv, kappa, col0, (size_t)slab * B + q0,
                        out_s, out_i);
}

// Kernel 2's f32 entry: CTA (rank, query tile, slab) holds groups 2 rank
// and 2 rank + 1 of the slab whole, so it writes their rounds alone.
template <int TQ>
__global__ void __launch_bounds__(F_THREADS, 1)
group_topk_f32(const __grid_constant__ CUtensorMap tg,
               const __grid_constant__ CUtensorMap tq,
               const float* __restrict__ c,
               const uint8_t* __restrict__ valid,
               float* __restrict__ out_s, int* __restrict__ out_i, int B,
               int twoD, int per_group) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x, q0 = blockIdx.y * TQ, slab = blockIdx.z;
  const int qv = min(TQ, B - q0);
  const int col0 = slab * SLAB + rank * NTC;     // the CTA's first column
  f32_tile<TQ>(base, &tg, &tq, c, valid, q0, col0, twoD, NEG);
  const float* sc = reinterpret_cast<const float*>(base);

  // Warp w takes the pairs p = w + 8 j, query p / 2 and the CTA's group
  // p % 2, side by side; lane l holds rows l + 32 m of the group as keys
  // (a pair past the batch: every key at NEG's, its rounds not written).
  // A round: the max by redux, then its lowest row by redux; the taken
  // row's key becomes NEG's, so once every row is at NEG a round returns
  // NEG at the group's lowest row, as the plain version (argmax) does.
  // The pairs' rounds are straight-line code, so their redux chains
  // overlap; lane j keeps pair j's result and writes it, one store a round.
  constexpr int NP = (2 * TQ + 7) / 8, M = GROUP / 32;
  const unsigned full = 0xffffffffu;
  const uint32_t taken = score_key(NEG);
  const int KO = per_group * NG;
  uint32_t key[NP][M];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int p = warp + 8 * j, q = p >> 1;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      key[j][m] = q < qv ? score_key(sc[q * LDS + (p & 1) * GROUP + 32 * m +
                                        lane])
                         : taken;
    }
  }
  const int pl = warp + 8 * lane, ql = pl >> 1;   // lane j's pair: j = lane
  const bool writes = lane < NP && ql < qv;
  const size_t ol = ((size_t)slab * B + q0 + ql) * KO + 2 * rank + (pl & 1);
  const int rl = col0 + (pl & 1) * GROUP;         // its group's first row
  for (int r = 0; r < per_group; ++r) {
    uint32_t ws = 0u;
    int wr = 0;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      uint32_t lm = key[j][0];
#pragma unroll
      for (int m = 1; m < M; ++m) lm = max(lm, key[j][m]);
      const uint32_t wm = __reduce_max_sync(full, lm);
      int lr = 0x7fffffff;
#pragma unroll
      for (int m = M - 1; m >= 0; --m) {
        lr = key[j][m] == wm ? 32 * m + lane : lr;
      }
      const int br = __reduce_min_sync(full, lr);
      ws = lane == j ? wm : ws;
      wr = lane == j ? br : wr;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        key[j][m] = br == 32 * m + lane ? taken : key[j][m];
      }
    }
    if (writes) {
      out_s[ol + (size_t)r * NG] = key_score(ws);
      out_i[ol + (size_t)r * NG] = rl + wr;
    }
  }
}

// Both f32 entries take the same arguments: (tg, tq, c, valid, out_s,
// out_i, B, twoD, kappa or per_group).
using F32Kernel = void (*)(CUtensorMap, CUtensorMap, const float*,
                           const uint8_t*, float*, int*, int, int, int);

template <int TQ>
F32Kernel f32_kernel(bool group) {
  if (group) return group_topk_f32<TQ>;
  return slab_topk_f32<TQ>;
}

// The units of an f32 entry at query tile TQ resident at once, its shared
// memory set first: clusters of SPLIT CTAs (kernel 1), CTAs (kernel 2).
template <int TQ>
int f32_active(bool group, int* n) {
  const F32Kernel kern = f32_kernel<TQ>(group);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F32Layout<TQ>::SMEM);
  if (e != cudaSuccess) return (int)e;
  if (group) {
    int per_sm = 0, dev = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, F_THREADS, F32Layout<TQ>::SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    *n = per_sm * sms;
    return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(SPLIT);
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = F32Layout<TQ>::SMEM;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

// One launch of an f32 entry: SPLIT CTAs (kernel 1: a cluster) a (query
// tile, slab).
template <int TQ>
int launch_f32_tile(bool group, const CUtensorMap& tg, const void* qq,
                    int twoD4, const void* c, const void* valid, void* out_s,
                    void* out_i, int B, int twoD, int NS, int sel,
                    cudaStream_t stream) {
  CUtensorMap tq;
  const cuuint64_t dq[2] = {(cuuint64_t)twoD4, (cuuint64_t)B};
  if (!tensor_map_f32(&tq, qq, 2, dq, FDK, TQ, true)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(SPLIT, (B + TQ - 1) / TQ, NS);
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = F32Layout<TQ>::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = group ? 0 : 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, f32_kernel<TQ>(group), tg, tq, reinterpret_cast<const float*>(c),
      reinterpret_cast<const uint8_t*>(valid),
      reinterpret_cast<float*>(out_s), reinterpret_cast<int*>(out_i), B,
      twoD, sel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Kernel 1's (group false: sel = kappa) or kernel 2's (group true: sel =
// per_group) f32 entry.
int launch_f32(bool group, const void* qq, const void* gt, const void* c,
               const void* valid, void* out_s, void* out_i, int B, int twoD,
               int Sp, int sel, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(qq) | reinterpret_cast<uintptr_t>(gt)) &
      15u) {
    return (int)cudaErrorInvalidValue;
  }
  // units of each query tile resident at once, by entry and device (0: not
  // asked)
  static int active[2][MAX_DEVICES][F_TILES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int* act = active[group][dev];
  if (act[0] == 0) {
    int rc = f32_active<1>(group, &act[0]);
    if (rc == 0) rc = f32_active<8>(group, &act[1]);
    if (rc == 0) rc = f32_active<16>(group, &act[2]);
    if (rc == 0) rc = f32_active<32>(group, &act[3]);
    if (rc == 0) rc = f32_active<64>(group, &act[4]);
    if (rc != 0) {
      act[0] = 0;
      return rc;
    }
    for (int t = 0; t < F_TILES; ++t) {
      if (act[t] <= 0) {
        act[0] = 0;
        return (int)cudaErrorInvalidConfiguration;
      }
    }
  }
  // The query tile whose waves of units cost least: a CTA's products take
  // time in proportion to TQ from TQ = 8 on (a 1-query tile about half an
  // 8-query one's), beside a fixed part (the stream's latency, the
  // selection) worth F_FIXED queries (tuned on the card against every tile
  // at the served shapes).
  const int NS = Sp / SLAB, units = group ? SPLIT : 1;
  int tile = 0;
  double best = 0.0;
  for (int t = 0; t < F_TILES; ++t) {
    const int TQ = t == 0 ? 1 : 4 << t;
    const double need = (double)NS * ((B + TQ - 1) / TQ) * units;
    const double cost = std::ceil(need / act[t]) *
                        ((TQ == 1 ? 4 : TQ) + F_FIXED);
    if (t == 0 || cost < best) {
      best = cost;
      tile = t;
    }
  }
  CUtensorMap tg;
  const cuuint64_t dg[2] = {(cuuint64_t)Sp, (cuuint64_t)twoD};
  if (!tensor_map_f32(&tg, gt, 2, dg, NTC, FDK, false)) {
    return (int)cudaErrorInvalidValue;
  }
  const int twoD4 = (twoD + 3) / 4 * 4;
  switch (tile) {
    case 0:
      return launch_f32_tile<1>(group, tg, qq, twoD4, c, valid, out_s,
                                out_i, B, twoD, NS, sel, stream);
    case 1:
      return launch_f32_tile<8>(group, tg, qq, twoD4, c, valid, out_s,
                                out_i, B, twoD, NS, sel, stream);
    case 2:
      return launch_f32_tile<16>(group, tg, qq, twoD4, c, valid, out_s,
                                 out_i, B, twoD, NS, sel, stream);
    case 3:
      return launch_f32_tile<32>(group, tg, qq, twoD4, c, valid, out_s,
                                 out_i, B, twoD, NS, sel, stream);
    default:
      return launch_f32_tile<64>(group, tg, qq, twoD4, c, valid, out_s,
                                 out_i, B, twoD, NS, sel, stream);
  }
}
// -- kernel 1 at scale: the pruned pool -------------------------------------
//
// Where a query's pool c is far smaller than the per-slab pools NS kappa,
// the pool is taken in four launches, none of which writes a per-slab pool:
//   * pass A (slab_topk_prune<false>): the sweep, and each 64-row group's
//     maximum in registers (a lane pair's columns, one shuffle) as an
//     order-preserving key, into gv (B, n), n = 32 NS;
//   * the bound (slab_topk_bound): each query's c-th largest of its n group
//     keys, by a radix select of four 8-bit passes over gv; the group
//     values are scores of distinct rows, so it is at most the query's
//     c-th score (key 0, no bound, where n < c).  It also zeroes the
//     survivor counts and the overflow count;
//   * pass B (slab_topk_prune<true>): the same sweep again, so that
//     every row's score is pass A's bit for bit, and each row whose score
//     is finite and at or above its query's bound goes out as one 64-bit
//     key (score key above, the inverted row id below: larger is higher,
//     then lower id) into the query's buffer of ``cap``, at a slot from a
//     counter a query that counts past cap;
//   * the final selection (slab_topk_final): a CTA a query sorts its
//     min(count, cap) keys (bitonic, in shared memory, padded with 0) and
//     writes the top k: the exact top k, ties to the lower id, whatever
//     order the slots were taken in; slots past the survivors are -inf with
//     id -1.  A query with more than cap survivors adds one to the overflow
//     count, and the caller answers its chunk by the per-slab pools.
// The sweep of both passes is kernel 1's and 2's (an item: 64 queries x
// 256 columns, two warpgroups of m64n128k16 wgmma over 64-deep chunks in
// order), so their scores are kernel 1's bit for bit.  Both passes hold a
// block's GT resident (2D <= 320, nk <= 5 chunks; ops/fused_topk.py sends
// no wider index here): a CTA walks the 256-column blocks and holds a
// block's GT chunks in shared memory while it sweeps every query tile
// against them, streaming only the query boxes; GT then comes from device
// memory once and each query box once a block, where kernel 2's items
// fetch both for every (block, tile) from L2 (160 KB an item at B = 1024,
// 2D = 256, which held pass A at 5 TB/s of L2 and 1.5 ms).  The bias comes
// folded: cm = c, or -inf for an invalid row.
//
// What bounds it at the batch cell's shapes (B = 1024, 1M rows, c = 512;
// measured on an "NVIDIA H100 80GB HBM3, 700.00 W"): the products alone run
// near the bf16 peak (a pass with no epilogue: 0.62 ms for 0.55 TFLOP),
// and the epilogues, which the two warpgroups run while the tensor cores
// wait, take the rest: pass A 1.26 ms, pass B 1.62 ms, the bound and the
// final selection 0.11 ms each, over the path-score index (2D = 256);
// 0.78 and 1.10 ms over the backstop's store (2D = 128).  So the epilogues
// are kept short: the bias is one load and add a score; pass A's maximum
// is a running maximum and a shuffle; pass B holds a lane's best score of a
// row against the bound before it looks at each (about 2% of lanes hold a
// survivor) and loads the bound before the products, whose latency it then
// hides (1.2 ms of pass B when loaded after them); survivors leave by a
// loop over set bits (an unrolled one doubled pass B: code size).

// Pass B's survivors are staged in shared memory, a buffer a warpgroup:
// a warp reserves its slots by one shared atomic, and the warpgroup
// flushes the buffer to the queries' global buffers (one global atomic an
// entry) once it holds FLUSH_AT keys, so that no returning global atomic
// sits on an item's path.  An entry that finds the buffer full goes out
// directly.
constexpr int STAGE_N = 512;              // staged survivors a warpgroup
constexpr int FLUSH_AT = 256;             // flush from this many on
constexpr int STAGING = 2 * STAGE_N * 12 + 16;
constexpr int RES_MAX_NK = 5;             // GT chunks a resident block holds
constexpr int RES_MAX_QST = 8;            // query boxes in flight
constexpr int PG_SLAB = SLAB / 64;        // pass A's groups of a slab

struct Staging {
  unsigned long long key[2][STAGE_N];
  int q[2][STAGE_N];
  int count[2];
};

// Shared memory of a pass: a 256-column block's GT chunks (nk x 32 KB), a
// ring of ``s`` query boxes, the staging and the mbarriers (full and empty
// a ring stage; full and empty a GT chunk).
struct PruneLayout {
  int ring, staging, bars, total;
  __host__ __device__ PruneLayout(int nk, int s)
      : ring(nk * GBOXES), staging(ring + s * QBOX),
        bars(staging + (STAGING + 15) / 16 * 16),
        total(1024 + bars + 16 * s + 16 * nk) {}
};

// A bound's key as the least score that reaches it: the key's own score
// (a score reaches the key iff it is at or above that score, -0 and +0
// alike); key 0 (no bound) or -inf's: the least finite score, so that no
// -inf (an invalid row's) goes out.
__device__ __forceinline__ float bound_score(uint32_t k) {
  return k <= score_key(__int_as_float(0xff800000)) ? -3.4028235e38f
                                                    : key_score(k);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;" :: "r"(id) : "memory");
}

// a barrier of the warpgroup (named barrier ``id``): whether any of its
// threads passes ``p``
__device__ __forceinline__ bool bar_any(int id, bool p) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred a, b;\nsetp.ne.u32 a, %1, 0;\n"
      "bar.red.or.pred b, %2, 128, a;\nselp.u32 %0, 1, 0, b;\n}\n"
      : "=r"(r) : "r"((uint32_t)p), "r"(id) : "memory");
  return r != 0;
}

__device__ __forceinline__ void put_survivor(Staging* st, int wg, int pos,
                                             unsigned long long key, int q,
                                             int* cnt,
                                             unsigned long long* surv,
                                             int cap) {
  if (pos < STAGE_N) {
    st->key[wg][pos] = key;
    st->q[wg][pos] = q;
  } else {
    const int slot = atomicAdd(&cnt[q], 1);
    if (slot < cap) surv[(size_t)q * cap + slot] = key;
  }
}

// The warpgroup's staged survivors to their queries' buffers.
__device__ __forceinline__ void flush_staged(Staging* st, int wg, int n,
                                             int* cnt,
                                             unsigned long long* surv,
                                             int cap) {
  const int t = threadIdx.x & (WG - 1);
  for (int e = t; e < min(n, STAGE_N); e += WG) {
    const int q = st->q[wg][e];
    const int slot = atomicAdd(&cnt[q], 1);
    if (slot < cap) surv[(size_t)q * cap + slot] = st->key[wg][e];
  }
}

// One item's epilogue of a consumer warpgroup: + cm on its 64 x 128 scores
// (columns from gc0, rows qa and qb of this lane), then pass A's group
// maxima into gv (this lane pair's group at ga), or pass B's survivors
// into the staging.
template <bool SURVIVE>
__device__ __forceinline__ void prune_item(
    float* acc, const float* __restrict__ cm, int gc0, int qa, int qb, int B,
    int NS, size_t ga, uint32_t* __restrict__ gv,
    uint32_t ka, uint32_t kb, int* __restrict__ cnt,
    unsigned long long* __restrict__ surv, int cap, Staging* st, int wg) {
  const int lane = threadIdx.x & 31, cq = lane & 3;
  const unsigned full = 0xffffffffu;
  // this lane's column 8j + 2cq + e is acc[4j + e] for row qa, acc[4j + 2
  // + e] for row qb; + cm: the column's c, or -inf where it is invalid
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cb = cm[gc0 + 8 * j + 2 * cq + e];
      acc[4 * j + e] += cb;
      acc[4 * j + 2 + e] += cb;
    }
  }
  if constexpr (!SURVIVE) {
    // the group's maximum alone: its value, no column; the even lane of
    // the pair writes row qa's, the odd lane row qb's
    const size_t n = (size_t)NS * PG_SLAB;
    float va = acc[0], vb = acc[2];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        va = fmaxf(va, acc[4 * j + e]);
        vb = fmaxf(vb, acc[4 * j + 2 + e]);
      }
    }
    va = fmaxf(va, __shfl_xor_sync(full, va, 1));
    vb = fmaxf(vb, __shfl_xor_sync(full, vb, 1));
    if ((cq & 1) == 0 && qa < B) gv[(size_t)qa * n + ga] = score_key(va);
    if ((cq & 1) == 1 && qb < B) gv[(size_t)qb * n + ga] = score_key(vb);
  } else {
    // Pass B: the rows' bounds ka, kb (loaded before the sweep) as the
    // least score that reaches them (a row past the batch: NaN, which no
    // score reaches); bit 2j + e of fa / fb: the row goes out.  The lane's
    // best score of a row is held against its bound first: most lanes
    // hold no survivor
    const float la = qa < B ? bound_score(ka) : __int_as_float(0x7fc00000);
    const float lb = qb < B ? bound_score(kb) : __int_as_float(0x7fc00000);
    float ma = acc[0], mb = acc[2];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ma = fmaxf(ma, acc[4 * j + e]);
        mb = fmaxf(mb, acc[4 * j + 2 + e]);
      }
    }
    uint32_t fa = 0u, fb = 0u;
    if (ma >= la) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          fa |= acc[4 * j + e] >= la ? 1u << (2 * j + e) : 0u;
        }
      }
    }
    if (mb >= lb) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          fb |= acc[4 * j + 2 + e] >= lb ? 1u << (2 * j + e) : 0u;
        }
      }
    }
    const int nl = __popc(fa) + __popc(fb);
    if (__any_sync(full, nl != 0)) {
      // the warp's slots in the staging: an inclusive scan of its lanes'
      // counts, one shared atomic
      int incl = nl;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(full, incl, off);
        if (lane >= off) incl += t;
      }
      int base = 0;
      if (lane == 31) base = atomicAdd(&st->count[wg], incl);
      int pos = __shfl_sync(full, base, 31) + incl - nl;
      // the lane's scores by bit, for the loops over its set bits (an
      // indexed read: local memory, on this rare path only; unrolled
      // emission took twice as long, from its code's size)
      float sa[32], sb[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sa[2 * j + e] = acc[4 * j + e];
          sb[2 * j + e] = acc[4 * j + 2 + e];
        }
      }
      for (uint32_t f = fa; f; f &= f - 1u) {
        const int i = __ffs(f) - 1;
        const uint32_t row = gc0 + 8 * (i >> 1) + 2 * cq + (i & 1);
        put_survivor(st, wg, pos++,
                     (unsigned long long)score_key(sa[i]) << 32 | ~row, qa,
                     cnt, surv, cap);
      }
      for (uint32_t f = fb; f; f &= f - 1u) {
        const int i = __ffs(f) - 1;
        const uint32_t row = gc0 + 8 * (i >> 1) + 2 * cq + (i & 1);
        put_survivor(st, wg, pos++,
                     (unsigned long long)score_key(sb[i]) << 32 | ~row, qb,
                     cnt, surv, cap);
      }
    }
    // the warpgroup's staging: flushed once it holds FLUSH_AT keys (each
    // warp reads the count after its own reservation, so the or of the
    // warps' reads sees the last one)
    if (bar_any(1 + wg, st->count[wg] >= FLUSH_AT)) {
      flush_staged(st, wg, st->count[wg], cnt, surv, cap);
      bar_sync(1 + wg);
      if ((threadIdx.x & (WG - 1)) == 0) st->count[wg] = 0;
      bar_sync(1 + wg);
    }
  }
}

// The resident sweep of a consumer warpgroup: query tile chunks g0 .. g0 +
// nk - 1 of the ring (query boxes) against the block's resident GT chunks
// (chunk k full at parity ``gpar``), each ring stage released once read,
// and each GT chunk too where ``last`` (the block's last query tile).
__device__ __forceinline__ void sweep_resident(float* acc, uint32_t gt0,
                                               uint32_t ring0, uint32_t full0,
                                               uint32_t empty0, int stages,
                                               uint32_t gfull0,
                                               uint32_t gempty0,
                                               uint32_t gpar, bool last,
                                               uint32_t g0, int nk, int wg) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const uint32_t g = g0 + k, s = g % stages;
    mbar_wait(full0 + 8 * s, g / stages & 1u);
    mbar_wait(gfull0 + 8 * k, gpar);
    const uint32_t a = ring0 + s * QBOX;
    const uint32_t b = gt0 + k * GBOXES + wg * 2 * KC * ROWB;
    fence_regs<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      wgmma_ss_tb_n128(acc, smem_desc(a + ks * 32, 16),
                       smem_desc(b + ks * 16 * ROWB, KC * ROWB));
    }
    wgmma_commit();
    wgmma_wait<1>();                      // chunk k - 1 is read
    if (k > 0) {
      mbar_arrive(empty0 + 8 * ((g - 1) % stages));
      if (last) mbar_arrive(gempty0 + 8 * (k - 1));
    }
  }
  wgmma_wait<0>();
  fence_regs<64>(acc);
  mbar_arrive(empty0 + 8 * ((g0 + nk - 1) % stages));
  if (last) mbar_arrive(gempty0 + 8 * (nk - 1));
}

// Passes A and B (SURVIVE): a CTA walks the 256-column blocks, holds each
// block's GT chunks while it sweeps every query tile against them, and
// streams only the query boxes; the GT then comes from device memory once
// and the query boxes (B x 2D) once a block.  The wgmma sequence of an
// item is kernel 1's and 2's: the same scores bit for bit.
template <bool SURVIVE>
__global__ void __launch_bounds__(W_THREADS, 1)
slab_topk_prune(const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tq,
                const float* __restrict__ cm,
                uint32_t* __restrict__ gv, const uint32_t* __restrict__ bound,
                int* __restrict__ cnt, unsigned long long* __restrict__ surv,
                int B, int twoD, int NS, int cap, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  const int nk = (twoD + KC - 1) / KC;
  const PruneLayout lay(nk, stages);
  const uint32_t b0 = smem_u32(base);
  const uint32_t ring0 = b0 + lay.ring, full0 = b0 + lay.bars;
  const uint32_t empty0 = full0 + 8 * stages;
  const uint32_t gfull0 = empty0 + 8 * stages, gempty0 = gfull0 + 8 * nk;
  Staging* st = reinterpret_cast<Staging*>(base + lay.staging);
  const int ntiles = (B + WTQ - 1) / WTQ;
  const int blocks = NS * SPLIT;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, W_CONSUMERS);
    }
    for (int k = 0; k < nk; ++k) {
      mbar_init(gfull0 + 8 * k, 1);
      mbar_init(gempty0 + 8 * k, W_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    st->count[0] = st->count[1] = 0;
  }
  __syncthreads();

  if (tid >= W_CONSUMERS) {
    // -- producer (one thread)
    if (tid != W_CONSUMERS) return;
    uint32_t g = 0;
    int lb = 0;
    for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x, ++lb) {
      const int col0 = blk * NTC;
      for (int t = 0; t < ntiles; ++t) {
        for (int k = 0; k < nk; ++k, ++g) {
          if (t == 0) {                     // the block's GT chunk k
            const uint32_t gf = gfull0 + 8 * k;
            if (lb > 0) mbar_wait(gempty0 + 8 * k, (lb - 1) & 1);
            mbar_expect_tx(gf, GBOXES);
            const uint32_t dst = b0 + k * GBOXES;
            for (int b = 0; b < NTC / BOXC; ++b) {
              tma_2d(dst + b * KC * ROWB, &tg, col0 + b * BOXC, k * KC, gf);
            }
          }
          const uint32_t s = g % stages;
          if (g >= (uint32_t)stages) {
            mbar_wait(empty0 + 8 * s, (g / stages & 1u) ^ 1u);
          }
          mbar_expect_tx(full0 + 8 * s, QBOX);
          tma_2d(ring0 + s * QBOX, &tq, k * BOXC, t * WTQ, full0 + 8 * s);
        }
      }
    }
    return;
  }

  // -- consumers: each item's scores in registers, then its epilogue
  const int wg = tid >> 7, lane = tid & 31;
  const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int cq = lane & 3;
  float acc[64];
  uint32_t g = 0;
  int lb = 0;                                          // blocks so far
  for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x, ++lb) {
    const int slab = blk / SPLIT, wb = blk % SPLIT * 2 + wg;
    const int gc0 = slab * SLAB + wb * GROUP;           // the WG's columns
    const size_t ga = (size_t)slab * PG_SLAB + wb * 2 + (cq >> 1);
    for (int t = 0; t < ntiles; ++t, g += nk) {
      const int qa = t * WTQ + r0, qb = qa + 8;
      // pass B's bounds, loaded while the products run
      const uint32_t ka = SURVIVE && qa < B ? bound[qa] : 0u;
      const uint32_t kb = SURVIVE && qb < B ? bound[qb] : 0u;
      sweep_resident(acc, b0, ring0, full0, empty0, stages, gfull0, gempty0,
                     lb & 1, t == ntiles - 1, g, nk, wg);
      prune_item<SURVIVE>(acc, cm, gc0, qa, qb, B, NS, ga, gv, ka, kb, cnt,
                          surv, cap, st, wg);
    }
  }
  if constexpr (SURVIVE) {
    bar_sync(1 + wg);                      // the last items' staging
    flush_staged(st, wg, st->count[wg], cnt, surv, cap);
  }
}

constexpr int BOUND_THREADS = 512;

// The bound: CTA q takes query q's k-th largest of its n keys (n a multiple
// of 4, the row 16-byte aligned), a radix select of four 8-bit digits from
// the top, each pass counting the keys that match the digits taken so far
// (one shared atomic a distinct digit and warp: __match_any_sync); then
// the survivor count of the query, and the overflow count, to zero.
__global__ void __launch_bounds__(BOUND_THREADS)
slab_topk_bound(const uint32_t* __restrict__ gv, int n, int k,
                uint32_t* __restrict__ bound, int* __restrict__ cnt,
                int* __restrict__ over) {
  __shared__ uint32_t hist[BINS];
  __shared__ uint32_t pick[2];              // the digits so far, rank left
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const unsigned full = 0xffffffffu;
  if (tid == 0) {
    cnt[q] = 0;
    if (q == 0) *over = 0;
  }
  if (n < k) {                              // fewer keys than k: no bound
    if (tid == 0) bound[q] = 0u;
    return;
  }
  const uint4* row = reinterpret_cast<const uint4*>(gv + (size_t)q * n);
  uint32_t prefix = 0u, mask = 0u, rem = (uint32_t)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < BINS; i += BOUND_THREADS) hist[i] = 0u;
    __syncthreads();
    for (int b = 0; b < n / 4; b += BOUND_THREADS) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const bool in = b + tid < n / 4;
      if (in) v = row[b + tid];
      const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t d = in && (x[e] & mask) == prefix
                               ? (x[e] >> shift) & (BINS - 1) : BINS;
        const unsigned peers = __match_any_sync(full, d);
        if (d < BINS && lane == __ffs(peers) - 1) {
          atomicAdd(&hist[d], (uint32_t)__popc(peers));
        }
      }
    }
    __syncthreads();
    if (tid < 32) {
      // lane l sums digits 255 - 8l down to 248 - 8l; the digit of the
      // rem-th largest key, and the keys above it
      uint32_t own[8], sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        own[j] = hist[BINS - 1 - 8 * lane - j];
        sum += own[j];
      }
      uint32_t cum = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t t = __shfl_up_sync(full, cum, off);
        if (lane >= off) cum += t;
      }
      const int L = __ffs(__ballot_sync(full, cum >= rem)) - 1;
      if (lane == L) {
        uint32_t at = cum - sum;
        int j = 0;
        for (; j < 7; ++j) {
          if (at + own[j] >= rem) break;
          at += own[j];
        }
        pick[0] = (uint32_t)(BINS - 1 - 8 * lane - j);
        pick[1] = rem - at;
      }
    }
    __syncthreads();
    prefix |= pick[0] << shift;
    mask |= (uint32_t)(BINS - 1) << shift;
    rem = pick[1];
    __syncthreads();                        // pick is read before rewritten
  }
  if (tid == 0) bound[q] = prefix;
}

constexpr int FINAL_THREADS = 1024;

// The final selection: CTA q sorts query q's min(count, cap) survivor keys
// descending (bitonic over P, the next power of two of that count and k,
// padded with 0, below every key) and writes the first k.
__global__ void __launch_bounds__(FINAL_THREADS)
slab_topk_final(const unsigned long long* __restrict__ surv,
                const int* __restrict__ cnt, int cap, int k,
                float* __restrict__ out_s, int* __restrict__ out_i,
                int* __restrict__ over) {
  extern __shared__ unsigned long long keys[];
  const int q = blockIdx.x, tid = threadIdx.x;
  int m = cnt[q];
  if (m > cap) {
    if (tid == 0) atomicAdd(over, 1);
    m = cap;
  }
  int P = 2;
  while (P < m || P < k) P <<= 1;
  const unsigned long long* src = surv + (size_t)q * cap;
  for (int i = tid; i < P; i += FINAL_THREADS) keys[i] = i < m ? src[i] : 0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += FINAL_THREADS) {
        const int ij = i ^ j;
        if (ij > i) {
          const unsigned long long a = keys[i], b = keys[ij];
          if ((i & size) == 0 ? a < b : a > b) {
            keys[i] = b;
            keys[ij] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < k; r += FINAL_THREADS) {
    const unsigned long long x = keys[r];
    out_s[(size_t)q * k + r] =
        x ? key_score((uint32_t)(x >> 32)) : __int_as_float(0xff800000);
    out_i[(size_t)q * k + r] = x ? (int)~(uint32_t)x : -1;
  }
}

int prune_launch(bool survive, const void* qq, const void* gt, const void* cm,
                 void* gv, const void* bound, void* cnt, void* surv, int B,
                 int twoD, int Sp, int cap, cudaStream_t stream) {
  CUtensorMap tg, tq;
  if (!wgmma_maps(&tg, &tq, qq, gt, B, twoD, Sp)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nk = (twoD + KC - 1) / KC;
  if (nk > RES_MAX_NK) return (int)cudaErrorInvalidValue;
  int stages = 2;
  while (stages < RES_MAX_QST &&
         PruneLayout(nk, stages + 1).total <= SMEM_LIMIT) {
    ++stages;
  }
  const int smem = PruneLayout(nk, stages).total;
  using Kern = void (*)(CUtensorMap, CUtensorMap, const float*, uint32_t*,
                        const uint32_t*, int*, unsigned long long*, int, int,
                        int, int, int);
  const Kern kern = survive ? slab_topk_prune<true> : slab_topk_prune<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  static int sms[64] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (sms[dev & 63] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev & 63], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = Sp / SLAB * SPLIT;
  const int grid = blocks < sms[dev & 63] ? blocks : sms[dev & 63];
  kern<<<grid, W_THREADS, smem, stream>>>(
      tg, tq, reinterpret_cast<const float*>(cm),
      reinterpret_cast<uint32_t*>(gv),
      reinterpret_cast<const uint32_t*>(bound), reinterpret_cast<int*>(cnt),
      reinterpret_cast<unsigned long long*>(surv), B, twoD, Sp / SLAB, cap,
      stages);
  return (int)cudaGetLastError();
}

// Passes A and B and the bound between them, on one stream.
int launch_prune(const void* qq, const void* gt, const void* cm, void* gv,
                 void* bound, void* cnt, void* surv, void* over, int B,
                 int twoD, int Sp, int k, int cap, cudaStream_t stream) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  int rc = prune_launch(false, qq, gt, cm, gv, bound, cnt, surv, B, twoD, Sp,
                        cap, stream);
  if (rc != 0) return rc;
  slab_topk_bound<<<B, BOUND_THREADS, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(gv), Sp / SLAB * PG_SLAB, k,
      reinterpret_cast<uint32_t*>(bound), reinterpret_cast<int*>(cnt),
      reinterpret_cast<int*>(over));
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return prune_launch(true, qq, gt, cm, gv, bound, cnt, surv, B, twoD, Sp,
                      cap, stream);
}

int launch_final(const void* surv, const void* cnt, void* out_s, void* out_i,
                 void* over, int B, int cap, int k, cudaStream_t stream) {
  int P = 2;
  while (P < cap || P < k) P <<= 1;
  const int smem = P * 8;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      slab_topk_final, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  slab_topk_final<<<B, FINAL_THREADS, smem, stream>>>(
      reinterpret_cast<const unsigned long long*>(surv),
      reinterpret_cast<const int*>(cnt), cap, k,
      reinterpret_cast<float*>(out_s), reinterpret_cast<int*>(out_i),
      reinterpret_cast<int*>(over));
  return (int)cudaGetLastError();
}
}  // namespace

// bf16: qq's rows are padded to a multiple of 8 elements (the query boxes
// come by TMA), the pad zero; ops/fused_topk.py pads them.
extern "C" int fused_topk_bf16(const void* qq, const void* gt, const void* c,
                               const void* valid, void* out_s, void* out_i,
                               int B, int twoD, int Sp, int kappa,
                               void* stream) {
  return launch_topk(qq, gt, c, valid, out_s, out_i, B, twoD, Sp, kappa,
                     reinterpret_cast<cudaStream_t>(stream));
}

// f32: qq's rows are padded to a multiple of 4 elements, 16-byte aligned
// (the query boxes come by TMA), the pad zero; ops/fused_topk.py pads them.
extern "C" int fused_topk_f32(const void* qq, const void* gt, const void* c,
                              const void* valid, void* out_s, void* out_i,
                              int B, int twoD, int Sp, int kappa,
                              void* stream) {
  return launch_f32(false, qq, gt, c, valid, out_s, out_i, B, twoD, Sp,
                    kappa, reinterpret_cast<cudaStream_t>(stream));
}

#ifdef FUSED_GUESS_STATS
// Kernel 1's guessed windows since the last call: out[0] held, out[1]
// missed; the counts restart at 0.
extern "C" int read_guess_stats(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_guess, sizeof(g_guess));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[2] = {0ull, 0ull};
  return (int)cudaMemcpyToSymbol(g_guess, zero, sizeof(zero));
}
#endif

// Group pool: out_s/out_i (NS, B, per_group * 16), 1 <= per_group <= 128;
// qq padded as for fused_topk_bf16 or fused_topk_f32.
extern "C" int fused_group_topk_bf16(const void* qq, const void* gt,
                                     const void* c, const void* valid,
                                     void* out_s, void* out_i, int B,
                                     int twoD, int Sp, int per_group,
                                     void* stream) {
  return launch_group(qq, gt, c, valid, out_s, out_i, B, twoD, Sp, per_group,
                      reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int fused_group_topk_f32(const void* qq, const void* gt,
                                    const void* c, const void* valid,
                                    void* out_s, void* out_i, int B,
                                    int twoD, int Sp, int per_group,
                                    void* stream) {
  return launch_f32(true, qq, gt, c, valid, out_s, out_i, B, twoD, Sp,
                    per_group, reinterpret_cast<cudaStream_t>(stream));
}

// The pruned pool (B, k) of kernel 1: passes A and B and the bound
// (fused_prune_bf16), then the final selection (fused_prune_final).  2D <=
// 320; cm is (Sp,) f32, c where valid and -inf elsewhere; gv is (B, 32 NS)
// uint32, bound and cnt (B,), surv (B, cap) uint64, over one int; qq
// padded as for fused_topk_bf16.
extern "C" int fused_prune_bf16(const void* qq, const void* gt,
                                const void* cm, void* gv, void* bound,
                                void* cnt, void* surv, void* over, int B,
                                int twoD, int Sp, int k, int cap,
                                void* stream) {
  return launch_prune(qq, gt, cm, gv, bound, cnt, surv, over, B, twoD, Sp, k,
                      cap, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int fused_prune_final(const void* surv, const void* cnt,
                                 void* out_s, void* out_i, void* over, int B,
                                 int cap, int k, void* stream) {
  return launch_final(surv, cnt, out_s, out_i, over, B, cap, k,
                      reinterpret_cast<cudaStream_t>(stream));
}
