"""Roofline accounting for the query engines on an NVIDIA H100 (port of
``rag_cobweb_tpu/bench/roofline.py``).

Each engine gets an analytic model of the operations and device-memory
bytes of one batch, the same counts as the JAX module's; combined with a
measured batch time it says whether the engine is bound by its products
or by memory, and what share of the card's roofline it reaches.

Peaks of one H100 SXM (NVIDIA's data sheet, dense rates without
sparsity), which assume the card's full 700 W power limit; a card set
below it runs slower under load, so a share is stated beside the card's
``nvidia-smi`` name and power limit:
  * bf16 on the tensor cores: 989e12 FLOP/s (kernel 1's sweep);
  * float32 on the CUDA cores, TF32 off: 67e12 FLOP/s (the port's full
    f32 products and the re-rank's distances);
  * HBM3: 3.35e12 bytes/s.

The bound of a stage with F operations and Q bytes is
``max(F / peak_flops, Q / peak_bw)``; a row gather is charged its bytes
at the HBM rate (each row read once), a true lower bound.  The card's
measured rate of an ``emb[idx]`` gather is printed beside it by
``chip_smoke.py`` (phase 3k (d)) and recorded in ``PERF.md``.
"""

from __future__ import annotations

from typing import NamedTuple

H100_PEAK_BF16 = 989e12   # FLOP/s, tensor cores, dense
H100_PEAK_F32 = 67e12     # FLOP/s, CUDA cores (TF32 off)
H100_HBM_BW = 3.35e12     # bytes/s
H100_POWER_LIMIT_W = 700.0


def gather_time_s(rows: float, row_bytes: float) -> float:
    """Least time to gather ``rows`` rows of ``row_bytes`` each: their
    bytes at the HBM rate."""
    return rows * row_bytes / H100_HBM_BW


class EngineModel(NamedTuple):
    """Analytic per-batch cost model of one engine invocation."""

    name: str
    flops: float          # total operations for the batch
    hbm_bytes: float      # total device-memory traffic for the batch
    f32_products: bool = True   # the products run in f32 (CUDA cores)
    gather_rows: float = 0.0    # rows gathered by id
    gather_row_bytes: float = 0.0
    # sequential stages: their minima sum, and the dominant one names the
    # bound
    min_time_override_s: float = 0.0
    bound_override: str = ""

    @property
    def intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    @property
    def peak_flops(self) -> float:
        return H100_PEAK_F32 if self.f32_products else H100_PEAK_BF16

    def bound(self) -> str:
        if self.bound_override:
            return self.bound_override
        g = gather_time_s(self.gather_rows, self.gather_row_bytes)
        if g > max(self.flops / self.peak_flops,
                   self.hbm_bytes / H100_HBM_BW):
            return "GATHER"
        ridge = self.peak_flops / H100_HBM_BW
        return "COMPUTE" if self.intensity >= ridge else "HBM"

    def min_time_s(self) -> float:
        if self.min_time_override_s > 0:
            return self.min_time_override_s
        return max(self.flops / self.peak_flops,
                   self.hbm_bytes / H100_HBM_BW,
                   gather_time_s(self.gather_rows, self.gather_row_bytes))

    def report(self, measured_s: float, batch: int) -> dict:
        t = max(measured_s, 1e-12)
        return {
            "engine": self.name,
            "batch": batch,
            "gflops_per_query": round(self.flops / max(batch, 1) / 1e9, 3),
            "achieved_tflops": round(self.flops / t / 1e12, 3),
            "achieved_gbps": round(self.hbm_bytes / t / 1e9, 1),
            "flops_pct": round(100.0 * self.flops / t / self.peak_flops, 2),
            "hbm_pct": round(100.0 * self.hbm_bytes / t / H100_HBM_BW, 1),
            "bound": self.bound(),
            "roofline_min_ms": round(1e3 * self.min_time_s(), 4),
            "measured_ms": round(1e3 * measured_s, 4),
            "roofline_frac": round(self.min_time_s() / t, 3),
            "intensity_flop_per_byte": round(self.intensity, 1),
        }


def exact_flat_model(B: int, S: int, D: int,
                     dtype_bytes: int = 4) -> EngineModel:
    """One (B, D) x (D, S) product + top-k: the corpus once a batch, the
    scores written and read back for the top-k."""
    flops = 2.0 * B * S * D
    hbm = S * D * dtype_bytes + 2.0 * B * S * 4
    return EngineModel("exact_flat", flops, hbm, dtype_bytes == 4)


def blocked_model(B: int, NB: int, M: int, TS: int, D: int,
                  dtype_bytes: int = 4, fused: bool = False) -> EngineModel:
    """Blocked sweep: per block two (B, D) x (D, M) products and one
    (B, M) x (M, TS) path product; the block stats and W once a batch.
    Unfused, the (B, NB, TS) scores are also written and read back for
    the top-k, the traffic the kernel keeps on chip (``fused=True``)."""
    flops = NB * (4.0 * B * M * D + 2.0 * B * M * TS)
    hbm = NB * (2.0 * M * D + M * TS) * dtype_bytes
    if not fused:
        hbm += 2.0 * B * NB * TS * 4
    return EngineModel("kernel_blocked" if fused else "torch_blocked",
                       flops, hbm, dtype_bytes == 4)


def fused_flat_model(B: int, Sp: int, D: int,
                     dtype_bytes: int = 4) -> EngineModel:
    """Fused sweep: one (B, 2D) x (2D, Sp) product + bias + top-k; the
    (2D, Sp) matrix once a batch and the (B, Sp) scores written and read
    back (the unfused accounting: kernel 1 keeps them on chip)."""
    flops = 2.0 * B * Sp * 2 * D
    hbm = 2.0 * D * Sp * dtype_bytes + 2.0 * B * Sp * 4
    return EngineModel("fused_flat", flops, hbm, dtype_bytes == 4)


def model_for_fused_index(fidx, B: int) -> EngineModel:
    TwoD, Sp = fidx.GT.shape
    return fused_flat_model(B, Sp, TwoD // 2,
                            dtype_bytes=fidx.GT.dtype.itemsize)


def product_path_model(B: int, Sp: int, D_tree: int, C: int, D_store: int,
                       gt_dtype_bytes: int = 2, d_raw: int = 0,
                       backstop: int = 0) -> EngineModel:
    """The served path (``CobwebIndex.query_ids``): optional whitening
    product -> fused sweep -> [optional backstop pool] -> exact re-rank
    of C candidates on the stored rows.  The stages run one after the
    other, so the bound is the sum of their minima; the sweep is charged
    at the bf16 peak where its matrix is bf16 (kernel 1), the rest at the
    f32 peak."""
    stage_times = {}
    sweep_peak = H100_PEAK_BF16 if gt_dtype_bytes == 2 else H100_PEAK_F32
    # the sweep writes its scores once; the selection pass reads them
    flops = 2.0 * B * Sp * 2 * D_tree
    hbm = 2.0 * D_tree * Sp * gt_dtype_bytes + B * Sp * 4
    t_sweep = max(flops / sweep_peak, hbm / H100_HBM_BW)
    if d_raw:
        w_flops = 2.0 * B * d_raw * D_tree
        w_hbm = d_raw * D_tree * 4 + B * (d_raw + D_tree) * 4
        flops += w_flops
        hbm += w_hbm
        t_sweep += max(w_flops / H100_PEAK_F32, w_hbm / H100_HBM_BW)
    stage_times["HBM"] = t_sweep
    # the pool selection: a second pass over the (B, Sp) scores
    stage_times["POOL"] = B * Sp * 4 / H100_HBM_BW
    hbm += B * Sp * 4
    if backstop:
        bs_flops = 2.0 * B * Sp * D_tree
        bs_hbm = D_tree * Sp * 2 + B * Sp * 4
        flops += bs_flops
        hbm += bs_hbm + B * Sp * 4
        stage_times["BACKSTOP"] = max(
            bs_flops / H100_PEAK_BF16, bs_hbm / H100_HBM_BW
        ) + B * Sp * 4 / H100_HBM_BW
    # the exact re-rank: `pool` stored rows a query, distance, top-k
    pool = C + (backstop or 0)
    rr_flops = 3.0 * B * pool * D_store
    rr_hbm = B * pool * D_store * 4
    flops += rr_flops
    hbm += rr_hbm
    stage_times["GATHER"] = max(rr_flops / H100_PEAK_F32,
                                gather_time_s(B * pool, D_store * 4))
    dominant = max(stage_times, key=stage_times.get)
    return EngineModel("product_path", flops, hbm, True,
                       gather_rows=float(B * pool),
                       gather_row_bytes=float(D_store * 4),
                       min_time_override_s=sum(stage_times.values()),
                       bound_override=dominant)


def gather_path_model(B: int, S: int, N: int, D: int, P: int) -> EngineModel:
    """Path scores (``core/index.query_topk``): two (B, D) x (D, N)
    products + P gathers of (B, S) from the (B, N) node log-probs."""
    flops = 4.0 * B * N * D + 2.0 * B * S * P
    hbm = 2.0 * N * D * 4 + P * (B * S * 4 + S * 8) + 2.0 * B * S * 4
    return EngineModel("gather_path", flops, hbm)


def beam_model(B: int, depth: int, W: int, F: int, D: int) -> EngineModel:
    """Beam search: a level's (B, W*F) candidate log-probs from gathered
    stats (elementwise) + top-k; two stat rows a (query, candidate)."""
    cand = B * W * F
    flops = depth * cand * 4.0 * D
    hbm = depth * cand * (2.0 * D * 4 + 8)
    return EngineModel("beam", flops, hbm)


def beam_pack_model(B: int, depth: int, C: int, D: int,
                    pack_bytes: int = 4) -> EngineModel:
    """Packed beam (``core/index.beam_pack_topk``): a level's one gather
    of (B, C) packed (2D,) stat rows + a batched (B, C, 2D) dot."""
    cand = B * C
    flops = depth * cand * 4.0 * D
    hbm = depth * cand * (2.0 * D * pack_bytes + 8)
    return EngineModel("beam_pack", flops, hbm)


def leaf_rerank_model(B: int, C: int, D: int) -> EngineModel:
    """Leaf log-prob re-rank of C candidates a query."""
    flops = B * C * 4.0 * D
    hbm = B * C * (2.0 * D * 4 + 8)
    return EngineModel("leaf_rerank", flops, hbm)


def model_for_blocked_index(bidx, B: int, fused: bool) -> EngineModel:
    NB, M, D = bidx.ivt_b.shape
    TS = bidx.W.shape[2]
    return blocked_model(B, NB, M, TS, D,
                         dtype_bytes=bidx.ivt_b.dtype.itemsize,
                         fused=fused)
