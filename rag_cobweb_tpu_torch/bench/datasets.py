"""Benchmark corpora: the synthetic generators of
``rag_cobweb_tpu/bench/datasets.py``, copied byte for byte so both
packages draw the same corpus from the same seed.

The generators are host numpy; the engine moves the arrays to the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RetrievalDataset(NamedTuple):
    """corpus[i] are indexable passages; queries[j] should retrieve
    targets[j] (which is a member of corpus)."""

    corpus: list
    queries: list
    targets: list
    name: str


class SyntheticEmbeddings(NamedTuple):
    corpus_embs: np.ndarray    # (C, D)
    query_embs: np.ndarray     # (T, D)
    target_ids: np.ndarray     # (T,) index into corpus of the gold passage
    name: str


def synthetic_retrieval(corpus_size: int = 10000, target_size: int = 1000,
                        dim: int = 768, n_clusters: int = 128,
                        noise: float = 0.35, query_noise: float = 0.25,
                        anisotropy: float = 0.85,
                        seed: int = 0) -> SyntheticEmbeddings:
    """Hermetic stand-in for encoder embeddings: anisotropic Gaussian-mixture
    vectors mimicking sentence-embedding geometry (a few dominant directions
    carry most variance — exactly the pathology PCA+ICA whitening fixes,
    SURVEY.md §6 'key readings').

    Queries are noisy copies of ``target_size`` random corpus rows, so the
    gold neighbor is known by construction.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim))
    assign = rng.integers(0, n_clusters, size=corpus_size)
    corpus = centers[assign] + noise * rng.normal(size=(corpus_size, dim))
    # anisotropy: squash most dimensions so a few directions dominate
    scales = np.where(
        np.arange(dim) < max(4, dim // 24), 1.0,
        (1.0 - anisotropy) + anisotropy * np.exp(
            -np.arange(dim) / (dim / 6.0))
    )
    corpus = corpus * scales[None, :]
    target_ids = rng.choice(corpus_size, size=target_size, replace=False)
    queries = corpus[target_ids] + query_noise * scales[None, :] * rng.normal(
        size=(target_size, dim)
    )
    return SyntheticEmbeddings(
        corpus.astype(np.float32), queries.astype(np.float32),
        target_ids.astype(np.int64), f"synth_c{corpus_size}_d{dim}"
    )


def synthetic_retrieval_hard(corpus_size: int = 10000,
                             target_size: int = 1000, dim: int = 768,
                             n_clusters: int = 64, noise: float = 1.0,
                             query_noise: float = 0.55,
                             query_noise_spread: float = 0.30,
                             dup_targets_frac: float = 0.25,
                             dup_group: int = 30,
                             dup_noise_min: float = 0.02,
                             dup_noise_max: float = 0.5,
                             df: float = 5.0, anisotropy: float = 0.85,
                             seed: int = 0) -> SyntheticEmbeddings:
    """Calibrated HARD retrieval distribution: exact flat recall@10 lands
    ~0.9 at c=10k (matching the reference's hard regime — QQP roberta
    c10000: FAISS recall@10 = 0.913, BASELINE.md) so the
    cobweb-vs-exact delta is a metric that can actually move, instead of
    the saturated ~1.000 of ``synthetic_retrieval``.

    Three difficulty mechanisms, mirroring what makes QQP hard:

      * **overlapping clusters**: cluster centers at unit scale with
        unit-scale intra-cluster noise — no margin between clusters;
      * **heavy-tailed noise**: Student-t (``df``) intra-cluster and query
        noise, so a tail of queries lands far from its gold row;
      * **near-duplicate distractor groups at controlled margins**:
        ``dup_targets_frac`` of the gold targets get ``dup_group``
        near-copies planted in the corpus — the analog of QQP's
        paraphrase clusters.  A dup at
        radius r (in units of the query offset) beats the gold with
        probability ~Phi(-r*sqrt(2*D_eff)/2), a transition that lives
        entirely in r ~ [0, ~0.1] at these dimensions; per-group radii
        are drawn LOG-UNIFORM in [dup_noise_min, dup_noise_max] so the
        groups span a margin spectrum: the tightest defeat even exact
        search, and the marginal ones are exactly where an engine with
        extra score noise (approximate sweeps, bf16, path-score
        calibration) loses recall first — the discriminative band the
        saturated easy dataset lacks.

    Per-query difficulty is log-normal (``query_noise_spread``); in
    isolation the high-D concentration keeps the gold nearest (verified:
    recall 1.0 without dup groups even at query_noise=1.5), so the dup
    margins carry the difficulty by design.
    """
    rng = np.random.default_rng(seed)

    def tnoise(shape):
        t = rng.standard_t(df, size=shape)
        return (t / np.sqrt(df / (df - 2.0))).astype(np.float32)

    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=corpus_size)
    if corpus_size <= 2_000_000:
        corpus = centers[assign] + noise * tnoise((corpus_size, dim))
    else:
        # chunked fill: one ``standard_t`` draw materializes an f64
        # intermediate (2x corpus bytes) plus the gathered-centers copy —
        # at 8M x 768 the one-shot form peaked ~100 GB of host RAM and
        # the generation was OOM-killed.  The chunked stream consumes the
        # same variates in the same order; small sizes keep the one-shot
        # path so their cached corpora stay byte-identical.
        corpus = np.empty((corpus_size, dim), np.float32)
        CH = 1 << 20
        for s in range(0, corpus_size, CH):
            n = min(CH, corpus_size - s)
            corpus[s:s + n] = centers[assign[s:s + n]] \
                + noise * tnoise((n, dim))

    # anisotropy: same spectral shaping as synthetic_retrieval — a few
    # dominant directions (what PCA+ICA whitening is for)
    scales = np.where(
        np.arange(dim) < max(4, dim // 24), 1.0,
        (1.0 - anisotropy) + anisotropy * np.exp(
            -np.arange(dim) / (dim / 6.0))
    ).astype(np.float32)

    target_ids = rng.choice(corpus_size, size=target_size, replace=False)

    # per-query noise scale: lognormal spread around query_noise
    qscale = (query_noise * np.exp(
        query_noise_spread * rng.normal(size=(target_size, 1))
    )).astype(np.float32)
    queries = corpus[target_ids] + qscale * tnoise((target_size, dim))

    # near-duplicate groups: overwrite non-target corpus rows with
    # near-copies of a subset of targets, at radius dup_noise * qscale
    n_dup_t = int(round(dup_targets_frac * target_size))
    n_dup_rows = n_dup_t * dup_group
    free = np.setdiff1d(np.arange(corpus_size), target_ids,
                        assume_unique=False)
    if n_dup_rows > len(free):
        n_dup_t = len(free) // max(dup_group, 1)
        n_dup_rows = n_dup_t * dup_group
    if n_dup_t > 0:
        dup_t = rng.choice(target_size, size=n_dup_t, replace=False)
        slots = rng.choice(free, size=n_dup_rows, replace=False)
        src = np.repeat(target_ids[dup_t], dup_group)
        # per-group margin: log-uniform radius spectrum
        r_group = np.exp(rng.uniform(
            np.log(dup_noise_min), np.log(dup_noise_max), size=(n_dup_t, 1)
        )).astype(np.float32)
        radius = np.repeat(qscale[dup_t] * r_group, dup_group, axis=0)
        corpus[slots] = corpus[src] + radius * tnoise((n_dup_rows, dim))

    corpus *= scales[None, :]     # in-place: no second corpus-size copy
    queries = queries * scales[None, :]
    return SyntheticEmbeddings(
        corpus.astype(np.float32, copy=False),
        queries.astype(np.float32, copy=False),
        target_ids.astype(np.int64), f"synthhard_c{corpus_size}_d{dim}"
    )
