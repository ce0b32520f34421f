"""Benchmark corpora (port of ``rag_cobweb_tpu/bench/datasets.py``,
copied so both packages draw the same data from the same seed):

  * hand-written sample corpora (topic paragraphs + user-profile
    memories) for smoke tests and the visualization scripts;
  * QQP duplicate-question pairs and MS-MARCO selected-passage pairs ->
    (corpus, queries, targets), and STS-B sentence pairs; these read
    HF ``datasets`` (a locally cached copy: nothing is downloaded here),
    gated on the package;
  * synthetic clustered-embedding corpora, so benchmarks run hermetically;
  * the ``.npy`` embedding caches (the reference's own format,
    benchmark_utils.py:143-168).

All of it is host numpy / Python; the engine moves the arrays to the
device.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np


def load_sample_corpuses() -> dict:
    """Small hand-written corpora (reference datasets.py:10-82).

    Original text, same roles: two mixed-topic corpora, an incremental-add
    snippet, and two user-profile memory corpora (the RAG memory use case).
    """
    small_corpus1 = [
        "The Voyager probes crossed into interstellar space decades after launch.",
        "Their golden records carry sounds and images chosen to describe Earth.",
        "Deep space missions rely on radioisotope generators for electricity.",
        "A sourdough starter is a living culture of wild yeast and bacteria.",
        "Regular feeding with flour and water keeps a starter active.",
        "Long fermentation develops both flavor and an open crumb in bread.",
        "The printing press spread literacy rapidly across early modern Europe.",
        "Movable type made producing books dramatically cheaper than copying by hand.",
        "Pamphlets and broadsheets became engines of political change.",
        "Glaciers store most of the planet's fresh water as slowly moving ice.",
        "As glaciers retreat, downstream communities lose seasonal water supplies.",
        "Ice cores preserve air bubbles that record ancient atmospheres.",
    ]

    small_corpus2 = [
        "Volcanoes form where magma from the mantle reaches the surface.",
        "Eruptions can build islands and reshape entire coastlines.",
        "Ash clouds from large eruptions can cool the global climate.",
        "The stock market lets companies raise capital by selling shares.",
        "Index funds track a basket of stocks rather than a single company.",
        "Diversification reduces the risk of any single investment failing.",
        "Honeybees communicate the location of food with a waggle dance.",
        "A hive's workers, drones, and queen each have distinct roles.",
        "Pollinators are essential to most flowering food crops.",
        "The telegraph collapsed communication times from weeks to minutes.",
        "Undersea cables linked continents in the nineteenth century.",
        "Morse code encoded letters as short and long electrical pulses.",
    ]

    small_add_corpus2 = [
        "Lava cools into new rock, slowly building volcanic mountains.",
        "Exchange-traded funds trade like stocks but hold many assets.",
        "Queen bees lay nearly all the eggs in a colony.",
        "Telegraph operators became the first real-time news network.",
    ]

    user_corpus1 = [
        "User prefers plant-based meals.",
        "User goes trail running on Saturdays.",
        "User works as a data analyst at a logistics firm.",
        "User asks for Thai or Mexican restaurant suggestions.",
        "User listens to ambient and classical music while working.",
        "User reads mystery novels before bed.",
        "User is allergic to peanuts.",
        "User has two cats named Juniper and Clove.",
        "User enjoys visiting botanical gardens.",
        "User meditates for ten minutes every morning.",
        "User uses a Linux laptop for personal projects.",
        "User is training for a half marathon.",
        "User is learning conversational Portuguese.",
        "User takes the tram to work.",
        "User watches nature documentaries on weekends.",
        "User plays the piano at an intermediate level.",
        "User volunteers at a community garden.",
        "User prefers refillable and low-waste products.",
        "User keeps a daily reading log.",
        "User often asks about budgeting strategies.",
    ]

    user_corpus2 = [
        "User's name is Priya Raman.",
        "User is 34 years old.",
        "User lives in Austin, Texas.",
        "User works as a machine learning engineer.",
        "User is employed at Brightlake Systems.",
        "User enjoys rock climbing, baking, and chess.",
        "User's favorite programming language is Rust.",
        "User holds an M.S. degree in Statistics.",
        "User graduated in 2015.",
        "User is married with one daughter.",
        "User speaks English, Tamil, and French.",
        "User has a parrot named Mango.",
        "User has lived in four different countries.",
        "User uses PyTorch, JAX, Kubernetes, and Terraform.",
        "User's GitHub username is priyar.",
        "User is passionate about interpretable models.",
        "User maintains two open-source libraries.",
        "User mentors early-career engineers.",
        "User's favorite food is dosa.",
        "User is lactose intolerant.",
        "User loves strong filter coffee.",
        "User collects vintage fountain pens.",
    ]

    return {
        "small_corpus1": small_corpus1,
        "small_corpus2": small_corpus2,
        "small_add_corpus2": small_add_corpus2,
        "user_corpus1": user_corpus1,
        "user_corpus2": user_corpus2,
    }


class RetrievalDataset(NamedTuple):
    """corpus[i] are indexable passages; queries[j] should retrieve
    targets[j] (which is a member of corpus)."""

    corpus: list
    queries: list
    targets: list
    name: str


def hf_available() -> bool:
    try:
        import datasets  # noqa: F401
        return True
    except ImportError:
        return False


def load_qqp(corpus_size: int = 10000, target_size: int = 1000,
             split: str = "train", seed: int = 42) -> RetrievalDataset:
    """GLUE/QQP duplicate pairs (reference qqp_dataset.py:14-36): label==1
    pairs give (query=question1, target=question2); the corpus is the
    targets padded with non-duplicate question2s up to ``corpus_size``."""
    from datasets import load_dataset

    ds = load_dataset("glue", "qqp", split=split)
    rng = np.random.default_rng(seed)
    dup_q1, dup_q2, neg_q2 = [], [], []
    for row in ds:
        if row["label"] == 1:
            dup_q1.append(row["question1"])
            dup_q2.append(row["question2"])
        else:
            neg_q2.append(row["question2"])
        if len(dup_q1) >= target_size and \
                len(neg_q2) >= corpus_size - target_size:
            break
    n_t = min(target_size, len(dup_q1))
    queries, targets = dup_q1[:n_t], dup_q2[:n_t]
    corpus = targets + neg_q2[: corpus_size - n_t]
    order = rng.permutation(len(corpus))
    corpus = [corpus[i] for i in order]
    return RetrievalDataset(corpus, queries, targets, f"qqp_c{len(corpus)}")


def load_ms_marco(corpus_size: int = 10000, target_size: int = 1000,
                  split: str = "train", seed: int = 42) -> RetrievalDataset:
    """MS-MARCO v2.1 (reference ms_marco_dataset.py:14-46): queries whose
    passage group contains an ``is_selected`` passage become (query,
    selected passage) pairs; the corpus is those groups' passages plus
    random fill."""
    from datasets import load_dataset

    ds = load_dataset("ms_marco", "v2.1", split=split)
    rng = np.random.default_rng(seed)
    queries, targets, corpus = [], [], []
    for row in ds:
        p = row["passages"]
        sel = [t for t, s in zip(p["passage_text"], p["is_selected"]) if s]
        if sel and len(queries) < target_size:
            queries.append(row["query"])
            targets.append(sel[0])
            corpus.extend(p["passage_text"])
        elif len(corpus) < corpus_size:
            corpus.extend(p["passage_text"])
        if len(queries) >= target_size and len(corpus) >= corpus_size:
            break
    # dedupe, keep targets present, trim
    seen, dedup = set(), []
    for t in targets:
        seen.add(t)
    for c in corpus:
        if c not in seen:
            dedup.append(c)
            seen.add(c)
    corpus = targets + dedup[: max(0, corpus_size - len(targets))]
    order = rng.permutation(len(corpus))
    corpus = [corpus[i] for i in order]
    return RetrievalDataset(corpus, queries, targets,
                            f"msmarco_c{len(corpus)}")


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


def load_sts(split: str = "train",
             score_threshold: Optional[float] = None) -> tuple:
    """STS-Benchmark sentence pairs with similarity scores (reference
    utils/datasets.py:109-173 load_sts_embeddings/combiner role).  Returns
    (sentence_pairs [(s1, s2), ...], scores (N,) in [0, 5])."""
    from datasets import load_dataset

    ds = load_dataset("glue", "stsb", split=split)
    pairs, scores = [], []
    for row in ds:
        if score_threshold is not None and row["label"] < score_threshold:
            continue
        pairs.append((row["sentence1"], row["sentence2"]))
        scores.append(float(row["label"]))
    return pairs, np.asarray(scores, np.float32)


def sts_embeddings(encode_func, split: str = "train",
                   score_threshold: Optional[float] = None) -> tuple:
    """Encode STS pairs -> (embs1 (N,D), embs2 (N,D), scores (N,))."""
    pairs, scores = load_sts(split, score_threshold)
    embs1 = np.asarray(encode_func([a for a, _ in pairs]), np.float32)
    embs2 = np.asarray(encode_func([b for _, b in pairs]), np.float32)
    return embs1, embs2, scores


def combine_sts_splits(encode_func, splits=("train", "validation"),
                       score_threshold: Optional[float] = None) -> tuple:
    """Concatenate several STS splits (reference combiner :150-173)."""
    e1s, e2s, ss = [], [], []
    for split in splits:
        e1, e2, s = sts_embeddings(encode_func, split, score_threshold)
        e1s.append(e1)
        e2s.append(e2)
        ss.append(s)
    return (np.concatenate(e1s), np.concatenate(e2s), np.concatenate(ss))


def load_embeddings(filepath: str) -> Optional[np.ndarray]:
    """Load a ``.npy`` embedding cache (reference datasets.py:101-109 and the
    cache layout of benchmark_utils.py:143-168)."""
    if not os.path.exists(filepath):
        return None
    return np.load(filepath)


def save_embeddings(filepath: str, embs: np.ndarray):
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    np.save(filepath, np.asarray(embs))
