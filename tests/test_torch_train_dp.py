"""Data-parallel training of the port (the two trainers' ``fit_dp``) on 2
and 4 gloo ranks, against the JAX package's ``fit_dp`` on the same-sized
virtual CPU mesh and the port's own single-process ``fit`` on the same
global batches, from the JAX trainers' initial parameters and trees
(``save`` files of the JAX indexes) carried across.

The fixtures and tolerances are ``tests/test_torch_training.py``'s:
per-epoch losses (and the end-to-end trainer's encoder gradient norms,
taken after the gradients are averaged) within 1e-5 relative, the
parameters after the fit within ``atol=1e-5, rtol=1e-4``, but the
attention's key bias, whose gradient is 0 in exact arithmetic and which
Adam walks by rounding noise: it is held to having moved at most lr a
step.  An empty query set and a batch that does not divide over the
ranks raise ``ValueError`` before any step."""

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.parallel.forest import make_mesh
from rag_cobweb_tpu.training import query_train as jqt
from rag_cobweb_tpu.training import text_encoder as jte
from rag_cobweb_tpu_torch.bench import multichip
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.training import flax_layout
from rag_cobweb_tpu_torch.training.query_train import CobwebQueryTrainer
from rag_cobweb_tpu_torch.training.text_encoder import EndToEndQueryTrainer
from test_torch_training import E2E, KEY_BIAS, LOSS_RTOL, assert_same_params

torch.set_num_threads(1)
EPOCHS, BATCH = 2, 16


@pytest.fixture(scope="module")
def query_case():
    """The single-device tests' query fixture: 80 rows in 8 clusters,
    16-d, 48 queries in a rotated space."""
    rng = np.random.default_rng(4)
    centers = rng.normal(scale=3.0, size=(8, 16))
    docs = np.concatenate(
        [c + 0.2 * rng.normal(size=(10, 16)) for c in centers]
    ).astype(np.float32)
    rng = np.random.default_rng(5)
    R = np.linalg.qr(rng.normal(size=(16, 16)))[0].astype(np.float32)
    gold = rng.choice(len(docs), size=48, replace=False)
    queries = (docs[gold] @ R + 0.05 * rng.normal(size=(48, 16))).astype(
        np.float32)
    jdb = JIndex(corpus=None, corpus_embeddings=docs, config=JCfg(dim=16))
    return jdb, queries, gold


@pytest.fixture(scope="module")
def e2e_case():
    """The single-device tests' end-to-end fixture: 64 rows in 8
    clusters, texts naming cluster and item, some query texts empty."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(8, 16))
    xs = np.concatenate(
        [c + 0.15 * rng.normal(size=(8, 16)) for c in centers]
    ).astype(np.float32)
    texts = [f"cluster{r // 8} item{r % 8} corpus entry"
             for r in range(len(xs))]
    q_texts = [f"find cluster{r // 8} item{r % 8}" if r % 9 else ""
               for r in range(len(xs))]
    jdb = JIndex(corpus=texts, corpus_embeddings=xs)
    return jdb, q_texts, np.arange(len(xs))


@pytest.fixture(scope="module")
def saved(query_case, e2e_case, tmp_path_factory):
    """The JAX indexes' ``save`` files, the trees every rank loads."""
    d = tmp_path_factory.mktemp("dp")
    query_case[0].save(str(d / "query.npz"))
    e2e_case[0].save(str(d / "e2e.npz"))
    return str(d / "query.npz"), str(d / "e2e.npz")


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def run(request, query_case, e2e_case, saved):
    n = request.param
    mesh = make_mesh(n)
    jdb, queries, gold = query_case
    jtr = jqt.CobwebQueryTrainer(jdb, in_dim=16, hidden_dim=64, lr=1e-3,
                                 seed=0)
    params0 = jax.device_get(jtr.state.params)
    jlosses = jtr.fit_dp(queries, gold, mesh, epochs=EPOCHS,
                         batch_size=BATCH)
    edb, q_texts, egold = e2e_case
    etr = jte.EndToEndQueryTrainer(edb, **E2E)
    enc0 = jax.device_get(etr.state.enc_params)
    head0 = jax.device_get(etr.state.head_params)
    ejax = etr.fit_dp(q_texts, egold, mesh, epochs=EPOCHS, batch_size=BATCH)
    settings = {k: v for k, v in E2E.items()}
    payload = {
        "query": {"db": saved[0], "queries": queries, "gold": gold,
                  "hidden": 64, "params": params0, "epochs": EPOCHS,
                  "batch": BATCH},
        "e2e": {"db": saved[1], "texts": q_texts,
                "gold": egold, "settings": settings, "enc_params": enc0,
                "head_params": head0, "epochs": EPOCHS, "batch": BATCH}}
    out = multichip.spawn(torch_ranks.train_rank, n, payload, device="cpu",
                          timeout=300, threads=1)
    jax_run = {"query": (jlosses, jtr.state.params),
               "e2e": (ejax, etr.state.enc_params, etr.state.head_params),
               "enc0": enc0}
    return n, payload, jax_run, out


def single_process_fits(payload):
    """The port's ``fit`` from the same parameters on the same batches."""
    q = payload["query"]
    db = CobwebIndex.load(q["db"], device="cpu")
    tr = CobwebQueryTrainer(db, in_dim=16, hidden_dim=q["hidden"], lr=1e-3,
                            seed=0)
    flax_layout.load_flax(tr.head, q["params"])
    losses = tr.fit(q["queries"], q["gold"], epochs=EPOCHS, batch_size=BATCH)
    e = payload["e2e"]
    edb = CobwebIndex.load(e["db"], device="cpu")
    et = EndToEndQueryTrainer(edb, **e["settings"])
    flax_layout.load_flax(et.encoder, e["enc_params"])
    flax_layout.load_flax(et.head, e["head_params"])
    eout = et.fit(e["texts"], e["gold"], epochs=EPOCHS, batch_size=BATCH)
    return {"query": (losses, flax_layout.to_flax(tr.head)),
            "e2e": (eout, flax_layout.to_flax(et.encoder),
                    flax_layout.to_flax(et.head))}


@pytest.fixture(scope="module")
def single(run):
    return single_process_fits(run[1])


def key_bias_moved(tree, tree0):
    att = "MultiHeadDotProductAttention_0"
    kb = np.asarray(tree["params"]["EncoderBlock_0"][att]["key"]["bias"])
    kb0 = np.asarray(tree0["params"]["EncoderBlock_0"][att]["key"]["bias"])
    return float(np.abs(kb - kb0).max())


def test_query_fit_dp_matches_jax(run):
    n, _, jax_run, out = run
    jl, jp = jax_run["query"]
    for o in out:
        losses, params = o["query"]
        np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
        assert_same_params(params, jp)


def test_query_fit_dp_is_fit_on_the_global_batches(run, single):
    _, _, _, out = run
    sl, sp = single["query"]
    for o in out:
        losses, params = o["query"]
        np.testing.assert_allclose(losses, sl, rtol=LOSS_RTOL)
        assert_same_params(params, sp)


def test_e2e_fit_dp_matches_jax(run):
    n, payload, jax_run, out = run
    (jl, jg), jenc, jhead = jax_run["e2e"]
    steps = EPOCHS * (len(payload["e2e"]["gold"]) // BATCH)
    for o in out:
        (losses, norms), enc, head = o["e2e"]
        np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(norms, jg, rtol=LOSS_RTOL)
        assert_same_params(enc, jenc, skip=(KEY_BIAS,))
        assert_same_params(head, jhead)
        assert key_bias_moved(enc, jax_run["enc0"]) <= \
            steps * E2E["lr"] * 1.01


def test_e2e_fit_dp_is_fit_on_the_global_batches(run, single):
    _, _, _, out = run
    (sl, sg), senc, shead = single["e2e"]
    for o in out:
        (losses, norms), enc, head = o["e2e"]
        np.testing.assert_allclose(losses, sl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(norms, sg, rtol=LOSS_RTOL)
        assert_same_params(enc, senc, skip=(KEY_BIAS,))
        assert_same_params(head, shead)


def test_fit_dp_refusals(run):
    n, payload, _, out = run
    steps = EPOCHS * (len(payload["query"]["gold"]) // BATCH)
    e_steps = EPOCHS * (len(payload["e2e"]["gold"]) // BATCH)
    for o in out:
        err = o["errors"]
        assert "empty" in err["empty"]
        assert f"over {n} devices" in err["indivisible"]
        assert f"over {n} devices" in err["e2e_indivisible"]
        # no step ran in the refused calls
        assert o["steps_after_errors"] == (steps, e_steps)
