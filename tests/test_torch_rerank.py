"""Exact re-rank of the PyTorch port against the JAX ``exact_rerank`` and
against the formula of the ``scripts/gather_probe.py`` Pallas kernel
(``sum((q - emb[cand])^2)``, written here in numpy because that kernel
lives in a script).  Ids must be equal; scores within rtol=1e-5 (float32
summation order only)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core import index as jidx
from rag_cobweb_tpu_torch.core import index as tidx
from rag_cobweb_tpu_torch.ops import rerank

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

PV = 1.0 / (2.0 * math.e * math.pi)


def inputs(seed, S=400, B=9, C=50, D=24):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(S, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    cand = rng.integers(0, S, size=(B, C)).astype(np.int32)
    cs = rng.normal(size=(B, C)).astype(np.float32)
    cs[:, ::7] = -np.inf           # dropped candidates
    return emb, q, cand, cs


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 10), (2, 20)])
def test_exact_rerank_matches_jax(seed, k):
    emb, q, cand, cs = inputs(seed)
    ws, wi = jidx.exact_rerank(jnp.asarray(emb), jnp.asarray(q),
                               jnp.asarray(cand), jnp.asarray(cs), k,
                               jnp.float32(PV))
    gs, gi = tidx.exact_rerank(torch.as_tensor(emb), torch.as_tensor(q),
                               torch.as_tensor(cand), torch.as_tensor(cs), k,
                               PV)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5)


@pytest.mark.parametrize("D", [16, 50, 768, 1536])
@pytest.mark.parametrize("pv", [PV, 0.37, 1.0, 2.5])
def test_rerank_lp_matches_gather_probe_formula(D, pv):
    """At widths that are and are not a multiple of 4, and prior variances
    below and above 1 (log(pv) of either sign)."""
    emb, q, cand, cs = inputs(3, D=D, C=64)
    d2 = np.sum((q.astype(np.float64)[:, None, :]
                 - emb.astype(np.float64)[cand]) ** 2, axis=-1)
    want = -0.5 * (d2 / np.float32(pv) + D * np.log(np.float32(pv)))
    want = np.where(np.isfinite(cs), want, -np.inf)
    got = rerank.rerank_lp(torch.as_tensor(emb), torch.as_tensor(q),
                           torch.as_tensor(cand), torch.as_tensor(cs),
                           pv).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


def test_diff_form_keeps_near_duplicate_margins():
    """Two rows 1e-3 apart at norm ~1e3: the diff form still orders them
    (the dot form's cancellation would not)."""
    rng = np.random.default_rng(4)
    base = (1000.0 + rng.normal(size=(1, 32))).astype(np.float32)
    emb = np.concatenate([base, base + 1e-3, base + 2e-3])
    q = base - 1e-3
    cand = np.array([[2, 1, 0]], np.int32)
    cs = np.zeros((1, 3), np.float32)
    _, ids = tidx.exact_rerank(torch.as_tensor(emb), torch.as_tensor(q),
                               torch.as_tensor(cand), torch.as_tensor(cs), 3,
                               PV)
    assert ids.tolist() == [[0, 1, 2]]


def test_rerank_rejects_bad_inputs():
    emb, q, cand, cs = (torch.as_tensor(a) for a in inputs(5))
    with pytest.raises(TypeError):
        rerank.rerank_lp(emb, q, cand.long(), cs, PV)
    with pytest.raises(ValueError):
        rerank.rerank_lp(emb.double(), q, cand, cs, PV)
    with pytest.raises(ValueError):
        rerank.rerank_lp(emb, q[:, :5], cand, cs, PV)
    with pytest.raises(ValueError):
        rerank.rerank_lp(emb, q, cand, cs[:, :3], PV)
