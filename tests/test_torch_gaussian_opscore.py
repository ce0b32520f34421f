"""Gaussian and op-score math of the PyTorch port against the JAX
functions, elementwise on random float32 inputs made with numpy.

Tolerance: rtol=1e-5, atol=1e-6 — the two packages run the same
operations in the same order, so only float32 reduction order differs.
The op-score tie-break noise comes from different generators, so the
inputs are tie-free (continuous random statistics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.ops import gaussian as jg
from rag_cobweb_tpu.ops import opscore as jo
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.ops import gaussian as tg
from rag_cobweb_tpu_torch.ops import opscore as to

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
VARIANTS = [dict(), dict(use_kl=False), dict(use_info=False),
            dict(acuity_cutoff=True)]


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL,
                               atol=ATOL)


def stats(rng, shape, D):
    count = rng.integers(1, 9, size=shape).astype(np.float32)
    mean = rng.normal(size=shape + (D,)).astype(np.float32)
    m2 = (rng.random(size=shape + (D,)) * count[..., None]).astype(
        np.float32)
    return count, mean, m2


def both(count, mean, m2):
    return (jg.GaussStats(jnp.asarray(count), jnp.asarray(mean),
                          jnp.asarray(m2)),
            tg.GaussStats(torch.as_tensor(count), torch.as_tensor(mean),
                          torch.as_tensor(m2)))


@pytest.mark.parametrize("kw", VARIANTS, ids=["kl", "info", "cu", "acuity"])
def test_gaussian_functions_match(kw):
    rng = np.random.default_rng(0)
    D = 12
    jcfg, tcfg = JCfg(dim=D, **kw), TreeConfig(dim=D, **kw)
    ja, ta = both(*stats(rng, (7,), D))
    jb, tb = both(*stats(rng, (7,), D))
    x = rng.normal(size=(7, D)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)

    for f in ("count", "mean", "m2"):
        close(getattr(jg.welford_insert(ja, jx), f),
              getattr(tg.welford_insert(ta, tx), f))
        close(getattr(jg.chan_merge(ja, jb), f),
              getattr(tg.chan_merge(ta, tb), f))
    for fn in ("stats_mean_var",):
        for j, t in zip(getattr(jg, fn)(ja, jcfg), getattr(tg, fn)(ta, tcfg)):
            close(j, t)
    for j, t in zip(jg.insert_mean_var(ja, jx, jcfg),
                    tg.insert_mean_var(ta, tx, tcfg)):
        close(j, t)
    for j, t in zip(jg.merge_mean_var(ja, jb, jx, jcfg),
                    tg.merge_mean_var(ta, tb, tx, tcfg)):
        close(j, t)
    # an empty concept takes the prior variance
    zc = np.zeros((7,), np.float32)
    close(jg.compute_var(ja.m2, jnp.asarray(zc)[:, None], jcfg),
          tg.compute_var(ta.m2, torch.as_tensor(zc)[:, None], tcfg))
    jm, jv = jg.stats_mean_var(ja, jcfg)
    tm, tv = tg.stats_mean_var(ta, tcfg)
    close(jg.log_prob(jx, jm, jv), tg.log_prob(tx, tm, tv))
    jm2, jv2 = jg.stats_mean_var(jb, jcfg)
    tm2, tv2 = tg.stats_mean_var(tb, tcfg)
    close(jg.compute_score(jm, jv, jm2, jv2, jcfg),
          tg.compute_score(tm, tv, tm2, tv2, tcfg))


def _block(rng, L, F, D, n_valid):
    """L lanes of a parent, a fanout block with n_valid[l] children and
    best1's grandchildren block."""
    pc, pm, pm2 = stats(rng, (L,), D)
    pc = pc + 20.0
    cc, cm, cm2 = stats(rng, (L, F), D)
    mask = np.arange(F)[None, :] < np.asarray(n_valid)[:, None]
    gc, gm, gm2 = stats(rng, (L, F), D)
    gmask = np.arange(F)[None, :] < rng.integers(1, F, size=(L, 1))
    x = rng.normal(size=(L, D)).astype(np.float32)
    return (pc, pm, pm2), (cc, cm, cm2), mask, (gc, gm, gm2), gmask, x


@pytest.mark.parametrize("kw", VARIANTS, ids=["kl", "info", "cu", "acuity"])
def test_opscore_matches_per_lane(kw):
    rng = np.random.default_rng(1)
    L, F, D = 6, 8, 10
    jcfg, tcfg = JCfg(dim=D, **kw), TreeConfig(dim=D, **kw)
    n_valid = [1, 2, 3, 5, 8, 4]
    p, c, mask, g, gmask, x = _block(rng, L, F, D, n_valid)
    tp, tc, tgc = (tg.GaussStats(*map(torch.as_tensor, s))
                   for s in (p, c, g))
    tmask, tgmask = torch.as_tensor(mask), torch.as_tensor(gmask)
    tx = torch.as_tensor(x)
    noise_f = torch.rand((L, F), generator=torch.Generator().manual_seed(0))
    noise_4 = torch.rand((L, 4), generator=torch.Generator().manual_seed(1))
    tb = to.two_best_children(tx, tp, tc, tmask, tcfg, noise_f)
    full = torch.as_tensor(np.asarray(n_valid)) >= F
    fits = torch.as_tensor(rng.random(L) < 0.7)
    t_op, t_util = to.best_operation(tx, tp, tc, tmask, tb, tgc, tgmask,
                                     tcfg, noise_4, full, fits)
    t_new = to.pu_for_new_child(tx, tp, tc, tmask, tcfg)
    t_split = to.pu_for_split(tp, tc, tmask, tb.best1, tgc, tgmask, tcfg)
    t_merge = to.pu_for_merge(tx, tp, tc, tmask, tb.best1, tb.best2, tcfg)

    key = jax.random.PRNGKey(0)
    for lane in range(L):
        jp = jg.GaussStats(*(jnp.asarray(a[lane]) for a in p))
        jc = jg.GaussStats(*(jnp.asarray(a[lane]) for a in c))
        jgc = jg.GaussStats(*(jnp.asarray(a[lane]) for a in g))
        jm, jgm = jnp.asarray(mask[lane]), jnp.asarray(gmask[lane])
        jx = jnp.asarray(x[lane])
        jb = jo.two_best_children(jx, jp, jc, jm, jcfg, key)
        assert int(jb.best1) == int(tb.best1[lane])
        assert int(jb.best2) == int(tb.best2[lane])
        close(jb.best1_pu, tb.best1_pu[lane])
        close(jo.pu_for_new_child(jx, jp, jc, jm, jcfg), t_new[lane])
        close(jo.pu_for_split(jp, jc, jm, jb.best1, jgc, jgm, jcfg),
              t_split[lane])
        if int(jb.best2) >= 0 and n_valid[lane] > 1:
            close(jo.pu_for_merge(jx, jp, jc, jm, jb.best1, jb.best2, jcfg),
                  t_merge[lane])
        op, util = jo.best_operation(
            jx, jp, jc, jm, jb, jgc, jgm, jcfg, key,
            jnp.asarray(bool(full[lane])), jnp.asarray(bool(fits[lane])))
        assert int(op) == int(t_op[lane]), (lane, kw)
        close(util, t_util[lane])


def test_lex_argmax_tie_breaks():
    """(primary, secondary, noise) order over masked entries."""
    p = torch.tensor([[1.0, 3.0, 3.0, 3.0], [0.0, 0.0, 0.0, 0.0]])
    s = torch.tensor([[9.0, 1.0, 2.0, 2.0], [1.0, 1.0, 1.0, 1.0]])
    n = torch.tensor([[0.9, 0.9, 0.1, 0.5], [0.2, 0.8, 0.4, 0.3]])
    m = torch.tensor([[True, True, True, True], [True, False, True, True]])
    assert to._lex_argmax(p, s, n, m).tolist() == [3, 2]
