"""The group-max pool of the PyTorch port (``ops/fused_topk.
fused_group_topk``, the counterpart of ``pallas_fused_group_topk``)
against the JAX package's Pallas kernel in interpret mode, on the same
FusedIndex arrays.

The port merges with an exact ``torch.topk``; the Pallas entry in
interpret mode merges with an exact ``lax.top_k`` too.  Pool entries at
NEG (groups with no valid row left) tie with each other, and the two
top-k functions break that tie differently, so those entries are compared
by count, the rest as (score, id) sets with scores within rtol=atol=1e-4
(f32 summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core import index as jidx
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.ops.pallas_query import pallas_fused_group_topk
from rag_cobweb_tpu.parallel.vforest import VForest as JForest
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.ops import fused_topk as ft

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


def _forest(n_rows: int, seed: int):
    rng = np.random.default_rng(seed)
    D = 12
    centers = rng.normal(scale=2.0, size=(8, D))
    xs = (centers[rng.integers(0, 8, n_rows)]
          + 0.5 * rng.normal(size=(n_rows, D))).astype(np.float32)
    jf = JForest(JCfg(dim=D), n_subtrees=3, capacity_per_tree=64, seed=0)
    jf.add(xs)
    return jf, xs


@pytest.fixture(scope="module")
def small():
    """90 rows: one 128-row group (as tests/test_fused_index.py)."""
    return _forest(90, 5)


@pytest.fixture(scope="module")
def wide():
    """360 rows: three groups of one slab, the last one ragged."""
    return _forest(360, 11)


def _port_index(fidx):
    return interop.fused_index_from_numpy(
        np.asarray(fidx.GT), np.asarray(fidx.c), np.asarray(fidx.valid),
        device="cpu")


def _compare(want_s, want_i, got_s, got_i):
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    got_s, got_i = got_s.numpy(), got_i.numpy()
    assert got_i.dtype == np.int32
    for b in range(len(want_s)):
        wr, gr = want_s[b] > ft.NEG / 2, got_s[b] > ft.NEG / 2
        assert wr.sum() == gr.sum()
        w = dict(zip(want_i[b][wr].tolist(), want_s[b][wr].tolist()))
        g = dict(zip(got_i[b][gr].tolist(), got_s[b][gr].tolist()))
        assert set(g) == set(w)
        np.testing.assert_allclose([g[i] for i in sorted(g)],
                                   [w[i] for i in sorted(w)],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_group_per_group_4(small, dtype):
    jf, xs = small
    fidx = jf.fused_index(dtype=jnp.dtype(dtype))
    want = pallas_fused_group_topk(fidx, jnp.asarray(xs[:6]), 16,
                                   interpret=True, per_group=4)
    got = ft.fused_group_topk(_port_index(fidx), torch.as_tensor(xs[:6]),
                              16, per_group=4)
    _compare(*want, *got)
    # the pool holds the group's exact top-4 path scores
    exact_s, exact_i = jidx.fused_query_topk(jf.fused_index(),
                                             jnp.asarray(xs[:6]), 4)
    for b in range(6):
        assert set(np.asarray(exact_i)[b].tolist()) <= set(
            got[1][b].tolist())


@pytest.mark.parametrize("k", [10, 32])
def test_three_groups_per_group_2(wide, k):
    jf, xs = wide
    fidx = jf.fused_index()
    want = pallas_fused_group_topk(fidx, jnp.asarray(xs[:7]), k,
                                   interpret=True, per_group=2)
    got = ft.fused_group_topk(_port_index(fidx), torch.as_tensor(xs[:7]), k,
                              per_group=2)
    _compare(*want, *got)


@pytest.mark.parametrize("per_group,keep,k", [(3, 2, 48), (3, 0, 20),
                                              (1, 5, 16), (5, 3, 37)])
def test_ragged_groups_against_pallas(wide, per_group, keep, k):
    """Group 1 cut to its first ``keep`` valid rows, so per_group rounds
    exhaust it (keep < per_group): the pool (all of it where k is the
    slab's per_group * 16 candidates) is the Pallas kernel's."""
    jf, xs = wide
    fidx = jf.fused_index()
    v = np.asarray(fidx.valid).copy()
    v[ft.GROUP + keep:2 * ft.GROUP] = False
    fidx = fidx._replace(valid=jnp.asarray(v))
    want = pallas_fused_group_topk(fidx, jnp.asarray(xs[:5]), k,
                                   interpret=True, per_group=per_group)
    got = ft.fused_group_topk(_port_index(fidx), torch.as_tensor(xs[:5]), k,
                              per_group=per_group)
    _compare(*want, *got)


@pytest.mark.parametrize("per_group", [1, 3, 128])
def test_plain_pool_against_a_numpy_oracle(per_group):
    """Dyadic scores (exact in f32, many ties) over two slabs, a group
    partly and the rest of the last slab wholly invalid: round i of group g
    is the i-th row in (score descending, row ascending) order, and once
    the valid rows are taken, (NEG, the group's first row)."""
    rng = np.random.default_rng(per_group)
    B, twoD, Sp, S = 3, 6, 2 * ft.SLAB, 3000
    qq = rng.integers(-4, 5, size=(B, twoD)) / 4
    GT = rng.integers(-4, 5, size=(twoD, Sp)) / 4
    c = rng.integers(-8, 9, size=Sp) / 2
    valid = np.arange(Sp) < S
    s = qq @ GT + c
    KO = per_group * ft.NG
    want_s = np.empty((Sp // ft.SLAB, B, KO), np.float32)
    want_i = np.empty((Sp // ft.SLAB, B, KO), np.int32)
    for b in range(B):
        for gg in range(Sp // ft.GROUP):
            rows = np.arange(gg * ft.GROUP, (gg + 1) * ft.GROUP)
            rows = rows[valid[rows]]
            order = rows[np.lexsort((rows, -s[b, rows]))]
            slab, g = divmod(gg, ft.NG)
            for i in range(per_group):
                at = (slab, b, i * ft.NG + g)
                if i < len(order):
                    want_s[at], want_i[at] = s[b, order[i]], order[i]
                else:
                    want_s[at], want_i[at] = ft.NEG, gg * ft.GROUP
    got_s, got_i = ft.slab_group_topk_plain(
        torch.as_tensor(qq, dtype=torch.float32),
        torch.as_tensor(GT, dtype=torch.float32),
        torch.as_tensor(c, dtype=torch.float32), torch.as_tensor(valid),
        per_group)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_plain_pool_layout(wide):
    """Column i * 16 + g holds round i of group g, with the global row id;
    a group without valid rows gives NEG at its first row in every
    round."""
    jf, xs = wide
    fidx = _port_index(jf.fused_index())
    q = torch.as_tensor(xs[:3])
    qq = torch.cat([q, q * q], 1)
    out_s, out_i = ft.slab_group_topk(qq, fidx.GT, fidx.c, fidx.valid, 3)
    NS = fidx.GT.shape[1] // ft.SLAB
    assert tuple(out_s.shape) == (NS, 3, 3 * ft.NG)
    g = torch.arange(ft.NG).repeat(3)
    assert bool(((out_i[0] // ft.GROUP) == g).all())
    rounds = out_s[0].view(3, 3, ft.NG)                  # (B, round, group)
    assert bool((rounds[:, 1:] <= rounds[:, :-1]).all())
    empty = ~fidx.valid.view(-1, ft.GROUP).any(1)[:ft.NG]
    assert bool(empty.any())
    assert bool((out_s[0].view(3, 3, ft.NG)[:, :, empty] == ft.NEG).all())
    assert bool((out_i[0].view(3, 3, ft.NG)[:, :, empty]
                 == (g.view(3, ft.NG)[:, empty] * ft.GROUP)).all())


@pytest.mark.parametrize("per_group", [1, 2, 7])
def test_plain_pool_at_the_single_tree_width_against_pallas(per_group):
    """The plain f32 pool, which the card tests hold the kernel to, against
    the Pallas kernel in interpret mode at the single tree's served width
    (2D=496): two slabs, the last partly invalid, group 3 cut to fewer
    valid rows than per_group (its last rounds exhausted); dyadic f32
    inputs, exact in any order, and the whole pool (k = NS * per_group *
    16) compared."""
    rng = np.random.default_rng(40 + per_group)
    D, Sp, S = 248, 2 * ft.SLAB, 3000
    GT = (rng.integers(-16, 17, size=(2 * D, Sp)) / 16).astype(np.float32)
    c = (rng.integers(-64, 65, size=Sp) / 4).astype(np.float32)
    valid = np.arange(Sp) < S
    valid[3 * ft.GROUP + per_group - 1:4 * ft.GROUP] = False
    q = (rng.integers(-8, 9, size=(4, D)) / 8).astype(np.float32)
    k = Sp // ft.SLAB * per_group * ft.NG
    fidx = jidx.FusedIndex(GT=jnp.asarray(GT), c=jnp.asarray(c),
                           valid=jnp.asarray(valid))
    want = pallas_fused_group_topk(fidx, jnp.asarray(q), k, interpret=True,
                                   per_group=per_group)
    got = ft.fused_group_topk(_port_index(fidx), torch.as_tensor(q), k,
                              per_group=per_group)
    _compare(*want, *got)
