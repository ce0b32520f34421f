"""Where a card build and a host build of the same forest part ways.

    python -m rag_cobweb_tpu_torch.bench.build_divergence [--case a|b|both]
        [--rows N] [--out FILE]

The same whitened rows go into the same forest (lanes, capacity, seed)
twice, on the card and on the host (``device="cpu"``), every descent step
run eagerly with its decision recorded: the primary keys of
``opscore._lex_argmax`` (each child's ``opscore.insert_gains`` and the
four ``opscore.operation_utilities``), their tie-break keys and noise,
and what was chosen.  On the card each step's keys are also recomputed
on the host from the card's own inputs, which tells a difference of the
inputs from one of the arithmetic.  The recorded card build is held
against an unrecorded one (each step replayed from its CUDA graph), so a
fault of the graph would show as well.

For every lane whose tree differs (any node's count, parent or children,
or a row's leaf), the lane's inserts are walked in order to the first
step whose decision differs.  There the record holds the competing
values of that decision on both devices, their gap (the winner's key
less the other's, on each device), the float32 rounding bound of the
terms summed into them (the number of terms x 2^-24 x the sum of their
magnitudes, ``U``), the noise drawn at both entries on both devices and
whether the noise decided (the keys tied exactly).  Its verdict:

  * ``exact tie``: both gaps 0, the noise decided on both devices; by
    design, as the CPU and CUDA generator streams differ;
  * ``near tie``: a gap within the rounding bound: float32 sums in
    another order (or another ``log``) flipped the decision;
  * ``beyond bound``: a fault of the port.

Cases: (a) phase 3g (d) of ``chip_smoke.py``: the first 4096 rows of
phase 3e's corpus (``synthetic_retrieval_hard(5000, 750, 768)``),
PCA+ICA at 0.96 fitted on them, 32 lanes; (b) the 2000-row, 64-d
PCA+ZCA forest of ``tests/test_torch_cuda_kernels.py``'s
``test_zca_forests_serve_the_hosts_ids_on_the_card`` (``seed=12``,
8 lanes).  ``--rows`` cuts a case to its first rows.  Without a card
(``device="cpu"`` in ``run_case``) only the host build is made and
traced, which is what the CPU tests compare with the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device
from rag_cobweb_tpu_torch.ops import opscore
from rag_cobweb_tpu_torch.ops.gaussian import (GaussStats, insert_mean_var,
                                               stats_mean_var)
from rag_cobweb_tpu_torch.parallel.vforest import VForest

U = 2.0 ** -24          # float32 unit roundoff
OPS = ("best", "new", "merge", "split")

# the lanes, the rows and the whitener of each case
CASES = {
    "a": dict(corpus=5000, queries=750, dim=768, seed=0, rows=4096,
              lanes=32, whitener="pcaica"),
    "b": dict(corpus=2000, queries=200, dim=64, seed=12, rows=2000,
              lanes=8, whitener="pcazca"),
}


# ---------------------------------------------------------------------------
# rounding bounds
# ---------------------------------------------------------------------------

def score_magnitude(mu1, var1, mu2, var2, cfg: TreeConfig) -> torch.Tensor:
    """The sum of the magnitudes of the terms ``gaussian.compute_score``
    sums, broadcast as it broadcasts."""
    if cfg.use_info:
        logs = torch.log(var2).abs() + torch.log(var1).abs()
        if cfg.use_kl:
            ratio = (var1 + torch.square(mu1 - mu2)) / var2
            return 0.5 * (torch.sum(logs + ratio.abs(), dim=-1)
                          + mu1.shape[-1])
        return 0.5 * torch.sum(logs, dim=-1)
    c = 1.0 / (2.0 * np.sqrt(np.pi))
    return torch.sum(c / torch.sqrt(var2) + c / torch.sqrt(var1), dim=-1)


def decision_terms(kind: str, cfg: TreeConfig) -> int:
    """How many terms a key of a decision sums: a child gain two scores,
    an operation utility up to ``max_fanout`` + 2; a score 3D + 1 (KL)
    or 2D terms, and one more for its weight."""
    D = cfg.dim
    n = (3 * D + 1 if (cfg.use_info and cfg.use_kl) else 2 * D) + 1
    return (cfg.max_fanout + 2) * n if kind == "operation" else 2 * n


@contextlib.contextmanager
def _magnitudes():
    """Every score the opscore functions compute is its magnitude (their
    weights are nonnegative, so a utility becomes the magnitude of the
    terms it sums)."""
    score = opscore.compute_score
    opscore.compute_score = score_magnitude
    try:
        yield
    finally:
        opscore.compute_score = score


def gain_magnitudes(x, parent: GaussStats, children: GaussStats,
                    cfg: TreeConfig) -> torch.Tensor:
    """(L, F) magnitude of the terms each ``insert_gains`` entry sums."""
    p_mean, p_var = insert_mean_var(parent, x, cfg)
    ci_mean, ci_var = insert_mean_var(children, x.unsqueeze(-2), cfg)
    c_mean, c_var = stats_mean_var(children, cfg)
    denom = (parent.count + 1.0).unsqueeze(-1)
    pm, pv = p_mean.unsqueeze(-2), p_var.unsqueeze(-2)
    return (((children.count + 1.0) / denom)
            * score_magnitude(ci_mean, ci_var, pm, pv, cfg)
            + (children.count / denom)
            * score_magnitude(c_mean, c_var, pm, pv, cfg))


# ---------------------------------------------------------------------------
# the recorded build
# ---------------------------------------------------------------------------

def _cpu(v):
    if isinstance(v, torch.Tensor):
        return v.cpu()
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_cpu(a) for a in v))
    return v


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _Recorder:
    """Patches the descent's decision functions to record every step.
    ``steps`` collects one dict of host arrays a step, ``calls`` one dict
    a ``descend`` call (its active lanes, rows and leaves, and the range
    of its steps)."""

    def __init__(self):
        self.steps: list = []
        self.calls: list = []
        self._cur: dict = {}

    def two_best(self, x, parent, children, mask, cfg, noise):
        out = self._two_best(x, parent, children, mask, cfg, noise)
        rec = self._cur
        rec["gains"] = _np(opscore.insert_gains(x, parent, children, cfg))
        rec["gain_mag"] = _np(gain_magnitudes(x, parent, children, cfg))
        rec["counts"] = _np(children.count)
        rec["mask"] = _np(mask)
        rec["best1"], rec["best2"] = _np(out.best1), _np(out.best2)
        if x.device.type == "cuda":
            rec["gains_host"] = _np(opscore.insert_gains(
                _cpu(x), _cpu(parent), _cpu(children), cfg))
        return out

    def best_op(self, x, parent, children, mask, tb, gc, gc_mask, cfg,
                noise, full, fits):
        op, u = self._best_op(x, parent, children, mask, tb, gc, gc_mask,
                              cfg, noise, full, fits)
        rec = self._cur
        util, valid = opscore.operation_utilities(
            x, parent, children, mask, tb, gc, gc_mask, cfg, full, fits)
        rec["util"], rec["valid"], rec["op"] = _np(util), _np(valid), _np(op)
        with _magnitudes():
            pu = opscore.pu_for_insert(x, parent, children, mask, tb.best1,
                                       cfg)
            mag, _ = opscore.operation_utilities(
                x, parent, children, mask, tb._replace(best1_pu=pu), gc,
                gc_mask, cfg, full, fits)
        rec["util_mag"] = _np(mag)
        if x.device.type == "cuda":
            a = [_cpu(v) for v in (x, parent, children, mask, tb, gc,
                                   gc_mask)]
            pu_h = opscore.pu_for_insert(a[0], a[1], a[2], a[3],
                                         a[4].best1, cfg)
            a[4] = a[4]._replace(best1_pu=pu_h)
            rec["util_host"] = _np(opscore.operation_utilities(
                *a, cfg, _cpu(full), _cpu(fits))[0])
        return op, u

    def advance(self, st, lanes, c, x, noise_two, noise_op, depth, cfg):
        self._cur = {"live": _np(~c.done), "node": _np(c.v.cur),
                     "internal": _np(c.v.n > 0), "depth": int(depth),
                     "noise_two": _np(noise_two), "noise_op": _np(noise_op)}
        out = self._advance(st, lanes, c, x, noise_two, noise_op, depth,
                            cfg)
        self.steps.append(self._cur)
        return out

    def descend(self, st, xs, active, cfg, max_steps, gen, graph=None):
        if graph is not None:
            raise ValueError("a recorded build runs its steps eagerly")
        first = len(self.steps)
        leaf = self._descend(st, xs, active, cfg, max_steps, gen, graph)
        self.calls.append({"active": _np(active), "xs": _np(xs),
                           "first": first, "last": len(self.steps),
                           "leaf": _np(leaf)})
        return leaf

    def __enter__(self):
        self._two_best, self._best_op = (opscore.two_best_children,
                                         opscore.best_operation)
        self._advance, self._descend = tree_mod._advance, tree_mod.descend
        opscore.two_best_children = self.two_best
        opscore.best_operation = self.best_op
        tree_mod._advance = self.advance
        tree_mod.descend = self.descend
        return self

    def __exit__(self, *exc):
        opscore.two_best_children = self._two_best
        opscore.best_operation = self._best_op
        tree_mod._advance = self._advance
        tree_mod.descend = self._descend


def make_forest(cfg: TreeConfig, lanes: int, rows: int, device,
                seed: int = 0) -> VForest:
    """The forest ``CobwebIndex(config=cfg, n_subtrees=lanes)`` makes for
    ``rows`` rows (its default capacity split over the lanes)."""
    cap = max(1024, 4 * rows + 16)
    return VForest(cfg, n_subtrees=lanes,
                   capacity_per_tree=max(1024, cap // lanes), seed=seed,
                   device=device)


class Trace:
    """A recorded build: the forest and its ``_Recorder``."""

    def __init__(self, forest: VForest, rec: _Recorder):
        self.forest, self.rec = forest, rec
        self.arrays = tree_mod.state_to_numpy(forest.state)
        self.device = forest.device.type

    def attempts(self, lane: int) -> list:
        """The lane's completed inserts in the order they were applied:
        (row bytes, the step indices where the lane was live, leaf)."""
        out = []
        for c in self.rec.calls:
            if not c["active"][lane] or c["leaf"][lane] < 0:
                continue
            steps = [s for s in range(c["first"], c["last"])
                     if self.rec.steps[s]["live"][lane]]
            out.append((c["xs"][lane].tobytes(), steps,
                        int(c["leaf"][lane])))
        return out

    def lane_equal(self, other: "Trace", lane: int) -> bool:
        """Slot for slot: every node's count, parent and children, and
        every row's leaf."""
        a, b = self.arrays, other.arrays
        if not all(np.array_equal(a[f][lane], b[f][lane])
                   for f in ("counts", "parent", "children", "n_children",
                             "root", "n_alloc", "free_top")):
            return False
        return (self.forest._leaf_of_local[lane]
                == other.forest._leaf_of_local[lane])


def traced_build(rows: torch.Tensor, cfg: TreeConfig, lanes: int,
                 device, seed: int = 0) -> Trace:
    """``rows`` (already whitened) built into ``make_forest``'s forest on
    ``device``, every step eager and recorded."""
    vf = make_forest(cfg, lanes, len(rows), device, seed)
    vf._step_graph = lambda: None
    with _Recorder() as rec:
        vf.add(rows.to(vf.device))
    return Trace(vf, rec)


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def _noise_decided(keys, tie, mask) -> bool:
    """Whether ``_lex_argmax`` fell through to its noise: the masked
    maximum of the keys and then of the tie-break keys attained twice."""
    k = np.where(mask, keys, -np.inf)
    t1 = mask & (k == k.max())
    if t1.sum() < 2:
        return False
    s = np.where(t1, tie, -np.inf)
    return int((t1 & (s == s.max())).sum()) >= 2


def _decision(rec: dict, lane: int, kind: str):
    """(keys, magnitudes, tie-break keys, mask, noise, choice, host
    recomputation or None) of one decision of one lane at one step."""
    if kind == "operation":
        return (rec["util"][lane], rec["util_mag"][lane],
                rec["noise_op"][lane], rec["valid"][lane],
                rec["noise_op"][lane], int(rec["op"][lane]),
                rec.get("util_host", [None] * (lane + 1))[lane])
    mask = rec["mask"][lane].copy()
    if kind == "second child":
        mask[int(rec["best1"][lane])] = False
    choice = rec["best1" if kind == "child" else "best2"][lane]
    return (rec["gains"][lane], rec["gain_mag"][lane], rec["counts"][lane],
            mask, rec["noise_two"][lane], int(choice),
            rec.get("gains_host", [None] * (lane + 1))[lane])


def _flip(h: dict, c: dict, lane: int, kind: str, cfg: TreeConfig) -> dict:
    """The record of one decision that went another way on each device."""
    n = decision_terms(kind, cfg)
    out = {"kind": kind, "n_terms": n}
    dh, dc = _decision(h, lane, kind), _decision(c, lane, kind)
    a, b = dh[5], dc[5]
    out["choice"] = {"host": a, "card": b}
    if kind == "operation":
        out["choice"] = {k: OPS[v] for k, v in out["choice"].items()}
    worst = 0.0
    for name, d, (win, lose) in (("host", dh, (a, b)), ("card", dc, (b, a))):
        keys, mag, tie, mask, noise = d[:5]
        gap = float(keys[win]) - float(keys[lose])
        bound = n * U * (float(mag[win]) + float(mag[lose]))
        out[name] = {"values": [float(keys[a]), float(keys[b])],
                     "gap": gap, "bound": bound,
                     "noise": [float(noise[a]), float(noise[b])],
                     "noise_decided": _noise_decided(keys, tie, mask)}
        worst = max(worst, abs(gap) / bound if bound > 0 else np.inf)
    if dc[6] is not None:
        # the card's inputs through the host's arithmetic
        hk = dc[6]
        out["card_inputs_on_host"] = [float(hk[a]), float(hk[b])]
        out["inputs_equal"] = bool(np.array_equal(
            np.asarray(hk)[dh[3]], np.asarray(dh[0])[dh[3]]))
    gh, gc = out["host"]["gap"], out["card"]["gap"]
    if gh == 0.0 and gc == 0.0:
        out["verdict"] = "exact tie"
    elif worst <= 1.0:
        out["verdict"] = "near tie"
    else:
        out["verdict"] = "beyond bound"
    out["gap_over_bound"] = worst
    return out


def first_difference(host: Trace, card: Trace, lane: int) -> dict:
    """Walk one lane's inserts in order to the first step whose decision
    differs between the two builds."""
    cfg = host.forest.cfg
    ha, ca = host.attempts(lane), card.attempts(lane)
    for i, ((hx, hs, hl), (cx, cs, cl)) in enumerate(zip(ha, ca)):
        where = {"lane": lane, "insert": i}
        if hx != cx:
            return dict(where, kind="row order", verdict="beyond bound")
        for j, (sh, sc) in enumerate(zip(hs, cs)):
            h, c = host.rec.steps[sh], card.rec.steps[sc]
            at = dict(where, step=j, depth=h["depth"],
                      node=int(h["node"][lane]))
            if (h["node"][lane] != c["node"][lane]
                    or h["internal"][lane] != c["internal"][lane]):
                return dict(at, kind="node", verdict="beyond bound")
            if not h["internal"][lane]:
                continue
            for kind, key in (("child", "best1"), ("second child", "best2"),
                              ("operation", "op")):
                if h[key][lane] != c[key][lane]:
                    return dict(at, **_flip(h, c, lane, kind, cfg))
        if len(hs) != len(cs) or hl != cl:
            return dict(where, kind="leaf rule", leaf={"host": hl,
                                                       "card": cl},
                        verdict="beyond bound")
    return {"lane": lane, "kind": "none found", "verdict": "beyond bound"}


def near_ties(trace: Trace, lane: int, upto: int) -> list:
    """The steps of the lane's first ``upto + 1`` inserts whose decision
    was within the rounding bound of another: (insert, step, kind,
    gap, bound).  What another build may decide the other way."""
    cfg = trace.forest.cfg
    out = []
    for i, (_, steps, _) in enumerate(trace.attempts(lane)[:upto + 1]):
        for j, s in enumerate(steps):
            rec = trace.rec.steps[s]
            if not rec["internal"][lane]:
                continue
            for kind in ("child", "second child", "operation"):
                keys, mag, _, mask, _, choice, _ = _decision(rec, lane, kind)
                if choice < 0:
                    continue
                others = mask.copy()
                others[choice] = False
                if not others.any():
                    continue
                rival = int(np.argmax(np.where(others, keys, -np.inf)))
                n = decision_terms(kind, cfg)
                gap = float(keys[choice]) - float(keys[rival])
                bound = n * U * (float(mag[choice]) + float(mag[rival]))
                if gap <= bound:
                    out.append((i, j, kind, gap, bound))
    return out


def compare(host: Trace, card: Trace) -> dict:
    """Every lane slot for slot; the first difference of each lane that
    differs (``first_difference``)."""
    lanes = host.forest.K
    differ = [l for l in range(lanes) if not host.lane_equal(card, l)]
    return {"lanes": lanes, "lanes_differing": differ,
            "first_differences": [first_difference(host, card, l)
                                  for l in differ]}


# ---------------------------------------------------------------------------
# the two recorded cases
# ---------------------------------------------------------------------------

def case_rows(case: str, rows=None, device="cpu"):
    """(whitened rows on ``device``, TreeConfig, lanes) of a case, cut to
    its first ``rows`` rows."""
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.whitening import (PCAICAWhiteningModel,
                                                PCAZCAWhiteningModel)
    c = CASES[case]
    n = c["rows"] if rows is None else int(rows)
    data = synthetic_retrieval_hard(c["corpus"], c["queries"], c["dim"],
                                    seed=c["seed"])
    raw = data.corpus_embs[:n]
    if c["whitener"] == "pcaica":
        wh = PCAICAWhiteningModel.fit(raw, pca_dim=0.96, ica_max_iter=500,
                                      seed=0, ica_sample_size=10000)
    else:
        wh = PCAZCAWhiteningModel.fit(raw, pca_dim=0.96)
    dev = resolve_device(device)
    x = wh.transform_torch(torch.as_tensor(raw, device=dev))
    return x, TreeConfig(dim=wh.dim_out), c["lanes"]


def run_case(case: str, rows=None, device="cuda") -> dict:
    """One case: on the card, the recorded host and card builds compared
    lane by lane, and the recorded card build against an unrecorded one;
    with ``device="cpu"``, the recorded host build alone (its record and
    forest under ``"host"``)."""
    dev = resolve_device(device)
    full_f32_matmul()
    x, cfg, lanes = case_rows(case, rows, dev)
    host = traced_build(x.cpu(), cfg, lanes, "cpu")
    out = {"case": case, "rows": len(x), "lanes": lanes, "dim": cfg.dim,
           "host": host}
    if dev.type == "cpu":
        return out
    card = traced_build(x, cfg, lanes, dev)
    plain = make_forest(cfg, lanes, len(x), dev)
    plain.add(x)
    arrays = tree_mod.state_to_numpy(plain.state)
    out["recorded_equals_graph_build"] = bool(
        all(np.array_equal(arrays[f], card.arrays[f]) for f in arrays)
        and plain._leaf_of_local == card.forest._leaf_of_local)
    out["card"] = card
    out.update(compare(host, card))
    return out


def summary(rec: dict) -> dict:
    """The JSON-able part of a ``run_case`` record."""
    return {k: v for k, v in rec.items() if k not in ("host", "card")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=("a", "b", "both"), default="both")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("build_divergence: needs a CUDA device", file=sys.stderr)
        return 2
    out = []
    for case in (("a", "b") if args.case == "both" else (args.case,)):
        rec = summary(run_case(case, args.rows))
        out.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
