"""The first steps of a trainer on the card against a host copy.

    rec = train_steps.hold(card_trainer, host_trainer, steps)

``host_copy`` makes the copy: the same trainer class on the host
(``device="cpu"``, or the index's host copy for the query trainers) with
the card trainer's parameters and a fresh optimizer.  ``steps`` are
``Step`` objects, one a step (``query_steps``, ``e2e_steps``,
``vicreg_steps``, ``factorvae_steps`` make them from the same batches
and, for FactorVAE, the same draws).  ``dp_steps`` wraps query or
end-to-end steps so that a data-parallel trainer takes each global batch
through ``train_step_dp`` on every rank of its group, held against a
single-process trainer taking it whole.

The steps run in lockstep: before each, the host copy takes the card's
parameters and optimizer state, so a difference shows in the step that
made it.  Both devices run the same float32 arithmetic in another order,
so each step is held to the CPU tests' tolerances: every metric within
1e-5 relative (a difference of larger terms, FactorVAE's ``tc``, within
1e-5 of their magnitude), every parameter after the step within
``atol=1e-5, rtol=1e-4``, with two kinds of near ties excepted:

* Adam moves each entry by ~lr whatever its gradient's size, so an entry
  whose gradient is below ``SETTLE`` of its module's rms gradient (its
  own float32 rounding, n x 2^-24 of its terms, then moves that step by
  more than the tolerance: lr x 256 x 2^-24 x 1e3 = 1.5e-5 at lr 1e-3
  and batches of 256) may step either way; exact zeros are among them
  (the attention's key bias, which the softmax cancels; VICReg's last
  bias, which its loss cannot see);
* a ReLU input within float32 rounding of 0 on one of the batch's rows
  gives its unit that row's gradient on one device and not on the
  other, which parts the unit's weights by up to a step: at most
  ``PARTED_FRAC`` of a tensor's other entries may part so.

Each excepted entry is counted and held to a step of at most
``MAX_STEP_LR`` x lr on each device; a fault of the port moves the
metrics and most entries.  Free-running steps part further (a parted
entry feeds every later gradient), so lockstep is what holds the port to
the rule; the gradients' relative difference is recorded.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from rag_cobweb_tpu_torch.training import factorvae as fv
from rag_cobweb_tpu_torch.training import vicreg as vr
from rag_cobweb_tpu_torch.training.flax_layout import load_flax, to_flax
from rag_cobweb_tpu_torch.training.query_train import (CobwebQueryTrainer,
                                                       epoch_order)
from rag_cobweb_tpu_torch.training.text_encoder import (EndToEndQueryTrainer,
                                                        hash_tokenize)

METRIC_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
SETTLE = 1e-3
PARTED_FRAC = 1e-2
MAX_STEP_LR = 10.0


def modules(tr) -> dict:
    """The trained modules of a trainer, by name."""
    if isinstance(tr, CobwebQueryTrainer):
        return {"head": tr.head}
    if isinstance(tr, EndToEndQueryTrainer):
        return {"encoder": tr.encoder, "head": tr.head}
    if isinstance(tr, vr.VICRegWhitener):
        return {"net": tr.net}
    return {"encoder": tr.encoder, "decoder": tr.decoder, "disc": tr.disc}


def host_copy(tr, host_db=None):
    """A fresh trainer of ``tr``'s class and settings on the host with
    ``tr``'s parameters (the query trainers on ``host_db``, the host copy
    of their index)."""
    lr = optimizers(tr)[0].param_groups[0]["lr"]
    if isinstance(tr, CobwebQueryTrainer):
        lin = tr.head.Dense_0
        out = CobwebQueryTrainer(host_db, lin.in_features, lin.out_features,
                                 tr.temperature, lr)
    elif isinstance(tr, EndToEndQueryTrainer):
        enc = tr.encoder
        vocab, d = enc.Embed_0.weight.shape
        out = EndToEndQueryTrainer(host_db, vocab, d, enc.n_layers,
                                   tr.max_len,
                                   tr.head.Dense_0.out_features,
                                   tr.temperature, lr)
    elif isinstance(tr, vr.VICRegWhitener):
        sim, std, cov = tr.coeffs
        out = vr.VICRegWhitener(tr.in_dim, tr.out_dim, tr.hidden, lr, sim,
                                std, cov, device="cpu")
    else:
        out = fv.FactorVAE(tr.input_dim, tr.z_dim, tr.gamma, lr, tr.hidden,
                           device="cpu")
    for name, m in modules(tr).items():
        load_flax(modules(out)[name], to_flax(m))
    return out


# ---------------------------------------------------------------------------
# the steps of each trainer
# ---------------------------------------------------------------------------

class Step:
    """One training step on fixed inputs, runnable on either trainer."""

    def run(self, tr) -> dict:
        raise NotImplementedError

    def tc_scale(self, tr) -> float:
        """The magnitude a metric that is a difference of larger terms is
        held against (FactorVAE's ``tc``); 0 for the others."""
        return 0.0


class QueryStep(Step):
    def __init__(self, queries, gold):
        self.queries, self.gold = queries, gold

    def run(self, tr):
        return {"loss": tr.train_step(self.queries, self.gold)}


class E2EStep(Step):
    def __init__(self, ids, mask, gold):
        self.ids, self.mask, self.gold = ids, mask, gold

    def run(self, tr):
        loss, gn = tr.train_step(self.ids, self.mask, self.gold)
        return {"loss": loss, "encoder_grad_norm": gn}


class VICRegStep(Step):
    def __init__(self, xa, xb):
        self.xa, self.xb = xa, xb

    def run(self, tr):
        return tr.train_step(self.xa, self.xb)


class FactorVAEStep(Step):
    def __init__(self, x, eps, perm1, perm2):
        self.x, self.draws = x, (eps, perm1, perm2)

    def run(self, tr):
        return tr.train_step(self.x, *self.draws)

    def tc_scale(self, tr):
        eps, _, perm2 = (t.to(tr.device) for t in self.draws)
        with torch.no_grad():
            mu, logvar = tr.encoder(torch.as_tensor(self.x,
                                                    device=tr.device))
            z = fv.reparameterize(mu, logvar, eps)
            return float(tr.disc(z).abs().mean()
                         + tr.disc(fv.permute_dims(z, perm2)).abs().mean())


class DPStep(Step):
    """A query or end-to-end step whose data-parallel trainer ``dp`` takes
    the global batch through ``train_step_dp`` over ``group`` (every rank
    runs it); any other trainer takes it whole."""

    def __init__(self, step, dp, group):
        self.step, self.dp, self.group = step, dp, group

    def run(self, tr):
        if tr is not self.dp:
            return self.step.run(tr)
        st = self.step
        if isinstance(st, QueryStep):
            return {"loss": tr.train_step_dp(st.queries, st.gold,
                                             self.group)}
        loss, gn = tr.train_step_dp(st.ids, st.mask, st.gold, self.group)
        return {"loss": loss, "encoder_grad_norm": gn}


def dp_steps(steps: list, dp, group) -> list:
    """``steps`` (``query_steps`` or ``e2e_steps`` at the global batch)
    run by the data-parallel trainer ``dp`` over ``group``."""
    return [DPStep(s, dp, group) for s in steps]


def _orders(n_items: int, n: int, batch: int, seed: int) -> list:
    """The first ``n`` batches of the query trainers' ``fit`` orders."""
    rng = np.random.default_rng(seed)
    order = np.concatenate([epoch_order(rng, n_items, batch)
                            for _ in range(-(-n * batch // n_items) + 1)])
    return [order[batch * i:batch * (i + 1)] for i in range(n)]


def query_steps(queries, gold, n: int = 5, batch: int = 16,
                seed: int = 0) -> list:
    """``n`` steps on ``CobwebQueryTrainer.fit``'s first batches."""
    queries, gold = np.asarray(queries, np.float32), np.asarray(gold)
    return [QueryStep(queries[s], gold[s])
            for s in _orders(len(gold), n, batch, seed)]


def e2e_steps(texts, gold, vocab: int, max_len: int, n: int = 5,
              batch: int = 16, seed: int = 0) -> list:
    """``n`` steps on ``EndToEndQueryTrainer.fit``'s first batches."""
    ids, mask = hash_tokenize(texts, vocab, max_len)
    gold = np.asarray(gold)
    return [E2EStep(ids[s], mask[s], gold[s])
            for s in _orders(len(gold), n, batch, seed)]


def vicreg_steps(views_a, views_b, n: int = 5, batch: int = 256) -> list:
    """``n`` steps on consecutive batches of paired views."""
    return [VICRegStep(views_a[batch * i:batch * (i + 1)],
                       views_b[batch * i:batch * (i + 1)]) for i in range(n)]


def factorvae_steps(tr, rows, n: int = 5, batch: int = 256) -> list:
    """``n`` steps on consecutive batches, each with one draw of ``tr``'s
    generator (``FactorVAE.draws``), kept on the host for both devices."""
    return [FactorVAEStep(rows[batch * i:batch * (i + 1)],
                          *(t.cpu() for t in tr.draws(batch)))
            for i in range(n)]


def optimizers(tr) -> list:
    return [tr.opt] if hasattr(tr, "opt") else [tr.opt_vae, tr.opt_disc]


def sync(host, card):
    """The host copy takes the card trainer's parameters and optimizer
    state."""
    for name, m in modules(card).items():
        load_flax(modules(host)[name], to_flax(m))
    for oh, oc in zip(optimizers(host), optimizers(card)):
        oh.load_state_dict(copy.deepcopy(oc.state_dict()))


def hold(card, host, steps: list) -> dict:
    """Run ``steps`` in lockstep on the card trainer and its host copy;
    the record of each step's metrics on both, the worst differences and
    the excepted entries, ``ok`` False where the rule of the module
    docstring fails."""
    lr = optimizers(host)[0].param_groups[0]["lr"]
    rec = {"steps": len(steps), "metrics_card": [], "metrics_host": [],
           "worst_metric_rel": 0.0, "worst_grad_rel": 0.0,
           "worst_param_excess": 0.0, "unsettled": 0, "parted": 0,
           "entries": 0, "fails": []}
    for i, step in enumerate(steps):
        sync(host, card)
        before = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
                  for k, m in modules(host).items()}
        scale = step.tc_scale(host)
        mc = {k: float(v) for k, v in step.run(card).items()}
        mh = {k: float(v) for k, v in step.run(host).items()}
        rec["metrics_card"].append(mc)
        rec["metrics_host"].append(mh)
        for k, want in mh.items():
            err = abs(mc[k] - want)
            rec["worst_metric_rel"] = max(rec["worst_metric_rel"],
                                          err / max(abs(want), 1e-30))
            if err > METRIC_RTOL * (abs(want) + (k == "tc") * scale):
                rec["fails"].append(("metric", i, k, mc[k], want))
        for k, m in modules(host).items():
            theirs = dict(modules(card)[k].named_parameters())
            pairs = [(n, p, theirs[n]) for n, p in m.named_parameters()
                     if p.grad is not None]
            gh = torch.cat([p.grad.flatten() for _, p, _ in pairs])
            gc = torch.cat([q.grad.detach().cpu().flatten()
                            for _, _, q in pairs])
            rec["worst_grad_rel"] = max(rec["worst_grad_rel"],
                                        float((gc - gh).norm() / gh.norm()))
            rms = float(gh.pow(2).mean().sqrt())
            for n, p, q in pairs:
                got, want = q.detach().cpu(), p.detach()
                loose = p.grad.abs() <= SETTLE * rms
                excess = ((got - want).abs()
                          - (PARAM_ATOL + PARAM_RTOL * want.abs()))
                parted = ~loose & (excess > 0)
                rec["unsettled"] += int(loose.sum())
                rec["parted"] += int(parted.sum())
                rec["entries"] += loose.numel()
                if (~loose).any():
                    rec["worst_param_excess"] = max(
                        rec["worst_param_excess"], float(excess[~loose].max()))
                if int(parted.sum()) > PARTED_FRAC * int((~loose).sum()):
                    rec["fails"].append(("parameter", i, k, n,
                                         int(parted.sum()),
                                         float(excess.max())))
                for x in (got, want):
                    moved = (x - before[k][n])[loose | parted].abs()
                    if len(moved) and float(moved.max()) > MAX_STEP_LR * lr:
                        rec["fails"].append(("excepted step", i, k, n,
                                             float(moved.max())))
    rec["ok"] = not rec["fails"]
    return rec
