"""One run of one cell: set-up from the seed, the measured window, the
check against the reference, and the result's line.

The port is driven only through its serving API: ``CobwebIndex`` with a
wrapper-owned whitener, ``add_sentences`` and ``query_ids``.  Rows reach
it from host memory, as a client's would.  The check reads the port's
forest state after the window (``reference`` follows it for the sweep
pool, and checks it by itself).  After the window a few calls of the
mix with the backstop off (``post_calls``, not timed) hold the sweep's
pool to the reference: with it on, the backstop alone may find every
answer.  Where the window adds rows, the index that served it was built
from a state that later adds changed, so one more add with stale reads
off first makes the port rebuild over its final state.
"""

from __future__ import annotations

import sys
import time
import numpy as np
import torch

from perfbench import check as check_mod
from perfbench import gen
from perfbench import trace as trace_mod


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# what the harness drives; any other value of these keys is refused, not
# run as something it is not
SUPPORTED = {("index", "engine"): "fused",
             ("index", "store"): "raw float32",
             ("index", "whitener", "kind"): "pcaica"}
SUPPORTED_LOOP = "closed, one caller"


def validate(cfg: dict, mix: dict):
    """Refuse a configuration or mix that asks for what the harness does
    not drive."""
    for path, want in SUPPORTED.items():
        v = cfg
        for key in path:
            v = v.get(key) if isinstance(v, dict) else None
        if v != want:
            raise ValueError(f"{'.'.join(path)} = {v!r}: the harness drives "
                             f"only {want!r}")
    if mix.get("loop") != SUPPORTED_LOOP:
        raise ValueError(f"loop = {mix.get('loop')!r}: the harness drives "
                         f"only {SUPPORTED_LOOP!r}")


class Staleness:
    """The configuration's staleness rule, worked out from the calls alone:
    which rows the serving index covers when a query runs.  An add keeps
    the index while the unindexed rows stay within max(``delta_rebuild_min``,
    ``delta_rebuild_frac`` x indexed rows); past that the index is dropped
    and the next query rebuilds it over every row."""

    def __init__(self, cfg: dict):
        st = cfg["index"]["staleness"]
        self.lo = int(st["delta_rebuild_min"])
        self.frac = float(st["delta_rebuild_frac"])
        self.n = 0
        self.indexed = None     # rows the serving index covers, or none
        self.rebuilds = 0

    def add(self, m: int, stale_reads: bool = True):
        unindexed = self.n - (self.indexed or 0)
        if (stale_reads and self.indexed is not None and unindexed + m
                <= max(self.lo, int(self.frac * max(self.indexed, 1)))):
            self.n += m
            return
        self.n += m
        self.indexed = None

    def query(self) -> int:
        if self.indexed is None:
            self.indexed = self.n
            self.rebuilds += 1
        return self.indexed


class Setup:
    """What set-up made: the device rows, their host copies, the port's
    index, and the schedule of the window."""

    def __init__(self, cfg, mix, seed, dev, port):
        validate(cfg, mix)
        self.cfg, self.mix, self.dev, self.seed = cfg, mix, dev, seed
        ix = cfg["index"]
        self.k, self.pool = int(ix["k"]), int(ix["rerank"])
        n_fresh = int(mix.get("fresh_rows", 0))
        self.fresh_chunk = n_fresh or 1 << 16
        self.data = gen.make_data(cfg, seed, dev, n_fresh)
        _sync(dev)
        d = self.data
        self.N = d.corpus.shape[0]
        self.q_host = d.queries.cpu().numpy()
        self.fq_host = d.fresh_queries.cpu().numpy()
        self.fresh_host = d.fresh.cpu().numpy()
        self.gold = d.gold.cpu().numpy()
        wh = ix["whitener"]
        pca = wh["pca_dim"]
        fit_rows = d.corpus[:int(wh["fit_rows"])].cpu().numpy()
        t0 = time.perf_counter()
        self.whitener = port.PCAICAWhiteningModel.fit(
            fit_rows, pca_dim=pca, ica_max_iter=int(wh["ica_max_iter"]),
            seed=0, ica_sample_size=int(wh["ica_sample_size"]))
        log(f"[perfbench] whitener -> {self.whitener.dim_out} in "
            f"{time.perf_counter() - t0:.1f}s")
        K = int(ix["lanes"])
        slots = 2 * (self.N + n_fresh)
        db = port.CobwebIndex(
            config=port.TreeConfig(
                dim=self.whitener.dim_out,
                prior_var=float(cfg["tree"]["prior_var"]),
                acuity_cutoff=bool(cfg["tree"]["acuity_cutoff"])),
            capacity=K * max(2048, slots // K + 64), n_subtrees=K, seed=0,
            whitener=self.whitener, device=dev)
        db.use_pallas = False           # the fused engine at every size
        st = ix["staleness"]
        db.stale_reads = bool(st["stale_reads"])
        db.stale_pending_limit = int(st["stale_pending_limit"])
        db.delta_rebuild_min = int(st["delta_rebuild_min"])
        db.delta_rebuild_frac = float(st["delta_rebuild_frac"])
        db.backstop_pool = ix["backstop_pool"]
        db.backstop_threshold = int(ix["backstop_threshold"])
        self.db = db
        self.stale = Staleness(cfg)
        t0 = time.perf_counter()
        chunk = K * int(ix["build_rows_per_lane"])
        for s in range(0, self.N, chunk):
            m = min(chunk, self.N - s)
            db.add_sentences([None] * m, d.corpus[s:s + m].cpu().numpy())
            self.stale.add(m)
        _sync(dev)
        self.build_s = time.perf_counter() - t0
        log(f"[perfbench] built {self.N} rows in {self.build_s:.1f}s "
            f"({self.N / self.build_s:.0f} rows/s)")
        self.sched = gen.Schedule(mix, len(self.q_host), seed)
        self.added = 0
        self.calls = []
        self.post_calls = []

    def backstop_size(self, n_rows: int) -> int:
        ix = self.cfg["index"]
        bs = ix["backstop_pool"]
        if bs == "auto":
            return (self.pool if n_rows >= int(ix["backstop_threshold"])
                    else 0)
        return int(bs)

    def _more_fresh(self, upto: int):
        """Window rows past those made in set-up, drawn from the seed a
        chunk at a time (only a program faster than the mix was sized for
        gets here)."""
        d = self.data
        while d.fresh.shape[0] < upto:
            j = d.fresh.shape[0] // self.fresh_chunk
            f, fq = gen.fresh_chunk(self.cfg, self.seed, self.dev, j,
                                    self.fresh_chunk)
            d = d._replace(fresh=torch.cat([d.fresh, f]),
                           fresh_queries=torch.cat([d.fresh_queries, fq]))
            self.fresh_host = np.concatenate([self.fresh_host,
                                              f.cpu().numpy()])
            self.fq_host = np.concatenate([self.fq_host, fq.cpu().numpy()])
        self.data = d

    def step(self, traced: bool = False) -> dict:
        """One call of the schedule, timed from the call until its answer
        is on the host (an add: until the device is done)."""
        call = self.sched.next()
        rec = self._add(call.add) if call.add else self._query(call)
        rec["traced"] = traced
        self.calls.append(rec)
        return rec

    def _add(self, m: int, stale_reads: bool = True) -> dict:
        if self.added + m > self.fresh_host.shape[0]:
            self._more_fresh(self.added + m)
        rows = self.fresh_host[self.added:self.added + m]
        t0 = time.perf_counter()
        with torch.profiler.record_function("add"):
            self.db.add_sentences([None] * m, rows)
            _sync(self.dev)
        dt = time.perf_counter() - t0
        self.added += m
        self.stale.add(m, stale_reads)
        return {"add": m, "dt": dt, "t": t0}

    def _query(self, call) -> dict:
        batch = np.concatenate([self.q_host[call.pool],
                                self.fq_host[call.fresh]])
        n_idx = self.stale.query()
        t0 = time.perf_counter()
        with torch.profiler.record_function("query"):
            ids = self.db.query_ids(batch, self.k, rerank=self.pool).cpu()
        dt = time.perf_counter() - t0
        gold = np.concatenate([self.gold[call.pool], self.N + call.fresh])
        return {"add": 0, "dt": dt, "t": t0, "B": len(batch),
                "pool": call.pool, "fresh": call.fresh, "ids": ids,
                "gold": gold, "n_total": self.N + self.added,
                "n_indexed": n_idx}

    def sweep_calls(self, n: int):
        """After the window, ``n`` query calls of the mix with the backstop
        off, kept apart in ``post_calls``: their answers come from the
        sweep's pool alone.  Where the window added rows, one more add
        with stale reads off comes first, so the port rebuilds its index
        over the forest state as it now stands."""
        db = self.db
        backstop = db.backstop_pool
        try:
            if self.sched.add_every:
                db.stale_reads = False
                self._add(self.sched.add_now().add, stale_reads=False)
            db.backstop_pool = 0
            self.post_calls = [self._query(self.sched.next_query())
                               for _ in range(n)]
        finally:
            db.backstop_pool = backstop
            db.stale_reads = bool(
                self.cfg["index"]["staleness"]["stale_reads"])


def _warm(s: Setup, calls: int):
    """Set-up's last part: the window's own calls, ``calls`` steps of the
    schedule (its adds go into the index like any other)."""
    for _ in range(calls):
        s.step()
    _sync(s.dev)
    s.calls.clear()


def window(s: Setup, seconds: float, trace: bool) -> dict:
    """The measured window: the schedule's calls for ``seconds``, a stretch
    of it under the profiler where ``trace``."""
    dev, mix = s.dev, s.mix
    s.calls.clear()
    prof, on, n_traced = None, False, 0
    lo, hi = (float(f) * seconds for f in mix["traced_stretch"])
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while (now := time.perf_counter()) < deadline:
        if trace and prof is None and now - t_start >= lo:
            prof, on = _profiler(), True
            prof.start()
        # the stretch holds at least one call, however long calls take
        if on and n_traced and now - t_start >= hi:
            _sync(dev)
            prof.stop()
            on = False
        s.step(traced=on)
        n_traced += on
    t_end = time.perf_counter()
    if on:
        _sync(dev)
        prof.stop()
    window_s = t_end - t_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    stretch = trace_mod.from_profiler(prof) if prof is not None else None
    log(f"[perfbench] window {window_s:.3f}s, "
        f"{sum(1 for c in s.calls if not c['add'])} query calls, "
        f"{sum(c['add'] for c in s.calls)} rows added, "
        f"{s.stale.rebuilds} index builds in all")
    if stretch is not None:
        _log_profiler_cost(s.calls, stretch.window_s)
    return {"setup": s, "window_s": window_s,
            "memory_peak_bytes": int(peak), "stretch": stretch}


def _log_profiler_cost(calls, stretch_s: float):
    """How far the profiler slows the host: each kind of call's mean time
    in the traced stretch against the rest of the window's (an idle share
    read under the profiler is read on a slowed host)."""
    for kind, pick in (("query", lambda c: not c["add"]),
                       ("add", lambda c: c["add"])):
        tr = [c["dt"] for c in calls if pick(c) and c["traced"]]
        un = [c["dt"] for c in calls if pick(c) and not c["traced"]]
        if tr and un:
            a, b = sum(tr) / len(tr), sum(un) / len(un)
            log(f"[perfbench] profiler: {kind} {1e3 * a:.3f} ms over "
                f"{len(tr)} calls in the {stretch_s:.3f}s stretch, "
                f"{1e3 * b:.3f} ms over {len(un)} outside: {a / b:.3f}x")


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, port, t_process: float,
        fault=None, control: bool = False) -> dict:
    """Set up, warm up, measure for ``seconds``, check; returns the parts
    of the result (``run.py`` prints them).  ``fault(setup)`` (tests only)
    breaks the program's timed path after set-up."""
    s = Setup(cfg, mix, seed, dev, port)
    _warm(s, int(mix["warm_steps"]))
    if trace:
        _profiler_warm()
    if fault is not None:
        fault(s)
    setup_s = time.perf_counter() - t_process
    log(f"[perfbench] set-up {setup_s:.1f}s")
    res = window(s, seconds, trace)
    res["setup_s"] = setup_s
    res["verdict"] = check_mod.check(s, seed, trace, control)
    return res


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _profiler_warm():
    """Start and stop the profiler once in set-up: its first start loads
    the tracing library, which is no work of the window."""
    p = _profiler()
    p.start()
    torch.zeros(1, device="cuda" if torch.cuda.is_available()
                else "cpu").add_(1)
    p.stop()


def result_metrics(res: dict, bench: dict, cell: dict, trace: bool,
                   readers) -> dict:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones
    (``trace`` True), each ``{"value", "unit"}``; a reader that finds
    nothing leaves its metric out."""
    name = cell["name"]
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        cells = m.get("workloads")
        if cells is not None and name not in cells:
            continue
        v = readers(m["name"])(res)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_info(res: dict, dev, trace: bool) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace and res["stretch"] is not None:
        info["busy_s"] = trace_mod.busy_s(res["stretch"])
        info["window_s"] = res["stretch"].window_s
    return info
