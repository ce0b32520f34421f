"""Tracing and profiling (port of ``rag_cobweb_tpu/utils/profiling.py``,
on ``torch.profiler`` where the JAX package used ``jax.profiler``):

  * ``PhaseTimer``: accumulating named phases of wall time; on the card
    each phase starts and ends with ``torch.cuda.synchronize(device)``, so
    a phase holds the device work it queued;
  * ``trace(log_dir)``: a ``torch.profiler.profile`` of the host and, on
    the card, the device, exported as a Chrome trace into ``log_dir``;
  * ``span(name, **attrs)``: the program's spans, read by ``records()``;
  * ``count``/``counters()``: the program's counter registry;
  * ``events()``: a small always-on log of the spans made with ``log``
    (the serving-index rebuilds): a few entries a window.

Spans.  Each records its name, its start and end on
``time.perf_counter_ns`` (the clock of a caller's ``time.perf_counter``),
its parent span and the id of its request: the outermost span of a call
(``serve.query``, ``serve.add``) opens a request, and every span inside it
shares that id.  Attributes are the call's sizes; a span given
``counters`` also stores those counters' deltas over its interval.  A
span given ``device`` (True, or the device its work runs on) records a
pair of timing CUDA events on the current stream at its edges; the
stream milliseconds between them are read when ``records()`` is.
Records go into a bounded buffer (``MAX_RECORDS``, oldest dropped),
read by ``records()`` and emptied by ``clear()``.

Spans are on while a ``torch.profiler`` session records, or while the
operator switch is on (``tracing(True)``, or ``RAG_COBWEB_TRACE=1`` in
the environment, read once at import).  Under the profiler each span is
also a ``record_function`` range, so its start and end sit on the
profiler's clock beside the device's operations, and ``trace``'s Chrome
file holds it.  Off, a span site costs one check and gets a shared no-op
context: no record, no event, no ``record_function``.  A span made with
``log`` is the exception: whatever the switch it enters ``events()``,
timed by its CUDA events on the card (so that its device tail counts),
else by the host clock.

Names carry their layer as a prefix (``serve.``, ``engine.``,
``tiers.``, ``index.``, ``insert.``); none is ``query`` or ``add``, the
names a benchmark gives its own ranges around the calls.

Counters are plain integers, always on, never reset: a reader takes the
difference of two ``counters()`` snapshots.  The kernels' launches
(``launch.<kernel>``, every launch, and ``launch.<kernel>_<entry>`` those
of a second entry; ``launch.backstop`` and ``launch.pending`` those made
for the backstop pool and the pending tier) and the insert's work
(``INSERT_COUNTERS``, whose deltas each ``serve.add`` span carries: why
an add was slow).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque

import torch

from rag_cobweb_tpu_torch.device import resolve_device


class PhaseTimer:
    """Accumulating named-phase wall timer.  ``sync``: on a CUDA
    ``device``, synchronize it at each phase's start and end (on the host
    there is nothing to wait for)."""

    def __init__(self, sync: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.sync = sync and self.device.type == "cuda"
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def _sync(self):
        if self.sync:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'phase':<28} {'total_s':>9} {'calls':>6} {'mean_ms':>9}"]
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<28} {total:>9.3f} {n:>6} {1000 * total / n:>9.3f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {name: {"total_s": self.totals[name],
                       "calls": self.counts[name]}
                for name in self.totals}


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block with ``torch.profiler`` (host activity, and the
    device's on a CUDA ``device``) and write its Chrome trace to
    ``log_dir/trace.json``.  Yields the profiler, whose ``key_averages()``
    sum the recorded events by name once the block has ended."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

INSERT_COUNTERS = (
    "insert.rounds",          # lockstep descents (one row a lane each)
    "insert.steps",           # descent steps over all rounds
    "insert.syncs",           # points where the insert waits on the device
    "insert.retry_waves",
    "insert.exact",           # rows inserted alone on the exact path
    "insert.graph_captures",  # step graphs captured
    "insert.grows",           # state capacity growths
)

_counts: defaultdict = defaultdict(int)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name``."""
    _counts[name] += n


def counter(name: str) -> int:
    return _counts.get(name, 0)


def counters() -> dict:
    """A snapshot of every counter."""
    return dict(_counts)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

ENV_VAR = "RAG_COBWEB_TRACE"
MAX_RECORDS = 1 << 17
MAX_EVENTS = 4096

_switch = os.environ.get(ENV_VAR, "0") not in ("", "0")
_profiler_enabled = torch._C._autograd._profiler_enabled
_records: deque = deque(maxlen=MAX_RECORDS)
_events: deque = deque(maxlen=MAX_EVENTS)
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()


def tracing(on: bool) -> bool:
    """Turn the operator switch on or off; returns its former state."""
    global _switch
    was, _switch = _switch, bool(on)
    return was


def enabled() -> bool:
    """Whether spans record now: the switch is on or a profiler records."""
    return _switch or _profiler_enabled()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _cuda_pair(device):
    """A started pair of timing events where ``device`` (True: the current
    CUDA device; or a torch.device) is a CUDA device, else None."""
    if device is True:
        if not torch.cuda.is_initialized():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    elif not isinstance(device, torch.device) or device.type != "cuda":
        return None
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    pair[0].record(torch.cuda.current_stream(device))
    return pair, device


class _Record:
    __slots__ = ("name", "id", "parent", "request", "t0_ns", "t1_ns",
                 "attrs", "events", "device_ms")

    def resolve(self):
        """Read the stream ms of the record's CUDA events, once."""
        if self.events is not None:
            a, b = self.events
            b.synchronize()
            self.device_ms = a.elapsed_time(b)
            self.events = None

    def as_dict(self) -> dict:
        self.resolve()
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "t0_ns": self.t0_ns,
                "t1_ns": self.t1_ns, "attrs": self.attrs,
                "device_ms": self.device_ms}


class _NoSpan:
    """The shared context of a span site while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    request = None


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("rec", "device", "counters", "log", "on", "base", "rf",
                 "pair")

    def __init__(self, name, device, counters, log, attrs):
        rec = self.rec = _Record()
        rec.name, rec.attrs = name, attrs
        rec.id = rec.parent = rec.request = None
        rec.events = rec.device_ms = None
        self.device, self.counters, self.log = device, counters, log

    def set(self, **attrs):
        self.rec.attrs.update(attrs)

    @property
    def request(self) -> int:
        """The id of the request the span belongs to."""
        return self.rec.request

    def __enter__(self):
        rec = self.rec
        # a logged span with tracing off enters the event log alone
        self.on = _switch or _profiler_enabled()
        self.rf = None
        if self.on:
            stack = _stack()
            rec.id = next(_ids)
            if stack:
                rec.parent, rec.request = stack[-1].id, stack[-1].request
            else:
                rec.request = next(_requests)
            stack.append(rec)
            if _profiler_enabled():
                self.rf = torch.profiler.record_function(rec.name)
                self.rf.__enter__()
        self.pair = _cuda_pair(self.device) if self.device else None
        self.base = [_counts[c] for c in self.counters]
        rec.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1_ns = time.perf_counter_ns()
        if self.pair is not None:
            (a, b), dev = self.pair
            b.record(torch.cuda.current_stream(dev))
            rec.events = (a, b)
        if self.counters:
            rec.attrs["counters"] = {c: _counts[c] - n for c, n in
                                     zip(self.counters, self.base)}
        if self.on:
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            stack = _stack()
            if stack and stack[-1] is rec:
                stack.pop()
            _records.append(rec)
        if self.log:
            _events.append(rec)
        return False


def span(name: str, device=False, counters=(), log=False, **attrs):
    """A span named ``name`` (a context manager; ``set(**attrs)`` adds
    attributes inside it).  ``device``: True or the device the work runs
    on, to time the span on the CUDA stream; ``counters``: names whose
    deltas over the span join its attributes under ``"counters"``;
    ``log``: enter ``events()`` whatever the tracing switch."""
    if not (log or _switch or _profiler_enabled()):
        return _NOOP
    return _Span(name, device, counters, log, attrs)


def records() -> list:
    """The buffered spans in the order they ended, each a dict: ``name``,
    ``id``, ``parent`` (the enclosing span's id or None), ``request``,
    ``t0_ns``/``t1_ns`` (``time.perf_counter_ns``), ``attrs`` and
    ``device_ms`` (stream ms of a device-timed span on the card, else
    None; reading it waits for the span's work)."""
    return [r.as_dict() for r in list(_records)]


def clear():
    """Empty the span buffer and the event log."""
    _records.clear()
    _events.clear()


def events() -> list:
    """The logged spans, oldest first, each a dict: ``name``, ``t0_ns``
    (``time.perf_counter_ns`` at its start), ``s`` (its duration: its
    CUDA events on the card, else the host clock), ``host_s`` and
    ``attrs``."""
    out = []
    for r in list(_events):
        r.resolve()
        host_s = 1e-9 * (r.t1_ns - r.t0_ns)
        out.append({"name": r.name, "t0_ns": r.t0_ns, "host_s": host_s,
                    "s": host_s if r.device_ms is None
                    else 1e-3 * r.device_ms, "attrs": r.attrs})
    return out
