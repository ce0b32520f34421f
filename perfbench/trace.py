"""A traced stretch of the window: ``torch.profiler`` over a steady part of
it, reduced to plain lists, and what the per-layer metrics read from them.

``device`` holds each operation that ran on the card as (start us, end
us, name); ``host`` each host range (start us, end us, name), the
harness's own ``record_function`` ranges (``query``, ``add``) among
them.  Both are on the profiler's one clock.  ``busy_us`` (the union of
the device intervals) is copied from the port's ``bench/build_idle``.
"""

from __future__ import annotations

from typing import NamedTuple

HARNESS_RANGES = ("query", "add")


class Stretch(NamedTuple):
    device: list      # [(start_us, end_us, name)]
    host: list        # [(start_us, end_us, name)]
    t0_us: float      # the stretch's start and end on the same clock
    t1_us: float

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) * 1e-6


def from_profiler(prof) -> Stretch:
    """The lists of a finished ``torch.profiler.profile``; the stretch runs
    from the first harness range's start to the last one's end."""
    import torch
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        span = (float(e.time_range.start), float(e.time_range.end), e.name)
        if e.device_type != cuda:
            host.append(span)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name in HARNESS_RANGES):
            # a range's image on the device's timeline is no operation
            dev.append(span)
    ranges = [h for h in host if h[2] in HARNESS_RANGES]
    if not ranges:
        raise RuntimeError("the traced stretch holds no harness call")
    t0 = min(s for s, _, _ in ranges)
    t1 = max(t for _, t, _ in ranges)
    clip = [(max(s, t0), min(t, t1), n) for s, t, n in dev if t > t0
            and s < t1]
    return Stretch(clip, host, t0, t1)


def busy_us(spans) -> float:
    """The union of the intervals' lengths."""
    total, end = 0.0, float("-inf")
    for s, t, *_ in sorted(spans):
        if t <= end:
            continue
        total += t - max(s, end)
        end = t
    return total


def device_s_by(stretch: Stretch, match) -> float:
    """Seconds of device operations whose name ``match(name)`` accepts."""
    return 1e-6 * sum(t - s for s, t, n in stretch.device if match(n))


def busy_s(stretch: Stretch) -> float:
    return 1e-6 * busy_us(stretch.device)


def _gaps(stretch: Stretch):
    """Idle intervals of the device inside the stretch."""
    out, end = [], stretch.t0_us
    for s, t, _ in sorted(stretch.device):
        if s > end:
            out.append((end, s))
        end = max(end, t)
    if stretch.t1_us > end:
        out.append((end, stretch.t1_us))
    return out


def _label(stretch: Stretch, at: float) -> str:
    """What the host was doing at ``at``: the harness range around it and
    the innermost host operation inside that range."""
    around = [(t - s, n) for s, t, n in stretch.host if s <= at <= t]
    if not around:
        return "harness"
    outer = [n for _, n in sorted(around, reverse=True)
             if n in HARNESS_RANGES]
    inner = min(around)[1]
    top = outer[0] if outer else "harness"
    return top if inner == top else f"{top}:{inner}"


def breakdown(stretch: Stretch, n: int = 10) -> dict:
    """The ``n`` device operations with most time (by name) and the ``n``
    longest idle gaps, each named by what the host was doing."""
    by = {}
    for s, t, name in stretch.device:
        by[name] = by.get(name, 0.0) + (t - s) * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(_gaps(stretch), key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[_label(stretch, 0.5 * (a + b)), (b - a) * 1e-6]
                          for a, b in gaps]}
