"""Published peaks of one NVIDIA H100 SXM and the operations and bytes
that each hand-written kernel needs for one call of the served path.

The peaks are the data sheet's dense rates (copied from the port's
``bench/roofline.py``).  The counts are corrected from that file: each
input byte is read once and each output byte written once, and only what
the function needs is charged, not what one design of it moves.  Kernel 1
keeps its (B, Sp) score matrix on chip, so none is charged: it reads the
(2D, S) matrix, its bias and mask and the query terms, and writes one
(score, id) pool of ``kappa`` a query.  The per-slab pools that the
present kernel writes (``kappa`` per slab of 2048 rows and query) and
then merges are its design's traffic, not the function's, and are not
charged: a later design that drops them keeps the same bound.  Kernel 5 reads each distinct
candidate row once, the queries, and each candidate's id and pool score,
and writes one key per candidate.  Only live rows count: padding columns
of a slab or of a store's capacity are no work the call needs.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_BF16 = 989e12     # FLOP/s, tensor cores, dense
PEAK_F32 = 67e12       # FLOP/s, CUDA cores
HBM_BPS = 3.35e12      # bytes/s


class Work(NamedTuple):
    flops: float
    bytes: float
    peak_flops: float

    def least_s(self) -> float:
        """The least time the chip could take: the larger of the two."""
        return max(self.flops / self.peak_flops, self.bytes / HBM_BPS)

    def __add__(self, o):
        if self.flops * o.flops and self.peak_flops != o.peak_flops:
            raise ValueError("work at different peaks cannot be summed")
        return Work(self.flops + o.flops, self.bytes + o.bytes,
                    self.peak_flops if self.flops else o.peak_flops)


NONE = Work(0.0, 0.0, PEAK_BF16)


def kernel1(B: int, two_d: int, rows: int, kappa: int,
            elt: int = 2) -> Work:
    """One sweep of kernel 1: ``B`` queries of ``two_d`` terms against
    ``rows`` live columns in ``elt``-byte operands, a pool of ``kappa`` a
    query out."""
    flops = 2.0 * B * two_d * rows
    read = two_d * rows * elt + rows * (4 + 1) + B * two_d * elt
    write = B * min(kappa, rows) * (4 + 4)
    return Work(flops, read + write, PEAK_BF16 if elt == 2 else PEAK_F32)


def kernel5(B: int, C: int, D: int, distinct_rows: int) -> Work:
    """One re-rank of kernel 5: ``B`` queries, ``C`` candidates each,
    ``distinct_rows`` f32 rows of ``D`` read once; a difference, a square
    and a sum a dimension and pair."""
    flops = 3.0 * B * C * D
    read = distinct_rows * D * 4 + B * D * 4 + B * C * (4 + 4)
    return Work(flops, read + B * C * 4, PEAK_F32)


def share(work: Work, device_s: float):
    """Percent of the roofline reached, or None without device time."""
    if device_s <= 0 or work.flops <= 0:
        return None
    return 100.0 * work.least_s() / device_s
