"""Kernel 5 (the exact re-rank) against its roofline: each traced call's
live candidate pairs and distinct rows, worked out by the reference from
one traced call's pools."""

from perfbench import readers, roofline


def read(res):
    w = res["verdict"].get("rerank_work")
    if not w:
        return None
    D = res["setup"].data.corpus.shape[1]
    calls = readers.traced_queries(res)
    per = roofline.kernel5(w["B"], w["pairs"] / w["B"], D, w["rows"])
    work = roofline.Work(per.flops * len(calls), per.bytes * len(calls),
                         per.peak_flops)
    return readers.device_share(res, work, lambda n: "rerank_l2" in n)
