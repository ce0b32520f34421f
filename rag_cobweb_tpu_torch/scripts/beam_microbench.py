"""Beam-expansion scoring forms timed on the card (twin of
``scripts/beam_microbench.py``): a beam level scores (B, W*F) candidate
nodes against the query batch; the forms below do that over ``--levels``
levels, each level deriving the next frontier from its winners (data
dependent, so no level can be hoisted):

  gather2xf32   two f32 row gathers of the (N, D) tables
  gather1xbf16  one gather of an interleaved bf16 (N, 2D) table
  block_slice   a contiguous child block a parent (start + arange(F))
  lanes_vmap    gather2xf32 over ``--k-lanes`` lanes at once
  beam_pack     the port's production form, ``core/index.beam_pack_topk``,
                on a ``BeamIndex`` of the same N and D (a complete F-ary
                tree in BFS order, a sentence a leaf), as deep as the tree

    python -m rag_cobweb_tpu_torch.scripts.beam_microbench [--n 100000] \\
        [--d 456] [--b 128] [--w 32] [--f 16] [--k-lanes 8] \\
        [--levels 96] [--device cuda]

The four forms are PyTorch loops over the JAX script's ``lax.scan``
bodies on the same ``default_rng(0)`` draws; products in f32 (TF32 off),
the bf16 forms' rows widened to f32 (exact products).  Each returns the
sum of its top scores over every level (``checksum``), as the JAX forms
do.  Time: the best of 3 calls each ended by a synchronize, after a warm
call (the JAX script subtracts a 30 ms relay round trip, which has no
counterpart).  The bytes each form gathers are set against the H100's
HBM rate (``bench/roofline.H100_HBM_BW``), not the TPU's.  Not carried
over, as it exists only for the TPU: the XLA compile cache.
"""

import argparse
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device


def inputs(N: int, D: int, B: int, W: int, F: int):
    """The JAX script's draws, in its order, as host arrays."""
    rng = np.random.default_rng(0)
    movt = rng.normal(size=(N, D)).astype(np.float32)
    ivt = rng.uniform(0.5, 2.0, size=(N, D)).astype(np.float32)
    const = rng.normal(size=(N,)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    nodes = rng.integers(0, N, size=(B, W * F)).astype(np.int32)
    starts = rng.integers(0, N - F, size=(B, W)).astype(np.int32)
    return movt, ivt, const, q, nodes, starts


def _next(win, lv: int, N: int, F: int, ar):
    """((win * 7 + lv + arange(F)) % N) as a (B, W*F) frontier."""
    return ((win.unsqueeze(2) * 7 + lv + ar) % N).reshape(win.shape[0], -1)


def gather2xf32(ivt, movt, const, nodes, q, W, F, L):
    N, ar = ivt.shape[0], torch.arange(F, device=q.device)
    nds, total = nodes.long(), torch.zeros((), device=q.device)
    x = q.unsqueeze(1)
    for lv in range(L):
        s = (torch.sum(x * movt[nds], -1)
             - 0.5 * torch.sum(torch.square(x) * ivt[nds], -1) + const[nds])
        top, ids = torch.topk(s, W, dim=1)
        nds = _next(nds.gather(1, ids), lv, N, F, ar)
        total = total + top.sum()
    return total


def gather1xbf16(inter, const, nodes, qq, W, F, L):
    N, ar = inter.shape[0], torch.arange(F, device=qq.device)
    nds, total = nodes.long(), torch.zeros((), device=qq.device)
    qb = qq.to(torch.bfloat16).float().unsqueeze(2)
    for lv in range(L):
        s = torch.bmm(inter[nds].float(), qb).squeeze(2) + const[nds]
        top, ids = torch.topk(s, W, dim=1)
        nds = _next(nds.gather(1, ids), lv, N, F, ar)
        total = total + top.sum()
    return total


def block_slice(inter, const, starts, qq, W, F, L):
    N, ar = inter.shape[0], torch.arange(F, device=qq.device)
    st, total = starts.long(), torch.zeros((), device=qq.device)
    qb = qq.to(torch.bfloat16).float().unsqueeze(2)
    B = qq.shape[0]
    for lv in range(L):
        idx = (st.unsqueeze(2) + ar).reshape(B, -1)
        s = torch.bmm(inter[idx].float(), qb).squeeze(2) + const[idx]
        top, ids = torch.topk(s, W, dim=1)
        st = (idx.gather(1, ids) * 5 + lv) % (N - F)
        total = total + top.sum()
    return total


def lanes_vmap(ivt_l, movt_l, const_l, nodes, q, W, F, L):
    """gather2xf32 on each of the KL lanes' tables at once: the lanes'
    rows are one (KL N, D) table, each lane's ids offset by its base."""
    KL, N, D = ivt_l.shape
    B = q.shape[0]
    ar = torch.arange(F, device=q.device)
    base = (torch.arange(KL, device=q.device) * N).view(KL, 1, 1)
    iv, mv, cs = ivt_l.view(-1, D), movt_l.view(-1, D), const_l.view(-1)
    nds = nodes.long().unsqueeze(0).expand(KL, -1, -1)
    x = q.view(1, B, 1, D)
    total = torch.zeros((), device=q.device)
    for lv in range(L):
        g = nds + base
        s = (torch.sum(x * mv[g], -1)
             - 0.5 * torch.sum(torch.square(x) * iv[g], -1) + cs[g])
        top, ids = torch.topk(s, W, dim=2)
        win = nds.gather(2, ids)
        nds = ((win.unsqueeze(3) * 7 + lv + ar) % N).reshape(KL, B, -1)
        total = total + top.sum()
    return total


def tree_beam_index(movt, ivt, const, F: int):
    """A ``BeamIndex`` over the N nodes: a complete F-ary tree in BFS
    order (node i's children F i + 1 .. F i + F), a sentence a leaf."""
    from rag_cobweb_tpu_torch.core.index import BeamIndex
    N, dev = movt.shape[0], movt.device
    i = torch.arange(N, device=dev)
    first = F * i + 1
    count = (N - first).clamp(0, F)
    start = torch.where(count > 0, first, torch.full_like(first, -1))
    leaf = count == 0
    lcount = leaf.long()
    lstart = torch.cumsum(lcount, 0) - lcount
    return BeamIndex(
        pack=torch.cat([movt, -0.5 * ivt], dim=1).contiguous(), const=const,
        child_start=start, child_count=count,
        leaf_sentence_start=torch.where(leaf, lstart,
                                        torch.zeros_like(lstart)),
        leaf_sentence_count=lcount,
        sentence_order=torch.arange(int(lcount.sum()), device=dev)), max(
            1, int(np.ceil(np.log(N * (F - 1) + 1) / np.log(F))) - 1)


def timeit(fn, dev, iters: int = 3):
    """(best ms of ``iters`` synchronized calls after a warm one, the
    warm call's checksum)."""
    from rag_cobweb_tpu_torch.scripts._sweeps import sync
    out = float(fn())
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=456)
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--w", type=int, default=32)
    ap.add_argument("--f", type=int, default=16)
    ap.add_argument("--k-lanes", type=int, default=8)
    ap.add_argument("--levels", type=int, default=96)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_f32_matmul()
    from rag_cobweb_tpu_torch.bench import roofline as rl
    from rag_cobweb_tpu_torch.core.index import beam_pack_topk

    N, D, B, W, F, L = args.n, args.d, args.b, args.w, args.f, args.levels
    movt, ivt, const, q, nodes, starts = (torch.as_tensor(a, device=dev)
                                          for a in inputs(N, D, B, W, F))
    inter = torch.cat([movt, -0.5 * ivt], dim=1).to(torch.bfloat16)
    qq = torch.cat([q, torch.square(q)], dim=1)

    bytes_g2 = L * B * W * F * D * 4 * 2 / 1e9
    bytes_g1 = L * B * W * F * 2 * D * 2 / 1e9
    bw = rl.H100_HBM_BW / 1e9
    print(f"shapes: N={N} D={D} B={B} W={W} F={F} L={L}; "
          f"gather2xf32 {bytes_g2:.2f} GB, bf16 {bytes_g1:.2f} GB "
          f"(H100 HBM bound @{bw:.0f}GB/s: {bytes_g2/bw*1e3:.1f} / "
          f"{bytes_g1/bw*1e3:.1f} ms)", flush=True)
    rec = {"shapes": {"N": N, "D": D, "B": B, "W": W, "F": F, "L": L},
           "forms": {}}

    def row(name, fn, gb, lanes=1, iters=3):
        ms, checksum = timeit(fn, dev, iters)
        note = f" x{lanes} lanes" if lanes > 1 else ""
        print(f"{name:14s} {ms:8.2f} ms{note}  ({ms/B*1e3:7.1f} us/query; "
              f"{gb:.2f} GB, bound {gb/bw*1e3:.2f} ms; checksum "
              f"{checksum:.6g})", flush=True)
        rec["forms"][name] = {"ms": ms, "checksum": checksum, "gb": gb,
                              "bound_ms": gb / bw * 1e3}

    row("gather2xf32", lambda: gather2xf32(ivt, movt, const, nodes, q, W, F,
                                           L), bytes_g2)
    row("gather1xbf16", lambda: gather1xbf16(inter, const, nodes, qq, W, F,
                                             L), bytes_g1)
    row("block_slice", lambda: block_slice(inter, const, starts, qq, W, F,
                                           L), bytes_g1)
    KL = args.k_lanes
    ivt_l, movt_l, const_l = (t.unsqueeze(0).expand(KL, *t.shape)
                              .contiguous() for t in (ivt, movt, const))
    row("lanes_vmap", lambda: lanes_vmap(ivt_l, movt_l, const_l, nodes, q,
                                         W, F, L), KL * bytes_g2, KL,
        iters=2)
    del ivt_l, movt_l, const_l
    bidx, depth = tree_beam_index(movt, ivt, const, F)
    C = min(64 * max(1, -(-4 * W // 64)), W * 16)
    model = rl.beam_pack_model(B, depth, C, D, pack_bytes=4)

    def pack():
        top = beam_pack_topk(bidx, q, 10, beam_width=W, max_depth=depth)[0]
        return torch.where(top > -1e38, top, torch.zeros_like(top)).sum()

    row("beam_pack", pack, model.hbm_bytes / 1e9)
    rec["forms"]["beam_pack"].update(depth=depth, cand_budget=C,
                                     roofline_min_ms=1e3 * model.min_time_s())
    return rec


if __name__ == "__main__":
    main()
