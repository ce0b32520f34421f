"""Derive million-benchmark caches from one big raw cache, on the card
(twin of ``scripts/derive_caches.py``).

The raw cache (``corpus``, ``queries``, ``target_ids`` and the pickled
whitener, as ``scripts/million_benchmark.py --raw-store`` and the port's
``bench/million.py`` write it) gives, without generating the corpus
again:

  * the WHITENED cache (``corpus_w``, ``queries_w``, ``target_ids``: the
    layout ``scripts/million_benchmark.py`` loads without
    ``--raw-store``, ``exact_scan`` and ``incremental_benchmark``) at any
    prefix size, the rows through the whitener's ``transform_torch`` on
    ``--device`` in ``--chunk``-row slices, and/or
  * a sliced RAW cache with the same keys (a corpus prefix; target ids
    past it are masked by the benchmarks' own ``target_ids < size``).

The whitener comes from the pickle through ``files.whitener_from_pickle``
(the port's class of the name the stream gives, nothing imported); the
sliced cache keeps the pickle's bytes as they are.  Not carried over, as
it exists only for the TPU: the XLA compile cache.

    python -m rag_cobweb_tpu_torch.scripts.derive_caches \\
        --raw-cache RAW.npz --whitened-out W.npz [--raw-slice-out S.npz \\
        --raw-slice-size N] [--device cuda]
"""

import argparse
import time

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw-cache", required=True,
                    help="mb_cache_raw_*.npz (corpus, queries, target_ids, "
                         "whitener_pickle)")
    ap.add_argument("--whitened-out", default=None,
                    help="write the whitened cache here")
    ap.add_argument("--whitened-size", type=int, default=None,
                    help="corpus prefix size for the whitened cache "
                         "(default: full)")
    ap.add_argument("--raw-slice-out", default=None,
                    help="write a sliced raw cache here")
    ap.add_argument("--raw-slice-size", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=131072)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.files import whitener_from_pickle
    from rag_cobweb_tpu_torch.scripts._sweeps import sync, whiten

    t0 = time.perf_counter()
    with np.load(args.raw_cache) as z:
        corpus = z["corpus"]
        queries = z["queries"]
        target_ids = z["target_ids"]
        wh_blob = z["whitener_pickle"].tobytes()
    whitener = whitener_from_pickle(wh_blob)
    print(f"[derive] loaded {corpus.shape} raw cache "
          f"({time.perf_counter()-t0:.1f}s)", flush=True)
    out = {}

    if args.raw_slice_out:
        n = args.raw_slice_size or len(corpus)
        t0 = time.perf_counter()
        np.savez(args.raw_slice_out, corpus=corpus[:n], queries=queries,
                 target_ids=target_ids,
                 whitener_pickle=np.frombuffer(wh_blob, np.uint8))
        out["raw_slice_s"] = time.perf_counter() - t0
        print(f"[derive] raw slice {n} -> {args.raw_slice_out} "
              f"({out['raw_slice_s']:.1f}s)", flush=True)

    if args.whitened_out:
        n = args.whitened_size or len(corpus)
        t0 = time.perf_counter()
        corpus_w = whiten(whitener, corpus[:n], dev, args.chunk)
        queries_w = whiten(whitener, queries, dev, args.chunk)
        sync(dev)
        out["whiten_s"] = time.perf_counter() - t0
        print(f"[derive] whitened {corpus_w.shape} "
              f"({out['whiten_s']:.1f}s)", flush=True)
        np.savez(args.whitened_out, corpus_w=corpus_w, queries_w=queries_w,
                 target_ids=target_ids)
        print(f"[derive] -> {args.whitened_out}", flush=True)
    return out


if __name__ == "__main__":
    main()
