"""Build a small Cobweb index over a sample corpus and render its
per-grandparent subtrees (twin of ``scripts/visualize_tree.py``;
reference visualize_qqp.py:77 / visualize_ms_marco.py:108, on the sample
corpora).  PNG files where the ``dot`` binary exists, else the ``.dot``
sources.  ``--model``: a locally cached checkpoint of a ported encoder
(``bench/torch_encoder.make_local_hf_encoder``); by default the hermetic
hash encoder."""

import argparse

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device


def hash_encode(sentences, dim=64):
    """A seeded normal row per sentence, seeded by Python's ``hash`` (so,
    as in the JAX script, the same within one process only)."""
    out = np.zeros((len(sentences), dim), np.float32)
    for i, s in enumerate(sentences):
        rng = np.random.default_rng(abs(hash(s)) % (2 ** 31))
        out[i] = rng.normal(size=dim)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus", default="user_corpus2")
    p.add_argument("--output-dir", default="outputs/visualizations")
    p.add_argument("--num-leaves", type=int, default=6)
    p.add_argument("--model", default=None,
                   help="locally cached BERT, RoBERTa, GPT-2 or T5 "
                        "checkpoint (default: the hash encoder)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)     # no card: raise before any work

    from rag_cobweb_tpu_torch.bench.datasets import load_sample_corpuses
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    corpus = load_sample_corpuses()[args.corpus]
    if args.model:
        from rag_cobweb_tpu_torch.bench.torch_encoder import (
            make_local_hf_encoder)
        encode = make_local_hf_encoder(args.model, device=args.device)
    else:
        encode = hash_encode
    db = CobwebIndex(corpus, encode(corpus), encode_func=encode,
                     device=args.device)
    db.print_tree()
    paths = db.visualize_subtrees(args.output_dir,
                                  num_leaves=args.num_leaves)
    print(f"rendered under {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()
