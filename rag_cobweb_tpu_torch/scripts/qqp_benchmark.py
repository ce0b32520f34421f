"""QQP duplicate-question retrieval benchmark on the card (twin of
``scripts/qqp_benchmark.py``; reference src/benchmarks/qqp_dataset.py).
Needs the HF ``datasets`` cache of GLUE QQP (or the sentence and
embedding caches under ``data/``) and, without cached embeddings, a
locally cached encoder; ``--use_dpr`` encodes questions and passages with
DPR's question checkpoint and its ``ctx_encoder`` twin."""

from rag_cobweb_tpu_torch.scripts._bench import run


def main(argv=None):
    return run("qqp", "QQP benchmark", argv, ("use_dpr",))


if __name__ == "__main__":
    main()
