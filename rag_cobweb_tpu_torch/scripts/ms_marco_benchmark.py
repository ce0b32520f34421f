"""MS-MARCO passage retrieval benchmark on the card (twin of
``scripts/ms_marco_benchmark.py``; reference
src/benchmarks/ms_marco_dataset.py).  Needs the HF ``datasets`` cache of
MS-MARCO v2.1 (or the caches under ``data/``) and, without cached
embeddings, a locally cached encoder; ``--use_dpr`` as in
``qqp_benchmark``."""

from rag_cobweb_tpu_torch.scripts._bench import run


def main(argv=None):
    return run("msmarco", "MS-MARCO benchmark", argv, ("use_dpr",))


if __name__ == "__main__":
    main()
