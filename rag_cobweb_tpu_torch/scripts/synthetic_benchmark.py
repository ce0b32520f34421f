"""Hermetic benchmark on synthetic clustered embeddings, on the card (twin
of ``scripts/synthetic_benchmark.py``; the reference's entry points,
qqp_dataset.py __main__ :63-80, with the synthetic dataset adapter).

    python -m rag_cobweb_tpu_torch.scripts.synthetic_benchmark \\
        --subset_size 10000 --target_size 1000 --method extra
"""

from rag_cobweb_tpu_torch.scripts._bench import run


def main(argv=None):
    return run("synthetic", "Synthetic-embedding retrieval benchmark", argv,
               ("dim",))


if __name__ == "__main__":
    main()
