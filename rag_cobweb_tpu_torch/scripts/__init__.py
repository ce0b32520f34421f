"""The port's twins of the reference's entry-point scripts (``scripts/`` at
the repository's root): each module takes its script's name and
arguments plus ``--device`` (``"cuda"`` by default; ``"cpu"`` runs on the
host), calls the port's library, and runs as

    python -m rag_cobweb_tpu_torch.scripts.<name> [arguments]

or from Python as ``main([arguments])``, which returns what the run made.
"""
