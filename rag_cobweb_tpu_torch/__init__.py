"""PyTorch / CUDA port of ``rag_cobweb_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout (``core/``, ``ops/``,
``parallel/``, ``whitening/``, ``bench/``) and imports nothing of it.
Entry points take an explicit ``device`` and default to ``"cuda"``.
"""
