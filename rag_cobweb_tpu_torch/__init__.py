"""PyTorch / CUDA port of ``rag_cobweb_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout and imports nothing of it:

  core/       the tree (``CobwebTree``), the prediction indexes and the
              ``CobwebIndex`` database facade
  ops/        the node math and the hand-written CUDA kernels' wrappers
              (sources in ``csrc/``, built at first use, never at import)
  whitening/  PCA+ICA, PCA+ZCA and ZCA whitening
  parallel/   forests and multi-device engines on ``torch.distributed``
  training/   the query trainers, VICReg and FactorVAE
  bench/      the benchmark harness, metrics, baselines, encoders, reports
              and the card's probes
  utils/      logging, profiling, the kernels' build cache, tree views

Entry points take an explicit ``device`` and default to ``"cuda"``.
"""

__version__ = "0.1.0"

from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import CobwebTree
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex

__all__ = ["TreeConfig", "CobwebTree", "CobwebIndex", "__version__"]
