"""Forests and the multi-device layer on ``torch.distributed``: the
K-lane forest of one device (``vforest``), the sharded forest, within-tree
tensor parallelism and the composed mesh forest over the ranks of a
``DeviceMesh``, one rank a card (NCCL) or on the host (gloo)."""

from rag_cobweb_tpu_torch.parallel.distributed import (forest_mesh,
                                                       initialize)
from rag_cobweb_tpu_torch.parallel.forest import CobwebForest, make_mesh
from rag_cobweb_tpu_torch.parallel.tp import (TPFusedPredictionIndex,
                                              TPPredictionIndex)

__all__ = ["CobwebForest", "make_mesh", "forest_mesh", "initialize",
           "TPFusedPredictionIndex", "TPPredictionIndex"]
