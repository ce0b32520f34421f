"""Embedding whitening: the PCA+ICA model of the main path."""

from rag_cobweb_tpu_torch.whitening.fastica import fastica
from rag_cobweb_tpu_torch.whitening.models import PCAICAWhiteningModel

__all__ = ["PCAICAWhiteningModel", "fastica"]
