"""Embedding whitening: the PCA+ICA, PCA+ZCA and ZCA models, and the
helpers that encode and whiten in one call."""

from rag_cobweb_tpu_torch.whitening.fastica import fastica
from rag_cobweb_tpu_torch.whitening.models import (
    PCAICAWhiteningModel,
    PCAZCAWhiteningModel,
    ZCAWhiteningModel,
    encode_and_whiten_pcaica,
    encode_and_whiten_pcazca,
    encode_and_whiten_zca,
)

__all__ = [
    "PCAICAWhiteningModel",
    "PCAZCAWhiteningModel",
    "ZCAWhiteningModel",
    "encode_and_whiten_pcaica",
    "encode_and_whiten_pcazca",
    "encode_and_whiten_zca",
    "fastica",
]
