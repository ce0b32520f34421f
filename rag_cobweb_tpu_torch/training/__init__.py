"""Single-device training: the query trainers (a projection head, and an
end-to-end text encoder with its head, trained through the Cobweb rank
scores) and the learned whiteners (VICReg, FactorVAE)."""

from rag_cobweb_tpu_torch.training.factorvae import (
    FactorVAE,
    latent_correlation_diagnostics,
)
from rag_cobweb_tpu_torch.training.query_train import (
    CobwebQueryTrainer,
    ProjectionHead,
)
from rag_cobweb_tpu_torch.training.text_encoder import (
    EndToEndQueryTrainer,
    TinyTextEncoder,
    hash_tokenize,
)
from rag_cobweb_tpu_torch.training.vicreg import VICRegWhitener, vicreg_loss

__all__ = [
    "CobwebQueryTrainer",
    "EndToEndQueryTrainer",
    "FactorVAE",
    "ProjectionHead",
    "TinyTextEncoder",
    "VICRegWhitener",
    "hash_tokenize",
    "latent_correlation_diagnostics",
    "vicreg_loss",
]
