"""Compare embedding decorrelation across whitening approaches on the card
(twin of ``scripts/compare_whitening.py``; the working version of the
reference's src/whitening/whitened_models_test.py:13-131): raw, PCA+ICA,
PCA alone, PCA+ZCA, ZCA and FactorVAE latents, each with its mean
|off-diagonal| correlation and most correlated pairs."""

import argparse

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--embeddings", type=str, default=None,
                   help=".npy matrix; default: synthetic corpus")
    p.add_argument("--samples", type=int, default=5000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--pca-dim", type=int, default=128)
    p.add_argument("--factorvae-epochs", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)     # no card: raise before any work

    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval
    from rag_cobweb_tpu_torch.training.factorvae import (
        FactorVAE, latent_correlation_diagnostics)
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache
    from rag_cobweb_tpu_torch.whitening import (PCAICAWhiteningModel,
                                                PCAZCAWhiteningModel,
                                                ZCAWhiteningModel)

    enable_persistent_cache()
    if args.embeddings:
        X = np.load(args.embeddings)[: args.samples]
    else:
        X = synthetic_retrieval(args.samples, 1, args.dim).corpus_embs
    out = {}

    def report(name, Z):
        d = latent_correlation_diagnostics(Z, top_k=3)
        out[name] = d
        print(f"{name:<22} mean|offdiag corr| = "
              f"{d['mean_abs_offdiag']:.5f}  top: "
              f"{[(i, j, round(c, 3)) for i, j, c in d['top_pairs']]}")

    report("raw", X)
    pca_ica = PCAICAWhiteningModel.fit(X, pca_dim=args.pca_dim,
                                       ica_max_iter=500)
    report("PCA+ICA", pca_ica.transform(X))
    report("PCA only (normed)", pca_ica.transform(X, is_ica=False))
    pca_zca = PCAZCAWhiteningModel.fit(X, pca_dim=min(args.pca_dim,
                                                      X.shape[1]))
    report("PCA->ZCA", pca_zca.transform(X))
    zca = ZCAWhiteningModel.fit(X)
    report("ZCA", zca.transform(X))

    vae = FactorVAE(input_dim=X.shape[1], z_dim=args.pca_dim, hidden=512,
                    lr=1e-3, device=args.device)
    vae.fit(X, epochs=args.factorvae_epochs, batch_size=256,
            diag_samples=min(4096, len(X)))
    report("FactorVAE latents", vae.encode(X[:4096]).cpu().numpy())
    return {"reports": out, "vae": vae}


if __name__ == "__main__":
    main()
