"""FactorVAE training on the card (twin of ``scripts/train_factorvae.py``;
reference src/training/factorvae_train.py:375-423).

Tasks: qqp / msmarco (the HF ``datasets`` cache and a locally cached
encoder, or a cached .npy), synthetic (hermetic), or ``--embeddings``, any
.npy matrix.
"""

import argparse

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", choices=["qqp", "msmarco", "synthetic"],
                   default="synthetic")
    p.add_argument("--embeddings", type=str, default=None,
                   help=".npy embedding matrix (overrides --task)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--z-dim", type=int, default=392)
    p.add_argument("--gamma", type=float, default=10.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save-dir", type=str, default=None)
    p.add_argument("--embed-model", type=str, default="bert-base-uncased")
    p.add_argument("--max-embed-samples", type=int, default=20000)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)     # no card: raise before any work

    from rag_cobweb_tpu_torch.bench import datasets, encoders
    from rag_cobweb_tpu_torch.training.factorvae import FactorVAE
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if args.embeddings:
        X = np.load(args.embeddings)
    elif args.task == "synthetic":
        X = datasets.synthetic_retrieval(
            corpus_size=args.max_embed_samples, target_size=1,
            dim=768, seed=args.seed).corpus_embs
    else:
        data = (datasets.load_qqp if args.task == "qqp"
                else datasets.load_ms_marco)(
            corpus_size=args.max_embed_samples, target_size=1)
        enc = encoders.make_encoder(args.embed_model, device=args.device)
        X = enc(data.corpus)

    save_dir = args.save_dir or f"models/factorvae_{args.task}_ckpts"
    vae = FactorVAE(input_dim=X.shape[1], z_dim=args.z_dim,
                    gamma=args.gamma, lr=args.lr, seed=args.seed,
                    device=args.device)
    history = vae.fit(X, epochs=args.epochs, batch_size=args.batch_size,
                      save_dir=save_dir, seed=args.seed, log_every=1)
    print("done; checkpoints in", save_dir)
    return {"history": history, "vae": vae}


if __name__ == "__main__":
    main()
