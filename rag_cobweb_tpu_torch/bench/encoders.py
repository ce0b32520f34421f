"""Sentence encoders + content-addressed embedding caches (port of
``rag_cobweb_tpu/bench/encoders.py``, the same functions and cache
layout, so both packages read each other's caches and run ids).

Covers the roles of the reference's encoder zoo and cache layer
(benchmark_utils.py:38-102 MODEL_TYPE_MAPPING + heuristics, :218-346 batch
encoding + load_or_compute caches, :105-140 unique run ids).

The primary ingress is precomputed ``.npy`` embeddings (the reference's
own cache format).  Nothing is downloaded: the ``transformers`` and
``sentence_transformers`` encoders load locally cached models only, and
are gated on those packages; any callable ``encode_func`` slots in, and
``bench/torch_encoder.py`` runs a BERT forward pass on the card without
either package.  The encoders run on ``device``, ``"cuda"`` by default.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Optional

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device

# model-name -> encoder family (reference MODEL_TYPE_MAPPING :38-60)
MODEL_TYPE_MAPPING = {
    "all-roberta-large-v1": "sentence_transformer",
    "all-MiniLM-L6-v2": "sentence_transformer",
    "all-mpnet-base-v2": "sentence_transformer",
    "gtr-t5-large": "sentence_transformer",
    "bert-base-uncased": "bert",
    "roberta-base": "bert",
    "openai-community/gpt2": "gpt2",
    "gpt2": "gpt2",
    "t5-base": "t5",
    "google-t5/t5-base": "t5",
}


def infer_model_type(model_name: str) -> str:
    """Fallback heuristics (reference :62-102)."""
    if model_name in MODEL_TYPE_MAPPING:
        return MODEL_TYPE_MAPPING[model_name]
    low = model_name.lower()
    if "sentence-transformers" in low or low.startswith(("all-", "gtr-")):
        return "sentence_transformer"
    if "t5" in low:
        return "t5"
    if "gpt" in low:
        return "gpt2"
    if "dpr-" in low:
        return "dpr"
    return "bert"


def generate_unique_id(model_name: str, dataset: str, split: str,
                       subset_size: int, target_size: int, **kwargs) -> str:
    """Content-addressed run id (reference generate_unique_id :105-140):
    readable param string, md5-suffixed when over 100 chars."""
    params = {
        "model_name": model_name.replace("/", "-"),
        "dataset": dataset,
        "split": split,
        "subset_size": subset_size,
        "target_size": target_size,
        **kwargs,
    }
    param_str = "_".join(f"{k}={v}" for k, v in sorted(params.items()))
    if len(param_str) > 100:
        h = hashlib.md5(param_str.encode()).hexdigest()[:8]
        base = (f"{params['model_name']}_{dataset}_{split}"
                f"_c{subset_size}_t{target_size}_k{params.get('top_k', 0)}")
        return f"{base}_{h}"
    return param_str.replace("=", "").replace("/", "-")


# ------------------------------------------------------------------ #
# cache paths (reference :143-215 layout)                            #
# ------------------------------------------------------------------ #

def embedding_cache_path(root: str, kind: str, unique_id: str) -> str:
    return os.path.join(root, "data", "embeddings", f"{kind}_{unique_id}.npy")


def model_cache_path(root: str, family: str, unique_id: str,
                     ext: str = "pkl") -> str:
    return os.path.join(root, "models", family, f"{family}_{unique_id}.{ext}")


def results_path(root: str, dataset: str, unique_id: str) -> str:
    return os.path.join(root, "outputs", dataset,
                        f"benchmark_{unique_id}.txt")


def load_or_compute(path: str, compute_fn: Callable[[], np.ndarray],
                    compute: bool = True) -> Optional[np.ndarray]:
    """.npy cache wrapper (reference load_or_compute_embeddings :280-346)."""
    if os.path.exists(path):
        return np.load(path)
    if not compute:
        return None
    embs = np.asarray(compute_fn(), np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, embs)
    return embs


def sentences_cache_path(root: str, kind: str, unique_id: str) -> str:
    """data/sentences/<kind>_<uid>.txt (reference sentence caches
    benchmark_utils.py:409-435): one sentence per line.  With these plus
    the .npy embedding caches present, a dataset benchmark runs with NO
    dataset/model network access — the drop-in real-data ingress path."""
    return os.path.join(root, "data", "sentences", f"{kind}_{unique_id}.txt")


def target_ids_cache_path(root: str, unique_id: str) -> str:
    """data/sentences/target_ids_<uid>.npy — persisted gold row indices.
    The sentence text cache is LOSSY (``save_sentences`` flattens embedded
    newlines), so target row ids must be stored, not re-derived by string
    match over the round-tripped text (ADVICE r4: two corpus rows that
    differed only by newline-vs-space collapse and remap the target)."""
    return os.path.join(root, "data", "sentences",
                        f"target_ids_{unique_id}.npy")


def save_sentences(path: str, sentences) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for s in sentences:
            f.write(str(s).replace("\n", " ") + "\n")


def load_sentences(path: str) -> Optional[list]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


# ------------------------------------------------------------------ #
# encoders (gated; CPU torch / HF)                                   #
# ------------------------------------------------------------------ #

def transformers_available() -> bool:
    try:
        import transformers  # noqa: F401
        return True
    except ImportError:
        return False


def make_hf_encoder(model_name: str, max_length: int = 512,
                    batch_size: int = 32, device="cuda") -> Callable:
    """Build an encode_func from a local/cached HF model.  Families follow
    the reference (benchmark_utils.py:218-346): T5 encoder mean-pool with a
    "Summarize :" prefix (:311), BERT CLS token, GPT-2 mean-pool with pad
    token = eos, generic mean-pool otherwise."""
    import torch
    from transformers import AutoModel, AutoTokenizer

    device = resolve_device(device)
    family = infer_model_type(model_name)
    tok = AutoTokenizer.from_pretrained(model_name)
    if family == "gpt2" and tok.pad_token is None:
        tok.pad_token = tok.eos_token
    if family == "t5":
        from transformers import T5EncoderModel
        model = T5EncoderModel.from_pretrained(model_name)
    else:
        model = AutoModel.from_pretrained(model_name)
    model = model.to(device).eval()

    @torch.no_grad()
    def encode(sentences):
        outs = []
        for s in range(0, len(sentences), batch_size):
            batch = list(sentences[s:s + batch_size])
            if family == "t5":
                batch = ["Summarize :" + t for t in batch]
            enc = tok(batch, padding=True, truncation=True,
                      max_length=max_length, return_tensors="pt").to(device)
            h = model(**enc).last_hidden_state
            if family == "bert":
                emb = h[:, 0]                      # CLS
            else:
                mask = enc["attention_mask"][..., None].float()
                emb = (h * mask).sum(1) / mask.sum(1).clamp(min=1)
            outs.append(emb.cpu().numpy())
        return np.concatenate(outs).astype(np.float32)

    return encode


def make_sentence_transformer_encoder(model_name: str,
                                      batch_size: int = 64,
                                      device="cuda") -> Callable:
    """sentence-transformers path, if the package + weights are present."""
    from sentence_transformers import SentenceTransformer

    st = SentenceTransformer(model_name, device=str(resolve_device(device)))

    def encode(sentences):
        return np.asarray(
            st.encode(list(sentences), convert_to_numpy=True,
                      batch_size=batch_size, show_progress_bar=False),
            np.float32,
        )

    return encode


def make_dpr_encoders(question_model: str, ctx_model: str,
                      max_length: int = 512, batch_size: int = 32,
                      device="cuda"):
    """DPR dual-encoder pair: separate query and passage encoders
    (reference benchmark_utils.py:349-406 — pooled output of
    DPRQuestionEncoder / DPRContextEncoder).  Returns
    (encode_queries, encode_passages)."""
    import torch
    from transformers import (
        DPRContextEncoder, DPRContextEncoderTokenizer,
        DPRQuestionEncoder, DPRQuestionEncoderTokenizer,
    )

    device = resolve_device(device)
    q_tok = DPRQuestionEncoderTokenizer.from_pretrained(question_model)
    q_enc = DPRQuestionEncoder.from_pretrained(question_model).to(device).eval()
    c_tok = DPRContextEncoderTokenizer.from_pretrained(ctx_model)
    c_enc = DPRContextEncoder.from_pretrained(ctx_model).to(device).eval()

    @torch.no_grad()
    def _run(tok, enc, sentences):
        outs = []
        for s in range(0, len(sentences), batch_size):
            batch = tok(list(sentences[s:s + batch_size]), padding=True,
                        truncation=True, max_length=max_length,
                        return_tensors="pt").to(device)
            outs.append(enc(**batch).pooler_output.cpu().numpy())
        return np.concatenate(outs).astype(np.float32)

    return (lambda xs: _run(q_tok, q_enc, xs),
            lambda xs: _run(c_tok, c_enc, xs))


def encode_corpus_to_npy(corpus, encode_func: Callable, output_path: str,
                         batch_size: int = 100) -> np.ndarray:
    """Encode a corpus and persist as .npy (reference
    utils/datasets.generate_and_save_convo_embeddings :84-95)."""
    embs = []
    for s in range(0, len(corpus), batch_size):
        embs.append(np.asarray(encode_func(corpus[s:s + batch_size])))
    out = np.concatenate(embs).astype(np.float32)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    np.save(output_path, out)
    return out


def make_encoder(model_name: str, **kw) -> Callable:
    """Best-available encoder for a model name (reference setup flow)."""
    family = infer_model_type(model_name)
    if family == "sentence_transformer":
        try:
            return make_sentence_transformer_encoder(
                model_name, device=kw.get("device", "cuda"))
        except (ImportError, OSError):
            pass  # no sentence-transformers or no cached model: raw HF
    return make_hf_encoder(model_name, **kw)
