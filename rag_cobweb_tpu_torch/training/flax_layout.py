"""The layers the trainers share, in the JAX package's flax layout.

Each layer draws its fresh parameters from the distribution of the flax
initialiser it stands for (``Dense``: ``lecun_normal`` kernels, i.e. a
normal truncated at 2 standard deviations, scaled to variance 1/fan_in,
zero biases; ``Embed``: N(0, 1/features); ``LayerNorm``: ones and zeros,
epsilon 1e-6), from an explicit ``torch.Generator``.  A module whose
children carry the flax names (``Dense_0``, ``LayerNorm_1``, ...)
converts to and from the flax parameter tree of its JAX twin with
``to_flax`` and ``load_flax``: a ``Dense`` kernel (in, out) is the
transpose of the Linear weight, and the attention's ``DenseGeneral``
kernels are the same products with their head axes split out.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def dense(n_in: int, n_out: int, gen: torch.Generator) -> nn.Linear:
    """``nn.Dense(n_out)`` on ``n_in`` inputs: a Linear whose weight is
    ``lecun_normal`` (fan_in = ``n_in``), bias zero."""
    lin = nn.Linear(n_in, n_out)
    std = 1.0 / math.sqrt(n_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)
        lin.bias.zero_()
    return lin


def layer_norm(d: int) -> nn.LayerNorm:
    """``nn.LayerNorm()``: epsilon 1e-6 (torch's default is 1e-5)."""
    return nn.LayerNorm(d, eps=1e-6)


def embed(vocab: int, d: int, gen: torch.Generator) -> nn.Embedding:
    """``nn.Embed(vocab, d)``: N(0, 1/d) entries."""
    emb = nn.Embedding(vocab, d)
    with torch.no_grad():
        nn.init.normal_(emb.weight, 0.0, 1.0 / math.sqrt(d), generator=gen)
    return emb


class Attention(nn.Module):
    """``nn.MultiHeadDotProductAttention(num_heads, qkv_features=d)``
    self-attention: the query scaled by 1/sqrt(head_dim), masked keys set
    to the dtype's most negative value before the softmax.  So a row whose
    keys are all masked attends uniformly, as in flax (a boolean mask in
    ``scaled_dot_product_attention`` would give NaN there)."""

    def __init__(self, d: int, n_heads: int, gen: torch.Generator):
        super().__init__()
        if d % n_heads:
            raise ValueError(f"{d} features do not split over {n_heads} "
                             "heads")
        self.n_heads = n_heads
        self.query = dense(d, d, gen)
        self.key = dense(d, d, gen)
        self.value = dense(d, d, gen)
        self.out = dense(d, d, gen)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, d = x.shape
        h = self.n_heads

        def heads(lin):
            return lin(x).view(B, L, h, d // h)

        q = heads(self.query) / math.sqrt(d // h)
        w = torch.einsum("bqhd,bkhd->bhqk", q, heads(self.key))
        keep = (mask > 0)[:, None, None, :]
        w = torch.where(keep, w, torch.full_like(w, torch.finfo(w.dtype).min))
        w = torch.softmax(w, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, heads(self.value))
        return self.out(o.reshape(B, L, d))

    def to_flax(self) -> dict:
        h = self.n_heads
        d = self.out.out_features
        out = {}
        for name in ("query", "key", "value"):
            lin = getattr(self, name)
            out[name] = {"kernel": _np(lin.weight.T).reshape(d, h, d // h),
                         "bias": _np(lin.bias).reshape(h, d // h)}
        out["out"] = {"kernel": _np(self.out.weight.T).reshape(h, d // h, d),
                      "bias": _np(self.out.bias)}
        return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def to_flax(module: nn.Module) -> dict:
    """The flax parameter tree of ``module`` (``{"params": ...}``, numpy
    float32), as the JAX package's ``init`` returns it."""
    return {"params": _tree(module)}


def _tree(module: nn.Module) -> dict:
    if isinstance(module, Attention):
        return module.to_flax()
    if isinstance(module, nn.Linear):
        return {"kernel": _np(module.weight.T), "bias": _np(module.bias)}
    if isinstance(module, nn.LayerNorm):
        return {"scale": _np(module.weight), "bias": _np(module.bias)}
    if isinstance(module, nn.Embedding):
        return {"embedding": _np(module.weight)}
    out = {name: _np(p) for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = _tree(child)
    return out


def load_flax(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a flax parameter tree (``{"params": ...}`` or its inside, numpy
    arrays) into ``module`` in place; every leaf must fit a parameter of
    the same shape.  Returns ``module``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    with torch.no_grad():
        _load(module, tree, "")
    return module


def _put(p: torch.Tensor, a, where: str):
    t = torch.as_tensor(np.array(a, np.float32))
    if t.numel() != p.numel():
        raise ValueError(f"{where}: {tuple(t.shape)} does not fit "
                         f"{tuple(p.shape)}")
    p.copy_(t.reshape(p.shape).to(p.device))


def _load(module: nn.Module, tree: dict, where: str):
    if isinstance(module, nn.Linear):
        k = np.asarray(tree["kernel"], np.float32)
        _put(module.weight, k.reshape(module.in_features, -1).T,
             where + "kernel")
        _put(module.bias, tree["bias"], where + "bias")
        return
    if isinstance(module, nn.LayerNorm):
        _put(module.weight, tree["scale"], where + "scale")
        _put(module.bias, tree["bias"], where + "bias")
        return
    if isinstance(module, nn.Embedding):
        _put(module.weight, tree["embedding"], where + "embedding")
        return
    names = {n for n, _ in module.named_parameters(recurse=False)}
    names |= {n for n, _ in module.named_children()}
    if set(tree) != names:
        raise ValueError(f"{where or 'the tree'} holds {sorted(tree)}, the "
                         f"module {sorted(names)}")
    for name, p in module.named_parameters(recurse=False):
        _put(p, tree[name], where + name)
    for name, child in module.named_children():
        _load(child, tree[name], where + name + ".")
