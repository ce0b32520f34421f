"""State carry-over from the JAX package, as plain numpy arrays.

These functions take what ``rag_cobweb_tpu`` objects hold (fetched with
``jax.device_get`` by the caller, or read from its ``.npz`` files and
pickles) and build the port's objects, so one state can run through both
packages: trees, forests, indexes, whiteners, and the trainers' modules
from their flax parameter trees.  A rank of a mesh takes its own shard of
a JAX sharded forest or composed mesh forest (``forest_shard_from_numpy``,
``mesh_vforest_from_numpy``).  Nothing here imports the JAX package.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.index import (BlockedIndex, FusedIndex,
                                             PredictionIndex)
from rag_cobweb_tpu_torch.core.tree import CobwebTree
from rag_cobweb_tpu_torch.device import resolve_device
from rag_cobweb_tpu_torch.files import read_npz
from rag_cobweb_tpu_torch.parallel.distributed import axis_group
from rag_cobweb_tpu_torch.parallel.forest import CobwebForest, make_mesh
from rag_cobweb_tpu_torch.parallel.mesh_vforest import MeshVForest
from rag_cobweb_tpu_torch.parallel.vforest import VForest
from rag_cobweb_tpu_torch.training.factorvae import (Discriminator,
                                                     MLPDecoder, MLPEncoder)
from rag_cobweb_tpu_torch.training.flax_layout import load_flax
from rag_cobweb_tpu_torch.training.query_train import ProjectionHead
from rag_cobweb_tpu_torch.training.text_encoder import TinyTextEncoder
from rag_cobweb_tpu_torch.training.vicreg import Projector
from rag_cobweb_tpu_torch.whitening.models import (PCAICAWhiteningModel,
                                                   PCAZCAWhiteningModel,
                                                   ZCAWhiteningModel)


def forest_from_numpy(arrays: dict, meta: dict, device="cuda") -> VForest:
    """A port VForest from the JAX forest's state arrays
    (``jax.device_get(vf.state)._asdict()``: counts, means, m2s, parent,
    children, n_children, root, n_alloc, free_stack, free_top, each with a
    leading lane axis) and ``meta``: ``cfg`` (a TreeConfig or its JSON
    dict), ``shard_of``, ``local_sid`` and ``leaf_of_local`` (the JAX
    forest's ``_leaf_of_local``, one list per lane); for a content-routed
    forest also ``routing`` and its router state ``centroids``,
    ``route_count`` and ``lane_total`` (``VForest.from_numpy``)."""
    return VForest.from_numpy(arrays, meta, device=device)


def load_jax_npz(path: str, device="cuda") -> VForest:
    """A port VForest from a file written by the JAX ``VForest.save_npz``,
    router state included (``VForest.load_npz``)."""
    return VForest.load_npz(path, device=device)[0]


_SCALARS = ("root", "n_alloc", "free_top")
_NULL_PAD = {"parent", "children", "free_stack"}


def tree_from_numpy(arrays: dict, cfg, seed: int = 0, n_inserted=None,
                    device="cuda") -> CobwebTree:
    """A port CobwebTree from a JAX single tree's state arrays
    (``jax.device_get(tree.state)._asdict()``, or the fields of its
    ``.npz``): counts (N,), means/m2s (N, D), parent (N,), children (N, F),
    n_children (N,), free_stack (N,) and the scalars root, n_alloc,
    free_top.  ``cfg`` is a TreeConfig or its JSON dict.  The lane axis is
    added here; a capacity that is not aligned (the JAX ``load_json``
    sizes it exactly) is padded with empty slots, so every slot keeps its
    id."""
    if not isinstance(cfg, TreeConfig):
        cfg = TreeConfig.from_json_dict(cfg)
    cap = int(np.asarray(arrays["counts"]).shape[0])
    tree = CobwebTree(cfg, capacity=cap, seed=seed, device=device)
    full = tree.state.capacity
    lane = {}
    for name in tree_mod.FIELDS:
        a = np.asarray(arrays[name])
        if name in _SCALARS:
            lane[name] = a.reshape(1)
            continue
        if full > cap:
            pad = np.full((full - cap,) + a.shape[1:],
                          -1 if name in _NULL_PAD else 0, a.dtype)
            a = np.concatenate([a, pad])
        lane[name] = a[None]
    tree.state = tree_mod.state_from_numpy(lane, tree.device)
    tree.n_inserted = int(n_inserted) if n_inserted is not None else 0
    return tree


def load_jax_tree_npz(path: str, seed: int = 0, device="cuda"):
    """A port CobwebTree from a single-tree ``.npz`` of either package
    (the JAX ``CobwebTree.save_npz`` layout); returns (tree, dict of the
    extra arrays saved beside the state; object arrays through
    ``files.read_npz``'s restricted unpickler)."""
    data = read_npz(path)
    cfg = json.loads(bytes(data["__cfg__"]).decode())
    arrays = {k: data[k] for k in tree_mod.FIELDS}
    extras = {k: v for k, v in data.items()
              if k not in set(tree_mod.FIELDS) | {"__cfg__", "n_inserted"}}
    return tree_from_numpy(arrays, cfg, seed=seed,
                           n_inserted=int(data["n_inserted"]),
                           device=device), extras


def forest_shard_from_numpy(arrays: dict, meta: dict, mesh=None,
                            axis_name: str = "shard",
                            device="cuda") -> CobwebForest:
    """This rank's shard of a JAX ``CobwebForest``, served by the port:
    ``arrays`` its stacked state (``jax.device_get(forest.state)
    ._asdict()``, leading axis = shard), ``meta`` its ``cfg`` (a
    TreeConfig or its JSON dict), ``shard_of``, ``local_sid`` and
    ``leaf_of_local`` (its ``_leaf_of_local``).  Rank r of ``mesh``'s
    axis takes shard r."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    _, shard, _ = axis_group(mesh, axis_name)
    tree = tree_from_numpy({k: np.asarray(v)[shard]
                            for k, v in arrays.items()}, meta["cfg"],
                           device=device)
    return CobwebForest.from_shard_state(tree, meta, mesh, axis_name)


def mesh_vforest_from_numpy(arrays: dict, meta: dict, lanes_per_shard: int,
                            mesh=None, axis_name: str = "shard",
                            device="cuda") -> MeshVForest:
    """This rank's lanes of a JAX ``MeshVForest``, served by the port:
    ``arrays`` its stacked state (leading axis = the L = N x
    ``lanes_per_shard`` lanes), ``meta`` as ``forest_shard_from_numpy``'s
    over all L lanes.  Rank r takes lanes ``[r K, (r + 1) K)``."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    _, shard, _ = axis_group(mesh, axis_name)
    K = lanes_per_shard
    lanes = slice(shard * K, (shard + 1) * K)
    forest = VForest.from_numpy(
        {k: np.asarray(v)[lanes] for k, v in arrays.items()},
        {"cfg": meta["cfg"], "shard_of": [], "local_sid": [],
         "leaf_of_local": [[] for _ in range(K)]}, device=device)
    return MeshVForest.from_lane_state(forest, meta, mesh, axis_name)


def _float_tensor(a, dev) -> torch.Tensor:
    """f32 tensor, or bf16 when the numpy array is ml_dtypes bfloat16."""
    a = np.asarray(a)
    t = torch.as_tensor(a.astype(np.float32), device=dev)
    return (t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t) \
        .contiguous()


def fused_index_from_numpy(GT, c, valid, device="cuda") -> FusedIndex:
    """A port FusedIndex from the JAX FusedIndex's arrays; a bf16 GT
    (ml_dtypes) stays bf16."""
    dev = resolve_device(device)
    return FusedIndex(
        GT=_float_tensor(GT, dev),
        c=torch.as_tensor(np.array(c, np.float32), device=dev),
        valid=torch.as_tensor(np.array(valid, bool), device=dev))


def whitener_from_numpy(arrays: dict):
    """A port whitener from the arrays of a JAX whitening model (the dict
    its ``save`` pickles), its class chosen by the keys: ``ica_unmixing``
    for PCA+ICA, ``whitening_matrix`` for ZCA, else PCA+ZCA."""
    if "ica_unmixing" in arrays:
        cls = PCAICAWhiteningModel
    elif "whitening_matrix" in arrays:
        cls = ZCAWhiteningModel
    else:
        cls = PCAZCAWhiteningModel
    return cls.from_dict(arrays)


def prediction_index_from_numpy(arrays: dict,
                                device="cuda") -> PredictionIndex:
    """A port PredictionIndex from the JAX PredictionIndex's arrays
    (``jax.device_get(idx)._asdict()``: inv_var_T, mu_over_var_T, const,
    paths, path_weights, children, leaf_sentence_start,
    leaf_sentence_count, sentence_order); the host copies the blocked
    build reads are taken from the same arrays."""
    dev = resolve_device(device)

    def f32(name):
        return torch.as_tensor(np.array(arrays[name], np.float32),
                               device=dev)

    def i64(name):
        return torch.as_tensor(np.array(arrays[name], np.int64), device=dev)

    return PredictionIndex(
        inv_var_T=f32("inv_var_T"), mu_over_var_T=f32("mu_over_var_T"),
        const=f32("const"), paths=i64("paths"),
        path_weights=f32("path_weights"), children=i64("children"),
        leaf_sentence_start=i64("leaf_sentence_start"),
        leaf_sentence_count=i64("leaf_sentence_count"),
        sentence_order=i64("sentence_order"),
        paths_h=np.array(arrays["paths"], np.int32),
        weights_h=np.array(arrays["path_weights"], np.float32),
        order_h=np.array(arrays["sentence_order"], np.int32))


def blocked_index_from_numpy(arrays: dict, device="cuda") -> BlockedIndex:
    """A port BlockedIndex from the JAX BlockedIndex's arrays (ivt_b,
    movt_b, const_b, W, valid, sid_of_slot); bf16 (ml_dtypes) terms stay
    bf16."""
    dev = resolve_device(device)
    return BlockedIndex(
        ivt_b=_float_tensor(arrays["ivt_b"], dev),
        movt_b=_float_tensor(arrays["movt_b"], dev),
        const_b=torch.as_tensor(np.array(arrays["const_b"], np.float32),
                                device=dev),
        W=_float_tensor(arrays["W"], dev),
        valid=torch.as_tensor(np.array(arrays["valid"], bool), device=dev),
        sid_of_slot=torch.as_tensor(np.array(arrays["sid_of_slot"],
                                             np.int32), device=dev))


# ---------------------------------------------------------------------------
# the trainers' modules from the JAX package's flax parameter trees
# ---------------------------------------------------------------------------

def _inner(params: dict) -> dict:
    return params["params"] if set(params) == {"params"} else params


def _kernel(params: dict, name: str) -> tuple:
    return np.asarray(params[name]["kernel"]).shape


def projection_head_from_flax(params: dict, device="cuda") -> ProjectionHead:
    """``ProjectionHead`` from the JAX head's parameters (the trainer's
    ``state.params``, or ``"params"`` of its pickle); the widths are read
    from the kernels."""
    p = _inner(params)
    (n_in, hidden), (_, n_out) = _kernel(p, "Dense_0"), _kernel(p, "Dense_1")
    return load_flax(ProjectionHead(n_in, n_out, hidden),
                     p).to(resolve_device(device))


def text_encoder_from_flax(params: dict, n_heads: int = 4,
                           device="cuda") -> TinyTextEncoder:
    """``TinyTextEncoder`` from the JAX encoder's parameters (the
    attention's ``query``/``key``/``value`` kernels (d, heads, head_dim),
    ``out`` (heads, head_dim, d); ``Embed_0``, ``pos``, ``LayerNorm``)."""
    p = _inner(params)
    vocab, d = np.asarray(p["Embed_0"]["embedding"]).shape
    n_layers = sum(k.startswith("EncoderBlock_") for k in p)
    enc = TinyTextEncoder(vocab, d, n_layers,
                          np.asarray(p["pos"]).shape[0], n_heads)
    return load_flax(enc, p).to(resolve_device(device))


def projector_from_flax(params: dict, device="cuda") -> Projector:
    """VICReg's ``Projector`` from the JAX projector's parameters."""
    p = _inner(params)
    (n_in, hidden), (_, n_out) = _kernel(p, "Dense_0"), _kernel(p, "Dense_2")
    return load_flax(Projector(n_in, n_out, hidden),
                     p).to(resolve_device(device))


def factorvae_modules_from_flax(params: tuple, device="cuda") -> tuple:
    """(``MLPEncoder``, ``MLPDecoder``, ``Discriminator``) from the JAX
    FactorVAE's (encoder, decoder, discriminator) parameters, the tuple
    its pickle holds."""
    enc_p, dec_p, disc_p = (_inner(t) for t in params)
    n_in, hidden = _kernel(enc_p, "Dense_0")
    z_dim = _kernel(enc_p, "Dense_2")[1]
    dev = resolve_device(device)
    return (load_flax(MLPEncoder(n_in, z_dim, hidden), enc_p).to(dev),
            load_flax(MLPDecoder(z_dim, n_in, hidden), dec_p).to(dev),
            load_flax(Discriminator(z_dim, _kernel(disc_p, "Dense_0")[1]),
                      disc_p).to(dev))
