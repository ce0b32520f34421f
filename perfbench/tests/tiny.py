"""The two cells shrunk to a size the CPU runs in seconds: every width
and rule kept in kind, the sizes cut, the backstop and the tiers brought
down to them."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def batch_cell():
    cfg = copy.deepcopy(load("configs", "msmarco_dpr_1m"))
    cfg.update(rows=12288, dim=64, queries=600)
    ix = cfg["index"]
    ix.update(lanes=16, build_rows_per_lane=128, rerank=64,
              backstop_threshold=4096)
    ix["whitener"].update(pca_dim=16, fit_rows=4096, ica_sample_size=2000)
    cfg["assumed"]["generator"]["n_clusters"] = 12
    cfg["check"].update(sample=96, basis_rows=1024)
    mix = copy.deepcopy(load("traffic", "batch"))
    mix.update(batch=64, warm_steps=2)
    return cfg, mix


def mixed_cell():
    cfg = copy.deepcopy(load("configs", "quora_roberta_523k"))
    cfg.update(rows=9000, dim=64, queries=600)
    ix = cfg["index"]
    ix.update(lanes=16, build_rows_per_lane=128, rerank=64,
              backstop_threshold=4096)
    ix["whitener"].update(fit_rows=4096, ica_sample_size=2000)
    ix["staleness"].update(stale_pending_limit=64, delta_rebuild_min=256,
                           delta_rebuild_frac=0.02)
    cfg["assumed"]["generator"]["n_clusters"] = 9
    cfg["check"].update(sample=96, basis_rows=1024)
    mix = copy.deepcopy(load("traffic", "mixed"))
    mix.update(batch=16, add_every=4, add_rows=128, fresh_rows=8192,
               warm_steps=10)
    return cfg, mix


def port():
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

    class Api:
        pass
    Api.TreeConfig = TreeConfig
    Api.CobwebIndex = CobwebIndex
    Api.PCAICAWhiteningModel = PCAICAWhiteningModel
    return Api


def run(cell, seed=123456789012, seconds=2.0, trace=False, fault=None,
        control=False, device=torch.device("cpu")):
    from perfbench import cell as cell_mod
    cfg, mix = cell()
    return cell_mod.run(cfg, mix, seed, seconds, trace, device, port(),
                        time.perf_counter(), fault=fault, control=control)
