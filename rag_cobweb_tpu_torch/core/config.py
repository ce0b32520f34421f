"""Tree hyper-parameters.

Parity with the reference tree constructor (CobwebTorchTree.py:23-41):
``use_info=True, acuity_cutoff=False, use_kl=True, prior_var=1/(2*e*pi), alpha=1e-8``.
A frozen dataclass, field for field the same as ``rag_cobweb_tpu.core.config``,
so one configuration drives both packages and JSON round-trips between them.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    dim: int
    use_info: bool = True
    acuity_cutoff: bool = False
    use_kl: bool = True
    prior_var: float = 1.0 / (2.0 * math.e * math.pi)
    alpha: float = 1e-8
    # TPU-native structural limits (the reference pointer-graph has no fanout bound;
    # measured reference trees have small fanout, see SURVEY.md §7 hard-part 2).
    max_fanout: int = 16
    # `greedy` replicates COBWEB_GREEDY_MODE (src/utils/constants.py:1, default False).
    greedy: bool = False
    # Depth-bounded leaf absorb (chain compaction), 0 = off (reference
    # parity).  When > 0, a descent that reaches a LEAF at depth >=
    # absorb_depth absorbs the instance into that leaf's statistics
    # (generalizing the reference's exact-match absorb,
    # CobwebTorchTree.py:184-188) instead of fringe-splitting.  This bounds
    # tree depth: tight near-duplicate groups otherwise build one-leaf-per-
    # duplicate fringe CHAINS (measured depth 96+ under content routing on
    # the hard corpus) whose descents blow every scan budget and whose
    # paths degrade the blocked engine's candidate pools.  Sentences
    # absorbed into a shared leaf stay individually retrievable through the
    # leaf sentence runs + the exact stored-embedding re-rank.
    absorb_depth: int = 0

    def __post_init__(self):
        if self.dim <= 0:
            raise ValueError(f"dim must be positive, got {self.dim}")
        if self.max_fanout < 2:
            raise ValueError(f"max_fanout must be >= 2, got {self.max_fanout}")

    def to_json_dict(self) -> dict:
        return {
            "use_info": self.use_info,
            "acuity_cutoff": self.acuity_cutoff,
            "use_kl": self.use_kl,
            "shape": [self.dim],
            "alpha": self.alpha,
            "prior_var": float(self.prior_var),
            "max_fanout": self.max_fanout,
            "absorb_depth": self.absorb_depth,
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "TreeConfig":
        shape = d.get("shape", [d.get("dim")])
        dim = shape[0] if isinstance(shape, (list, tuple)) else int(shape)
        return cls(
            dim=int(dim),
            use_info=bool(d.get("use_info", True)),
            acuity_cutoff=bool(d.get("acuity_cutoff", False)),
            use_kl=bool(d.get("use_kl", True)),
            prior_var=float(d.get("prior_var", 1.0 / (2.0 * math.e * math.pi))),
            alpha=float(d.get("alpha", 1e-8)),
            max_fanout=int(d.get("max_fanout", 16)),
            absorb_depth=int(d.get("absorb_depth", 0)),
        )
