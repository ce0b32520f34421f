"""The kernels' persistent build cache: the counterpart of the JAX
package's ``enable_persistent_cache`` (``rag_cobweb_tpu/utils/cache.py``).

Nothing in the port is JIT-compiled; what a cold process pays for is
``nvcc``.  Each kernel library is cached in the build directory under a
hash of its source (``ops/_build.py``), so pointing that directory at a
place that outlives the process makes every later process start warm.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from rag_cobweb_tpu_torch.ops import _build

ENV_VAR = "RAG_COBWEB_TPU_TORCH_BUILD_DIR"
DEFAULT_DIR = _build.BUILD_DIR     # the repository's build/torch_kernels/


def enable_persistent_cache(path: Optional[str] = None) -> Path:
    """Build and load the kernel libraries from ``path``; without one,
    from ``$RAG_COBWEB_TPU_TORCH_BUILD_DIR``, else the repository's
    ``build/torch_kernels/``.  Where that directory cannot be written
    (an installed package), ``~/.cache/rag_cobweb_tpu_torch/kernels``.
    Returns the directory in use."""
    d = Path(path or os.environ.get(ENV_VAR) or DEFAULT_DIR)
    try:
        d.mkdir(parents=True, exist_ok=True)
        if not os.access(d, os.W_OK):
            raise OSError(f"{d} not writable")
    except OSError:
        d = Path.home() / ".cache" / "rag_cobweb_tpu_torch" / "kernels"
        d.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = d
    return d
