"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use, never at import, into ``build/torch_kernels/`` at the
repository root; the library name carries a hash of its source and of
the shared headers beside it (``csrc/*.cuh``), so an edited kernel is
rebuilt and an unchanged one is reused.  All missing
libraries build at once, one ``nvcc`` process per source, under a file
lock (``build.lock``), so ranks of a multi-device run that start cold
build each library once and the rest load it.  A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCES = ("fused_topk", "rerank_l2", "blocked_topk")
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_topk": {
        "fused_topk_bf16": [_P] * 6 + [_I] * 4 + [_P],
        "fused_topk_f32": [_P] * 6 + [_I] * 4 + [_P],
        "fused_group_topk_bf16": [_P] * 6 + [_I] * 4 + [_P],
        "fused_group_topk_f32": [_P] * 6 + [_I] * 4 + [_P],
        "fused_prune_bf16": [_P] * 8 + [_I] * 5 + [_P],
        "fused_prune_final": [_P] * 5 + [_I] * 3 + [_P],
    },
    "blocked_topk": {
        "blocked_topk_bf16": [_P] * 9 + [_I] * 6 + [_P],
        "blocked_topk_f32": [_P] * 9 + [_I] * 6 + [_P],
    },
    "rerank_l2": {
        "rerank_l2": [_P] * 5 + [_I] * 3 + [_F, _F, _P],
        "rerank_l2_bf16": [_P] * 5 + [_I] * 3 + [_F, _F, _P],
    },
}
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def digest(src: Path) -> str:
    """Hash of a kernel source and the headers of its directory."""
    h = hashlib.sha1(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:12]


def nvcc_command(src: Path, out: Path, *flags: str) -> list:
    """The one ``nvcc`` command line of every kernel library."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", *flags, "-shared", "-Xcompiler", "-fPIC",
            "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{digest(_CSRC / f'{name}.cu')}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel,
    holding the build lock (another process building meanwhile: its
    libraries exist once the lock is taken).  Returns {name: nvcc output
    (with ``-Xptxas -v`` register counts)} for the sources built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_missing()


def _build_missing() -> dict:
    procs = {}
    for name in SOURCES:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = nvcc_command(_CSRC / f"{name}.cu", tmp, "-Xptxas", "-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
        so.with_suffix(".log").write_text(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _libs:
        so = library_path(name)
        if not so.exists():
            build_all()
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def launch(t, call):
    """``call(stream)`` on ``t``'s device and its current stream, the
    handle a plain int; the current device is switched only where it
    differs (a switch costs host time on every call)."""
    import torch
    if t.device.index == torch.cuda.current_device():
        return call(torch.cuda.current_stream(t.device).cuda_stream)
    with torch.cuda.device(t.device):
        return call(torch.cuda.current_stream().cuda_stream)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
