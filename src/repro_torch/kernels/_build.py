"""Build and load the CUDA kernels: ``nvcc`` into plain-C shared libraries,
loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own (one ``nvcc`` per source, all
started together by :func:`build_all`) into ``build/kernels/<name>-<hash>.so``
at the repository root; the hash covers the source and the flags, so a stale
library is never loaded. A build error raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("rng_prune", "beam_score", "pairwise_l2")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH): "
                           "the CUDA kernels are built on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every kernel not yet built, in parallel. Returns
    ``{"seconds": wall, "ptxas": {name: nvcc's -Xptxas -v report}}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"seconds": time.perf_counter() - t0, "ptxas": reports}


def load(name: str, argtypes: str):
    """The C entry point ``name`` of ``csrc/<name>.cu`` (built on first use),
    typed from ``argtypes``: one letter per argument, ``p`` a pointer or the
    stream (``c_void_p``: a Python int would be cut to 32 bits), ``i`` an
    int. It returns a ``cudaError_t`` as int."""
    fn = _LIBS.get(name)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        fn = getattr(ctypes.CDLL(str(path)), name)
        fn.argtypes = [{"p": ctypes.c_void_p, "i": ctypes.c_int}[c] for c in argtypes]
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
