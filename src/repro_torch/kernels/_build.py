"""Build and load the CUDA kernels: ``nvcc`` into plain-C shared libraries,
loaded with ``ctypes``.

Each ``csrc/<source>.cu`` compiles on its own (one ``nvcc`` per source, all
started together by :func:`build_all`) into
``build/kernels/<source>-<hash>.so`` at the repository root; a source may
hold several entry points (``beam_score`` and ``beam_score_int8``). The hash
covers the source, the ``csrc/*.cuh`` headers and the flags, so a stale
library is never loaded. A
build error raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.obs import trace as T

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("rng_prune", "rng_prune_wide", "beam_score", "beam_score_pq", "pairwise_l2",
           "fm_interact", "bucket_merge")  # sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}     # entry name -> typed C function
_OPEN: dict = {}     # library path -> ctypes.CDLL
TALLY = {"builds": 0, "loads": 0}
BUILD_LISTENERS: list = []   # fn(source, start_s, dur_s, rc) after each nvcc run
LOAD_LISTENERS: list = []    # fn(entry, source) after each library opened


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
    # the headers any source may include count as part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def ptxas_path(name: str) -> Path:
    """Where the ``-Xptxas -v`` report of source ``name``'s library is kept."""
    return _lib_path(name).with_suffix(".ptxas.txt")


def build_all(names=KERNELS) -> dict:
    """Compile every kernel not yet built, in parallel. Returns
    ``{"seconds": wall, "ptxas": {name: nvcc's -Xptxas -v report}}`` (the
    reports of the sources built by this call)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with T.timed("kernel/build_all") as tm:
        procs = {}
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out, T.clock())
        reports, errors = {}, []
        for name, (proc, tmp, out, start) in procs.items():
            log, _ = proc.communicate()
            # the end is when this wait returned: a source finished while an
            # earlier one was awaited is stamped late
            TALLY["builds"] += 1
            for fn in BUILD_LISTENERS:
                fn(name, start, T.clock() - start, proc.returncode)
            reports[name] = log
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
                continue
            ptxas_path(name).write_text(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"seconds": tm.seconds, "ptxas": reports}


def load(name: str, argtypes: str, source: str | None = None):
    """The C entry point ``name`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``; built on first use),
    typed from ``argtypes``: one letter per argument, ``p`` a pointer or the
    stream (``c_void_p``: a Python int would be cut to 32 bits), ``i`` an
    int. It returns a ``cudaError_t`` as int."""
    fn = _LIBS.get(name)
    if fn is None:
        source = source or name
        path = _lib_path(source)
        if not path.exists():
            build_all((source,))
        fn = getattr(_open(path, source), name)
        fn.argtypes = [{"p": ctypes.c_void_p, "i": ctypes.c_int}[c] for c in argtypes]
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def _open(path: Path, source: str):
    lib = _OPEN.get(path)
    if lib is None:
        lib = _OPEN[path] = ctypes.CDLL(str(path))
        TALLY["loads"] += 1
        for fn in LOAD_LISTENERS:
            fn(path.name, source)
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


def stream_handle(device: torch.device) -> int:
    """The raw handle of the current stream of CUDA ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without building
    a Stream object (0.3 against 5.2 us of host time per call on an H100
    80GB HBM3 host, scripts/beam_ab.py)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
