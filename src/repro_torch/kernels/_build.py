"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library of its own with a plain C interface: no PyTorch
header is included, so a build takes seconds, not minutes.  The library
is loaded with ``ctypes``; pointers and the CUDA stream are passed as
``c_void_p``.  Every C entry point returns ``cudaGetLastError()`` after
its launches (or a negative code for arguments it refuses), and
:func:`check` raises on anything but 0.

Libraries go to ``build/kernels/`` at the root of the checkout, named by
a hash of the sources and flags: an edited source is rebuilt, an unchanged
one is loaded.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_attention", "decode_attention", "state_push", "moe_gmm")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}      # nvcc's output (ptxas register/smem report)


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, the ``PATH`` or the
    toolkit's default prefix, in that order."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit "
                       "(set CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile every library in ``names`` that is not built yet, with one
    ``nvcc`` per source, all started together."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            out = library_path(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (p, tmp, out) in procs.items():
            BUILD_LOG[n] = p.communicate()[0]
            if p.returncode != 0:
                failed.append(f"{n}: nvcc exit {p.returncode}\n{BUILD_LOG[n]}")
            else:
                os.replace(tmp, out)
    finally:
        for p, tmp, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel ``name``, returning an int."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check(name: str, rc: int) -> None:
    """Raise unless a C entry point of kernel ``name`` returned 0."""
    if rc < 0:
        raise ValueError(f"{name}: the kernel refused its arguments "
                         f"(code {rc})")
    if rc != 0:
        err = load(name).repro_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {rc} at launch "
                           f"({err(rc).decode()})")
