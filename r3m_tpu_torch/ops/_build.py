"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``r3m_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface: no PyTorch headers, so a build takes
seconds. Libraries go to ``r3m_tpu_torch/build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is; the compiler's output (``-Xptxas -v``: registers,
shared memory, spills) is kept beside it in ``<library>.log``. `build` starts one ``nvcc``
per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
KERNELS = ("maxpool", "attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)
_NVCC_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's kernels are "
            "built from r3m_tpu_torch/csrc at first use and need the CUDA toolkit"
        )
    return path


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=KERNELS) -> Dict[str, Tuple[str, str]]:
    """Compile every named kernel source that has no library yet, in parallel.

    Returns ``{name: (library path, compiler output)}``; for a library that was already
    built, the output kept from its build. Raises with the compiler's output if a build
    fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    done: Dict[str, Tuple[str, str]] = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            log = ""
            if os.path.exists(f"{out}.log"):
                with open(f"{out}.log") as f:
                    log = f.read()
            done[name] = (out, log)
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (out, tmp, proc)
    failures = []
    for name, (out, tmp, proc) in jobs.items():
        try:
            log, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        with open(f"{out}.log", "w") as f:
            f.write(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        done[name] = (out, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            path, _ = build((name,))[name]
            _loaded[name] = ctypes.CDLL(path)
        return _loaded[name]
