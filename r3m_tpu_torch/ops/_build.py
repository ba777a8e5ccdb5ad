"""Build the port's native libraries at first use and load them with ctypes.

Each ``r3m_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface: no PyTorch headers, so a build takes
seconds. Libraries go to ``r3m_tpu_torch/build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is; the compiler's output (``-Xptxas -v``: registers,
shared memory, spills) is kept beside it in ``<library>.log``. `build` starts one ``nvcc``
per source, all at once.

The host JPEG decoder (the repo's ``csrc/jpeg_decoder.cpp``, shared with the JAX package
and unchanged) is built the same way by the C++ compiler (``$CXX``, else ``g++``) with the
flags of ``csrc/Makefile`` into ``build/libr3m_decoder-<hash>.so`` (`load_decoder`); it
needs libjpeg's headers and library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
KERNELS = ("maxpool", "attention", "dense", "layer_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)
# Flags of one source alone, after `NVCC_FLAGS`: dense.cu is built from CUTLASS's headers
# (``$CUTLASS_HOME/include``) and asks cuBLASLt, which the loaded PyTorch has already
# brought into the process, one question.
CUTLASS_INCLUDE = os.path.join(os.environ.get("CUTLASS_HOME", "/usr/local/cutlass"), "include")
EXTRA_FLAGS = {"dense": ("-I", CUTLASS_INCLUDE, "--expt-relaxed-constexpr", "-DNDEBUG",
                         "-lcublasLt")}
DECODER_SOURCE = os.path.join(os.path.dirname(_PKG), "csrc", "jpeg_decoder.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")  # csrc/Makefile
CXX_LIBS = ("-ljpeg", "-lpthread")
_COMPILE_TIMEOUT_S = 600

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


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _hashed_path(name: str, source: str, flags) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    return _hashed_path(name, os.path.join(CSRC, f"{name}.cu"), _flags(name))


def decoder_library_path() -> str:
    """Where the library built from the repo's ``csrc/jpeg_decoder.cpp`` lives."""
    return _hashed_path("r3m_decoder", DECODER_SOURCE, CXX_FLAGS + CXX_LIBS)


def _compile(jobs: Dict[str, Tuple[str, Callable[[str], List[str]]]]
             ) -> Dict[str, Tuple[str, str]]:
    """Build ``{name: (library path, command(output file))}`` for each library that does
    not exist yet, all at once; returns ``{name: (path, compiler output)}`` (the kept
    output for a library built before) and raises with the output of any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    done: Dict[str, Tuple[str, str]] = {}
    running = {}
    for name, (out, command) in jobs.items():
        if os.path.exists(out):
            log = ""
            if os.path.exists(f"{out}.log"):
                with open(f"{out}.log") as f:
                    log = f.read()
            done[name] = (out, log)
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (out, tmp, proc)
    failures = []
    for name, (out, tmp, proc) in running.items():
        try:
            log, _ = proc.communicate(timeout=_COMPILE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failures.append(f"{os.path.basename(proc.args[0])} failed for {name} "
                            f"(rc {proc.returncode}):\n{log}")
            continue
        with open(f"{out}.log", "w") as f:
            f.write(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        done[name] = (out, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def build(names=KERNELS) -> Dict[str, Tuple[str, str]]:
    """Compile every named kernel source that has no library yet, in parallel.

    Returns ``{name: (library path, compiler output)}``; for a library that was already
    built, the output kept from its build. Raises with the compiler's output if a build
    fails.
    """
    def command(name):
        return lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu"),
                            *EXTRA_FLAGS.get(name, ())]

    return _compile({name: (library_path(name), command(name)) for name in names})


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            path, _ = build((name,))[name]
            _loaded[name] = ctypes.CDLL(path)
        return _loaded[name]


def load_decoder() -> ctypes.CDLL:
    """The loaded JPEG decoder library, built first if needed; raises `RuntimeError`
    (with the compiler's output) where it cannot be built or loaded, e.g. on a host
    without a C++ compiler or without libjpeg's headers."""
    with _lock:
        if "r3m_decoder" not in _loaded:
            cxx = shutil.which(os.environ.get("CXX") or "g++")
            if cxx is None:
                raise RuntimeError("no C++ compiler ($CXX or g++) to build csrc/jpeg_decoder.cpp")
            path, _ = _compile({"r3m_decoder": (decoder_library_path(), lambda tmp: [
                cxx, *CXX_FLAGS, "-o", tmp, DECODER_SOURCE, *CXX_LIBS])})["r3m_decoder"]
            try:
                _loaded["r3m_decoder"] = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
        return _loaded["r3m_decoder"]
