"""Build and load the package's CUDA sources at first use.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles it in seconds into a shared library that
``ctypes`` loads; pointers and the stream cross the boundary as integers
(``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``).

The library goes into ``build/`` beside the package, under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
and a built one is reused.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
_library_paths: dict[str, pathlib.Path] = {}
_build_logs: dict[str, str] = {}


def build_dir() -> pathlib.Path:
    return CSRC.parent.parent / "build"


def find_nvcc() -> str:
    candidates = [
        os.path.join(os.environ.get(var, ""), "bin", "nvcc")
        for var in ("CUDA_HOME", "CUDA_PATH")
        if os.environ.get(var)
    ]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked at CUDA_HOME, CUDA_PATH, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _paths(name: str):
    """(source, library, log) of ``csrc/<name>.cu`` as it stands."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    return source, out_dir / f"lib{name}-{digest}.so", out_dir / f"lib{name}-{digest}.log"


def _build(name: str):
    """Compile ``csrc/<name>.cu`` unless its library is built; no lock held,
    so several sources compile at once."""
    source, target, log_path = _paths(name)
    if not (target.exists() and log_path.exists()):
        scratch = target.with_name(f"{target.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        log = compile_source(source, scratch)
        log_path.write_text(log)
        os.replace(scratch, target)  # atomic: a concurrent build is harmless


def build_all(names) -> None:
    """Compile the given sources at once, one ``nvcc`` each, and load them."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names) or 1) as pool:
        list(pool.map(_build, names))          # raises the first build's error
    for name in names:
        load_library(name)


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    with _lock:
        if name in _libraries:
            return _libraries[name]
        _build(name)
        _, target, log_path = _paths(name)
        _build_logs[name] = log_path.read_text()
        _library_paths[name] = target
        _libraries[name] = ctypes.CDLL(str(target))
        return _libraries[name]


def compile_source(source: pathlib.Path, target: pathlib.Path) -> str:
    """Compile one CUDA source into a shared library with the package's
    flags; returns what ``nvcc -Xptxas -v`` printed, raises if it failed."""
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(target), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name} (exit {proc.returncode}):\n{log}")
    return log


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for ``csrc/<name>.cu`` (registers,
    spills, shared memory); builds the library if that has not happened."""
    load_library(name)
    return _build_logs[name]


def library_path(name: str) -> pathlib.Path:
    """The file :func:`load_library` loads for the source as it stands."""
    load_library(name)
    return _library_paths[name]
