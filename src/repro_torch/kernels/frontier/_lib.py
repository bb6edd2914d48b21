"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled on first use with ``nvcc`` for Hopper (sm_90a)
into a shared library with a plain C interface, keyed by a hash of the
source, the shared headers and the flags, under
``build/repro_torch_kernels/`` at the root of the checkout, and loaded
with `ctypes`.  Nothing is compiled or loaded when this module is
imported.  Loading is safe from several threads at once (the sharded
fleet service's lanes): one build and one bind per library and process.
The wrappers count their launches through `count_launch`, under a lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = [
    "build",
    "build_dir",
    "check_tensor",
    "count_launch",
    "kernel_source",
    "load_library",
    "nvcc_path",
]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-ftz=true", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: seconds one nvcc invocation may take before the build is abandoned
_BUILD_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}
#: held across the check, build, load, bind and insert of `load_library`
_load_lock = threading.Lock()
#: held around each launch count's increment (`count_launch`)
_count_lock = threading.Lock()


def kernel_source(name: str) -> pathlib.Path:
    """Path of the CUDA source `name` (e.g. ``"fused_tick.cu"``)."""
    path = _CSRC / name
    if not path.is_file():
        raise FileNotFoundError(f"no CUDA source {path}")
    return path


def build_dir() -> pathlib.Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return _CSRC.parents[4] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source on first use"
    )


def _library_path(src: pathlib.Path) -> pathlib.Path:
    """The keyed library of `src`: the hash covers the source, every
    header of ``csrc/`` (any of them may be included) and the flags, so
    an edit to a shared header rebuilds every source."""
    digest = hashlib.sha256()
    digest.update(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile `csrc/<name>` unless its keyed library exists; returns the
    library path.  The compiler's report (registers, spills) is kept
    beside it as ``<library>.log``."""
    src = kernel_source(name)
    lib = _library_path(src)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # one temporary name per build: threads of one process share a pid
    tmp = lib.with_name(
        f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    )
    cmd = [nvcc_path(), *_NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see a half file
    return lib


def count_launch(counts: dict, key: str) -> None:
    """Add one to ``counts[key]`` (a wrapper module's `launches` entry,
    or its globals' ``"launches"``) under a lock: the sharded service's
    lanes launch from several threads at once."""
    with _count_lock:
        counts[key] += 1


def load_library(name: str, bind) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>`, then `bind(lib)` to
    declare its C interface; both once per process, however many threads
    ask at once."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            bind(lib)
            _loaded[name] = lib
    return lib


def check_tensor(t, name: str, shape, dtype, device, *,
                 contiguous: bool = True) -> None:
    """Raise unless tensor `t` (argument `name` of a kernel launch) has
    the device, dtype and shape the kernel takes, and is contiguous
    unless the kernel reads it through strides."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
