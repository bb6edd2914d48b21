"""Build and load the hand-written CUDA kernels of the port.

Each source is compiled on first use with ``nvcc`` for Hopper (sm_90a)
into a shared library with a plain C interface, keyed by a hash of the
source, the headers beside it and the flags, under
``build/repro_torch_kernels/`` at the root of the checkout, and loaded
with `ctypes`.  Each caller names the source's directory and its flags
(`NVCC_ARCH_FLAGS` and its own): one source built with two sets of flags
(say, two ``-D`` instances) gives two libraries.
Nothing is compiled or loaded when this module is imported.  Loading is
safe from several threads at once (the sharded fleet service's lanes):
one build and one bind per library and process.
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
    "NVCC_ARCH_FLAGS",
    "build",
    "build_dir",
    "check_tensor",
    "count_launch",
    "kernel_source",
    "load_library",
    "nvcc_path",
]

#: every library's target, language, shared-object and report flags
NVCC_ARCH_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: seconds one nvcc invocation may take before the build is abandoned
_BUILD_TIMEOUT_S = 600

#: the loaded libraries, by (source name, directory, flags)
_loaded: dict[tuple, ctypes.CDLL] = {}
#: held across the check, build, load, bind and insert of `load_library`
_load_lock = threading.Lock()
#: held around each launch count's increment (`count_launch`)
_count_lock = threading.Lock()


def kernel_source(name: str, csrc: pathlib.Path) -> pathlib.Path:
    """Path of the CUDA source `name` (e.g. ``"fused_tick.cu"``) in
    the directory `csrc`."""
    path = pathlib.Path(csrc) / name
    if not path.is_file():
        raise FileNotFoundError(f"no CUDA source {path}")
    return path


def build_dir() -> pathlib.Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


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


def _library_path(src: pathlib.Path, flags) -> pathlib.Path:
    """The keyed library of `src` built with `flags`: the hash covers the source, every header beside it (any of
    them may be included) and the flags, so an edit to a shared header
    rebuilds every source of its directory."""
    digest = hashlib.sha256()
    digest.update(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    return build_dir() / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build(name: str, csrc: pathlib.Path, flags) -> pathlib.Path:
    """Compile `<csrc>/<name>` with `flags` unless its keyed library
    exists; returns the library path.  The compiler's report (registers,
    spills) is kept beside it as ``<library>.log``."""
    src = kernel_source(name, csrc)
    lib = _library_path(src, flags)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # one temporary name per build: threads of one process share a pid
    tmp = lib.with_name(
        f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    )
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
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


def load_library(name: str, bind, csrc: pathlib.Path, flags) -> ctypes.CDLL:
    """Build (if needed) and load `<csrc>/<name>` with `flags` (as
    `build`), then `bind(lib)` to declare its C interface; both once per
    process and (name, directory, flags), however many threads ask at
    once."""
    key = (name, str(csrc), tuple(flags))
    with _load_lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, csrc, flags)))
            bind(lib)
            _loaded[key] = lib
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
