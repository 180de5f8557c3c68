"""Builds a CUDA source of the package into a shared library with a plain C
interface and loads it with ctypes.

The library is compiled with nvcc for sm_90a at first use, into
`build/kernels/` beside the package, under a name keyed by a hash of the
source, the headers (`csrc/*.cuh`) and the flags, so a changed source is rebuilt and an unchanged one
is loaded as it is. A missing compiler or a failed build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "kernels"

_lock = threading.Lock()
_loaded = {}


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def build(source: str) -> Path:
    """Builds `csrc/<source>` unless a library for this source and these
    flags exists; returns the library's path. The library appears under its
    final name only once complete, so processes building one source at once
    are safe, and threads may build different sources at once."""
    src = _PACKAGE_DIR / "csrc" / source
    # the headers beside the sources are part of every source's key
    headers = sorted(src.parent.glob("*.cuh"))
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in (src, *headers))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{src.stem}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    return lib_path


def load_library(source: str) -> ctypes.CDLL:
    """Returns the loaded library built from `csrc/<source>`, building it
    first if no library for this source and these flags exists yet."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
