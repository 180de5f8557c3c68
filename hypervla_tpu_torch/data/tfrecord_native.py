"""ctypes bindings for the native TFRecord reader (native/tfrecord_reader.cpp).

The port's copy of hypervla_tpu/data/tfrecord_native.py. The source is
built where it lies, with g++ on demand, into the repository's `build/native/`
($HYPERVLA_NATIVE_CACHE overrides it, as in the JAX package). Falls back to
the pure-Python reader when no compiler is available, as the JAX package
does on the host, so the pipeline always works; the native path is the
production throughput route.
"""
import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional

_LIB = None
_LIB_FAILED = False


def _native_source() -> Path:
    return Path(__file__).resolve().parents[2] / "native" / "tfrecord_reader.cpp"


def _lib_path() -> Path:
    cache = Path(
        os.environ.get(
            "HYPERVLA_NATIVE_CACHE",
            Path(__file__).resolve().parents[2] / "build" / "native",
        )
    )
    cache.mkdir(parents=True, exist_ok=True)
    return cache / "libhvtfrecord.so"


def _load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None:
        return _LIB
    if _LIB_FAILED:
        return None
    src = _native_source()
    lib_path = _lib_path()
    try:
        if (
            not lib_path.exists()
            or lib_path.stat().st_mtime < src.stat().st_mtime
        ):
            subprocess.run(
                [
                    "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    "-o", str(lib_path), str(src),
                ],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(str(lib_path))
        lib.hv_open.restype = ctypes.c_void_p
        lib.hv_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.hv_next.restype = ctypes.c_int64
        lib.hv_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ]
        lib.hv_error.restype = ctypes.c_char_p
        lib.hv_error.argtypes = [ctypes.c_void_p]
        lib.hv_close.argtypes = [ctypes.c_void_p]
        lib.hv_crc32c.restype = ctypes.c_uint32
        lib.hv_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _LIB = lib
        return lib
    except Exception as e:
        logging.warning(
            f"native tfrecord reader unavailable ({e}); using pure Python."
        )
        _LIB_FAILED = True
        return None


def native_available() -> bool:
    return _load_library() is not None


def read_tfrecord_native(path: str,
                         validate_crc: bool = True) -> Iterator[bytes]:
    """Yields record payloads using the C++ reader; falls back to the
    pure-Python implementation when native code can't be built."""
    lib = _load_library()
    if lib is None:
        from hypervla_tpu_torch.data.tfrecord import read_tfrecord

        yield from read_tfrecord(path, validate_crc=validate_crc)
        return

    reader = lib.hv_open(path.encode(), int(validate_crc))
    if not reader:
        raise FileNotFoundError(path)
    try:
        data_ptr = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            length = lib.hv_next(reader, ctypes.byref(data_ptr))
            if length == 0:
                return
            if length < 0:
                raise IOError(
                    f"{path}: {lib.hv_error(reader).decode()}"
                )
            yield ctypes.string_at(data_ptr, length)
    finally:
        lib.hv_close(reader)
