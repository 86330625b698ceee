"""ctypes bindings to the native crypto library (libreverie_native.so).

Builds the library on first use if the shared object is missing or stale.
The build is safe when several processes start at once: it holds an
exclusive lock on the source directory and writes to a temporary name that
is renamed into place, so no process loads a partly written library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libreverie_native.so")
_lock = threading.Lock()
_lib = None


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(_NATIVE_DIR, f)) > built
        for f in os.listdir(_NATIVE_DIR)
        if f.endswith(".c")
    )


@contextlib.contextmanager
def _dir_lock():
    """Exclusive lock across processes, held on the source directory."""
    fd = os.open(_NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _build() -> None:
    tmp = f"{os.path.basename(_LIB_PATH)}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-s", "-C", _NATIVE_DIR, f"OUT={tmp}"],
            check=True,
            capture_output=True,
        )
        os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(_NATIVE_DIR, tmp))


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            with _dir_lock():
                if _stale():
                    _build()
        lib = ctypes.CDLL(_LIB_PATH)

        lib.aes128_ctr_keystream.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.aes128_ctr_keystream_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
        ]
        lib.aes128_encrypt_block.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p]
        lib.aes128_key_expand.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.aes128_key_expand_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.blake3_hash.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        lib.blake3_xof.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.blake3_hash_many.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_void_p,
        ]
        _lib = lib
        return _lib
