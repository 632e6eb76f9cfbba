"""Build + load the native core.

Compiles ``wqcore.cpp`` (and the codec, the server daemon) with the system
``g++`` into the git-ignored ``adlb_tpu_torch/_build/native/`` (cached by
mtime), then loads it with ctypes. Sources stay next to this file; nothing
is written beside them. No pip/pybind11/setuptools involvement — the
reference's build layer is plain CMake over C sources (reference
``CMakeLists.txt:44-56``); this is the same spirit with less machinery.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Callable, Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
#: where every native output of the port goes (sources stay in _DIR)
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
_SRC = os.path.join(_DIR, "wqcore.cpp")
_LIB = os.path.join(BUILD_DIR, "libadlbwq.so")


def compile_to(out: str, deps: Sequence[str],
               cmd: Callable[[str], list]) -> str:
    """Build ``out`` with the command ``cmd(tmp)`` unless it is at least as
    new as every path in ``deps``; returns ``out``.

    The compiler writes a private temp file that is renamed into place, and
    the build holds a lock file beside ``out``: concurrent processes (test
    workers, a world's ranks) build once, and none loads a half-written
    file. Raises ``subprocess.CalledProcessError`` or ``OSError``."""
    newest = max(os.path.getmtime(d) for d in deps)

    def fresh() -> bool:
        return os.path.exists(out) and os.path.getmtime(out) >= newest

    if fresh():
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():  # another process built it while we waited
            return out
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run(cmd(tmp), check=True, capture_output=True,
                           text=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


_lock = threading.Lock()
_lib: Optional[ctypes.PyDLL] = None
_build_error: Optional[str] = None


def _compile() -> None:
    compile_to(_LIB, [_SRC], lambda tmp: [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC,
    ])


def _bind(lib: ctypes.PyDLL) -> ctypes.PyDLL:
    i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    i32p, i64p = ctypes.POINTER(i32), ctypes.POINTER(i64)
    sig = {
        "adlb_wq_new": (p, []),
        "adlb_wq_free": (None, [p]),
        "adlb_wq_add": (i32, [p, i64, i32, i32, i32, i32, i32, i64]),
        "adlb_wq_remove": (i32, [p, i64]),
        "adlb_wq_pin": (i32, [p, i64, i32]),
        "adlb_wq_unpin": (i32, [p, i64]),
        "adlb_wq_find_match": (i64, [p, i32, i32p, i32]),
        "adlb_wq_find_targeted": (i64, [p, i32, i32p, i32]),
        "adlb_wq_find_untargeted": (i64, [p, i32p, i32]),
        "adlb_wq_hi_prio_of_type": (i32, [p, i32, i32p]),
        "adlb_wq_count": (i64, [p]),
        "adlb_wq_max_count": (i64, [p]),
        "adlb_wq_total_bytes": (i64, [p]),
        "adlb_wq_num_unpinned": (i64, [p]),
        "adlb_wq_num_unpinned_untargeted": (i64, [p]),
        "adlb_wq_depth_sample": (None, [p, i64p]),
        "adlb_wq_snapshot_untargeted": (i64, [p, i64, i64p, i32p, i32p, i64p]),
        "adlb_wq_get": (i32, [p, i64, i32p, i32p, i32p, i32p, i64p]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def ensure_built() -> Optional[ctypes.PyDLL]:
    """Build if stale and load; returns None (and records why) on failure."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        try:
            _compile()
            # every call is a short, non-blocking C++ queue operation, so
            # the library is loaded through ctypes.PyDLL, which keeps the
            # interpreter lock: a CDLL call gives it up, and in a busy
            # world each re-acquire can stall the calling thread for a
            # scheduler switch interval (milliseconds)
            _lib = _bind(ctypes.PyDLL(_LIB))
            return _lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _build_error = f"native core unavailable: {detail[:500]}"
            return None


def native_available() -> bool:
    return ensure_built() is not None


def build_error() -> Optional[str]:
    return _build_error


# ------------------------------------------------------------------ codec

_CODEC_SRC = os.path.join(_DIR, "codec.cpp")
_CODEC_LIB = os.path.join(BUILD_DIR, "libadlbcodec.so")
_CODEC_ERRMARK = os.path.join(BUILD_DIR, "libadlbcodec.err")

_codec_lock = threading.Lock()
_codec_lib = None  # the _adlbcodec module object once loaded
_codec_error: Optional[str] = None


def _compile_codec() -> None:
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise OSError(f"Python.h not found under {inc}")
    compile_to(_CODEC_LIB, [_CODEC_SRC], lambda tmp: [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{inc}",
        "-o", tmp, _CODEC_SRC,
    ])


def _bind_codec(lib: ctypes.PyDLL):
    # PyDLL (the wqcore O(1)-getter discipline, GIL held throughout): the
    # ONE ctypes call asks the library for a fully-formed module object,
    # whose encode/decode are METH_FASTCALL builtins — per-frame calls
    # cost a builtin vector call, not a ctypes FFI marshal
    lib.adlb_codec_module.restype = ctypes.py_object
    lib.adlb_codec_module.argtypes = []
    return lib.adlb_codec_module()


def ensure_codec():
    """Build (if stale) and load the compiled TLV codec; returns the
    codec MODULE object, or None (recording why) when the toolchain or
    headers are unavailable.

    A failed compile writes a marker stamped with the source mtime so
    every subsequently spawned rank skips the doomed g++ attempt instead
    of paying it per process (spawn worlds fork dozens)."""
    global _codec_lib, _codec_error
    with _codec_lock:
        if _codec_lib is not None:
            return _codec_lib
        if _codec_error is not None:
            return None
        src_mtime = os.path.getmtime(_CODEC_SRC)
        try:
            if (
                not os.path.exists(_CODEC_LIB)
                or os.path.getmtime(_CODEC_LIB) < src_mtime
            ):
                try:
                    with open(_CODEC_ERRMARK) as f:
                        if float(f.read().split("\n", 1)[0]) == src_mtime:
                            _codec_error = ("codec build failed previously "
                                            f"(see {_CODEC_ERRMARK})")
                            return None
                except (OSError, ValueError):
                    pass
                _compile_codec()
                try:
                    os.unlink(_CODEC_ERRMARK)
                except OSError:
                    pass
            _codec_lib = _bind_codec(ctypes.PyDLL(_CODEC_LIB))
            return _codec_lib
        except AttributeError as e:
            # a stale .so predating the module-object entrypoint
            _codec_error = f"compiled codec unavailable: {e}"
            return None
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _codec_error = f"compiled codec unavailable: {detail[:500]}"
            try:
                os.makedirs(BUILD_DIR, exist_ok=True)
                with open(_CODEC_ERRMARK, "w") as f:
                    f.write(f"{src_mtime}\n{_codec_error}\n")
            except OSError:
                pass
            return None


def codec_error() -> Optional[str]:
    return _codec_error


# ---------------------------------------------------------------- serverd

_SERVERD_SRC = os.path.join(_DIR, "serverd.cpp")
_SERVERD_HDR = os.path.join(_DIR, "wqcore.hpp")
_SERVERD_BIN = os.path.join(BUILD_DIR, "adlb_serverd")

_serverd_lock = threading.Lock()
_serverd_error: Optional[str] = None


def ensure_serverd() -> str:
    """Build (if stale) and return the path of the native server daemon.

    Raises RuntimeError when the toolchain is unavailable — callers asked
    for server_impl="native" explicitly, so there is no silent fallback.
    """
    global _serverd_error
    with _serverd_lock:
        if _serverd_error is not None:
            raise RuntimeError(_serverd_error)
        try:
            return compile_to(
                _SERVERD_BIN, [_SERVERD_SRC, _SERVERD_HDR], lambda tmp: [
                    "g++", "-O2", "-std=c++17", "-pthread", "-o", tmp,
                    _SERVERD_SRC,
                ])
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _serverd_error = f"native server unavailable: {detail[:800]}"
            raise RuntimeError(_serverd_error) from None
