"""ctypes binding to the port's native batch JPEG decoder
(``csrc/decode.cpp``; the JAX package's ``data/jpeg.py``).

The library decodes a batch of JPEGs with libjpeg and resizes each with
an antialiased triangle filter, across a thread pool on the host: the
fast path of :func:`~irp_tpu_torch.data.pipeline.decode_blobs` and of
``build_cache(use_native=True)``, within 1/255 of PIL and byte-equal to
the JAX package's library.

At first use ``g++`` builds ``csrc/decode.cpp`` into
``build/irp_tpu_torch/libdecode-<digest>.so`` beside the package (the
digest covers the source and the flags, so an edited source is rebuilt)
and keeps its output in the ``.log`` beside it.  ``IRP_DECODER_LIB``
names a library to load instead, as in the JAX package.  Where the build
or the load fails, :func:`native_decoder_available` is False and
:func:`build_log_tail` says why; callers then decode with PIL.  A failed
build leaves a ``.failed`` file beside its log, and later processes do
not run the compiler again until it is removed.  The CLIs call
:func:`prepare` at startup, so no request or timed batch waits for the
compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Sequence

import numpy as np

from irp_tpu_torch._kernels import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "decode.cpp")
CXX_FLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-shared", "-std=c++17",
             "-Wall")
LINK_FLAGS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> str:
    """Where the library built from the current source lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libdecode-{digest.hexdigest()[:16]}.so")


def _log_path() -> str:
    return library_path()[:-3] + ".log"


def _failed_path() -> str:
    return library_path()[:-3] + ".failed"


def build() -> float:
    """Build the library from ``csrc/decode.cpp`` unless it is built;
    returns the seconds it took.  Raises RuntimeError, with the compiler's
    output in :func:`build_log_tail`, when it cannot be built, or when an
    earlier build of the same source failed (its ``.failed`` file)."""
    t0 = time.perf_counter()
    final = library_path()
    if os.path.exists(final):
        return time.perf_counter() - t0
    if os.path.exists(_failed_path()):
        raise RuntimeError(
            f"the native decoder did not build earlier (remove "
            f"{_failed_path()} to try again): {build_log_tail()}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        log, rc = "g++ not found: the native decoder needs a C++ compiler", 1
    else:
        tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp,
                               *LINK_FLAGS], capture_output=True, text=True)
        log, rc = proc.stdout + proc.stderr, proc.returncode
        if rc == 0:
            os.replace(tmp, final)
        elif os.path.exists(tmp):
            os.remove(tmp)
    with open(_log_path(), "w") as f:
        f.write(log)
    if rc != 0:
        with open(_failed_path(), "w") as f:
            f.write(f"{rc}\n")
        raise RuntimeError(f"the native decoder did not build (exit {rc}): "
                           f"{build_log_tail()}")
    return time.perf_counter() - t0


def build_log_tail(lines: int = 20) -> str:
    """The last ``lines`` lines of the build's log (the compiler's output,
    or why there was none, or why the library did not load); '' when
    nothing was built or tried here."""
    path = _log_path()
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return "\n".join(f.read().rstrip().splitlines()[-lines:])


def _bind(path: str):
    lib = ctypes.CDLL(path)
    lib.irp_decode_resize_batch.restype = ctypes.c_int
    lib.irp_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    return lib


def _note(text: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(_log_path(), "a") as f:
        f.write(f"\n{text}\n")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _lock:
        if not _TRIED:
            path = os.environ.get("IRP_DECODER_LIB")
            try:
                if path is None:
                    build()
                    path = library_path()
                _LIB = _bind(path)
            except RuntimeError:  # the build failed; build() logged why
                _LIB = None
            except OSError as e:
                _note(f"loading {path} failed: {e}")
                _LIB = None
            _TRIED = True
    return _LIB


def native_decoder_available() -> bool:
    """True when the library built (or ``IRP_DECODER_LIB``) loads."""
    return _load() is not None


def prepare(decoder: str = "auto") -> Optional[str]:
    """Build or load the library before a hot path when ``decoder`` is
    'auto'; returns why it is unavailable (the log's first error line,
    else its last line), else None."""
    if decoder != "auto" or native_decoder_available():
        return None
    lines = build_log_tail().strip().splitlines()
    errors = [line for line in lines if "error" in line or "failed" in line]
    if errors:
        return errors[0]
    return lines[-1] if lines else "the library did not load"


def decode_batch_native(jpegs: Sequence[bytes], out_size: int = 256,
                        n_threads: int = 0, out: Optional[np.ndarray] = None):
    """Decode and resize a batch of JPEG byte strings on the host's
    threads (``n_threads`` 0: one per core).

    Returns (images (N, out, out, 3) uint8, ok (N,) bool).  ``out``
    (C-contiguous (N, out, out, 3) uint8) decodes in place; rows whose
    ``ok`` is False are left untouched for the caller's fallback decoder.
    Raises RuntimeError when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"the native decoder is unavailable: {build_log_tail()}")
    n = len(jpegs)
    if out is None:
        out = np.zeros((n, out_size, out_size, 3), np.uint8)
    elif (out.shape != (n, out_size, out_size, 3) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError("out must be C-contiguous (N,out,out,3) uint8")
    ok = np.zeros(n, np.int32)
    buf_ptrs = (ctypes.c_char_p * n)(*jpegs)
    sizes = (ctypes.c_long * n)(*[len(b) for b in jpegs])
    lib.irp_decode_resize_batch(
        ctypes.cast(buf_ptrs, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(sizes, ctypes.POINTER(ctypes.c_long)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_size,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    return out, ok.astype(bool)


def make_native_decoder(out_size: int = 256):
    """A per-sample decoder with ``build_cache``'s ``decoder`` signature;
    raises ValueError on a blob the library cannot decode."""
    def decode_one(jpg: bytes, size: int = out_size):
        imgs, ok = decode_batch_native([jpg], size)
        if not ok[0]:
            raise ValueError("native JPEG decode failed")
        return imgs[0]
    return decode_one
