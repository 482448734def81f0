"""Build, load and call the port's CUDA kernels; resolve devices.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/irp_tpu_torch/`` beside the package.  The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  Libraries are loaded with
``ctypes``; every C entry returns ``cudaGetLastError()`` after its launch
and :func:`check` raises on anything but 0.  Nothing here falls back: a
missing compiler, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "irp_tpu_torch")
SOURCES = ("eval_preprocess", "identity_bottleneck", "pairwise_topk",
           "copy_floor", "frozen_epilogue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.POINTER(ctypes.c_float)
# restype, argtypes of every C entry point, by library
SIGNATURES = {
    "eval_preprocess": {
        "irp_eval_preprocess": (_I, [_P, _P, _I, _I, _I, _I, _I, _F, _F,
                                     _P]),
    },
    "identity_bottleneck": {
        "irp_identity_bottleneck": (_I, [_P] * 8 + [_I] * 6 + [_P]),
    },
    "pairwise_topk": {
        "irp_pairwise_topk_splits": (_I, [_I] * 4),
        "irp_pairwise_topk": (_I, [_P] * 8 + [_I] * 6 + [_P]),
    },
    "copy_floor": {
        "irp_relu_copy": (_I, [_P, _P, ctypes.c_longlong, _P]),
    },
    "frozen_epilogue": {
        "irp_bias_relu": (_I, [_P] * 3 + [_L, _I, _P]),
        "irp_bias_add_relu": (_I, [_P] * 5 + [_L, _I, _P]),
        "irp_bias_relu_maxpool": (_I, [_P] * 3 + [_I] * 6 + [_P]),
    },
}

_lock = threading.Lock()
_libs: dict = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Asking for CUDA on a machine without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --cpu) "
            "to run on the CPU")
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    final = library_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish_build(name: str, job) -> None:
    proc, tmp, final = job
    log, _ = proc.communicate()
    with open(final[:-3] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, final)


def build_all() -> float:
    """Build every kernel library that is not built yet, one nvcc per
    source, all started together.  Returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {name: _start_build(name) for name in SOURCES}
        errors = []
        for name, job in jobs.items():
            if job is None:
                continue
            try:
                _finish_build(name, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for the
    library as built from the current source; '' if not built here."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = ctypes.CDLL(library_path(name))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            lib.irp_cuda_error_string.restype = ctypes.c_char_p
            lib.irp_cuda_error_string.argtypes = [_I]
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.irp_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream
