"""Whether the port's native JPEG decoder (``irp_tpu_torch/data/jpeg.py``)
can be built on this host, for the tests that compare its decode paths;
they skip with the reason where it cannot, as ``tests/test_native_decode.py``
skips the JAX package's."""

import os
import shutil
import subprocess

import pytest


def toolchain_missing() -> str:
    """Why the decoder cannot be built here ('' when it can)."""
    if shutil.which("g++") is None:
        return "g++ is not installed"
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    return "" if probe.returncode == 0 else "jpeglib.h is not installed"


needs_native_decoder = pytest.mark.skipif(
    bool(toolchain_missing()), reason=toolchain_missing() or "ready")
