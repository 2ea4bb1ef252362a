"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file exports a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/kernels/`` at the root of the checkout, a directory git ignores.
The library name carries a hash of the source and the flags, so an edited
source is never served a stale build; concurrent builds write to a
temporary name and rename.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # every product and sum rounds on its own, like the separate torch ops
    # of the plain versions the kernels are held against
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_shared_library(source_name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source_name>`` unless an identical build exists.

    Returns (library path, compiler output; empty when the build was
    already there).  Raises RuntimeError with the compiler output when
    nvcc fails."""
    source = CSRC_DIR / source_name
    digest = hashlib.sha256(
        source.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source_name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr
