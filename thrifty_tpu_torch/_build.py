"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, where the
hash covers the source text, the compiler flags and the nvcc path, so a
changed kernel rebuilds and a stale library is never loaded.  The
library is compiled to a temporary name and moved into place with
``os.replace``, so a process never loads a half-written file even when
several build at once.  The sources have a plain C interface and
include no PyTorch header, which keeps a build to seconds.

Nothing here runs at import time: the first wrapper that launches a
kernel calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Print registers / shared memory / spills per kernel.
    "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, ``$PATH`` or the default CUDA prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels cannot be built")


def sources() -> list[str]:
    """Names of the kernel sources in ``csrc/`` (without ``.cu``)."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path(name: str, nvcc: str, source: str = None) -> str:
    with open(source or os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        text = f.read()
    digest = hashlib.sha256(
        text + "\0".join((nvcc,) + NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, "lib{}-{}.so".format(name, digest))


def build(name: str, force: bool = False,
          source: str = None) -> tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` (or the file ``source``, under the
    library name ``name``) unless an up-to-date library exists
    (``force`` compiles anyway).

    Returns (library path, seconds spent compiling -- 0.0 when it was
    already built, compiler output).
    """
    nvcc = find_nvcc()
    source = source or os.path.join(CSRC_DIR, name + ".cu")
    out = library_path(name, nvcc, source)
    if os.path.exists(out) and not force:
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.tmp.{}".format(out, os.getpid())
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("nvcc failed ({}) for {}:\n{}".format(
            proc.returncode, name, log))
    os.replace(tmp, out)
    return out, seconds, log


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        path, _, _ = build(name)
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
