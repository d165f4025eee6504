"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled on first
use with ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<digest>.so``
(``build/`` is git-ignored).  The digest covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edit rebuilds and an unchanged
source is reused.  No PyTorch
header is included: a source builds in seconds, not minutes.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them; ``load(name)`` builds one source if needed and returns its
``ctypes.CDLL``.  A failed build raises with the compiler's output.  The
``-Xptxas -v`` register / shared-memory / spill lines of a build are kept
beside its library (``lib<name>-<digest>.ptxas.txt``) and read back by
``ptxas_report(name)``, also when the library was built earlier.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention", "memcom_xattn", "paged_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source on first use")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared by the sources
        digest.update(header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def ptxas_path(name: str) -> Path:
    return library_path(name).with_suffix(".ptxas.txt")


def ptxas_report(name: str) -> List[str]:
    """The ``-Xptxas -v`` lines of the build of the current library."""
    return ptxas_path(name).read_text().splitlines()


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` process each, all started together."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists() and ptxas_path(name).exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        ptxas_path(name).write_text("".join(
            ln.strip() + "\n" for ln in log.splitlines()
            if "ptxas" in ln or "spill" in ln))
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
