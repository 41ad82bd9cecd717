"""Build the port's CUDA C++ sources into a shared library at first use.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, the objects are linked into one shared
library with a plain C interface, and the library is cached under
``build/kernels/`` in the checkout (listed in ``.gitignore``), keyed by a
hash of the sources and flags. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

#: compiler output of every build in this process (ptxas statistics when
#: built with ``verbose=True``)
LAST_BUILD_LOG: List[str] = []


def build_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "build", "kernels")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from csrc/ at first use on a machine with the CUDA toolkit")


def build_library(name: str, sources: Sequence[str], headers: Sequence[str] = (),
                  verbose: bool = False) -> str:
    """Compile ``sources`` (file names in csrc/) into ``lib<name>_<hash>.so``
    and return its path; reuse it when the sources are unchanged."""
    srcs = [os.path.join(CSRC_DIR, s) for s in sources]
    flags = ARCH_FLAGS + CFLAGS + (["-Xptxas", "-v"] if verbose else [])
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(srcs + [os.path.join(CSRC_DIR, h) for h in headers]):
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
    if os.path.exists(lib):
        return lib

    nvcc = find_nvcc()
    jobs = []
    for src in srcs:
        obj = os.path.join(out_dir, f"{name}_{tag}_{os.path.basename(src)}.o")
        cmd = [nvcc, *flags, "-c", src, "-o", obj]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        LAST_BUILD_LOG.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))

    tmp = f"{lib}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                           *[obj for _, obj, _ in jobs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {lib} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def load_ctypes_library(name: str, sources: Sequence[str], headers: Sequence[str],
                        argtypes: Dict[str, list], verbose: bool = False) -> ctypes.CDLL:
    """``build_library``, loaded with ctypes, each C entry point in
    ``argtypes`` declared with its parameters and an int result."""
    lib = ctypes.CDLL(build_library(name, sources, headers, verbose=verbose))
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    return lib
