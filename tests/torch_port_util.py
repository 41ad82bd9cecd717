"""Helpers for the PyTorch port's tests.

``one_torch_thread``: an autouse fixture that runs a test module's PyTorch
CPU ops on one thread and gives the process its thread count back after
the module. The suite runs in several worker processes at once, each with
XLA's own thread pool; PyTorch's default of one intra-op thread per core
then oversubscribes the cores. At the port tests' tiny shapes one thread
takes about half the CPU time, and no more wall time even on an idle
machine. Import it into a test module to use it there.

``c_params`` and ``c_struct``: the parameter and field types of a C entry
point and a struct in one of the port's CUDA sources, as ctypes types, so
that the CPU tests can hold the wrappers' ctypes declarations to the
sources (a mismatch shows on the card only, as garbage).
"""

import ctypes
import os
import re

import pytest
import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sketch2img_torch", "csrc")

_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return re.sub(r"//[^\n]*", "", f.read())


def _ctype(decl: str, pointers: dict):
    """'const float* lse' -> c_void_p; 'long long qsb' -> c_longlong; a
    pointer to a type named in ``pointers`` -> that ctypes type."""
    decl = " ".join(decl.replace("*", " * ").split())
    words = decl.split(" ")[:-1]  # drop the parameter's name
    if "*" in words:
        base = [w for w in words if w not in ("const", "*")]
        return pointers.get(" ".join(base), ctypes.c_void_p)
    return _SCALARS[" ".join(w for w in words if w != "const")]


def c_params(source: str, function: str, pointers=None) -> list:
    """Parameter types of ``extern "C" int function(...)`` in csrc/``source``."""
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % re.escape(function), _source(source))
    assert m, f"no extern \"C\" int {function}(...) in {source}"
    return [_ctype(p, pointers or {}) for p in m.group(1).split(",")]


def c_struct(source: str, struct: str) -> list:
    """[(field, ctypes type)] of ``struct name { ... };`` in csrc/``source``."""
    m = re.search(r"struct %s \{([^}]*)\};" % re.escape(struct), _source(source))
    assert m, f"no struct {struct} in {source}"
    fields = []
    for stmt in filter(None, (s.strip() for s in m.group(1).split(";"))):
        first, *rest = (x.strip() for x in stmt.split(","))
        *words, name = first.split()
        fields += [(n, _SCALARS[" ".join(words)]) for n in [name] + rest]
    return fields
