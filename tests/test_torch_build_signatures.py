"""The ctypes signatures of the kernels' C entries
(evostencils_tpu_torch/ops/kernels/_build.py ``SIGNATURES``) against the
``extern "C"`` declarations in the CUDA sources.

The library is built and called only on the card, where a wrong argument
count or type would shift every argument after it without an error; here
the declarations are read as text.  Each entry must be declared in exactly
one source, return ``int`` (a ``cudaError_t``), and take, in order, the
argument types of its row in ``SIGNATURES``: an ``int`` as ``c_int``, an
``int*`` as a pointer to ``c_int``, a ``double*`` as a pointer to
``c_double``, a ``void**`` as a pointer to ``c_void_p`` and any other
pointer (tensor data, the stream) as ``c_void_p``.
"""

import ctypes
import re

import pytest

pytest.importorskip("torch")

from evostencils_tpu_torch.ops.kernels import _build

_DECL = re.compile(r'extern\s+"C"\s+(\w+)\s+(es_\w+)\s*\(([^)]*)\)')


def _declarations():
    """name -> (return type, [parameter declarations], source file)."""
    found = {}
    for source in _build.SOURCES:
        for ret, name, params in _DECL.findall(source.read_text()):
            assert name not in found, f"{name} declared twice"
            found[name] = (ret, [p.strip() for p in params.split(",")
                                 if p.strip()], source.name)
    return found


DECLARED = _declarations()


def _ctype(param):
    """The ctypes type a C parameter declaration is passed as."""
    decl = re.sub(r"\b(const|__restrict__)\b", " ", param)
    decl = re.sub(r"\s*\w+$", "", decl.strip())   # the parameter's name
    decl = decl.replace(" ", "")
    if decl == "int":
        return ctypes.c_int
    if decl == "int*":
        return ctypes.POINTER(ctypes.c_int)
    if decl == "double*":
        return ctypes.POINTER(ctypes.c_double)
    if decl == "void**":
        return ctypes.POINTER(ctypes.c_void_p)
    if decl.endswith("*"):
        return ctypes.c_void_p
    raise AssertionError(f"no ctypes type for parameter {param!r}")


def test_every_declared_entry_has_a_signature():
    assert sorted(DECLARED) == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_declaration(name):
    ret, params, source = DECLARED[name]
    assert ret == "int", f"{name} in {source} returns {ret}"
    assert [_ctype(p) for p in params] == list(_build.SIGNATURES[name]), \
        f"{name} in {source}: {params}"
