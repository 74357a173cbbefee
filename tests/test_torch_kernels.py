"""The kernel loader's manifest (``gaussianhaircut_torch/kernels.py:
ENTRY_POINTS``) against the C signatures in ``csrc/*.cu``.  ctypes passes
what the manifest declares, whatever the C function takes, so a mismatch
would show only on the card, as garbage or a crash; here it fails on the
CPU.  Each entry point's ``extern "C" int <name>(...)`` is found in its
declared source, and its parameters are held to the declared ctypes, one
by one: a pointer (``T*``, ``void*``, ``const TailTable*``) for
``c_void_p``, ``int`` for ``c_int``, ``float`` for ``c_float``; a
launcher's last parameter is the stream.  And every ``extern "C" int`` of
the sources is in the manifest.  Then the loader's checks, which every
wrapper makes before a pointer goes to C: ``check_arg`` refuses each fault
with one message, and ``check_layout`` asks a library once and names the
constant that differs."""
import ctypes
import os
import re

import pytest
import torch

from gaussianhaircut_torch import kernels

CSRC = os.path.join(os.path.dirname(os.path.abspath(kernels.__file__)), "csrc")
_DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _declarations(source: str) -> dict[str, list[str]]:
    """{name: [parameter declaration]} of every ``extern "C" int`` of
    ``source`` (a file name under csrc/)."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    return {m[1]: [" ".join(p.split()) for p in m[2].split(",")] for m in _DECL.finditer(text)}


def _kind(param: str):
    """The ctypes type a C parameter declaration is passed as, or None."""
    if "*" in param:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}.get(param.rsplit(" ", 1)[0])


@pytest.mark.parametrize("entry", list(kernels.ENTRY_POINTS))
def test_entry_point_matches_its_c_signature(entry):
    e = kernels.ENTRY_POINTS[entry]
    decls = _declarations(kernels.SOURCES[e.library])
    assert entry in decls, f'no extern "C" int {entry}( in csrc/{kernels.SOURCES[e.library]}'
    params = decls[entry]
    if e.launcher:
        assert params[-1] == "void* stream", f"{entry}: the stream is not last: {params}"
        params = params[:-1]
    assert [_kind(p) for p in params] == list(e.argtypes), (
        f"{entry}: C parameters {params}, manifest "
        f"{[t.__name__ for t in e.argtypes]}")


def test_every_c_entry_point_is_in_the_manifest():
    declared = {(lib, name) for lib, src in kernels.SOURCES.items()
                for name in _declarations(src)}
    listed = {(e.library, name) for name, e in kernels.ENTRY_POINTS.items()}
    assert declared == listed
    assert sorted(f for f in os.listdir(CSRC) if f.endswith(".cu")) == sorted(
        kernels.SOURCES.values())


CPU = torch.device("cpu")
ARG_FAULTS = {
    # name: (tensor, check_arg's arguments after it, what the message must say)
    "dtype": (torch.zeros(2, 3, dtype=torch.float64), (torch.float32, (2, 3), CPU),
              r"x is torch.float64 \(2, 3\) on cpu; expected a contiguous torch.float32"),
    "shape": (torch.zeros(3, 2), (torch.float32, (2, 3), CPU), r"expected .* of shape \(2, 3\)"),
    "device": (torch.zeros(2, 3, device="meta"), (torch.float32, (2, 3), CPU),
               r"on meta; expected .* on cpu"),
    "not_cuda": (torch.zeros(2, 3), (torch.float32, (2, 3)), r"on a CUDA device"),
    "contiguity": (torch.zeros(3, 2).t(), (torch.float32, (2, 3), CPU),
                   r"on cpu, not contiguous; expected a contiguous"),
    "one_element": (torch.zeros(2), (torch.float32, kernels.ONE, CPU), r"of one element"),
}


@pytest.mark.parametrize("fault", list(ARG_FAULTS))
def test_check_arg_refuses_each_fault(fault):
    t, args, msg = ARG_FAULTS[fault]
    with pytest.raises(ValueError, match=msg):
        kernels.check_arg("x", t, *args)


def test_check_arg_passes_what_the_kernels_take():
    t = torch.zeros(3, 2).t()
    assert kernels.check_arg("x", t, torch.float32, (2, 3), CPU, contiguous=False) is t
    one = torch.zeros(1, 1)
    assert kernels.check_arg("x", one, torch.float32, kernels.ONE, CPU) is one
    assert kernels.check_arg("x", t.contiguous(), torch.float32, None, CPU) is not None


def test_check_layout_asks_once_and_names_what_differs(monkeypatch):
    """The library's constants against the wrapper's: asked once per
    process, a mismatch raises naming the constant that differs."""
    asked = []

    def query(entry, out):
        asked.append(entry)
        out[:] = [4096, 128]
        return 0

    monkeypatch.setattr(kernels, "query", query)
    monkeypatch.setattr(kernels, "_layouts_checked", set())
    with pytest.raises(RuntimeError, match=r"optim_tail\.cu's layout \(4096, 128\) is not the "
                                           r"wrapper's \(4096, 256\) .*: threads differ"):
        kernels.check_layout("optim_tail", {"chunk": 4096, "threads": 256})
    kernels.check_layout("optim_tail", {"chunk": 4096, "threads": 128})
    kernels.check_layout("optim_tail", {"chunk": 4096, "threads": 128})
    assert asked == ["optim_tail_layout"] * 2


def test_launch_and_query_keep_to_their_kind():
    with pytest.raises(ValueError, match="query, not a launcher"):
        kernels.launch("precompute_layout", None)
    with pytest.raises(ValueError, match="launcher, not a query"):
        kernels.query("raster_fwd")
