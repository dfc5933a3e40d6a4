"""The port's launch table against the C entry points it binds.

``kernels/_build.py`` declares each entry point's ctypes argument types in
``SIGNATURES``; the sources under ``csrc/`` declare the same functions
``extern "C"``.  Nothing on the CPU calls them, and on the card a wrong
entry passes a cut pointer or a misread integer without an error, so the
two are held against each other here, by name, arity and type: ``int`` is
``c_int``, any pointer ``c_void_p``, ``long long`` ``c_longlong`` and
``float`` ``c_float``.  The launch plumbing (the table bound once at load,
the lock taken only for the first load, the caller's stream passed on) is
held with a stand-in library.
"""
import ctypes
import re

import pytest
import torch

from repro_torch.kernels import _build, ops
from _torch_threads import one_intra_op_thread  # noqa: F401

_DECL = re.compile(r'extern\s+"C"\s+([\w\s*]+?)\s*\b(ishmem_\w+)\s*\(([^)]*)\)')
_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _ctype(param: str):
    """The ctypes type of one C parameter declaration, e.g. ``const int*
    table`` or ``long long n``."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    return _SCALARS[decl.rsplit(" ", 1)[0]]


def _exports() -> dict:
    """name -> (return type, [ctypes parameter types]) of every ``extern
    "C"`` function in ``csrc/*.cu``."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in _DECL.findall(path.read_text()):
            assert name not in found, f"{name} declared twice"
            found[name] = (" ".join(ret.split()),
                           [_ctype(p) for p in params.split(",") if p.strip()])
    return found


@pytest.mark.parametrize("entry", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_declaration(entry):
    exports = _exports()
    assert entry in exports, f'{entry} has no extern "C" declaration'
    ret, params = exports[entry]
    assert ret == "int"                         # a cudaError_t code
    assert _build.SIGNATURES[entry] == params


def test_every_export_is_in_the_table():
    assert set(_exports()) - set(_build.SIGNATURES) == \
        {"ishmem_error_string"}


class _FakeEntry:
    """A C entry point stand-in: records each call, returns ``rc``."""

    def __init__(self):
        self.calls, self.rc = [], 0

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _FakeLibrary:
    loads = 0

    def __init__(self, path):
        type(self).loads += 1
        self.ishmem_error_string = lambda code: b"stand-in error"

    def __getattr__(self, name):
        fn = _FakeEntry()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_library(monkeypatch):
    """``_build`` as before its first load, with a stand-in library and a
    stand-in stream query (this machine's PyTorch may have no CUDA)."""
    _FakeLibrary.loads = 0
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "ENTRIES", {})
    monkeypatch.setattr(_build, "build", lambda: "stand-in.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLibrary)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 1000 + device, raising=False)
    saved = dict(ops.LAUNCHES)
    yield
    ops.LAUNCHES.update(saved)


def test_load_binds_every_entry_once(fake_library):
    table = _build.entries()
    assert set(table) == set(_build.SIGNATURES)
    for name, fn in table.items():
        assert fn.argtypes == _build.SIGNATURES[name]
        assert fn.restype is ctypes.c_int
    assert _build.entries() is table and _build.lib() is _build.lib()
    assert _FakeLibrary.loads == 1


def test_loaded_library_takes_no_lock(fake_library, monkeypatch):
    handle = _build.lib()

    class NoLock:
        def __enter__(self):
            raise AssertionError("the lock was taken after the first load")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "_lock", NoLock())
    assert _build.lib() is handle
    assert set(_build.entries()) == set(_build.SIGNATURES)


def test_launch_passes_device_args_and_stream(fake_library):
    """``ops.launch`` calls the bound entry with the device ordinal, the
    wrapper's arguments and that device's current stream, counts the
    launch, and raises with the CUDA error string on a nonzero code
    without counting it."""
    fn = _build.entries()["ishmem_copy_into"]
    before = ops.LAUNCHES["copy_into"]
    ops.launch("copy_into", "ishmem_copy_into", 3, 11, 22, 33)
    assert fn.calls == [(3, 11, 22, 33, 1003)]
    assert ops.LAUNCHES["copy_into"] == before + 1
    fn.rc = 700
    with pytest.raises(RuntimeError, match=r"copy_into: CUDA error 700 "
                       r"\(stand-in error\)"):
        ops.launch("copy_into", "ishmem_copy_into", 0, 1, 2, 3)
    assert ops.LAUNCHES["copy_into"] == before + 1
