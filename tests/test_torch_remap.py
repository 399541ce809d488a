"""Run the JAX package's own test bodies against the port.

``PortRemap.collect(module, ...)`` rebinds the test functions of one of
the reference's test modules (``tests/test_distributed.py`` and the like;
the files themselves are not edited) so that every name they reach from
``minio_tpu`` resolves to the port's counterpart at the same relative
path: the module's globals, the helpers and classes it defines, and the
imports its bodies make at run time (``from minio_tpu.x import y`` inside a
test imports ``minio_tpu_torch.x``). Nothing else of a body changes.

The port's entry points run on the card unless the caller asks for the
CPU; ``CPU_DEFAULTS`` gives the few that a reference body calls without a
device (drives, erasure sets and objects, the object-layer builders, the
NAS gateway) ``device="cpu"`` (and ``backend="cpu"``) as their default,
as the port's CPU tests pass them by hand.

The cases in this file hold the remapping itself to that contract.
"""

from __future__ import annotations

import builtins
import functools
import importlib
import inspect
import types

import pytest

REF, PORT = "minio_tpu", "minio_tpu_torch"

# Port callables whose default device is the card, given the CPU here:
# (module, name) -> keyword defaults.
CPU_DEFAULTS = {
    ("storage.xl", "XLStorage"): {"device": "cpu"},
    ("erasure.engine", "ErasureObjects"): {"backend": "cpu", "device": "cpu"},
    ("erasure.sets", "ErasureSets"): {"backend": "cpu", "device": "cpu"},
    ("fs.backend", "FSObjects"): {"device": "cpu"},
    ("gateway.nas", "NASGateway"): {"device": "cpu"},
    ("gateway", "NASGateway"): {"device": "cpu"},
    ("rpc.cluster", "build_cluster_node"): {"device": "cpu"},
    ("__main__", "build_object_layer"): {"device": "cpu"},
}


def is_ref(name: str) -> bool:
    return name == REF or name.startswith(REF + ".")


def port_name(name: str) -> str:
    return PORT + name[len(REF):]


def _with_defaults(obj, defaults: dict):
    """``obj`` (a class or a function) with ``defaults`` for the keyword
    arguments the caller leaves out; a class stays a subclass, so
    ``isinstance`` still holds."""
    if inspect.isclass(obj):
        def __init__(self, *a, **kw):
            obj.__init__(self, *a, **{**defaults, **kw})
        return type(obj.__name__, (obj,), {"__init__": __init__,
                                          "__module__": obj.__module__,
                                          "__qualname__": obj.__qualname__})

    @functools.wraps(obj)
    def call(*a, **kw):
        return obj(*a, **{**defaults, **kw})
    return call


class _PortModule(types.ModuleType):
    """A port module as the reference's bodies see it: the module itself,
    with the CPU defaults of ``CPU_DEFAULTS`` laid over its names."""

    def __init__(self, real: types.ModuleType, over: dict):
        super().__init__(real.__name__, real.__doc__)
        self.__dict__.update(over)
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)


class PortRemap:
    def __init__(self):
        self._modules: dict[str, types.ModuleType] = {}
        self._builtins = dict(vars(builtins), __import__=self._import)

    def module(self, ref_name: str) -> types.ModuleType:
        """The port's counterpart of the reference module ``ref_name``."""
        name = port_name(ref_name)
        if name not in self._modules:
            real = importlib.import_module(name)
            rel = name[len(PORT) + 1:]
            over = {attr: _with_defaults(getattr(real, attr), kw)
                    for (mod, attr), kw in CPU_DEFAULTS.items()
                    if mod == rel and hasattr(real, attr)}
            self._modules[name] = _PortModule(real, over)
        return self._modules[name]

    def _import(self, name, globals=None, locals=None, fromlist=(),
                level=0):
        if level == 0 and is_ref(name):
            mod = self.module(name)
            return mod if fromlist else self.module(REF)
        return builtins.__import__(name, globals, locals, fromlist, level)

    def value(self, v, name: str):
        """A global of a reference test module, remapped to the port."""
        if isinstance(v, types.ModuleType):
            return self.module(v.__name__) if is_ref(v.__name__) else v
        owner = getattr(v, "__module__", None)
        if inspect.isclass(v) or inspect.isfunction(v):
            if owner and is_ref(owner):
                return getattr(self.module(owner), v.__name__)
            return v
        owner = type(v).__module__
        if is_ref(owner):
            # A singleton imported by name (``from ... import USAGE``).
            return getattr(self.module(owner), name)
        return v

    def namespace(self, ref_mod: types.ModuleType) -> dict:
        """The reference test module's globals, every name remapped and
        every function and class it defines rebound to the new globals."""
        g: dict = {}
        for name, v in vars(ref_mod).items():
            g[name] = self.value(v, name)
        g["__builtins__"] = self._builtins
        for name, v in list(g.items()):
            if inspect.isfunction(v) and v.__module__ == ref_mod.__name__:
                g[name] = self.rebind(v, g)
            elif inspect.isclass(v) and v.__module__ == ref_mod.__name__:
                g[name] = self._rebind_class(v, g)
        return g

    @staticmethod
    def rebind(fn, g: dict):
        new = types.FunctionType(fn.__code__, g, fn.__name__,
                                 fn.__defaults__, fn.__closure__)
        new.__kwdefaults__ = fn.__kwdefaults__
        new.__dict__.update(fn.__dict__)
        new.__qualname__ = fn.__qualname__
        new.__doc__ = fn.__doc__
        return new

    def _rebind_class(self, cls, g: dict):
        body = {}
        for k, v in vars(cls).items():
            if k in ("__dict__", "__weakref__"):
                continue
            if inspect.isfunction(v):
                v = self.rebind(v, g)
            elif isinstance(v, (staticmethod, classmethod)) and \
                    inspect.isfunction(v.__func__):
                v = type(v)(self.rebind(v.__func__, g))
            body[k] = v
        bases = tuple(self.value(b, b.__name__) for b in cls.__bases__)
        return type(cls.__name__, bases, body)

    def collect(self, ref_mod: types.ModuleType, tag: str, into: dict,
                skip: dict | None = None, fixtures: bool = False) -> dict:
        """Bind the reference module's ``test_*`` functions into ``into``
        (a test module's globals) as ``test_<tag>__<name>``; ``skip`` names
        the bodies left out, each with the reason. With ``fixtures``, the
        module's own fixtures come along too, rebound as its tests are.
        Returns the namespace."""
        g = self.namespace(ref_mod)
        skip = skip or {}
        for name, v in g.items():
            if name.startswith("test_") and inspect.isfunction(v) and \
                    name not in skip:
                into[f"test_{tag}__{name[5:]}"] = v
            marker = getattr(v, "_fixture_function_marker", None)
            if fixtures and marker is not None:
                fn = self.rebind(v._get_wrapped_function(), g)
                into[name] = g[name] = pytest.fixture(
                    fn, scope=marker.scope, params=marker.params,
                    autouse=marker.autouse, ids=marker.ids,
                    name=marker.name)
        return g


def test_remap_resolves_every_reference_name_to_the_port():
    import test_distributed as ref
    g = PortRemap().namespace(ref)
    assert g["S3Server"].__module__ == "minio_tpu_torch.s3.server"
    assert g["RPCRegistry"].__module__ == "minio_tpu_torch.rpc.transport"
    assert g["_start_cluster"].__globals__ is g
    # A body's own imports resolve to the port at run time.
    src = ("def f():\n"
           "    from minio_tpu.rpc.cluster import derive_cluster_key\n"
           "    import minio_tpu.rpc.peer as peer\n"
           "    return derive_cluster_key, peer\n")
    ns: dict = {}
    exec(compile(src, "<probe>", "exec"), ns)
    probe = PortRemap.rebind(ns["f"], g)
    dck, peer = probe()
    assert dck.__module__ == "minio_tpu_torch.rpc.cluster"
    assert peer.__name__ == "minio_tpu_torch.rpc.peer"


def test_remap_gives_card_defaults_the_cpu(tmp_path):
    rm = PortRemap()
    xl = rm.module("minio_tpu.storage.xl").XLStorage(str(tmp_path / "d"))
    from minio_tpu_torch.storage.xl import XLStorage
    assert isinstance(xl, XLStorage) and xl.device == "cpu"
    nas = rm.module("minio_tpu.gateway").NASGateway(str(tmp_path / "n"))
    assert nas.device == "cpu"
    # Outside the remapped bodies the port keeps the card as its default.
    assert XLStorage(str(tmp_path / "e")).device == "cuda"
