"""Run the JAX package's own test bodies against the port.

``PortRemap.collect(module, ...)`` rebinds the test functions of one of
the reference's test modules (``tests/test_distributed.py`` and the like;
the files themselves are not edited) so that every name they reach from
``minio_tpu`` resolves to the port's counterpart at the same relative
path: the module's globals, the helpers and classes it defines, and the
imports its bodies make at run time (``from minio_tpu.x import y`` inside a
test imports ``minio_tpu_torch.x``, ``from tools.loadgen import run_load``
the port's load generator). Nothing else of a body changes.

The port's entry points run on the card unless the caller asks for the
CPU; ``CPU_DEFAULTS`` gives the few that a reference body calls without a
device (drives, erasure sets and objects, the object-layer builders, the
gateways, the kernels' host entry points) ``device="cpu"`` (and
``backend="cpu"``) as their default, as the port's CPU tests pass them by
hand; a group file lays its own over them (``AUTO_CPU``). A body's
``python -m minio_tpu`` starts the port's CLI, on the CPU.

The cases in this file hold the remapping itself to that contract.
"""

from __future__ import annotations

import builtins
import contextlib
import functools
import importlib
import inspect
import os
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

REF, PORT = "minio_tpu", "minio_tpu_torch"

# The kernel modules the port renamed: reference name -> port name, both
# relative to the package.
ALIASES = {
    "ops.rs_tpu": "ops.rs_gpu",
    "ops.rs_pallas": "ops.rs_gpu",
    "ops.hh256_tpu": "ops.hh256_gpu",
}

# Modules of the JAX system outside the package that the port carries too:
# reference name -> port name.
TOOLS = {"tools.loadgen": f"{PORT}.tools.loadgen"}

# Port callables whose default device is the card, given the CPU here:
# (module, name) -> keyword defaults.
CPU_DEFAULTS = {
    ("storage.xl", "XLStorage"): {"device": "cpu"},
    ("erasure.engine", "ErasureObjects"): {"backend": "cpu", "device": "cpu"},
    ("erasure.sets", "ErasureSets"): {"backend": "cpu", "device": "cpu"},
    ("fs.backend", "FSObjects"): {"device": "cpu"},
    **{(mod, gw): {"device": "cpu"}
       for mod, names in (("gateway", ("NASGateway", "S3Gateway",
                                       "AzureGateway", "GCSGateway",
                                       "HDFSGateway")),
                          ("gateway.nas", ("NASGateway",)),
                          ("gateway.s3", ("S3Gateway",)),
                          ("gateway.cloud", ("AzureGateway", "GCSGateway",
                                             "HDFSGateway")))
       for gw in names},
    ("rpc.cluster", "build_cluster_node"): {"device": "cpu"},
    ("__main__", "build_object_layer"): {"device": "cpu"},
    ("ops.rs_gpu", "encode_batch"): {"device": "cpu"},
    ("ops.rs_gpu", "reconstruct_batch"): {"device": "cpu"},
    ("s3select.select", "run_select"): {"device": "cpu"},
    **{("erasure.bitrot", fn): {"device": "cpu"} for fn in (
        "digest", "digest_rows", "digest_chunks", "digest_chunks_many",
        "encode_stream_arrays", "frame_shard", "encode_stream",
        "encode_streams", "verify_frames", "extract_block",
        "decode_stream_at", "verify_stream")},
}


# A group's defaults for suites that boot servers and PUT whole objects:
# engines and drives under "auto" on the CPU, so frames hash on the native
# lane as the reference's do, not through K2's plain version.
AUTO_CPU = {
    ("storage.xl", "XLStorage"): {"device": "auto"},
    ("erasure.engine", "ErasureObjects"): {"backend": "auto",
                                           "device": "cpu"},
    ("erasure.sets", "ErasureSets"): {"backend": "auto", "device": "cpu"},
}


@contextlib.contextmanager
def cpu_plane(n_devices: int = 1):
    """The port's dispatch plane for a module of remapped bodies: no probe
    ladder on boot, the kernel lane on ``n_devices`` virtual CPU devices
    (the reference's suites run on the 8 virtual XLA devices of
    tests/conftest.py); afterwards the card again, with a fresh planner,
    lane health, fault plan and mesh census."""
    from minio_tpu_torch.faultinject import FAULTS
    from minio_tpu_torch.obs.kernprof import KERNPROF
    from minio_tpu_torch.ops import batching
    from minio_tpu_torch.ops.autotune import AUTOTUNE
    from minio_tpu_torch.parallel.mesh import MESH_AFFINITY
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_CODEC_PROBE_ON_BOOT", "off")
        mp.setattr(batching, "device_list",
                   lambda: [torch.device("cpu")] * n_devices)
        batching.set_dispatch_device("cpu")
        try:
            yield mp
        finally:
            batching.set_dispatch_device("cuda")
            AUTOTUNE.reset()
            KERNPROF.reset()
            FAULTS.clear()
            MESH_AFFINITY.reset()


def stop_rpc_loop() -> None:
    """Stop the port's process-wide RPC loop (started by the first
    internode call), join its thread and take it off the loop monitor
    (whose watcher and profiler then stop if no server holds it); the next
    call starts a fresh loop."""
    from minio_tpu_torch.obs.loopmon import LOOPMON
    from minio_tpu_torch.rpc.aio import RPC_LOOP
    with RPC_LOOP._mu:
        loop, thread = RPC_LOOP._loop, RPC_LOOP._thread
        RPC_LOOP._loop = RPC_LOOP._thread = None
    if loop is None:
        return
    LOOPMON.unregister("rpc", wait_s=0.5)
    if not loop.is_closed():
        loop.call_soon_threadsafe(loop.stop)
    thread.join(5.0)
    if not thread.is_alive():
        loop.close()


# The port's background threads that must end with the module that started
# them (thread names; the reference's threads have the same ones).
CENSUS_THREADS = ("timeline-sampler", "loopmon-watcher", "loopmon-profiler",
                  "alert-webhook", "mtpu-rpc-loop", "kernprof-probe")


class ModuleLife:
    """The life of each remapped reference module inside a group file.

    pytest keeps a module-scoped fixture up until the file that holds it
    ends, and a group file holds several reference modules: their servers
    would all stay up, each with its timeline sampler and its loops under
    the loop monitor, while the later modules' bodies run. So ``collect``
    gives each module-scoped fixture of a reference module the life of
    that module's cases (``fixture``), as in the reference's own run.

    ``enter(name)`` runs before every case of the file (an autouse
    fixture). At a case of another module it ends the previous one
    (``end``): its fixtures close in reverse order, the RPC loop is stopped
    if the module started it, and the webhook workers its bodies left are
    closed; then ``census[tag]`` lists what outlived it: a thread of
    ``CENSUS_THREADS`` the module started, a running timeline sampler, a
    loop the module registered with the loop monitor. A module starts with
    the loop monitor's stall ring empty, so no stall of another module's
    loops reaches its watchdog rules.
    """

    WAIT_S = 5.0

    def __init__(self):
        self.tags: set[str] = set()
        self.census: dict[str, list[str]] = {}
        self.tag: str | None = None
        self._values: dict[str, object] = {}
        self._open: list[tuple[str, types.GeneratorType]] = []
        self._threads: set = set()
        self._loops: set = set()
        self._rpc_thread = None

    def enter(self, name: str) -> None:
        head = name[5:].split("__", 1)[0] if "__" in name else None
        tag = head if head in self.tags else None
        if tag == self.tag:
            return
        self.end()
        if tag is None:
            return
        from minio_tpu_torch.obs.loopmon import LOOPMON
        from minio_tpu_torch.rpc.aio import RPC_LOOP
        self.tag = tag
        self._threads = {t for t in threading.enumerate()
                         if t.name.startswith(CENSUS_THREADS)}
        with LOOPMON._mu:
            self._loops = set(LOOPMON._loops)
            LOOPMON._stall_ring.clear()
        self._rpc_thread = RPC_LOOP._thread

    def fixture(self, tag: str, name: str, make):
        """The value of fixture ``name`` of module ``tag``, made by
        ``make()`` (a generator or a value) at its first use and cached
        until the module ends."""
        if self.tag != tag:
            self.enter(f"test_{tag}__")
        if name not in self._values:
            made = make()
            if inspect.isgenerator(made):
                self._open.append((name, made))
                made = next(made)
            self._values[name] = made
        return self._values[name]

    def end(self) -> None:
        if self.tag is None:
            return
        from minio_tpu_torch.obs.loopmon import LOOPMON
        from minio_tpu_torch.obs.timeline import TIMELINE
        from minio_tpu_torch.obs.watchdog import AlertWebhook
        from minio_tpu_torch.rpc.aio import RPC_LOOP
        problems = []
        while self._open:
            name, gen = self._open.pop()
            try:
                next(gen)
            except StopIteration:
                pass
            except Exception as e:  # noqa: BLE001 - listed in the census
                problems.append(f"fixture {name} failed closing: {e!r}")
            else:
                problems.append(f"fixture {name} yielded twice")
        self._values.clear()
        if RPC_LOOP._thread not in (None, self._rpc_thread):
            stop_rpc_loop()
        for t in threading.enumerate():
            owner = getattr(getattr(t, "_target", None), "__self__", None)
            if t not in self._threads and isinstance(owner, AlertWebhook):
                owner.close()
        deadline = time.monotonic() + self.WAIT_S
        while True:
            left = [t.name for t in threading.enumerate()
                    if t.name.startswith(CENSUS_THREADS)
                    and t not in self._threads]
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        problems += [f"thread {n} still alive" for n in left]
        if TIMELINE.active:
            problems.append("the timeline sampler still runs")
        with LOOPMON._mu:
            loops = set(LOOPMON._loops) - self._loops
        problems += [f"loop {n} still registered" for n in sorted(loops)]
        self.census[self.tag] = problems
        self.tag = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()


# Why a remapped body is left out (``collect(..., skip=)``): the deliberate
# divergences of ROADMAP §C, by their ids there, and C3.
DIVERGENCES = {
    "C3": "the remapped modules boot with the probe ladder off "
          "(MINIO_CODEC_PROBE_ON_BOOT=off), as every port test that boots "
          "a server does",
    "D1": "on a card a failed kernel dispatch raises to its caller, so "
          "kernprof always allows the card lane (it is never DOWN)",
    "D12": "the CPU kernel lane is torch-cpu (the kernels' plain "
           "versions); XLA's xla-cpu lane cannot exist without JAX",
    "D13": "a placed batch is a PlacedBatch of per-device tensors; "
           "jax.Array's .sharding and addressable shards cannot exist "
           "without JAX",
    "D14": "a kernel wrapper takes a torch tensor and runs where it lies; "
           "a numpy array names no device",
}


def collected(into: dict, tag: str) -> list[str]:
    return [n for n in into if n.startswith(f"test_{tag}__")]


def reference_cases(ref_mod: types.ModuleType) -> list[str]:
    """The reference module's test functions and ``Class.method`` cases."""
    out = []
    for name, v in vars(ref_mod).items():
        if name.startswith("test_") and inspect.isfunction(v):
            out.append(name)
        elif name.startswith("Test") and inspect.isclass(v) and \
                v.__module__ == ref_mod.__name__:
            out += [f"{name}.{m}" for m in dir(v) if m.startswith("test_")]
    return out


def is_ref(name: str) -> bool:
    return name == REF or name.startswith(REF + ".")


def is_port(name: str) -> bool:
    return name == PORT or name.startswith(PORT + ".")


def port_name(name: str) -> str:
    rel = name[len(REF) + 1:]
    return PORT + name[len(REF):] if rel not in ALIASES else \
        f"{PORT}.{ALIASES[rel]}"


def _with_defaults(obj, defaults: dict):
    """``obj`` (a class or a function) with ``defaults`` for the keyword
    arguments the caller leaves out; a class becomes a subclass that every
    instance of ``obj`` is an instance of, so ``isinstance`` holds both
    ways."""
    if inspect.isclass(obj):
        class Meta(type(obj)):
            def __instancecheck__(cls, inst):
                return isinstance(inst, obj)

            def __subclasscheck__(cls, sub):
                return issubclass(sub, obj)

        def __init__(self, *a, **kw):
            obj.__init__(self, *a, **{**defaults, **kw})
        return Meta(obj.__name__, (obj,), {"__init__": __init__,
                                          "__module__": obj.__module__,
                                          "__qualname__": obj.__qualname__})

    @functools.wraps(obj)
    def call(*a, **kw):
        return obj(*a, **{**defaults, **kw})
    return call


class _PortModule(types.ModuleType):
    """A port module as the reference's bodies see it: the module itself,
    with the CPU defaults of ``CPU_DEFAULTS`` laid over its names."""

    def __init__(self, real: types.ModuleType, over: dict, remap):
        super().__init__(real.__name__, real.__doc__)
        self.__dict__.update(over)
        self.__dict__["_real"] = real
        self.__dict__["_over"] = frozenset(over)
        self.__dict__["_remap"] = remap

    def __getattr__(self, name):
        v = getattr(self._real, name)
        if isinstance(v, types.ModuleType) and is_port(v.__name__):
            return self._remap.module(REF + v.__name__[len(PORT):])
        return v

    # A body's ``monkeypatch.setattr(module, name, ...)`` must reach the
    # port's own code, so it lands on the real module (a name of
    # ``CPU_DEFAULTS`` stays on this view: the port never calls the view).
    def __setattr__(self, name, value):
        if name in self._over or name.startswith("__"):
            self.__dict__[name] = value
        else:
            setattr(self._real, name, value)


def _case(fn, rename: dict, uses: list, cls: type | None = None):
    """``fn`` as pytest sees it, with the fixture parameters named in
    ``rename`` renamed and the fixtures ``uses`` requested too; with
    ``cls``, ``fn`` is a method of it, called on a fresh instance."""
    sig = inspect.signature(fn)
    params = list(sig.parameters.values())[1 if cls else 0:]
    back = {new: old for old, new in rename.items()}

    def args(kw):
        head = (cls(),) if cls else ()
        return head, {back.get(k, k): v for k, v in kw.items()}

    if inspect.isgeneratorfunction(fn):
        def case(**kw):
            head, kw = args(kw)
            yield from fn(*head, **kw)
    else:
        def case(**kw):
            head, kw = args(kw)
            return fn(*head, **kw)
    case.__name__, case.__qualname__ = fn.__name__, fn.__qualname__
    case.__doc__ = fn.__doc__
    case.__dict__.update(fn.__dict__)
    case.__signature__ = sig.replace(parameters=[
        p.replace(name=rename.get(p.name, p.name)) for p in params])
    if uses:
        case.pytestmark = list(getattr(fn, "pytestmark", [])) + \
            [pytest.mark.usefixtures(*uses)]
    return case


def _port_argv(args, kw: dict):
    """``[python, -m, minio_tpu, ...]`` -> the port's CLI, on the CPU."""
    args = list(args) if isinstance(args, (list, tuple)) else args
    if isinstance(args, list) and "-m" in args[:-1]:
        i = args.index("-m") + 1
        if isinstance(args[i], str) and is_ref(args[i]):
            args[i] = port_name(args[i])
            env = dict(kw.get("env") or os.environ)
            env.setdefault("MINIO_TORCH_DEVICE", "cpu")
            kw["env"] = env
    return args, kw


class _PortPopen(subprocess.Popen):
    def __init__(self, args, *a, **kw):
        args, kw = _port_argv(args, kw)
        super().__init__(args, *a, **kw)


class _PortSubprocess(types.ModuleType):
    """``subprocess`` as the reference's bodies see it: ``python -m
    minio_tpu ...`` starts the port's CLI (``minio_tpu_torch``) with
    ``MINIO_TORCH_DEVICE=cpu`` unless the caller's env names a device."""

    Popen = _PortPopen

    def __init__(self):
        super().__init__("subprocess", subprocess.__doc__)

    def __getattr__(self, name):
        return getattr(subprocess, name)


class PortRemap:
    """``defaults`` lays a group's own keyword defaults over
    ``CPU_DEFAULTS``, key by key (say ``"auto"`` engines on the CPU)."""

    def __init__(self, defaults: dict | None = None):
        self.defaults = {**CPU_DEFAULTS, **(defaults or {})}
        self._modules: dict[str, types.ModuleType] = {}
        self._namespaces: dict[str, dict] = {}
        self._builtins = dict(vars(builtins), __import__=self._import)
        self.life = ModuleLife()

    def module(self, ref_name: str) -> types.ModuleType:
        """The port's counterpart of the reference module ``ref_name``."""
        name = port_name(ref_name)
        if name not in self._modules:
            real = importlib.import_module(name)
            rel = name[len(PORT) + 1:]
            over = {attr: _with_defaults(getattr(real, attr), kw)
                    for (mod, attr), kw in self.defaults.items()
                    if mod == rel and hasattr(real, attr)}
            # ``from minio_tpu.ops import rs_tpu`` reaches the renamed one.
            for ref_rel in ALIASES:
                parent, _, attr = ref_rel.rpartition(".")
                if parent == rel:
                    over[attr] = self.module(f"{REF}.{ref_rel}")
            self._modules[name] = _PortModule(real, over, self)
        return self._modules[name]

    def _import(self, name, globals=None, locals=None, fromlist=(),
                level=0):
        if level == 0 and name in TOOLS and fromlist:
            # ``from tools.loadgen import run_load`` drives the port's.
            return importlib.import_module(TOOLS[name])
        if level == 0 and is_ref(name):
            mod = self.module(name)
            for sub in fromlist or ():
                # ``from minio_tpu.utils import snappy`` imports it.
                if sub != "*" and not hasattr(mod, sub):
                    mod.__dict__[sub] = self.module(f"{name}.{sub}")
            return mod if fromlist else self.module(REF)
        return builtins.__import__(name, globals, locals, fromlist, level)

    def value(self, v, name: str):
        """A global of a reference test module, remapped to the port."""
        if isinstance(v, types.ModuleType):
            if v is subprocess:
                return _PortSubprocess()
            return self.module(v.__name__) if is_ref(v.__name__) else v
        owner = getattr(v, "__module__", None)
        if inspect.isclass(v) or inspect.isfunction(v):
            if owner and is_ref(owner):
                return getattr(self.module(owner), v.__name__)
            if owner in TOOLS:
                return getattr(importlib.import_module(TOOLS[owner]),
                               v.__name__)
            if owner and owner.rpartition(".")[2].startswith("test_"):
                # A helper of another reference test module
                # (``from tests.test_engine import make_engine``); the
                # module's own names are rebound by ``namespace``.
                if owner not in self._namespaces:
                    self.namespace(sys.modules[owner])
                return self._namespaces[owner].get(v.__name__, v)
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
        self._namespaces[ref_mod.__name__] = g
        for name, v in vars(ref_mod).items():
            g[name] = self.value(v, name)
        g["__builtins__"] = self._builtins
        for name, v in list(g.items()):
            if inspect.isfunction(v) and v.__module__ == ref_mod.__name__:
                g[name] = self.rebind(v, g) \
                    if v.__globals__ is vars(ref_mod) else \
                    self._rebind_wrapper(v, g)
            elif inspect.isclass(v) and v.__module__ == ref_mod.__name__:
                g[name] = self._rebind_class(v, g)
        return g

    def _rebind_wrapper(self, fn, g: dict):
        """A decorator's wrapper of a module function (say
        ``contextlib.contextmanager``'s): the same wrapper around the
        rebound function."""
        inner = getattr(fn, "__wrapped__", None)
        if inner is None or not fn.__closure__:
            return fn
        new_inner = self.rebind(inner, g)
        cells = tuple(types.CellType(new_inner)
                      if c.cell_contents is inner else c
                      for c in fn.__closure__)
        new = PortRemap.rebind(fn, fn.__globals__, cells)
        new.__wrapped__ = new_inner
        return new

    @staticmethod
    def rebind(fn, g: dict, closure: tuple | None = None):
        new = types.FunctionType(fn.__code__, g, fn.__name__,
                                 fn.__defaults__, closure or fn.__closure__)
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
        new_cls = type(cls.__name__, bases, body)
        # Zero-argument ``super()`` reads the class from a ``__class__``
        # cell: point the rebound methods' cells at the new class.
        for k, v in body.items():
            fn = v.__func__ if isinstance(v, (staticmethod, classmethod)) \
                else v
            if inspect.isfunction(fn) and "__class__" in \
                    fn.__code__.co_freevars:
                i = fn.__code__.co_freevars.index("__class__")
                cells = list(fn.__closure__)
                cells[i] = types.CellType(new_cls)
                new_fn = PortRemap.rebind(fn, fn.__globals__, tuple(cells))
                setattr(new_cls, k, new_fn if fn is v else type(v)(new_fn))
        return new_cls

    def _module_scoped(self, fn, tag: str, name: str):
        """A module-scoped fixture of module ``tag`` as a function-scoped
        one whose value lives as long as that module's cases
        (``ModuleLife``)."""
        def fixture(**kw):
            return self.life.fixture(tag, name, lambda: fn(**kw))
        fixture.__name__ = fixture.__qualname__ = name
        fixture.__signature__ = fn.__signature__
        return fixture

    def collect(self, ref_mod: types.ModuleType, tag: str, into: dict,
                skip: dict | None = None, fixtures: bool = False,
                slow: dict | None = None) -> dict:
        """Bind the reference module's ``test_*`` functions into ``into``
        (a test module's globals) as ``test_<tag>__<name>``, and the
        ``test_*`` methods of its ``Test*`` classes as
        ``test_<tag>__<Class>__<name>``; ``skip`` names the bodies left out
        (``name`` or ``Class.name``), each with the reason, and ``slow``
        the ones marked ``slow`` (out of tier-1), each with why. With
        ``fixtures``, the module's own fixtures come along too, rebound as
        its tests are and named ``<tag>__<name>``, so that modules with
        fixtures of one name can share a file; an autouse fixture serves
        that module's cases only. Returns the namespace."""
        g = self.namespace(ref_mod)
        skip = skip or {}
        self.life.tags.add(tag)
        fx = {n: v for n, v in g.items()
              if getattr(v, "_fixture_function_marker", None) is not None}
        rename, uses = {}, []
        if fixtures:
            for name, v in fx.items():
                marker = v._fixture_function_marker
                rename[marker.name or name] = f"{tag}__{marker.name or name}"
                if marker.autouse:
                    uses.append(rename[marker.name or name])
            for name, v in fx.items():
                marker = v._fixture_function_marker
                fn = _case(self.rebind(v._get_wrapped_function(), g),
                           rename, [])
                new_name = rename[marker.name or name]
                scope = marker.scope
                if scope == "module":
                    fn, scope = self._module_scoped(fn, tag, new_name), \
                        "function"
                into[new_name] = pytest.fixture(
                    fn, scope=scope, params=marker.params,
                    ids=marker.ids, name=new_name)
        for name, v in g.items():
            if name.startswith("test_") and inspect.isfunction(v) and \
                    name not in skip:
                into[f"test_{tag}__{name[5:]}"] = _case(v, rename, uses)
            if name.startswith("Test") and inspect.isclass(v) and \
                    v.__module__ == ref_mod.__name__:
                for meth in dir(v):
                    if meth.startswith("test_") and \
                            f"{name}.{meth}" not in skip:
                        into[f"test_{tag}__{name}__{meth[5:]}"] = _case(
                            getattr(v, meth), rename, uses, cls=v)
        for name in slow or {}:
            case = f"test_{tag}__{name[5:]}"
            into[case] = pytest.mark.slow(into[case])
        return g


def test_remap_resolves_every_reference_name_to_the_port():
    import test_distributed as ref
    g = PortRemap().namespace(ref)
    assert g["S3Server"].__module__ == "minio_tpu_torch.s3.server"
    assert g["RPCRegistry"].__module__ == "minio_tpu_torch.rpc.transport"
    assert inspect.unwrap(g["_start_cluster"]).__globals__ is g
    # A body's own imports resolve to the port at run time.
    src = ("def f():\n"
           "    from minio_tpu.rpc.cluster import derive_cluster_key\n"
           "    import minio_tpu.rpc.peer as peer\n"
           "    from tools.loadgen import run_load\n"
           "    return derive_cluster_key, peer, run_load\n")
    ns: dict = {}
    exec(compile(src, "<probe>", "exec"), ns)
    probe = PortRemap.rebind(ns["f"], g)
    dck, peer, run_load = probe()
    assert dck.__module__ == "minio_tpu_torch.rpc.cluster"
    assert peer.__name__ == "minio_tpu_torch.rpc.peer"
    assert run_load.__module__ == "minio_tpu_torch.tools.loadgen"


def test_remap_gives_card_defaults_the_cpu(tmp_path):
    rm = PortRemap()
    xl = rm.module("minio_tpu.storage.xl").XLStorage(str(tmp_path / "d"))
    from minio_tpu_torch.storage.xl import XLStorage
    assert isinstance(xl, XLStorage) and xl.device == "cpu"
    nas = rm.module("minio_tpu.gateway").NASGateway(str(tmp_path / "n"))
    assert nas.device == "cpu"
    # Outside the remapped bodies the port keeps the card as its default.
    assert XLStorage(str(tmp_path / "e")).device == "cuda"
