"""One step of the port captured once as a CUDA graph and replayed: the
port's counterpart of the JAX package's jitted step and scanned rollout
(``jax.jit(jax.vmap(self._step_one))``, ``lax.scan`` over the decimation
loop and the rollout).

Eagerly, a nightmare_v3 env step launches ~6,300 kernels from Python and
the card waits on the host for most of it.  ``CapturedStep`` records the
kernels of one call of a step function into a ``torch.cuda.CUDAGraph``
and then replays them with one launch:

    step = CapturedStep(env.step, state, actions, generators=[env.generator],
                        state_field="state")
    out = step(state, actions)        # out.state is step.state
    out = step(out.state, next_actions)

The step function takes ``(state, *inputs)`` and returns the next state,
or a NamedTuple whose ``state_field`` holds it; the state and the inputs
are trees of tensors (dataclasses, NamedTuples, tuples, lists).  The
object owns static buffers for them: a call copies into them the leaves
that are not those buffers already, replays, and returns the step's
result with its state replaced by the state buffers, which the graph
updates at its end.  So a caller that passes back ``out.state`` copies
nothing, and one that writes a buffer with ``copy_`` (a checkpoint
restore) is read by the next replay.  The other outputs are the graph's
own tensors: the next replay overwrites them, and a caller that keeps one
across calls copies it out.

Capture, in the constructor on the card:

- one warm-up call of the step on clones of the state and the inputs, on
  the capture's side stream, so that lazy set-up (kernel builds, the PGS
  form's probe, cached index tensors, library handles and workspaces)
  happens outside the graph; the generators' states are saved before it
  and restored after it, so that the first replay draws what the first
  eager step would have drawn;
- every generator that the step draws from is registered with the graph
  (``CUDAGraph.register_generator_state``): a replay then advances it as
  an eager step does;
- inside ``utils/device.full_float32`` (a graph fixes the math mode of
  every product at capture) and with ``torch.cuda.set_sync_debug_mode``
  at "error": a host synchronization, or an operation that capture
  refuses, raises naming the line of the port that made it.  There is no
  eager fallback;
- the kernel wrappers' launch counters (``ops/pgs.py``, ``ops/newton.py``)
  count the launches the graph holds once per replay, not at capture.

Environment variables that a step reads (``NIGHTMARE_PGS``,
``NIGHTMARE_NO_WARMSTART``) are read at capture: the graph keeps the form
it was captured with.

On CPU tensors there is no graph: a call runs the step eagerly on the same
buffers, which is how the CPU tests exercise this module.

``CapturedUpdate`` captures a call that writes tensors in place rather than
returning a next state: a PPO minibatch step, which moves an ``nn.Module``'s
parameters and gradients, Adam's moments and step count and the learning
rate (the body of the JAX update's ``lax.scan``, which carries ``(params,
opt_state, lr)``; ``rl/ppo.py::CapturedLearn`` replays a minibatch step's
two parts per minibatch after the prologue's three, the reductions over
the ranks between them).  Its warm-up cannot run on clones of a module's
parameters, so it saves those tensors (``held``), runs the call, and writes
them back with ``copy_``: it moves nothing.  The tensors keep their storage
for the life of the graph, which reads and writes them at their addresses
on every replay.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch

from nightmare_rl_tpu_torch.ops import pgs as P
from nightmare_rl_tpu_torch.ops.newton import newton_solve
from nightmare_rl_tpu_torch.utils.device import full_float32

# the kernel wrappers whose ``launches`` attribute counts their launches
_COUNTED = (P.pgs, P.pgs_legs, newton_solve)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dataclasses, NamedTuples, tuples and lists,
    in a fixed order (other values are not leaves)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        children = tree
    else:
        return []
    return [x for c in children for x in leaves(c)]


def rebuild(tree, new: Sequence[torch.Tensor]):
    """``tree`` with its leaves replaced, in ``leaves`` order, by ``new``."""
    it = iter(new)

    def go(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{f.name: go(getattr(t, f.name))
                                             for f in dataclasses.fields(t)})
        if isinstance(t, tuple) and hasattr(t, "_fields"):  # NamedTuple
            return type(t)(*[go(c) for c in t])
        if isinstance(t, (tuple, list)):
            return type(t)(go(c) for c in t)
        return t

    return go(tree)


def clone(tree):
    """``tree`` with every tensor cloned (contiguous, fresh memory)."""
    return rebuild(tree, [x.clone(memory_format=torch.contiguous_format)
                          for x in leaves(tree)])


def assign(dst, src):
    """Write the leaves of ``src`` into those of ``dst`` with ``copy_`` and
    return ``dst``, so that buffers a captured step reads stay the ones it
    reads; where ``dst`` is None, its leaves differ in number, shape or
    dtype, or two of them share memory, return ``src`` itself."""
    if dst is None:
        return src
    d, s = leaves(dst), leaves(src)
    if (len(d) != len(s) or any(a.shape != b.shape or a.dtype != b.dtype
                                for a, b in zip(d, s))
            or len({a.untyped_storage().data_ptr() for a in d}) != len(d)):
        return src
    for a, b in zip(d, s):
        if a is not b:
            a.copy_(b)
    return dst


def _where(err: BaseException) -> str:
    """The innermost line of the port in an exception's traceback."""
    frames = traceback.extract_tb(err.__traceback__)
    ours = [f for f in frames if "nightmare_rl_tpu_torch" in f.filename
            and not f.filename.endswith("utils/graph.py")]
    f = (ours or frames)[-1] if frames else None
    return "?" if f is None else f"{f.filename}:{f.lineno} ({f.line})"


def _load(static: List[torch.Tensor], given: List[torch.Tensor]) -> None:
    """Copy into the static buffers each given leaf that is not one."""
    if len(given) != len(static):
        raise ValueError(f"the step was captured with {len(static)} "
                         f"tensors in its state and inputs, not {len(given)}")
    for dst, src in zip(static, given):
        if src is dst:
            continue
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(
                f"a captured step's buffer is {tuple(dst.shape)} "
                f"{dst.dtype}, the call gives {tuple(src.shape)} "
                f"{src.dtype}: capture a new step for a new shape")
        dst.copy_(src)


class _Captured:
    """What both captures share: the warm-up on the capture's side stream,
    the generators registered, the capture under the sync check, the
    launch counters and the pool.  A subclass gives ``fn``, ``_run`` (the
    call that the graph records; eager on the CPU) and ``_warm`` (the
    warm-up calls)."""

    WARMUP = 1  # eager calls before capture

    def _init_graph(self, device: torch.device,
                    generators: Sequence[Optional[torch.Generator]],
                    debug: bool = False) -> None:
        self.device = device
        self.debug = debug
        self.launches: Dict[str, int] = {}
        self.pool_bytes = 0
        self.warmup_s = self.capture_s = self.record_s = 0.0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._result = None
        if device.type == "cuda":
            with torch.cuda.device(device):
                self._capture([g for g in generators if g is not None])

    def __call__(self, *args):
        """Copy the given state and inputs into the buffers, then replay
        the graph (run the call eagerly on the CPU)."""
        _load(self._static, leaves(args))
        return self._run() if self.graph is None else self._replay()

    def _replay(self):
        self.graph.replay()
        for fn in _COUNTED:
            fn.launches += self.launches[fn.__name__]
        return self._result

    def warm_up(self, generators: Sequence[torch.Generator]) -> None:
        """``WARMUP`` eager calls, the generators' states restored after
        them (with what ``_warm`` restores itself)."""
        saved = [g.get_state() for g in generators]
        try:
            with full_float32():
                self._warm()
        finally:
            for g, s in zip(generators, saved):
                g.set_state(s)

    def _capture(self, generators: List[torch.Generator]) -> None:
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            self.warm_up(generators)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0

        # with debug, the graph's nodes are kept after instantiation
        graph = torch.cuda.CUDAGraph(keep_graph=self.debug)
        for g in generators:
            graph.register_generator_state(g)
        counts = {fn: fn.launches for fn in _COUNTED}
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        err: Optional[BaseException] = None
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=stream):
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self._result = self._run()
                except Exception as e:  # noqa: BLE001 - re-raised below
                    err = e
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
                    self.record_s = time.perf_counter() - t0
            if err is None and self.debug:
                graph.instantiate()
        except Exception as e:  # noqa: BLE001 - capture_end after a failure
            err = err or e
        finally:
            self.launches = {fn.__name__: fn.launches - n
                             for fn, n in counts.items()}
            for fn, n in counts.items():
                fn.launches = n
        if err is not None:
            name = getattr(self.fn, "__qualname__", repr(self.fn))
            raise RuntimeError(f"CUDA graph capture of {name} failed at "
                               f"{_where(err)}: {err}") from err
        # capture_end (or, with debug, instantiate) instantiated the graph
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph

    def node_counts(self) -> Dict[str, int]:
        """The captured graph's nodes by type (``KERNEL``, ``MEMCPY``,
        ``MEMSET``, ...), read through the CUDA driver
        (``cuGraphGetNodes``, ``cuGraphNodeGetType``); needs ``debug=True``
        at construction, which keeps the graph's nodes."""
        import ctypes

        if self.graph is None or not self.debug:
            raise ValueError("node_counts needs a graph captured with "
                             "debug=True")
        cu = ctypes.CDLL("libcuda.so.1")
        cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t)]
        cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int)]
        cu.cuGraphGetNodes.restype = cu.cuGraphNodeGetType.restype = ctypes.c_int

        def check(rc: int) -> None:
            if rc != 0:
                raise RuntimeError(f"CUDA driver error {rc}")

        g = ctypes.c_void_p(self.graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)))
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)))
        counts: Dict[str, int] = {}
        kind = ctypes.c_int()
        for node in nodes:
            check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
            name = _NODE_TYPES.get(kind.value, str(kind.value))
            counts[name] = counts.get(name, 0) + 1
        return counts


# CUgraphNodeType (cuda.h)
_NODE_TYPES = {0: "KERNEL", 1: "MEMCPY", 2: "MEMSET", 3: "HOST", 4: "GRAPH",
               5: "EMPTY", 6: "WAIT_EVENT", 7: "EVENT_RECORD",
               8: "EXT_SEMAS_SIGNAL", 9: "EXT_SEMAS_WAIT", 10: "MEM_ALLOC",
               11: "MEM_FREE", 12: "BATCH_MEM_OP", 13: "CONDITIONAL"}


class CapturedStep(_Captured):
    """``fn(state, *inputs)`` captured once as a CUDA graph on the card and
    replayed by each call (run eagerly on CPU tensors).  See the module's
    docstring.

    ``generators``: every ``torch.Generator`` the step draws from.
    ``state_field``: None when ``fn`` returns the next state, else the
    name of the field of its (NamedTuple) result that holds it.
    ``debug``: keep the graph's nodes (``keep_graph``) for
    ``node_counts``.

    After capture, ``launches`` maps each counted kernel wrapper's name to
    the launches one replay makes, ``pool_bytes`` is the device memory
    the capture reserved (the graph's private pool: its intermediates and
    outputs), ``warmup_s`` the warm-up's seconds, ``capture_s`` those of
    the capture and the graph's instantiation, and ``record_s`` those of
    the capture alone (the step's call while the stream records)."""

    def __init__(self, fn: Callable, state, *inputs,
                 generators: Sequence[Optional[torch.Generator]] = (),
                 state_field: Optional[str] = None, debug: bool = False):
        self.fn = fn
        self.state_field = state_field
        self.state = clone(state)
        self.inputs = clone(inputs)
        self._static = leaves((self.state, self.inputs))
        self._n_state = len(leaves(self.state))
        if not self._static:
            raise ValueError("a captured step needs tensors in its state")
        self._storages = {x.untyped_storage().data_ptr() for x in self._static}
        self._init_graph(self._static[0].device, generators, debug)

    def _run(self):
        """The step on the static buffers, its next state copied into the
        state buffers; returns the result with the state buffers in it."""
        with full_float32():
            result = self.fn(self.state, *self.inputs)
        new = result if self.state_field is None else getattr(result,
                                                              self.state_field)
        dst = self._static[:self._n_state]
        src = leaves(new)
        if len(src) != len(dst):
            raise ValueError("the step's next state does not have the "
                             "structure of its state")
        # a result that shares memory with a state buffer (a view of the
        # old state, not the buffer itself) is cloned before the buffers
        # are overwritten
        src = [s.clone() if s is not d and self._aliases(s) else s
               for s, d in zip(src, dst)]
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)
        if self.state_field is None:
            return self.state
        others = {f: getattr(result, f) for f in result._fields
                  if f != self.state_field}
        others = {f: rebuild(v, [x.clone() if self._aliases(x) else x
                                 for x in leaves(v)])
                  for f, v in others.items()}
        return result._replace(**{self.state_field: self.state}, **others)

    def _aliases(self, x: torch.Tensor) -> bool:
        return x.untyped_storage().data_ptr() in self._storages

    def _warm(self) -> None:
        """The step on clones of the state and inputs buffers, which are
        left as they were."""
        for _ in range(self.WARMUP):
            self.fn(clone(self.state), *clone(self.inputs))


class CapturedUpdate(_Captured):
    """``fn(*inputs)``, a call that writes the tensors ``held`` in place
    (a module's parameters and gradients, an optimizer's state, a learning
    rate) and returns a tree of tensors, captured once as a CUDA graph on
    the card and replayed by each call (run eagerly on CPU tensors).  See
    the module's docstring.

    ``fn`` must not write its inputs.  The tensors of the inputs given here
    are the object's buffers, not copies of them (an update reads large
    buffers that persist, such as a rollout's trajectory, or another
    graph's outputs): a call copies into them each given leaf that is not
    one of them, as ``CapturedStep`` does.  ``held`` lists every tensor that
    ``fn`` writes and that outlives a call; they must keep their storage
    while the object is used (write into them with ``copy_``), and the
    caller makes them before the capture (an optimizer's state included:
    a lazily made state would be made by the warm-up outside the graph and
    then reset by it).  Gradients are among them: ``fn`` zeroes them in
    place rather than setting them to None, so that backward accumulates
    into the same storage on every replay.  ``generators`` as for
    ``CapturedStep``, and so are the attributes it sets at capture.  The
    result is the graph's own tensors on the card: the next replay
    overwrites them."""

    def __init__(self, fn: Callable, *inputs, held: Sequence[torch.Tensor],
                 generators: Sequence[Optional[torch.Generator]] = ()):
        self.fn = fn
        self.inputs = inputs
        self._static = leaves(self.inputs)
        self.held = list(held)
        if not self._static:
            raise ValueError("a captured update needs tensors in its inputs")
        self._init_graph(self._static[0].device, generators)

    def _run(self):
        with full_float32():
            return self.fn(*self.inputs)

    def _warm(self) -> None:
        """The call on clones of the inputs; every held tensor written back
        as it was before."""
        with torch.no_grad():
            saved = [h.detach().clone() for h in self.held]
        try:
            for _ in range(self.WARMUP):
                self.fn(*clone(self.inputs))
        finally:
            with torch.no_grad():
                for h, x in zip(self.held, saved):
                    h.copy_(x)
