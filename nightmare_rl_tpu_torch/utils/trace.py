"""The port's tracing: named spans of host time and counters of events,
kept in memory while a recording is on and cost-free while it is off.

    from nightmare_rl_tpu_torch.utils import trace

    with trace.recording() as rec:
        ppo.learn_step()
    rec.spans     # ppo.iteration, its ppo.rollout (with ppo.record),
                  # ppo.learn and ppo.stats
    rec.counters  # {"host.syncs": 4, ...}
    rec.write("spans.json")

``span(name, **attrs)`` is a context manager.  Off (the default) it is one
shared null context: nothing is stamped, allocated or launched.  On, a span
stamps its start and end, records its parent (the enclosing open span) and
the PPO iteration it belongs to (a ``ppo.iteration`` span opens a new one,
every other span takes its parent's), and enters
``torch.profiler.record_function(name)``, so that an active profiler's
trace holds it as an annotation beside the kernels and copies.

``timed(name)`` is a span for code that needs its seconds whether or not a
recording is on (``learn_step``'s rollout and learning half, a capture's
warm-up and recording): off, it takes the two stamps and nothing else.

``spanned(name)`` decorates a function whose calls are spans (an env's
constructor: ``setup.env``).

``count(name, n=1)`` adds to a counter of the recording; off, it returns at
once.

Every stamp is ``time.time_ns()``: nanoseconds since the Unix epoch, the
clock of torch.profiler's exported trace (an event starts at
``baseTimeNanoseconds`` + 1000 ``ts``).  ``Recording.align`` measures what
is left between the two on an exported trace (``offset_ns``).

Spans and counters stay on the host side of the work: none opens inside a
function that ``utils/graph.py`` captures (a span there would be recorded
once and replayed as a lie; ``span`` refuses a capturing stream), and none
synchronizes with the card.  The device's side of a span is in the
profiler's trace.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function

ITERATION = "ppo.iteration"

now = time.time_ns

_NULL = contextlib.nullcontext()
_active: Optional["Recording"] = None


class Span:
    """One span of a recording: its name, its start and end (ns, ``now``),
    the index of its parent in the recording's spans (None at the top), its
    PPO iteration (None outside any) and its attributes."""

    __slots__ = ("name", "start", "end", "parent", "iteration", "attrs")

    def __init__(self, name: str, start: int, parent: Optional[int],
                 iteration: Optional[int], attrs: dict):
        self.name, self.start, self.end = name, start, None
        self.parent, self.iteration, self.attrs = parent, iteration, attrs

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class Recording:
    """The spans (in the order they opened) and counters of a recording,
    in memory; ``offset_ns`` is the profiler's clock less the stamps'
    (``align``)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.offset_ns = 0
        self._open: List[int] = []
        self._iterations = 0

    def _push(self, name: str, attrs: dict, start: int) -> int:
        parent = self._open[-1] if self._open else None
        if name == ITERATION:
            iteration = self._iterations
            self._iterations += 1
        else:
            iteration = None if parent is None else self.spans[parent].iteration
        self.spans.append(Span(name, start, parent, iteration, attrs))
        self._open.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def _pop(self, index: int, end: int) -> None:
        self.spans[index].end = end
        self._open.remove(index)

    def align(self, trace: dict) -> Optional[int]:
        """Sets ``offset_ns`` from an exported chrome trace (its JSON
        object): the median, over the spans the trace holds as annotations,
        of the annotation's start less the span's (the k-th span of a name
        against the k-th annotation of it, for each name of which the two
        hold as many).  Returns it, or None where nothing matched."""
        # both as ns after the trace's base, where a float holds them
        base = trace.get("baseTimeNanoseconds", 0)
        marks: Dict[str, List[float]] = {}
        for e in trace.get("traceEvents", []):
            if e.get("ph") == "X" and e.get("cat") == "user_annotation":
                marks.setdefault(e["name"], []).append(e["ts"] * 1e3)
        mine: Dict[str, List[int]] = {}
        for s in self.spans:
            mine.setdefault(s.name, []).append(s.start - base)
        diffs = [a - b for name, starts in mine.items()
                 if len(marks.get(name, ())) == len(starts)
                 for a, b in zip(sorted(marks[name]), starts)]
        if not diffs:
            return None
        self.offset_ns = round(statistics.median(diffs))
        return self.offset_ns

    def as_dict(self) -> dict:
        return {"clock": "time.time_ns", "offset_ns": self.offset_ns,
                "spans": [s.as_dict() for s in self.spans],
                "counters": dict(self.counters)}

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh)


class _Stamps:
    """``timed`` while no recording is on: the two stamps alone."""

    __slots__ = ("start", "end")

    def __enter__(self):
        self.start = now()
        return self

    def __exit__(self, *exc):
        self.end = now()
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class _On(_Stamps):
    """A span while a recording is on."""

    __slots__ = ("rec", "name", "attrs", "index", "_rf")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"span {self.name!r} inside a CUDA graph "
                               "capture")
        # each stamp is taken just before the annotation's own: the
        # profiler's work at entry and exit lies after its stamp
        self._rf = record_function(self.name)
        self.start = now()
        self._rf.__enter__()
        self.index = self.rec._push(self.name, self.attrs, self.start)
        return self

    def __exit__(self, *exc):
        self.end = now()
        self._rf.__exit__(*exc)
        self.rec._pop(self.index, self.end)
        return False


def span(name: str, **attrs):
    """A span named ``name`` with the attributes ``attrs`` (see the
    module's docstring); the shared null context while no recording is
    on."""
    rec = _active
    return _NULL if rec is None else _On(rec, name, attrs)


def spanned(name: str):
    """A decorator: each call of the function runs inside
    ``span(name, fn=<its qualname>)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name, fn=fn.__qualname__):
                return fn(*args, **kw)
        return call
    return wrap


def timed(name: str, **attrs):
    """A span that gives its ``start``, ``end`` (ns) and ``seconds`` after
    it closes, recorded or not."""
    rec = _active
    return _Stamps() if rec is None else _On(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the recording's counter ``name``."""
    rec = _active
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n


def start() -> Recording:
    """Turns tracing on; returns the new recording."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already on")
    _active = Recording()
    return _active


def stop() -> Optional[Recording]:
    """Turns tracing off; returns the recording that was on (or None)."""
    global _active
    rec, _active = _active, None
    return rec


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Tracing on for the block, which receives the recording."""
    rec = start()
    try:
        yield rec
    finally:
        stop()
