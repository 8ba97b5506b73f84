"""Spans on the profiler's clock, and the count of UNet forwards.

``span(name, **attrs)`` times a stretch of host code:

    with span("generate.decode") as s:
        ...
    s.seconds

Each span reads ``time.time_ns()`` as it opens and closes: the clock that
``torch.profiler``'s chrome trace is based on (an event's ``ts`` in us plus
the trace's ``baseTimeNanoseconds``), so a span lies on the device trace's
timeline as it is.  A span is kept only while recording is on: while a
``torch.profiler`` session records, or inside a ``recording()`` block.  A
kept span holds its name, start and end, its id, its parent's id (the span
open on the same thread when it opened), its root's id (the unit of work:
a request or a step, shared by every span under it), the thread and its
integer ``attrs``; ``take()`` hands the kept spans over.  The buffer holds
``MAX_SPANS``; what comes when it is full is dropped and counted.  While
recording is off a span reads the clock twice and keeps nothing.  A span
never synchronises: a stage that has to end on the device synchronises
inside its span, as ``stage`` does, which also hands the span's seconds to
a report.

``UNET_FORWARD`` counts the UNet's forwards and their rows in every run,
recording or not (``unet_forward`` opens the ``unet.forward`` span and
counts).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List

import torch

MAX_SPANS = 1 << 16

UNET_FORWARD: Dict[str, int] = {"forwards": 0, "rows": 0}

_profiler_on = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_kept: List["Span"] = []
_state = {"recording": 0, "dropped": 0}


class Span:
    __slots__ = ("name", "attrs", "start_ns", "end_ns", "id", "parent", "root",
                 "thread")

    def __init__(self, name: str, attrs: Dict[str, int]):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = 0
        self.id = self.parent = self.root = self.thread = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        if _state["recording"] or _profiler_on():
            stack = _stack()
            top = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent, self.root = (top.id, top.root) if top else (None, self.id)
            self.thread = threading.get_ident()
            stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self.id is not None:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:     # a generator's span closed out of order
                stack.remove(self)
            with _lock:
                if len(_kept) < MAX_SPANS:
                    _kept.append(self)
                else:
                    _state["dropped"] += 1
        return False

    def as_dict(self) -> Dict:
        return {"name": self.name, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "id": self.id, "parent": self.parent, "root": self.root,
                "thread": self.thread, "attrs": dict(self.attrs)}


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs: int) -> Span:
    return Span(name, attrs)


def unet_forward(rows: int) -> Span:
    """Count a UNet forward of ``rows`` rows; its span."""
    UNET_FORWARD["forwards"] += 1
    UNET_FORWARD["rows"] += rows
    return Span("unet.forward", {"rows": rows})


@contextlib.contextmanager
def stage(name: str, timings: Dict, key: str, device=None, **attrs: int) -> Iterator[Span]:
    """A span ``name`` whose seconds go to ``timings[key]``; with a CUDA
    ``device`` it synchronises that device before it closes, so the stage
    ends on the device."""
    with Span(name, attrs) as s:
        yield s
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    timings[key] = s.seconds


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Keep spans inside the block, profiler or not; the list it gives
    holds the spans taken in it (in the order they closed) once it ends,
    and they leave the buffer."""
    with _lock:
        _state["recording"] += 1
    first = next(_ids)
    got: List[Span] = []
    try:
        yield got
    finally:
        with _lock:
            _state["recording"] -= 1
            got.extend(s for s in _kept if s.id > first)
            _kept[:] = [s for s in _kept if s.id < first]


def take() -> List[Span]:
    """The kept spans, in the order they closed; the buffer is emptied."""
    with _lock:
        out = list(_kept)
        _kept.clear()
    return out


def dropped() -> int:
    """Spans dropped so far because the buffer was full."""
    return _state["dropped"]
