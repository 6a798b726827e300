"""Spans of the program's host work: where the time of a serving path goes
between enqueuing device work, waiting on the device, and planning.

    from pocket_tts_tpu_torch.utils import trace

    records = []
    trace.enable(records.append)   # every finished span is handed to the sink
    ...                            # serve, stream, clone
    trace.disable()

`span(name, **attrs)` is a context manager. While tracing is off (the
default) it returns one shared object that does nothing and reads no
clock. While it is on, each span becomes a `Record` when it closes: its
name, start and end in `time.time_ns()` (the clock of the profiler's
device records, so a device trace's idle gaps can be named by the spans
around them), the thread, its own id and the id of the span that was open
on the same thread when it began (None at the top). Each thread keeps its
own stack of open spans, so spans of the serving engine's thread never
nest into its callers' spans.

A span never stays open across a `yield`: the caller's time between frames
is not the program's. Names are dotted by layer (`engine.tick`,
`generate.segment`, `clone.read`, ...); docs/SERVING.md lists them.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, NamedTuple, Optional


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    attrs: dict


class _Off:
    """The span of a recorder that is off: enters, sets and exits as a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()
_sink: Optional[Callable[[Record], None]] = None
_ids = itertools.count(1)
_local = threading.local()


class _Span:
    __slots__ = ("name", "attrs", "sink", "id", "parent", "start")

    def __init__(self, name: str, attrs: dict, sink: Callable[[Record], None]):
        self.name, self.attrs, self.sink = name, attrs, sink

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        self.sink(Record(self.name, self.start, end, threading.get_ident(), self.id, self.parent, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the work inside has run."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A span named `name` around a block, with `attrs` on its record."""
    sink = _sink
    return OFF if sink is None else _Span(name, attrs, sink)


def enable(sink: Callable[[Record], None]) -> None:
    """Record every span from now on, handing each finished one to `sink`
    (called from the thread that ran the span)."""
    global _sink
    _sink = sink


def disable() -> None:
    """Record nothing from now on (spans open now still reach their sink)."""
    global _sink
    _sink = None
