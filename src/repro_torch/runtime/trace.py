"""Spans of the port's host work, kept in memory; off by default.

`span(name)` is a context manager around a stretch of host work. While
tracing is off it returns one shared object that does nothing: no clock is
read and nothing is allocated, so the wave loop pays one call a span. After
`enable()` each span that ends is kept as one tuple

    (name, start_ns, end_ns, span_id, parent_id, request_id)

on the wall clock (`time.time_ns`), the clock that `torch.profiler`'s
events are stamped on, so a span can be matched with the device work that
the host launched inside it. `parent_id` is the span open around it on the
same thread (0: none); `request_id` is the id of the outermost span open on
that thread, so every span of one `abc.posterior` carries that posterior's
id. Ids count from 1 over the process.

`records()` is a copy of the spans kept since the last `clear()`; there is
no other exporter. The spans of `core.abc` (`abc.posterior`, `abc.init`,
`abc.segment`, `abc.wave`, `abc.compact`, `abc.sync`, `abc.harvest`) are
listed where they are opened.
"""

from __future__ import annotations

import itertools
import threading
import time

_clock = time.time_ns
_enabled = False
_records: list = []
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "start", "id", "parent", "request")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[0].id
        else:
            self.parent, self.request = 0, self.id
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        _stack().pop()
        _records.append((self.name, self.start, end, self.id, self.parent, self.request))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context manager that records `name` around its block while tracing
    is on, and the shared no-op `OFF` while it is off."""
    return _Span(name) if _enabled else OFF


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def records() -> list:
    """The spans kept since the last `clear()`, in the order they ended."""
    return list(_records)


def clear() -> None:
    _records.clear()
