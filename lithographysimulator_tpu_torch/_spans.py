"""The port's spans and counters: one recording, one lock.

* :func:`span` marks a range of the host's work (``litho.<layer>.<step>``).
  While no ``torch.profiler`` trace records, it costs a flag check and a
  call. While one records, the span enters the trace as a CPU event of
  function scope (``_RecordFunctionFast``; ``record_function``'s user scope
  would cast the range onto the device's timeline as well), so it shares
  the device trace's clock, and appends itself to the recording on the
  same clock (``time.time_ns``): name, start, end, thread, span id, parent
  span id, request id and a few attributes. The profiler records the host
  events of the thread that started it; the recording takes every
  thread's spans.
* :func:`stamp` and :func:`end_span` make a span that starts on one thread
  and ends on another (a request's wait in a queue).
* :func:`request_scope` issues a request id and gives it to the spans that
  its thread opens meanwhile.
* :class:`Counters`: named totals, always on, under the store's one lock;
  while a trace records, each addition is also tallied in the recording as
  ``<group>.<name>``, so that a reader sees a traced window's counts apart
  from set-up's.
* :func:`recording` reads the recording out, :func:`reset` clears it.
  It holds at most :data:`MAX_SPANS` spans and counts those it drops.

``utils.profiling`` re-exports these names; its :func:`trace` resets the
recording when it starts and writes it beside its ``trace.json``.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

#: spans the recording holds; later ones are counted as dropped
MAX_SPANS = 1_000_000

# ``_is_profiler_enabled`` is set while any torch.profiler trace records
_PROFILER = torch.autograd.profiler
_FAST_RANGE = torch._C._profiler._RecordFunctionFast
_LOCK = threading.Lock()  # the counters' totals and the whole recording
_SPANS: list = []
_TALLY: dict = {}
_DROPPED = 0
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)
_LOCAL = threading.local()  # a thread's open spans and its request id


def _record(name, start_ns, end_ns, thread, span_id, parent, request, attrs):
    global _DROPPED
    with _LOCK:
        if len(_SPANS) < MAX_SPANS:
            _SPANS.append((name, start_ns, end_ns, thread, span_id, parent,
                           request, attrs))
        else:
            _DROPPED += 1


def _open_spans() -> list:
    try:
        return _LOCAL.spans
    except AttributeError:
        _LOCAL.spans = []
        return _LOCAL.spans


class _Off:
    """The span handed out while no trace records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        """Add attributes known only inside the span (a batch's size)."""
        self.attrs.update(attrs)

    def __enter__(self):
        spans = _open_spans()
        self.parent = spans[-1] if spans else None
        self.id = next(_SPAN_IDS)
        spans.append(self.id)
        self.request = getattr(_LOCAL, "request", None)
        self._range = _FAST_RANGE(self.name)
        self._range.__enter__()
        # stamped inside the profiler's event, which then holds the span
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(None, None, None)
        _open_spans().pop()
        _record(self.name, self.start, end, threading.get_ident(), self.id,
                self.parent, self.request, self.attrs)
        return False


def span(name: str, **attrs):
    """A context manager that records the range ``name`` while a
    ``torch.profiler`` trace records, and does nothing otherwise."""
    if not _PROFILER._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def stamp() -> int | None:
    """Now on the recording's clock while a trace records, else None: the
    start of a span that :func:`end_span` ends, maybe on another thread."""
    return time.time_ns() if _PROFILER._is_profiler_enabled else None


def end_span(name: str, start_ns: int | None, *, thread: int | None = None,
             request: int | None = None) -> None:
    """Record the span ``name`` from ``start_ns`` (a :func:`stamp`) to now,
    on ``thread`` (the one that stamped it) and for ``request``; nothing
    when ``start_ns`` is None or no trace records any more."""
    if start_ns is None or not _PROFILER._is_profiler_enabled:
        return
    _record(name, start_ns, time.time_ns(),
            threading.get_ident() if thread is None else thread,
            next(_SPAN_IDS), None, request, {})


def current_request() -> int | None:
    """The request id of this thread's :func:`request_scope`, if any."""
    return getattr(_LOCAL, "request", None)


class request_scope:  # noqa: N801 - used as a context manager, like span
    """Issue a request id (``.id``) and give it to the spans this thread
    opens inside the block."""

    __slots__ = ("id", "_outer")

    def __init__(self):
        self.id = next(_REQUEST_IDS)

    def __enter__(self):
        self._outer = getattr(_LOCAL, "request", None)
        _LOCAL.request = self.id
        return self

    def __exit__(self, *exc):
        _LOCAL.request = self._outer
        return False


class Counters:
    """Named counts of one ``group``, always on. ``totals`` is the live
    dict of cumulative counts; while a trace records, each addition is
    also tallied in the recording as ``<group>.<name>``."""

    def __init__(self, group: str, names):
        self.group = group
        self.totals = dict.fromkeys(names, 0)

    def add(self, name: str, n: int = 1) -> None:
        with _LOCK:
            # a server's threads count together: the read, add and write
            # of a total happen under the lock
            self.totals[name] = self.totals[name] + n
            if _PROFILER._is_profiler_enabled:
                key = f"{self.group}.{name}"
                _TALLY[key] = _TALLY.get(key, 0) + n

    def reset(self) -> None:
        with _LOCK:
            for name in self.totals:
                self.totals[name] = 0

    def snapshot(self) -> dict:
        with _LOCK:
            return dict(self.totals)


def recording() -> dict:
    """The recording: ``spans`` (each a dict of ``name``, ``start_ns``,
    ``end_ns``, ``thread``, ``id``, ``parent``, ``request``, ``attrs``; the
    ns on the profiler's clock), ``counters`` (``<group>.<name>`` -> count
    while traces recorded) and ``dropped`` (spans past the bound)."""
    keys = ("name", "start_ns", "end_ns", "thread", "id", "parent",
            "request", "attrs")
    with _LOCK:
        spans, tally, dropped = list(_SPANS), dict(_TALLY), _DROPPED
    return {"spans": [dict(zip(keys, s)) for s in spans],
            "counters": tally, "dropped": dropped}


def reset() -> None:
    """Clear the recording (its spans, tallies and drop count)."""
    global _DROPPED
    with _LOCK:
        _SPANS.clear()
        _TALLY.clear()
        _DROPPED = 0
