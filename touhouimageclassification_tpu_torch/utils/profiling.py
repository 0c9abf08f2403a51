"""Tracing (counterpart of the JAX package's ``utils/profiling.py``).

- :func:`trace` runs ``torch.profiler`` over the enclosed code and writes a
  Chrome trace; the trainer's ``TrainConfig.profile_dir`` knob traces a
  window of steps with it.
- :func:`span` marks a phase of the program (a train step and its parts,
  a judge sweep and its parts) with counts found there. Spans record only
  while torch's profiler is collecting, whoever started it (:func:`trace`,
  a benchmark's traced window): that is the rule of torch's own
  ``record_function``. Otherwise :func:`span` reads one flag and returns a
  shared no-op object.
- A recording span enters a ``record_function`` range ``tic.<name>``, so it
  lands in the profiler's Chrome trace beside the kernels it launched, and
  appends an entry to the record: its name, the id of its root span (a
  train step's ``state.step``, else a number of the record), its parent,
  thread (the system's id, the Chrome trace's ``tid``), host start and end
  (``time.perf_counter_ns``) and counts. A span
  given a CUDA ``device`` also records a pair of timing events on that
  device's current stream, read without a synchronisation until
  :func:`recorded`.
- The record is kept in memory, at most :data:`CAPACITY` entries (later
  ones are dropped and counted), and is read by :func:`recorded`, emptied
  by :func:`clear` and written beside the Chrome trace by :func:`trace`.
  It keeps one ``(time.time_ns(), time.perf_counter_ns())`` pair, so that
  :func:`unix_us` puts an entry on the Chrome trace's clock (a trace's
  ``ts`` is Unix microseconds less its ``baseTimeNanoseconds``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

CAPACITY = 200_000


@contextlib.contextmanager
def trace(logdir: str | None):
    """``torch.profiler`` trace (CPU activity, and CUDA where there is a
    GPU) of the enclosed code, written as a Chrome trace
    ``<logdir>/trace.<pid>.<ms>.json``, and the spans recorded meanwhile as
    ``<logdir>/spans.<pid>.<ms>.json`` (``{"clock_ns": [time_ns,
    perf_counter_ns], "dropped": n, "spans": recorded()}``); no-op when
    ``logdir`` is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield
    stamp = f"{os.getpid()}.{int(time.time() * 1e3)}"
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{stamp}.json"))
    with open(os.path.join(logdir, f"spans.{stamp}.json"), "w") as f:
        json.dump({"clock_ns": _record.clock, "dropped": _record.dropped,
                   "spans": recorded()}, f)


class _Entry:
    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "counts", "events", "device_ms")

    def __init__(self, name, id, parent, counts):
        self.name, self.id, self.parent, self.counts = name, id, parent, counts
        self.thread = threading.get_native_id()
        self.start_ns = self.end_ns = self.events = self.device_ms = None


class _Record:
    def __init__(self):
        self.lock = threading.Lock()
        self.entries: list[_Entry] = []
        self.dropped = 0
        self.clock: tuple[int, int] | None = None
        self.roots = itertools.count()

    def add(self, entry: _Entry) -> bool:
        with self.lock:
            if len(self.entries) >= CAPACITY:
                self.dropped += 1
                return False
            if self.clock is None:
                self.clock = (time.time_ns(), time.perf_counter_ns())
            self.entries.append(entry)
            return True


_record = _Record()
_stacks = threading.local()


class _NoSpan:
    """What :func:`span` returns while nothing is recorded."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _NoSpan()


class _Span:
    __slots__ = ("_entry", "_range", "_stream")

    def __init__(self, entry: _Entry, stream):
        self._entry, self._stream = entry, stream
        self._range = None

    def __enter__(self):
        entry = self._entry
        stack = _stacks.__dict__.setdefault("spans", [])
        stack.append(entry)
        # the clock is read before the range's own start: entering and
        # leaving it release the interpreter lock, and taking it back can
        # wait for another thread for milliseconds
        entry.start_ns = time.perf_counter_ns()
        self._range = record_function("tic." + entry.name)
        self._range.__enter__()
        if self._stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            entry.events = (start,)
        return self

    def __exit__(self, *exc):
        entry = self._entry
        if self._stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            entry.events += (end,)
        entry.end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _stacks.spans.pop()
        return False

    def set(self, **counts) -> None:
        """Add counts found inside the span."""
        self._entry.counts.update(counts)


def span(name: str, *, id: int | None = None, parent=None,
         device: torch.device | None = None, **counts):
    """A context manager marking phase ``name`` with ``counts``; its handle's
    ``set(**counts)`` adds counts found inside. Nested in the thread's open
    span, or under ``parent`` (the handle of a span of another thread); a
    root span takes ``id`` (default: the next number of the record), its
    descendants share it. With a CUDA ``device``, the span's device
    milliseconds are timed on that device's current stream."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if isinstance(parent, _Span):
        up = parent._entry
    else:
        stack = getattr(_stacks, "spans", None)
        up = stack[-1] if stack else None
    if up is not None:
        id = up.id
    elif id is None:
        id = next(_record.roots)
    entry = _Entry(name, id, up, counts)
    if not _record.add(entry):
        return _OFF
    stream = (torch.cuda.current_stream(device)
              if device is not None and device.type == "cuda" else None)
    return _Span(entry, stream)


def recorded() -> list[dict]:
    """The record's finished spans in the order they started, each a dict of
    ``name``, ``id``, ``parent`` (the index of its parent in this list, or
    None), ``thread``, ``start_ns``, ``end_ns``, ``host_ms``, ``device_ms``
    (None for a span without a CUDA device; waits for the device) and
    ``counts``."""
    with _record.lock:
        entries = [e for e in _record.entries if e.end_ns is not None]
    for e in entries:
        if e.events is not None and len(e.events) == 2:
            start, end = e.events
            end.synchronize()
            e.device_ms, e.events = start.elapsed_time(end), None
    index = {id(e): i for i, e in enumerate(entries)}
    return [{"name": e.name, "id": e.id,
             "parent": None if e.parent is None else index.get(id(e.parent)),
             "thread": e.thread, "start_ns": e.start_ns, "end_ns": e.end_ns,
             "host_ms": (e.end_ns - e.start_ns) / 1e6,
             "device_ms": e.device_ms, "counts": dict(e.counts)}
            for e in entries]


def dropped() -> int:
    """Entries the record left out for want of room."""
    return _record.dropped


def unix_us(perf_ns: int) -> float:
    """A ``time.perf_counter_ns`` reading of the record as Unix
    microseconds, the Chrome trace's clock before its base is taken off."""
    time_ns, at = _record.clock
    return (time_ns + perf_ns - at) / 1e3


def clear() -> None:
    """Empty the record."""
    global _record
    _record = _Record()
