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
  :func:`recorded`. :func:`device_span` records a phase that ran inside a
  replayed CUDA graph: its device time, no host time.
- Counts may be 0-d device tensors, found inside a step without a
  device -> host copy; :func:`recorded` reads them.
- Inside :func:`graph_spans`, a span given a CUDA ``device`` that opens
  while the current stream is captured into a CUDA graph (a phase of the
  train step, or a model's span in its forward or backward, that the step's
  graph records) is kept in the block's :class:`GraphSpans`, whatever the
  profiler does: a pair of timing events recorded into the graph as its
  nodes, and its counts, tensors the graph rewrites at each replay.
  :meth:`GraphSpans.read` gives each one's device time and counts of the
  last replay, for :func:`device_span`.
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
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _NoSpan()


class _Span:
    __slots__ = ("_entry", "_range", "_stream")
    recording = True

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


class _GraphSpan:
    """A span opened while a CUDA graph is captured (:class:`GraphSpans`)."""
    __slots__ = ("_entry",)
    recording = True

    def __init__(self, entry: list):
        self._entry = entry

    def _record(self):
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self._entry[1].append(event)

    def __enter__(self):
        self._record()
        return self

    def __exit__(self, *exc):
        self._record()
        return False

    def set(self, **counts) -> None:
        self._entry[2].update(counts)


class GraphSpans:
    """The spans opened while a CUDA graph was captured, in the order they
    opened: each one's name, its pair of timing events (graph nodes) and
    its counts."""

    def __init__(self):
        self.entries: list[list] = []   # [name, [start, end], counts]

    def open(self, name: str, counts: dict) -> _GraphSpan:
        entry = [name, [], dict(counts)]
        self.entries.append(entry)
        return _GraphSpan(entry)

    def read(self) -> list[tuple[str, float, dict]]:
        """(name, device ms, counts) of each span in the last replay, which
        has finished; tensor counts read in one device -> host copy."""
        tensors = [v for _, _, counts in self.entries
                   for v in counts.values() if torch.is_tensor(v)]
        values = iter(torch.stack([t.double() for t in tensors]).tolist()
                      if tensors else [])
        out = []
        for name, events, counts in self.entries:
            if len(events) != 2:
                continue
            read = {k: next(values) if torch.is_tensor(v) else v
                    for k, v in counts.items()}
            out.append((name, events[0].elapsed_time(events[1]), read))
        return out


_graph_record: GraphSpans | None = None


@contextlib.contextmanager
def graph_spans():
    """Keep the device spans opened on a capturing stream inside the block
    in the :class:`GraphSpans` it yields (any thread: a capture's backward
    runs on autograd's device thread). The train step's capture opens it:
    the trainer's four phases and the model's own spans (V-MoE's ``moe.*``)
    are kept here."""
    global _graph_record
    before, _graph_record = _graph_record, GraphSpans()
    try:
        yield _graph_record
    finally:
        _graph_record = before


def span(name: str, *, id: int | None = None, parent=None,
         device: torch.device | None = None, **counts):
    """A context manager marking phase ``name`` with ``counts``; its handle's
    ``set(**counts)`` adds counts found inside, and its ``recording`` says
    whether they are kept. Nested in the thread's open
    span, or under ``parent`` (the handle of a span of another thread); a
    root span takes ``id`` (default: the next number of the record), its
    descendants share it. With a CUDA ``device``, the span's device
    milliseconds are timed on that device's current stream; inside
    :func:`graph_spans` on a capturing stream, it goes to the graph's
    spans instead."""
    if (device is not None and _graph_record is not None
            and torch.cuda.is_current_stream_capturing()):
        return _graph_record.open(name, counts)
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


def collecting() -> bool:
    """Whether torch's profiler is collecting, so that spans record: the one
    flag :func:`span` reads."""
    return _autograd_profiler._is_profiler_enabled


def device_span(name: str, device_ms: float, **counts) -> None:
    """Record phase ``name`` that ran on the device with no host work of its
    own (a phase inside a replayed CUDA graph, timed by the graph's events):
    zero host milliseconds at the moment of the call, ``device_ms`` device
    milliseconds, nested in the thread's open span. Only while the profiler
    collects, as :func:`span`."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_stacks, "spans", None)
    up = stack[-1] if stack else None
    entry = _Entry(name, up.id if up is not None else next(_record.roots),
                   up, counts)
    entry.start_ns = entry.end_ns = time.perf_counter_ns()
    entry.device_ms = device_ms
    _record.add(entry)


def recorded() -> list[dict]:
    """The record's finished spans in the order they started, each a dict of
    ``name``, ``id``, ``parent`` (the index of its parent in this list, or
    None), ``thread``, ``start_ns``, ``end_ns``, ``host_ms``, ``device_ms``
    (None for a span without a CUDA device; waits for the device) and
    ``counts`` (tensor counts read as numbers)."""
    with _record.lock:
        entries = [e for e in _record.entries if e.end_ns is not None]
    for e in entries:
        if e.events is not None and len(e.events) == 2:
            start, end = e.events
            end.synchronize()
            e.device_ms, e.events = start.elapsed_time(end), None
    for e in entries:
        for k, v in e.counts.items():
            if torch.is_tensor(v):
                e.counts[k] = v.item()
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
