"""Tracing of the port: spans and counters inside it, and the profiler's
exporter (counterpart of radian_tpu/utils/profiling.py).

Tracing is on exactly while a ``torch.profiler`` session records: under
``trace(log_dir)`` here, or any other profiler (the benchmark's
``--trace 1``).  Off, ``span`` returns a shared no-op after one flag
check (no profiler range, no CUDA event, no lock, no allocation) and
``count`` returns.

On, each span records its name, its host start and end in Unix-epoch
nanoseconds (the profiler's clock, so spans and the device trace share
it), its parent span, the call and batch it belongs to, its thread and
device.  A span given a CUDA device also records CUDA events on that
device's current stream around its body, resolved to device times by
``spans()``.  A span given no device is host work alone and is also
emitted as a profiler range, so its name labels the device's idle gaps
in the trace; a span whose body launches kernels is never emitted: the
profiler would give its range a device-side record, and the trace would
count the whole range as device work.

Counters take host-known values only (shapes, numpy lengths), never a
device read.  ``launch(wrapper)`` counts a kernel launch: always in the
wrapper's ``launches`` attribute, and while on in the counter
``launches.<wrapper>``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

# spans kept between resets; later ones are counted in ``dropped``
MAX_SPANS = 200_000

_NOOP = contextlib.nullcontext()
# a profiler range in C++ (``record_function`` costs ~8x its time)
_range = torch._C._profiler._RecordFunctionFast


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return _autograd_profiler._is_profiler_enabled


class _Frame:
    """What a span hands its children: its id, call and batch."""

    __slots__ = ("id", "call", "batch")

    def __init__(self, id_, call, batch):
        self.id, self.call, self.batch = id_, call, batch


_TOP = _Frame(None, None, None)  # above a thread's outermost span


class _Span(_Frame):
    """One open span; ``_Recorder.resolve`` turns it into a record."""

    __slots__ = ("name", "device", "parent", "thread", "t0", "t1",
                 "stream", "ev", "rf")

    def __init__(self, name: str, device, call, batch):
        stack = _REC.stack()
        up = stack[-1] if stack else _TOP
        super().__init__(next(_REC.ids), up.call if call is None else call,
                         up.batch if batch is None else batch)
        self.name, self.parent = name, up.id
        self.device = None if device is None else torch.device(device)
        self.thread = threading.current_thread().name
        self.ev = self.rf = None

    def __enter__(self):
        dev = self.device
        if dev is None:
            self.rf = _range(self.name)
            self.rf.__enter__()
        elif dev.type == "cuda":
            self.stream = torch.cuda.current_stream(dev)
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record(self.stream)
        self.t0 = time.time_ns()
        _REC.stack().append(self)
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        _REC.stack().pop()
        if self.ev is not None:
            self.ev[1].record(self.stream)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _REC.add(self)
        return False


class _Within:
    """Pushes a parent frame onto this thread's stack for its body."""

    __slots__ = ("frame",)

    def __init__(self, frame):
        self.frame = frame

    def __enter__(self):
        _REC.stack().append(self.frame)

    def __exit__(self, *exc):
        _REC.stack().pop()
        return False


class _Recorder:
    """The process's spans and counters, bounded and thread-safe."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.ids = itertools.count()
            self.open: list[_Span] = []  # device times not yet resolved
            self.done: list[dict] = []
            self.counts: dict[str, int] = {}
            self.refs: dict[torch.device, torch.cuda.Event] = {}
            self.dropped = 0

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, sp: _Span) -> None:
        with self.lock:
            if len(self.open) + len(self.done) >= MAX_SPANS:
                self.dropped += 1
                return
            if sp.ev is not None and sp.device not in self.refs:
                self.refs[sp.device] = sp.ev[0]
            self.open.append(sp)

    def count(self, name: str, value: int) -> None:
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + int(value)

    def resolve(self) -> list[dict]:
        """Every recorded span as a dict, device times resolved (one
        synchronise of each device that has span events)."""
        with self.lock:
            todo, self.open = self.open, []
            refs = dict(self.refs)
        for dev in refs:
            torch.cuda.synchronize(dev)
        out = []
        for sp in todo:
            d0 = d1 = None
            if sp.ev is not None:
                ref = refs[sp.device]
                d0 = ref.elapsed_time(sp.ev[0])
                d1 = ref.elapsed_time(sp.ev[1])
            out.append({"name": sp.name, "id": sp.id, "parent": sp.parent,
                        "call": sp.call, "batch": sp.batch,
                        "thread": sp.thread,
                        "device": None if sp.device is None
                        else str(sp.device),
                        "host_start_ns": sp.t0, "host_end_ns": sp.t1,
                        "device_start_ms": d0, "device_end_ms": d1})
        with self.lock:
            self.done.extend(out)
            done = sorted(self.done, key=lambda s: s["id"])
        return done


_REC = _Recorder()


def span(name: str, device=None, *, call=None, batch=None):
    """A context manager timing its body as span ``name`` while tracing
    is on, else a shared no-op.

    ``device``: where the body launches its work; None for host work
    alone (the span is then also a profiler range).  ``call`` and
    ``batch`` default to the enclosing span's on this thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, device, call, batch)


def current():
    """The innermost open span on this thread, for ``within`` on another
    thread (None while tracing is off)."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    s = _REC.stack()
    return s[-1] if s else None


def within(parent, batch=None):
    """Make ``parent`` (from ``current()``, on another thread) and
    ``batch`` the enclosing span of this thread's spans in the body."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    up = parent or _TOP
    return _Within(_Frame(up.id, up.call,
                          up.batch if batch is None else batch))


def count(name: str, value: int) -> None:
    """Add ``value`` (host-known) to counter ``name`` while tracing."""
    if _autograd_profiler._is_profiler_enabled:
        _REC.count(name, value)


def launch(wrapper) -> None:
    """One more launch of the kernel behind ``wrapper`` (the shards of a
    multi-device Basecaller launch from their own threads)."""
    with _REC.lock:
        wrapper.launches += 1
    if _autograd_profiler._is_profiler_enabled:
        _REC.count(f"launches.{wrapper.__name__}", 1)


def spans() -> list[dict]:
    """The spans recorded since ``reset()``, in the order they opened:
    ``name``, ``id``, ``parent`` (id), ``call``, ``batch``, ``thread``,
    ``device``, ``host_start_ns`` and ``host_end_ns`` (Unix epoch), and
    for a CUDA span ``device_start_ms`` and ``device_end_ms`` (from one
    event of that device, the same for all its spans since ``reset()``;
    else None)."""
    return _REC.resolve()


def counters() -> dict[str, int]:
    """The counters since ``reset()`` (``dropped``: spans over
    MAX_SPANS)."""
    with _REC.lock:
        out = dict(_REC.counts)
        if _REC.dropped:
            out["dropped"] = _REC.dropped
    return out


def reset() -> None:
    """Forget every span and counter."""
    _REC.reset()


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block; on exit write ``log_dir/trace.json`` (Chrome
    trace format) and ``log_dir/spans.json`` (the port's spans and
    counters recorded in the block).  Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sums time
    by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    (log_dir / "spans.json").write_text(json.dumps(
        {"spans": spans(), "counters": counters()}))
