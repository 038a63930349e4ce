"""Spans and counters of the program, kept in memory while a profile records.

Tracing is on exactly while a ``torch.profiler`` profile records: that is its
only switch. Off, a span or counter site reads one flag and does nothing
else (no clock read, no allocation). On, every span records

- its name;
- its start and end in ns since the Unix epoch (``time.time_ns()``, the
  clock the profiler stamps its events with, so that a span can be joined by
  time to the profile's host ranges and device activities);
- its parent, the innermost span open when it opened;
- the root span ``proof`` it belongs to (``None`` outside a proof).

A counter is added to the innermost open span and to the total of its
proof. Nothing here synchronizes the card: a span's time is the host's wall
time, including any wait the program makes itself (a copy of device limbs to
the host waits for the kernels that make them). The spans never open a
``record_function`` range, which the profile would show as device activity.
One thread proves at a time: the open spans of a process form one stack.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ...]):
        wnn.proof(pk, srs, image)
    trace.summary()   # per span name: count, seconds, self seconds, counters
    trace.spans()     # the records, stamped on the profile's clock
"""

from __future__ import annotations

import collections
import functools
import time

from torch.autograd import profiler as _profiler

__all__ = ["Phases", "Span", "count", "enabled", "proof", "reset", "span",
           "spanned", "spans", "summary"]


def enabled() -> bool:
    """Whether a profile records now."""
    return _profiler._is_profiler_enabled


class _Null:
    """The span of a site while tracing is off: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Span:
    """One span's record. ``id`` is its index in :func:`spans`; ``parent``
    and ``proof`` are ids too; ``end_ns`` is None while it is open;
    ``counts`` holds the counters added while it was the innermost span."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "proof", "counts")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = None

    def open(self, t: int):
        rec = _rec
        top = rec.stack[-1] if rec.stack else None
        self.id = len(rec.records)
        self.start_ns = t
        self.parent = None if top is None else top.id
        inherited = None if top is None else top.proof
        self.proof = self.id if inherited is None and self.name == "proof" else inherited
        self.counts = {}
        rec.records.append(self)
        rec.stack.append(self)
        return self

    def close(self, t: int):
        """Ends this span at `t`, and any span still open inside it."""
        stack = _rec.stack
        if self not in stack:
            return
        while stack:
            s = stack.pop()
            s.end_ns = t
            if s is self:
                return

    def __enter__(self):
        return self.open(time.time_ns())

    def __exit__(self, *exc):
        self.close(time.time_ns())
        return False

    def __repr__(self):
        return (f"Span({self.id}, {self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent}, proof={self.proof}, counts={self.counts})")


class _Recorder:
    def __init__(self):
        self.records = []       # every span, in order of opening
        self.stack = []         # the open spans, innermost last
        self.totals = collections.defaultdict(collections.Counter)  # proof -> counts


_rec = _Recorder()


def span(name: str):
    """A context manager that records the span `name` around its block
    (closed on an exception too); while tracing is off, one that does
    nothing."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return Span(name)


def proof():
    """The root span ``proof``, or a span that does nothing where a proof's
    root is open already (``create_proof`` called by ``Wnn.proof``)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    stack = _rec.stack
    if stack and stack[-1].proof is not None:
        return _NULL
    return Span("proof")


def spanned(name: str):
    """Decorates a function to run inside the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return wrapped
    return wrap


def count(name: str, n: int = 1):
    """Adds `n` to the counter `name` of the innermost open span and of the
    total of its proof."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _rec.stack
    top = stack[-1] if stack else None
    if top is not None:
        top.counts[name] = top.counts.get(name, 0) + n
    _rec.totals[None if top is None else top.proof][name] += n


class Phases:
    """Spans ``prefix + name`` for the `names` in their order, one after the
    other with no gap: :meth:`start` opens the first, each :meth:`mark`
    closes the open one, which has to be the `name` it is given, and opens
    the next at the same instant; :meth:`stop` closes what is open. Whether
    they record is decided at :meth:`start`. Each returns the ns it stamped,
    or None while off."""

    def __init__(self, prefix: str, names):
        self.prefix = prefix
        self.names = tuple(names)
        self.i = 0
        self.open = None

    def start(self):
        if not _profiler._is_profiler_enabled:
            return None
        t = time.time_ns()
        self.open = Span(self.prefix + self.names[0]).open(t)
        return t

    def mark(self, name: str):
        if name != self.names[self.i]:
            raise ValueError(f"phase {name!r} marked where {self.names[self.i]!r} is open")
        self.i += 1
        if self.open is None:
            return None
        t = time.time_ns()
        self.open.close(t)
        self.open = (Span(self.prefix + self.names[self.i]).open(t)
                     if self.i < len(self.names) else None)
        return t

    def stop(self):
        if self.open is not None:
            self.open.close(time.time_ns())
            self.open = None


def spans() -> list:
    """Every span recorded since the last :func:`reset`, open ones too, in
    order of opening (a span's ``id`` is its index)."""
    return list(_rec.records)


def summary() -> dict:
    """The closed spans and the counters, since the last :func:`reset`:

    - ``spans``: per span name, ``count``, ``seconds`` (summed durations),
      ``self_seconds`` (less the part their child spans cover) and
      ``counts`` (counters added while such a span was the innermost);
    - ``counters``: every counter's total, inside a proof or not;
    - ``proofs``: the number of closed root spans ``proof``;
    - ``per_proof``: each closed proof's counter totals, in order.
    """
    records = _rec.records
    child_ns = collections.Counter()
    for s in records:
        if s.end_ns is not None and s.parent is not None:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out = {}
    for s in records:
        if s.end_ns is None:
            continue
        e = out.get(s.name)
        if e is None:
            e = out[s.name] = dict(count=0, seconds=0.0, self_seconds=0.0, counts={})
        dur = s.end_ns - s.start_ns
        e["count"] += 1
        e["seconds"] += dur / 1e9
        e["self_seconds"] += (dur - child_ns[s.id]) / 1e9
        for k, v in s.counts.items():
            e["counts"][k] = e["counts"].get(k, 0) + v
    counters = collections.Counter()
    for c in _rec.totals.values():
        counters.update(c)
    return dict(spans=out, counters=dict(counters),
                proofs=out.get("proof", {}).get("count", 0),
                per_proof=[dict(_rec.totals.get(s.id, {})) for s in records
                           if s.proof == s.id and s.end_ns is not None])


def reset():
    """Forgets every span and counter."""
    global _rec
    _rec = _Recorder()
