"""[PyTorch port: a copy of ``repro.obs.trace``, kept here so the port imports
nothing of the JAX package.]

Deterministic-clock causal spans.

A ``Span`` is an interval ``[start, end]`` on whatever clock the caller
already keeps (scheduler ticks, fleet-sim event time, engine stall cycles)
— the tracer never reads a wall clock and never draws randomness, so a
traced run replays bit-for-bit.  Causality is structural: a span begun
while another span of the same trace is open becomes its child, which is
exactly the shape of the serving stack (``session`` ⊃ ``request`` ⊃
``queue_wait`` / ``prefill`` / ``decode``).

``NULL_TRACER`` is the off switch: falsy, method-compatible, allocation
free.  Instrumentation sites guard with ``if self.tracer:`` so the disabled
path is one truthiness check — the zero-cost-off contract the cross-driver
grant-order tests pin.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Iterator


def trace_key(item: Any) -> Any:
    """Stable per-request trace id: ``rid`` (engine requests), ``sid``
    (router sessions), or the item itself for plain str/int payloads."""
    for attr in ("rid", "sid"):
        v = getattr(item, attr, None)
        if v is not None:
            return v
    if isinstance(item, (str, int)):
        return item
    return str(item)


@dataclass
class Span:
    """One named interval of one trace; ``end == -1`` while still open."""

    name: str
    trace: Any
    span_id: int
    parent_id: int | None
    start: int
    end: int = -1
    attrs: dict = field(default_factory=dict)
    events: list = field(default_factory=list)

    @property
    def open(self) -> bool:
        return self.end < 0

    @property
    def duration(self) -> int:
        return 0 if self.open else self.end - self.start

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace": self.trace,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "attrs": dict(self.attrs),
            "events": [
                {"name": n, "t": t, "attrs": dict(a)} for n, t, a in self.events
            ],
        }


def _event_attrs(ev: Any) -> dict:
    """Flatten a discipline event (``Scan``/``Shuffle``/``SecondaryFlush``/
    ``Park``/``Unpark``) into JSON-safe attrs — payload items are reduced to
    their trace key so spans never pin request objects alive."""
    if dataclasses.is_dataclass(ev) and not isinstance(ev, type):
        out = {}
        for f in dataclasses.fields(ev):
            v = getattr(ev, f.name)
            out[f.name] = v if isinstance(v, (int, float, str, bool, type(None))) else trace_key(v)
        return out
    return {"value": str(ev)}


class Tracer:
    """Collects spans under a caller-supplied deterministic clock.

    Every mutation takes an explicit time ``t`` — the tracer has no clock of
    its own.  ``begin`` with no explicit parent nests under the innermost
    open span of the same trace, which makes causal linking automatic when
    the layers share one tracer (router opens ``session``, engine opens
    ``request`` inside it, scheduler emits ``queue_wait`` inside that).
    """

    enabled = True

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._open: dict[Any, list[Span]] = {}
        self._next_id = 0

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self.spans)

    # -- span lifecycle ---------------------------------------------------
    def begin(self, name: str, trace: Any, t: int, parent: Span | None = None, **attrs) -> Span:
        stack = self._open.setdefault(trace, [])
        if parent is None and stack:
            parent = stack[-1]
        sp = Span(name, trace, self._next_id, parent.span_id if parent else None, t, attrs=attrs)
        self._next_id += 1
        self.spans.append(sp)
        stack.append(sp)
        return sp

    def end(self, span: Span | None, t: int, **attrs) -> None:
        if span is None or not span.open:
            return
        span.end = max(t, span.start)
        if attrs:
            span.attrs.update(attrs)
        stack = self._open.get(span.trace)
        if stack and span in stack:
            stack.remove(span)

    def span(self, name: str, trace: Any, start: int, end: int, parent: Span | None = None, **attrs) -> Span:
        """Emit an already-closed span (attribution intervals, instant
        events with duration zero).  Auto-parents like ``begin``."""
        stack = self._open.get(trace)
        if parent is None and stack:
            parent = stack[-1]
        sp = Span(
            name, trace, self._next_id, parent.span_id if parent else None,
            start, max(end, start), attrs,
        )
        self._next_id += 1
        self.spans.append(sp)
        return sp

    def event(self, span: Span | None, name: str, t: int, **attrs) -> None:
        if span is not None:
            span.events.append((name, t, attrs))

    def discipline_events(self, span: Span | None, events, t: int) -> None:
        """Attach a grant's discipline-level events (``Shuffle``,
        ``SecondaryFlush``, …) to a span as child events."""
        if span is None:
            return
        for ev in events:
            span.events.append((type(ev).__name__.lower(), t, _event_attrs(ev)))

    # -- queries ----------------------------------------------------------
    def open_span(self, trace: Any, name: str | None = None) -> Span | None:
        """Innermost open span of ``trace`` (optionally by name)."""
        for sp in reversed(self._open.get(trace, ())):
            if name is None or sp.name == name:
                return sp
        return None

    def for_trace(self, trace: Any) -> list[Span]:
        return [sp for sp in self.spans if sp.trace == trace]

    def traces(self) -> list:
        seen: dict = {}
        for sp in self.spans:
            seen.setdefault(sp.trace, None)
        return list(seen)

    def check(self) -> list[Span]:
        """Spans still open — empty after a fully-drained run."""
        return [sp for stack in self._open.values() for sp in stack]

    def phase_cycles(self, trace: Any) -> dict:
        """Per-phase attribution for one trace: sums the ``cycles`` attr of
        its ``phase.*`` spans — the quantity the conservation law pins."""
        out: dict = {}
        for sp in self.spans:
            if sp.trace == trace and sp.name.startswith("phase."):
                key = sp.name[len("phase."):]
                out[key] = out.get(key, 0) + sp.attrs.get("cycles", sp.duration)
        return out

    def __iter__(self) -> Iterator[Span]:
        return iter(self.spans)


class NullTracer:
    """Falsy no-op stand-in: the disabled path costs one truthiness check."""

    enabled = False
    spans: tuple = ()

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())

    def begin(self, *a, **k):
        return None

    def end(self, *a, **k):
        return None

    def span(self, *a, **k):
        return None

    def event(self, *a, **k):
        return None

    def discipline_events(self, *a, **k):
        return None

    def open_span(self, *a, **k):
        return None

    def for_trace(self, trace):
        return []

    def traces(self):
        return []

    def check(self):
        return []

    def phase_cycles(self, trace):
        return {}


NULL_TRACER = NullTracer()
