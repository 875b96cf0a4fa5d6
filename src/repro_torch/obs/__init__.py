"""Observability for the port: causal request spans and bounded histograms.

Copies of the parts of ``repro.obs`` that the scheduler and the engine use.
"""

from .registry import BoundedHistogram
from .trace import NULL_TRACER, NullTracer, Span, Tracer, trace_key

__all__ = ["BoundedHistogram", "NULL_TRACER", "NullTracer", "Span", "Tracer", "trace_key"]
