"""Serving layer of the port: decode engine, CNA admission, slot cache, prefix index, prefix-KV store."""

from .engine import DecodeEngine, Request  # noqa: F401
from .kvcache import SlotCache  # noqa: F401
from .prefixindex import PrefixIndex  # noqa: F401
from .prefixkv import PrefixKVStore  # noqa: F401
from .scheduler import CNAScheduler, FIFOScheduler, SchedulerMetrics  # noqa: F401
