"""Bounded histograms for the scheduler's wait-time samples.

A copy of ``BoundedHistogram`` from ``repro.obs.registry``; the rest of that
module (the metrics registry) waits for the slice that ports the exporters.
"""

from __future__ import annotations

import random
from typing import Iterator


class BoundedHistogram:
    """Bounded sample reservoir with exact quantiles under the cap.

    Behaves like the list it replaces (append / len / index / iterate) but
    retains at most ``cap`` samples: Vitter's algorithm R over a private
    seeded RNG once full.  ``n`` (true count), ``total``, ``vmin``/``vmax``
    are always exact; ``percentile`` is exact while ``n <= cap`` and an
    unbiased estimate beyond.
    """

    __slots__ = ("cap", "n", "total", "vmin", "vmax", "_samples", "_rng")

    def __init__(self, cap: int = 8192, seed: int = 0x0B5E) -> None:
        if cap < 1:
            raise ValueError("cap must be >= 1")
        self.cap = cap
        self.n = 0
        self.total = 0
        self.vmin: float | None = None
        self.vmax: float | None = None
        self._samples: list = []
        self._rng = random.Random(seed)

    def append(self, v) -> None:
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        if len(self._samples) < self.cap:
            self._samples.append(v)
        else:
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self._samples[j] = v

    observe = append

    def extend(self, vs) -> None:
        for v in vs:
            self.append(v)

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, i):
        return self._samples[i]

    def __iter__(self) -> Iterator:
        return iter(self._samples)

    def __bool__(self) -> bool:
        return bool(self._samples)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, q: float):
        """Nearest-rank percentile of the retained samples, ``q`` in [0, 100]."""
        if not self._samples:
            return 0
        s = sorted(self._samples)
        return s[min(len(s) - 1, int(q / 100.0 * len(s)))]

    def summary(self) -> dict:
        return {
            "count": self.n,
            "sum": self.total,
            "min": self.vmin if self.vmin is not None else 0,
            "max": self.vmax if self.vmax is not None else 0,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "retained": len(self._samples),
        }
