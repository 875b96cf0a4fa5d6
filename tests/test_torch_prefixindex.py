"""The port's prefix index (``repro_torch.serving.prefixindex``) against the
reference's, on the CPU.

Seeded sequences of ``record``/``home``/``holders``/``summary`` over prompts
that share runs (so edges split) and a small capacity (so LRU leaves are
evicted) go through both indexes; every answer and counter must be equal.
"""

import numpy as np
import pytest

from repro.serving.prefixindex import PrefixIndex as RefIndex
from repro_torch.serving import PrefixIndex


def _prompts(rng, n, vocab=12):
    """Prompts built from a few shared stems with random tails."""
    stems = [rng.integers(0, vocab, int(rng.integers(1, 9))) for _ in range(4)]
    out = []
    for _ in range(n):
        stem = stems[int(rng.integers(0, len(stems)))]
        tail = rng.integers(0, vocab, int(rng.integers(0, 7)))
        cut = int(rng.integers(0, len(stem) + 1))
        out.append(np.concatenate([stem[:cut], tail]).astype(np.int32))
    return out


def _drive(cls, seed, capacity, n_domains):
    rng = np.random.default_rng(seed)
    occ = {d: 0 for d in range(n_domains)}
    idx = cls(n_domains=n_domains, occupancy=lambda: occ, capacity=capacity)
    seen = []
    for prompt in _prompts(rng, 200):
        op = rng.random()
        if op < 0.45:
            dom = int(rng.integers(0, n_domains))
            # numpy arrays and lists are the same key
            idx.record(prompt if rng.random() < 0.5 else prompt.tolist(), dom)
            occ[dom] += 1
        elif op < 0.75:
            seen.append(("home", idx.home(prompt)))
        elif op < 0.9:
            seen.append(("holders", idx.holders(prompt)))
        else:
            seen.append(("summary", idx.summary(int(rng.integers(1, 6)))))
            d = int(rng.integers(0, n_domains))
            occ[d] = max(0, occ[d] - 1)
        seen.append((len(idx), idx.n_nodes, idx.records, idx.lookups, idx.hits))
    return seen


@pytest.mark.parametrize("capacity", [6, 40, 1 << 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sequence_equals_reference(seed, capacity):
    ref = _drive(RefIndex, seed, capacity, n_domains=3)
    port = _drive(PrefixIndex, seed, capacity, n_domains=3)
    assert port == ref
    assert any(kind == "home" and dm[1] > 0 for kind, dm in
               (s for s in port if isinstance(s[0], str)))


def test_cold_unbounded_and_errors_match_reference():
    for cls in (RefIndex, PrefixIndex):
        idx = cls()
        assert idx.home([1, 2, 3]) == (None, 0)
        idx.record([], 0)  # ignored
        assert len(idx) == 0
        with pytest.raises(ValueError):
            idx.record([1], -1)
        with pytest.raises(ValueError):
            cls(capacity=0)
        bounded = cls(n_domains=2)
        with pytest.raises(ValueError):
            bounded.record([1], 2)
        bounded.record(np.array([4, 5, 6]), 1)
        assert bounded.home([4, 5, 9]) == (1, 2)
        bounded.clear()
        assert len(bounded) == 0 and bounded.home([4, 5]) == (0, 0)
