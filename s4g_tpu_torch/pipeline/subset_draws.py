"""The detector's capacity subsets, drawn one call ahead on a worker thread.

`GraspDetector` fits a cloud of more points than its capacity to a seeded
subset: numpy's legacy `RandomState.choice(n, capacity, replace=False)`,
the first `capacity` entries of a permutation of n, scene by scene.  The
draw depends on the generator's state and the scenes' sizes alone, never
on their points, so `SubsetDraws.draws` hands out the draws a worker made
from the state the previous call left, where the generator, its state and
the sizes are what that call saw; else it draws inline.  Either way the
subsets, and the generator's state after them, are the inline draws' bit
for bit.

The worker permutes through `np.random.Generator` over an MT19937 in the
generator's state: its shuffle is the legacy one (the same `random_interval`
draws, from the last entry down) but runs with the interpreter lock
released, where the legacy shuffle holds it and would stall the thread
that launches the device's work.  numpy does not promise Generator's
streams across versions, so `_generator_is_legacy` checks the two against
each other once a process, and where they differ the worker draws with a
`RandomState` as the inline path does.

Clouds whose sizes change from call to call (points masked out) miss: they
pay the inline draw, and the worker's draw is wasted."""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..utils.profiling import count, span


def _same_state(a: tuple, b: tuple) -> bool:
    """Two `RandomState.get_state()` tuples: MT19937's key array, its
    position, and the cached Gaussian."""
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


def _choose(rng: np.random.RandomState, sizes: tuple, capacity: int):
    """The subsets of `sizes` drawn inline from `rng`."""
    return [rng.choice(n, capacity, replace=False) if n > capacity else None
            for n in sizes]


def _permute(state: tuple, sizes: tuple, capacity: int):
    """The subsets of `sizes` from the legacy `state`, and the state after
    them, by `Generator.permutation` (the interpreter lock released)."""
    bits = np.random.MT19937()
    bits.state = {"bit_generator": "MT19937",
                  "state": {"key": state[1], "pos": state[2]}}
    gen = np.random.Generator(bits)
    subsets = [gen.permutation(n)[:capacity] if n > capacity else None
               for n in sizes]
    after = bits.state["state"]
    return subsets, (state[0], after["key"], after["pos"], *state[3:])


@functools.cache
def _generator_is_legacy() -> bool:
    """Whether `Generator.permutation` over an MT19937 equals `RandomState.
    choice(..., replace=False)` from the same state, and leaves the same
    state."""
    rng, sizes = np.random.RandomState(20260101), (4099, 700)
    got, after = _permute(rng.get_state(), sizes, 512)
    want = _choose(rng, sizes, 512)
    return (all(np.array_equal(a, b) for a, b in zip(got, want))
            and _same_state(after, rng.get_state()))


def _draw_ahead(state: tuple, sizes: tuple, capacity: int):
    """The worker's draw: the subsets from `state` and the state after."""
    with span("fit.ahead"):
        if _generator_is_legacy():
            return _permute(state, sizes, capacity)
        rng = np.random.RandomState()
        rng.set_state(state)
        return _choose(rng, sizes, capacity), rng.get_state()


class SubsetDraws:
    """A detector's subset draws, one call ahead.  The worker thread starts
    with the first draw; it holds no reference to the detector and ends
    when this object is freed."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._pool: Optional[ThreadPoolExecutor] = None
        # (generator, its state, sizes, future) of the draw made ahead.
        self._ahead = None

    def draws(self, rng: np.random.RandomState,
              sizes: Sequence[int]) -> List[Optional[np.ndarray]]:
        """Per scene, the indices of the `capacity` points `rng.choice`
        keeps of a scene of more points, else None; `rng` is left as the
        inline draws leave it.  Counts `ahead_hits` / `ahead_misses` a
        scene drawn on the innermost open span (`detect.fit`), then draws
        the next call's subsets for the same sizes ahead."""
        sizes = tuple(int(n) for n in sizes)
        drawn = sum(n > self.capacity for n in sizes)
        if not drawn:
            return [None] * len(sizes)
        state = rng.get_state()
        ahead, self._ahead = self._ahead, None
        if (ahead is not None and ahead[0] is rng and ahead[2] == sizes
                and _same_state(ahead[1], state)):
            subsets, state = ahead[3].result()
            rng.set_state(state)
            count("ahead_hits", drawn)
        else:
            if ahead is not None:       # drawn for another state or sizes:
                ahead[3].cancel()       # its result is never read
            subsets = _choose(rng, sizes, self.capacity)
            state = rng.get_state()
            count("ahead_misses", drawn)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                1, thread_name_prefix="subset-draws")
        self._ahead = (rng, state, sizes, self._pool.submit(
            _draw_ahead, state, sizes, self.capacity))
        return subsets
