"""Jittered exponential restart backoff with success reset — the same
hygiene PushRouter applies to request retries, applied to process
restarts so a crash-looping child can't hot-spin the host. Lives in its
own module so non-HTTP supervisors (the worker dp spawner) can import it
without dragging in the fleet supervisor's aiohttp stack."""

from __future__ import annotations

import random


class BackoffPolicy:
    def __init__(
        self,
        base: float = 0.5,
        max_delay: float = 10.0,
        reset_after: float = 30.0,
        rng: random.Random | None = None,
    ):
        self.base = base
        self.max_delay = max_delay
        self.reset_after = reset_after
        self._rng = rng or random.Random()

    def delay(self, failures: int) -> float:
        raw = min(self.base * (2 ** max(failures - 1, 0)), self.max_delay)
        return raw * (0.5 + self._rng.random())  # jitter in [0.5x, 1.5x)
