"""Seeded choices of what to hold against the reference."""
from __future__ import annotations

import random
from typing import Dict, Hashable


class Reservoir:
    """A uniform sample of `size` items of a stream of unknown length,
    drawn from the seed (algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.items: Dict[Hashable, object] = {}
        self.seen = 0

    def offer(self, key: Hashable, make) -> None:
        """Consider item `key`; `make()` gives its value when kept."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items[key] = make()
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            del self.items[list(self.items)[j]]
            self.items[key] = make()

    def kept(self) -> Dict[Hashable, object]:
        return dict(self.items)
