"""Seeded fault injection of the port: node-readiness flaps.

A copy of ``NodeFlapInjector`` from ``kueue_oss_tpu/chaos/__init__.py``
(:384-421). The JAX package's other injectors (the solver sidecar's
faults, mesh loss, crash points, cluster loss and the campaign layer)
are cut: the port has no sidecar, mesh, persistence or federation
layer for them to break.
"""

from __future__ import annotations

import random
from typing import Optional


class NodeFlapInjector:
    """Seeded node-readiness flapping against the store.

    ``flap_down`` marks nodes NotReady (given names, or a seeded sample
    of the sorted ready node names: ``random.Random(seed).sample``, the
    draw the JAX package makes); ``flap_up`` restores them. Pairing the
    two inside or outside the failure controller's grace period drives
    the flap-recovery path deterministically.
    """

    def __init__(self, store, seed: int = 0) -> None:
        self.store = store
        self._rng = random.Random(seed)
        self._down: list[str] = []

    def flap_down(self, count: int = 1,
                  names: Optional[list[str]] = None) -> list[str]:
        if names is None:
            pool = sorted(n for n, node in self.store.nodes.items()
                          if node.ready)
            names = self._rng.sample(pool, min(count, len(pool)))
        for n in names:
            node = self.store.nodes[n]
            node.ready = False
            self.store.upsert_node(node)
        self._down.extend(names)
        return list(names)

    def flap_up(self, names: Optional[list[str]] = None) -> list[str]:
        if names is None:
            names, self._down = self._down, []
        else:
            self._down = [n for n in self._down if n not in names]
        for n in names:
            node = self.store.nodes.get(n)
            if node is not None:
                node.ready = True
                self.store.upsert_node(node)
        return list(names)


__all__ = ["NodeFlapInjector"]
