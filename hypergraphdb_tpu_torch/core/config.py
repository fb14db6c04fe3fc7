"""Configuration: the memory-backend subset of ``HGConfiguration``.

The port runs the in-memory store only. A ``store_backend`` other than
``"memory"`` raises :class:`HGException` when a graph opens, as the JAX
package does for a backend its build lacks.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CacheConfig:
    """Host cache sizing in entries."""

    atom_cache_size: int = 1 << 20
    incidence_cache_entries: int = 1 << 16
    max_cached_incidence_set_size: int = 1 << 20


@dataclass
class HGConfiguration:
    transactional: bool = True
    keep_incident_links_on_removal: bool = False
    store_backend: str = "memory"
    handle_factory: str = "sequential"  # "sequential" | "uuid"
    cache: CacheConfig = field(default_factory=CacheConfig)
