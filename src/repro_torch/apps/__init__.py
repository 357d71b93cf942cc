"""Replicated applications (§7: Flip, Memcached/Redis-style KV, Liquibook)."""

from repro_torch.apps.flip import FlipApp
from repro_torch.apps.kvstore import KVStoreApp
from repro_torch.apps.matching import MatchingEngineApp

__all__ = ["FlipApp", "KVStoreApp", "MatchingEngineApp"]
