"""Elastic membership manager (reference: python/paddle/distributed/fleet/
elastic/manager.py:125 ElasticManager — etcd membership watch, scale in/out,
rank-map regeneration, trainer relaunch)."""
from .manager import ElasticManager, ElasticStatus, FileStore, MemoryStore

__all__ = ["ElasticManager", "ElasticStatus", "FileStore", "MemoryStore"]
