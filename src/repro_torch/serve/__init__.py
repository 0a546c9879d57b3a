"""Serving side of the port: the prefix cache with TinyLFU admission on the
host sketch or the card (``prefix_cache``), ``extend`` and the
``ServeEngine``."""
from .prefix_cache import (block_hashes, PayloadPool, HostAdmission,
                           DeviceAdmission, PrefixCacheStats, PrefixCache)
from .engine import Request, ServeEngine
from .extend import extend

__all__ = ["block_hashes", "PayloadPool", "HostAdmission", "DeviceAdmission",
           "PrefixCacheStats", "PrefixCache", "Request", "ServeEngine",
           "extend"]
