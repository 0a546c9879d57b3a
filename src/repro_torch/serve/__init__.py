"""Serving-side admission of the port: the prefix cache with TinyLFU
admission on the card (``prefix_cache``)."""
from .prefix_cache import (block_hashes, PayloadPool, DeviceAdmission,
                           PrefixCacheStats, PrefixCache)

__all__ = ["block_hashes", "PayloadPool", "DeviceAdmission",
           "PrefixCacheStats", "PrefixCache"]
