"""TinyLFU core of the port: the host engine (sketch, admission, W-TinyLFU
and the cache policies it is evaluated against, all plain Python and numpy,
as in the reference) and the device trace engine (``device_simulate``, the
step kernel's driver), with the hashing and geometry both share."""
from .sketch import (FrequencySketch, ShardedFrequencySketch, SketchConfig,
                     ExactHistogram, default_sketch)
from .tinylfu import TinyLFUAdmission, tinylfu_cache
from .wtinylfu import WTinyLFU, AdaptiveWTinyLFU
from .policies import (
    Cache, Eviction, LRUEviction, FIFOEviction, RandomEviction, LFUEviction,
    SLRUEviction, ReplacementPolicy, ARC, LIRS, TwoQ, WLFU, PLFU,
    SetAssocS3FIFO, SetAssocARC, SetAssocLFU,
)
from .simulate import run_trace, run_matrix, SimResult, save_results, \
    load_results, theoretical_max_hit_ratio

__all__ = [
    "FrequencySketch", "ShardedFrequencySketch", "SketchConfig",
    "ExactHistogram", "default_sketch",
    "TinyLFUAdmission", "tinylfu_cache", "WTinyLFU", "AdaptiveWTinyLFU",
    "Cache", "Eviction", "LRUEviction", "FIFOEviction", "RandomEviction",
    "LFUEviction", "SLRUEviction", "ReplacementPolicy", "ARC", "LIRS", "TwoQ",
    "WLFU", "PLFU", "SetAssocS3FIFO", "SetAssocARC", "SetAssocLFU",
    "run_trace", "run_matrix", "SimResult", "save_results", "load_results",
    "theoretical_max_hit_ratio",
]
