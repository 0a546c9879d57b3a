"""Synthetic trace generators (numpy copies of the reference's)."""
from .synthetic import (zipf_probs, zipf_trace, scan_then_hotspot_trace,
                        multi_tenant_prompt_trace)

__all__ = ["zipf_probs", "zipf_trace", "scan_then_hotspot_trace",
           "multi_tenant_prompt_trace"]
