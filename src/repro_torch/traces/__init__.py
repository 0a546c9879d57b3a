"""Synthetic trace generators (numpy copies of the reference's)."""
from .synthetic import (zipf_probs, zipf_trace, youtube_dynamic_trace,
                        wiki_drift_trace, spc1_like_trace, oltp_like_trace,
                        glimpse_trace, fickle_churn_trace, phase_shift_trace,
                        scan_then_hotspot_trace, multi_tenant_prompt_trace,
                        panel_traces)

__all__ = ["zipf_probs", "zipf_trace", "youtube_dynamic_trace",
           "wiki_drift_trace", "spc1_like_trace", "oltp_like_trace",
           "glimpse_trace", "fickle_churn_trace", "phase_shift_trace",
           "scan_then_hotspot_trace", "multi_tenant_prompt_trace",
           "panel_traces"]
