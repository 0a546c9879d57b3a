"""Reports over the port's outputs (``python -m repro_torch.analysis.report``)."""
