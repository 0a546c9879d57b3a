"""Multi-rank execution of the port (``torch.distributed``)."""
