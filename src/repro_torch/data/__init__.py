"""The training data pipeline (``pipeline``)."""
