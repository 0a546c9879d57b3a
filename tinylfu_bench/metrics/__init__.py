"""One reader a metric: ``metrics/<name>.py`` holds ``read(ctx)``, which
takes a ``harness.Context`` and returns the metric's value, or None when
the run holds nothing for it to read."""
