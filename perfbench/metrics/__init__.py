"""Per-layer metric readers, one file per metric, found by the metric's
name: ``<name>.py``, or else ``<name before the first dot>.py`` (so
``idle_share.edit`` reads with ``idle_share.py``).  Each has
``read(trace) -> float | None``; ``trace`` is a ``devtrace.Trace`` of the
run's profiled steps.  A reader that finds nothing to read returns None,
and the metric is left out of the run's line."""
