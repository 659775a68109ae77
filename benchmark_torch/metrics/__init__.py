"""Metric readers: ``<metric>.py`` holds ``read(run)``, which returns the
metric's value from a ``common.harness.Run``, or None where it finds
nothing to read (the harness then leaves the metric out of the line)."""
