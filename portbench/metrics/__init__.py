"""One reader per metric of ``BENCHMARK.json``: ``<name>.py`` defines
``read(ctx)``, which returns the metric's value from the run's readings
(:mod:`portbench.readings`), or None when the run holds nothing to read
it from.  The harness loads a reader by its file's path, so a metric's
name may hold a dot."""
