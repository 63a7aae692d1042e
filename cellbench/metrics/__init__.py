"""One reader a metric, named as in ``BENCHMARK.json``: ``read(ctx)``
returns the metric's value, or None where the run has nothing for it to
read.  ``ctx`` is the run (``harness.Run``): its host clock readings,
the program's reports and, in a traced run, ``spans`` (the program's
tracer records) and ``trace`` (``trace.Profile.summary()``)."""
