"""One reader per metric, named as the metric: ``read(run)`` takes a
``lpabench.bench.Run`` and returns the metric's value, or None where the
run holds nothing to read (the metric is then left out of the line)."""
