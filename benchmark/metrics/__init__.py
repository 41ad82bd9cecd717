"""Per-layer metric readers, one file per metric name (the part before the
first dot). ``read(driver, suffix)`` returns the value, or None when the
run has nothing to read: the metric is then left out of the result."""
