"""Per-layer metric readers, one file per metric named as in BENCHMARK.json.
Each has ``read(ctx)``, which returns the metric's value or None where the
run holds nothing to read it from, and may have ``before_window(ctx)`` and
``after_window(ctx)``. ``ctx`` holds the cell's ``config`` and ``workload``,
a ``store`` dict for the hooks, the traced ``slice`` (``trace.Slice``), the
``record`` of every call (``drive.Record``), ``calls`` (the indices of the
window's calls: a traced run times its window as an untraced one does, and
the traced slice follows it) and the kernel counts' ``shapes``."""
