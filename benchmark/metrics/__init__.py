"""Per-layer metrics, one reader a file: `read(ctx)` takes the metric from
the traced run's spans, counters and trace (harness/run_cell.Context) and
returns it, or None where it finds nothing to read."""
