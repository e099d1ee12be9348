"""Per-layer metric readers: `read(ctx, **params)` → a number, or None
where the run holds nothing for it to read (the harness then leaves the
metric out of the line).  `params` come from the metric's file in
benchmark/metrics/."""
