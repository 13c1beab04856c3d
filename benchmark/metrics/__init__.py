"""Per-layer metric readers, one module per family: `read(record, trace)`
returns the metric from the driver's record of the window and the device
trace's summary (benchmark/harness/tracing.py), or None where there is
nothing to read (the harness then leaves the metric out of the line).
A share of a roofline or of a peak is never returned as 0 for want of a
reading."""
