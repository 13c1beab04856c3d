"""Device-timeline ms a traced unit of K6's forward launches (`hash.encode`,
inside `render.field` and the occupancy updates): from the stream reaching
the span's first event to it reaching its last. None where the program has
no such span."""
from benchmark.metrics.stage_spans import stage_ms


def read(record, trace):
    return stage_ms(record, trace, "encode")
