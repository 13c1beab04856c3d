"""Device-timeline ms a traced unit of K6's backward launches
(`hash.encode_grad`, inside `ngp.backward`, on autograd's device thread):
from the stream reaching the span's first event to it reaching its last.
None where the program has no such span."""
from benchmark.metrics.stage_spans import stage_ms


def read(record, trace):
    return stage_ms(record, trace, "encode_grad")
