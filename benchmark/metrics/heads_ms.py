"""Device-timeline ms a traced unit of the correspondence decoder and the per-
layer weighted Kabsch (`regtr.heads`): from the stream reaching the span's
first event to it reaching its last, so the device's wait for the stage's
launches counts."""
from benchmark.metrics.stage_spans import stage_ms


def read(record, trace):
    return stage_ms(record, trace, "heads")
