"""Device-timeline ms a traced unit of the optimizer (`ngp.optimizer`: Adam and
the ray-bucket feedback; `regtr.optimizer`: GuardedAdamW and the pose
error): from the stream reaching the span's first event to it reaching its
last, so the device's wait for the stage's launches counts."""
from benchmark.metrics.stage_spans import stage_ms


def read(record, trace):
    return stage_ms(record, trace, "optimizer")
