"""Device operations a unit (step or pair) of the traced window."""


def read(record, trace):
    if trace is None or not record.get("units"):
        return None
    return trace.n_device_ops / record["units"]
