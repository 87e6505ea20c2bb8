"""Device ms a traced request of the device operations enqueued while the
appearance head's span (``viewer.appearance``) was the innermost open on
the host (``benchmark.appearance_spans``). Reads
``appearance_ms.<anything>``."""

from benchmark import appearance_spans as A


def read(ctx):
    return A.device_ms(ctx, "appearance")
