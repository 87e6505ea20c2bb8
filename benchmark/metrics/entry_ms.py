"""Device ms a traced request of the device operations enqueued while an
entry span (``benchmark.spans.LAYER``) was the innermost open on the
host. Reads ``entry_ms.<anything>``."""

from benchmark import spans as S


def read(ctx):
    return S.device_ms(ctx, "entry")
