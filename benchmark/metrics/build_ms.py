"""Device ms a traced request of the device operations enqueued while a
build span (``benchmark.spans.LAYER``) was the innermost open on the
host. Reads ``build_ms.<anything>``."""

from benchmark import spans as S


def read(ctx):
    return S.device_ms(ctx, "build")
