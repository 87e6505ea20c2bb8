"""Device ms a traced request of the device operations enqueued while a
kernels span (``benchmark.spans.LAYER``) was the innermost open on the
host. Reads ``kernels_ms.<anything>``."""

from benchmark import spans as S


def read(ctx):
    return S.device_ms(ctx, "kernels")
