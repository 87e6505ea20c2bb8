"""Device idle ms a traced request while a projection span
(``benchmark.spans.LAYER``) was the innermost open on the host. Reads
``projection_idle_ms.<anything>``."""

from benchmark import spans as S


def read(ctx):
    return S.idle_ms(ctx, "projection")
