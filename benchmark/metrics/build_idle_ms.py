"""Device idle ms a traced request while a build span
(``benchmark.spans.LAYER``) was the innermost open on the host. Reads
``build_idle_ms.<anything>``."""

from benchmark import spans as S


def read(ctx):
    return S.idle_ms(ctx, "build")
