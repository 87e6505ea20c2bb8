"""Device idle ms a traced request while no program span was open on the
host: the client's own loop between requests (``benchmark.spans``).
Reads ``outside_idle_ms.<anything>``."""

from benchmark import spans as S


def read(ctx):
    return S.idle_ms(ctx, "outside")
