"""Device idle ms a traced request while no program span was open on the
host: the client's own loop between requests, with the appearance head's
span charged to its own layer (``benchmark.appearance_spans``). Reads
``outside_idle_ms.app``."""

from benchmark import appearance_spans as A


def read(ctx):
    return A.idle_ms(ctx, "outside")
