"""Device idle ms a traced request while the appearance head's span
(``viewer.appearance``) was the innermost open on the host
(``benchmark.appearance_spans``). Reads ``appearance_idle_ms.<anything>``."""

from benchmark import appearance_spans as A


def read(ctx):
    return A.idle_ms(ctx, "appearance")
