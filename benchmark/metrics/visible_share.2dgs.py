"""The share of the live surfels with a screen footprint, in percent: the
``n_visible`` count of each traced request's ``render.project`` span
(``rasterization_2dgs``) over the configuration's live rows, the mean
over the traced requests. Reads ``visible_share.2dgs``; nothing where
the program recorded no such count (a program without the surfel path)."""

from benchmark import spans as S


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    prof = S._profiling()
    if prof is None:
        return None
    seen = [dict(r.counts)["n_visible"] for r in prof.spans()
            if "n_visible" in dict(r.counts)]
    if not seen:
        return None
    return 100.0 * (sum(seen) / len(seen)) / int(ctx.cfg["n_gaussians"])
