"""The build sort's share of useful keys, in percent: the ``n_isect``
count of each traced request's ``render.build`` span over its
``exp_cap`` (the keys the build sorts), the mean over the traced
requests. Reads ``sort_use.<anything>``."""

from benchmark import spans as S


def read(ctx):
    return S.sort_use(ctx)
