"""The ``view_2dgs`` kind: ``kinds/view.py``'s client, window, check and
control, whose reference is 2D Gaussian Splatting's
(``reference/surfel.py``) in place of 3D Gaussian Splatting's: a private
copy of ``kinds/view.py`` with its reference module bound to the surfel
reference."""

from __future__ import annotations

import os

from benchmark import harness
from benchmark.reference import surfel

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_view = harness._module("kinds", "view", BENCH)
_view.R = surfel

run = _view.run
control_readings = _view.control_readings
