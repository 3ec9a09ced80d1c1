"""Solvers: saddle-point linear algebra, steady Stokes, time integrators."""

from .sadpnt import (  # noqa: F401
    InverseSaddleSolver,
    host_saddle_factorized,
    solve_sadpnt_host,
)
from .steady import solve_steadystate_nse  # noqa: F401
from .pfromv import get_pfromv  # noqa: F401
from .timeint import cnab, sbdf2, semi_implicit_euler  # noqa: F401
from .nse import solve_nse  # noqa: F401
