"""Solvers: saddle-point linear algebra, steady Stokes, time integrators."""

from .sadpnt import (  # noqa: F401
    InverseSaddleSolver,
    SaddleSolver,
    SchurSaddleSolver,
    SMWSolver,
    apply_massinv,
    jacobi_pcg,
    host_saddle_factorized,
    solve_sadpnt,
    solve_sadpnt_host,
)
from .steady import (  # noqa: F401
    solve_steadystate_nse, solve_steadystate_pseudotime)
from .convconts import expand_vp, get_bcinds, get_v_conv_conts  # noqa: F401
from .krylov import (  # noqa: F401
    KrylovCounter, device_fgmres, device_pgmres, solve_sadpnt_krylov)
from .krylov_saddle import KrylovSaddleSolver, build_krylov_ops  # noqa: F401
from .pfromv import get_pfromv  # noqa: F401
from .timeint import (  # noqa: F401
    DirichletControl, cnab, sbdf2, semi_implicit_euler)
from .nse import solve_nse  # noqa: F401
from .adjoint import make_diff_cnab  # noqa: F401
from .newton_ti import solve_nse_newton_ti  # noqa: F401
