"""Utilities: state carried across from the JAX package, I/O, caching,
timers, logging, Paraview output, spectra."""

from . import convert  # noqa: F401
from . import io  # noqa: F401
from . import vtk  # noqa: F401
from .convert import (  # noqa: F401
    carry_from_jax,
    inverse_solver_from_numpy,
    problem_from_numpy,
    problem_to_numpy,
)
from .io import (  # noqa: F401
    Timer,
    get_datastr,
    load_npa,
    load_or_comp,
    load_spa,
    logtofile,
    meas_output_diff,
    plot_outp_sig,
    save_npa,
    save_output_json,
    save_spa,
)
