"""Utilities: state carried across from the JAX package."""

from . import convert  # noqa: F401
from .convert import (  # noqa: F401
    carry_from_jax,
    inverse_solver_from_numpy,
    problem_from_numpy,
    problem_to_numpy,
)
