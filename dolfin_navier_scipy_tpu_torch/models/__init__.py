"""Problem setups: geometry descriptors -> device-ready NSE problems.

The analogue of the reference's ``problem_setups.py`` registry
(drivencavity / cylinderwake).
"""

from .problem import NSEProblem, build_problem, GeoSetup  # noqa: F401
from .drivencavity import drivencavity_problem  # noqa: F401
from .cylinderwake import cylinderwake_problem, geosetup_from_json  # noqa: F401
from .functionals import (  # noqa: F401
    LiftDragSurfForce,
    make_inscan_liftdrag,
    pressure_drop,
)
