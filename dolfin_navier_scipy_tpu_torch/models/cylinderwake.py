"""Cylinder-wake / generic boundary-controlled channel setups.

Covers the reference's ``cyl_fems`` + ``gen_bccont_fems``
(problem_setups.py:321-627, :773-987): DFG benchmark channel, parabolic
inflow, wall/moving-wall/control boundaries described by the JSON
geometry-descriptor schema of tests/mesh/*_geo_cntrlbc.json.
"""

import json

import numpy as np

from ..mesh.generators import channel_with_cylinder
from .problem import GeoSetup, build_problem


def parabola_inflow(xone, xtwo, normal, inflowvel):
    """Parabolic profile with unit mean: ``g(s) = 6 s (1-s) * inflowvel``
    along the segment xone->xtwo (problem_setups.py:1014-1041)."""
    xone = np.asarray(xone, dtype=float)
    xtwo = np.asarray(xtwo, dtype=float)
    normal = np.asarray(normal, dtype=float)
    lenb = np.linalg.norm(xtwo - xone)

    def fn(x):
        s = np.linalg.norm(np.asarray(x) - xone) / lenb
        return inflowvel * 6.0 * s * (1.0 - s) * normal

    return fn


def rotating_circle_fn(center, radius, omega):
    """Tangential velocity of a rotating cylinder surface
    (problem_setups.py:1083-1104): ``v = omega * r * t_hat``."""
    center = np.asarray(center, dtype=float)

    def fn(x):
        n = (np.asarray(x) - center) / radius
        return (-omega * radius * n[1], omega * radius * n[0])

    return fn


def control_shapefun(xone, xtwo):
    """Parabolic control shape function along a boundary segment, directed
    along the inward normal (problem_setups.py:990-1011)."""
    xone = np.asarray(xone, dtype=float)
    xtwo = np.asarray(xtwo, dtype=float)
    lencb = np.linalg.norm(xtwo - xone)
    tvec = (xtwo - xone) / lencb
    nvec = np.array([tvec[1], -tvec[0]])

    def fn(x):
        s = np.linalg.norm(np.asarray(x) - xone) / lencb
        return 6.0 * s * (1.0 - s) * nvec

    return fn


def arc_control_shapefun(center, radius, angle_deg, width_deg):
    """Parabolic control shape on a cylinder-surface arc, directed along
    the inward normal (native analogue of the reference's segment
    controls, problem_setups.py:990-1011)."""
    center = np.asarray(center, dtype=float)
    a0 = np.radians(angle_deg - width_deg / 2.0)
    a1 = np.radians(angle_deg + width_deg / 2.0)

    def fn(x):
        d = np.asarray(x) - center
        th = np.arctan2(d[1], d[0])
        s = ((th - a0) % (2 * np.pi)) / (a1 - a0)
        s = np.clip(s, 0.0, 1.0)
        nrm = -d / np.linalg.norm(d)     # inward normal
        return 6.0 * s * (1.0 - s) * nrm

    return fn


def geosetup_from_json(path_or_dict, inflowvel=1.0, movingwallcntrl=False,
                       rotcntrl_omega=0.0, bccontrol=True):
    """Parse the reference's geometry-descriptor JSON schema into
    :class:`GeoSetup` (problem_setups.py:829-962)."""
    if isinstance(path_or_dict, dict):
        d = path_or_dict
    else:
        with open(path_or_dict) as f:
            d = json.load(f)

    geo = GeoSetup(charlen=d["characteristic length"])
    inflw = d["inflow"]
    geo.inflow_tag = inflw["physical entity"]
    geo.inflow_fn = parabola_inflow(
        inflw["xone"], inflw["xtwo"], inflw["inward normal"], inflowvel
    )
    walls = d["walls"]["physical entity"]
    geo.wall_tags = list(walls) if isinstance(walls, (list, tuple)) else [walls]
    if "outflow" in d:
        geo.outflow_tag = d["outflow"]["physical entity"]

    geo.moving_wall_cntrl = movingwallcntrl
    for mw in d.get("moving walls", []):
        tag = mw["physical entity"]
        if mw["type"] != "circle":
            raise NotImplementedError(mw["type"])
        cgeo = mw["geometry"]
        # control: unit-omega stencil (scaled by the control function);
        # otherwise a static rotation at rotcntrl_omega (0 = rigid wall)
        omega = 1.0 if movingwallcntrl else rotcntrl_omega
        geo.moving_wall_tags.append(tag)
        geo.moving_wall_fns[tag] = rotating_circle_fn(
            cgeo["center"], cgeo["radius"], omega
        )

    for cbc in d.get("controlbcs", []):
        tag = cbc["physical entity"]
        geo.control_tags.append(tag)
        ctype = cbc.get("type", "inlet")
        if ctype == "inlet":
            geo.control_shapefuns.append(
                control_shapefun(cbc["xone"], cbc["xtwo"])
            )
        elif ctype == "arc":
            geo.control_shapefuns.append(
                arc_control_shapefun(cbc["center"], cbc["radius"],
                                     cbc["angle"], cbc["width"])
            )
        elif ctype == "rotating circle":
            # whole-surface tangential (rotation) control — the
            # reference's double-rotcyl Robin-control geometry
            # (2D-double-rotcyl_geo_cntrlbc_rotcntrl.json; consumed at
            # problem_setups.py:929-941)
            geo.control_shapefuns.append(
                rotating_circle_fn(cbc["center"], cbc["radius"], 1.0)
            )
        else:
            raise NotImplementedError(ctype)
    if not bccontrol:
        geo.wall_tags += geo.control_tags
        geo.control_tags, geo.control_shapefuns = [], []

    if "lift drag surface" in d:
        geo.liftdrag_tag = d["lift drag surface"]["physical entity"]
    geo.odcoo = d.get("observation-domain-coordinates")
    return geo


DFG_BENCH_GEO = {
    "characteristic length": 0.1,
    "walls": {"physical entity": [3, 4]},
    "outflow": {"physical entity": 2},
    "inflow": {
        "physical entity": 1,
        "inward normal": [1.0, 0.0],
        "xone": [0.0, 0.0],
        "xtwo": [0.0, 0.41],
    },
    "moving walls": [
        {
            "physical entity": 5,
            "type": "circle",
            "geometry": {"center": [0.2, 0.2], "radius": 0.05},
        }
    ],
    "lift drag surface": {"physical entity": 5},
}
"""The DFG 2D benchmark descriptor
(= tests/mesh/karman2D-rotcyl-bm_geo_cntrlbc.json of the reference)."""

DFG_CONTROL_ARCS = ((50.0, 15.0), (-50.0, 15.0))

DFG_BCCONTROL_GEO = dict(
    DFG_BENCH_GEO,
    controlbcs=[
        {"physical entity": 6, "type": "arc", "center": [0.2, 0.2],
         "radius": 0.05, "angle": DFG_CONTROL_ARCS[0][0],
         "width": DFG_CONTROL_ARCS[0][1]},
        {"physical entity": 7, "type": "arc", "center": [0.2, 0.2],
         "radius": 0.05, "angle": DFG_CONTROL_ARCS[1][0],
         "width": DFG_CONTROL_ARCS[1][1]},
    ],
)
"""DFG channel with two Robin-controllable arcs on the cylinder — the
native analogue of the reference's karman2D-outlets configuration."""


def cylinderwake_problem(
    level=1,
    nu=None,
    Re=None,
    charvel=0.2,
    scheme="TH",
    gradvsymmtrc=True,
    mesh=None,
    geodata=None,
    movingwallcntrl=False,
    rotcntrl_omega=0.0,
    bccontrol=False,
    device=None,
):
    """The DFG cylinder-wake benchmark problem on a native mesh.

    With ``movingwallcntrl`` the cylinder rotation becomes a control
    (reference 'cylinder_rot' problem class, problem_setups.py:125-128).
    """
    if mesh is None:
        mesh = channel_with_cylinder(
            level=level,
            control_arcs=DFG_CONTROL_ARCS if bccontrol else None)
    geo = geosetup_from_json(
        geodata or (DFG_BCCONTROL_GEO if bccontrol else DFG_BENCH_GEO),
        inflowvel=charvel,
        movingwallcntrl=movingwallcntrl,
        rotcntrl_omega=rotcntrl_omega,
        bccontrol=bccontrol,
    )
    return build_problem(mesh, geo, nu=nu, Re=Re, charvel=charvel,
                         gradvsymmtrc=gradvsymmtrc, scheme=scheme,
                         bccontrol=bccontrol, device=device)
