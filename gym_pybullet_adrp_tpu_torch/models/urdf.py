"""Drone URDF assets: parse and write reference-format drone URDFs.

Counterpart of gym_pybullet_adrp_tpu/models/urdf.py
(``parse_drone_urdf`` :54, ``drone_params_from_urdf`` :126,
``write_drone_urdf`` :141), on ``xml.etree`` and the port's
``DroneParams``. The reference reads 17 physical parameters out of its
drone URDFs (``BaseAviary._parseURDFParameters``, envs/BaseAviary.py:
989-1021): a ``<properties>`` element with the aerodynamic coefficients,
the base link's ``<inertial>`` mass and inertia, and its ``<collision>``
cylinder. The built-in models live in models/drone.py as data; this
module loads a user's own asset (found by tag, not by child position)
and writes one that loads in the reference and round-trips here.
"""

import xml.etree.ElementTree as ET
from os import PathLike
from typing import Union

import numpy as np
import torch

from .drone import DroneParams

# <properties> attributes (reference BaseAviary.py:998-1020) -> raw keys
_PROPERTIES_ATTRS = (
    "arm", "kf", "km", "thrust2weight", "max_speed_kmh", "gnd_eff_coeff",
    "prop_radius", "drag_coeff_xy", "drag_coeff_z",
    "dw_coeff_1", "dw_coeff_2", "dw_coeff_3",
)
# optional firmware/PWM attributes of the reference assets
# (assets/cf2x_IROS.urdf <properties>)
_OPTIONAL_ATTRS = ("pwm2rpm_scale", "pwm2rpm_const", "pwm_min", "pwm_max")


def _load_root(source: Union[str, PathLike]) -> ET.Element:
    if isinstance(source, str) and source.lstrip().startswith("<"):
        return ET.fromstring(source)
    return ET.parse(source).getroot()


def parse_drone_urdf(source: Union[str, PathLike]) -> dict:
    """A reference-format drone URDF (a path or an XML string) as a dict
    of the registry's keys (models/drone._REGISTRY: mass, arm,
    thrust2weight, J, kf, km, collision_h/r/z_offset, max_speed_kmh,
    gnd_eff_coeff, prop_radius, drag_coeff, dw_coeff_1..3) plus any
    optional PWM attribute present. Raises ``ValueError`` naming what is
    missing."""
    root = _load_root(source)
    props = root.find("properties")
    if props is None:
        raise ValueError("URDF has no <properties> element (drone "
                         "aerodynamic parameters)")
    missing = [a for a in _PROPERTIES_ATTRS if a not in props.attrib]
    if missing:
        raise ValueError(f"<properties> missing attributes: {missing}")
    p = {a: float(props.attrib[a]) for a in _PROPERTIES_ATTRS}

    link = root.find("link")
    if link is None:
        raise ValueError("URDF has no <link> element")
    inertial = link.find("inertial")
    if (inertial is None or inertial.find("mass") is None
            or inertial.find("inertia") is None):
        raise ValueError("base link has no <inertial><mass/><inertia/>")
    mass = float(inertial.find("mass").attrib["value"])
    inertia = inertial.find("inertia").attrib
    J = (float(inertia["ixx"]), float(inertia["iyy"]), float(inertia["izz"]))

    collision = link.find("collision")
    if collision is None:
        raise ValueError("base link has no <collision> element")
    cyl = collision.find("geometry/cylinder")
    if cyl is None:
        raise ValueError("collision geometry is not a <cylinder>")
    origin = collision.find("origin")
    xyz = (origin.attrib.get("xyz", "0 0 0") if origin is not None
           else "0 0 0")

    raw = dict(
        mass=mass, arm=p["arm"], thrust2weight=p["thrust2weight"], J=J,
        kf=p["kf"], km=p["km"],
        collision_h=float(cyl.attrib["length"]),
        collision_r=float(cyl.attrib["radius"]),
        collision_z_offset=float(xyz.split()[2]),
        max_speed_kmh=p["max_speed_kmh"], gnd_eff_coeff=p["gnd_eff_coeff"],
        prop_radius=p["prop_radius"],
        drag_coeff=(p["drag_coeff_xy"], p["drag_coeff_xy"],
                    p["drag_coeff_z"]),
        dw_coeff_1=p["dw_coeff_1"], dw_coeff_2=p["dw_coeff_2"],
        dw_coeff_3=p["dw_coeff_3"],
    )
    for a in _OPTIONAL_ATTRS:
        if a in props.attrib:
            raw[a] = float(props.attrib[a])
    return raw


def drone_params_from_urdf(source: Union[str, PathLike],
                           dtype=torch.float32,
                           device="cuda") -> DroneParams:
    """The ``DroneParams`` of a drone URDF, leaves on ``device`` (the card
    unless the caller asks for the CPU): ``models.drone.drone_params``
    for a user's asset; every env takes it."""
    raw = parse_drone_urdf(source)
    return DroneParams(**{
        k: torch.tensor(np.asarray(raw[k]), dtype=dtype, device=device)
        for k in DroneParams._fields})


def write_drone_urdf(raw: dict, path: Union[str, PathLike, None] = None,
                     name: str = "drone") -> str:
    """A minimal reference-compatible drone URDF of ``raw`` (the registry's
    keys, as ``parse_drone_urdf`` returns them), as a string, also written
    to ``path`` when given. ``parse_drone_urdf(write_drone_urdf(raw))``
    gives ``raw`` back exactly."""
    drag = raw["drag_coeff"]
    props = {
        "arm": raw["arm"], "kf": raw["kf"], "km": raw["km"],
        "thrust2weight": raw["thrust2weight"],
        "max_speed_kmh": raw["max_speed_kmh"],
        "gnd_eff_coeff": raw["gnd_eff_coeff"],
        "prop_radius": raw["prop_radius"],
        "drag_coeff_xy": drag[0], "drag_coeff_z": drag[2],
        "dw_coeff_1": raw["dw_coeff_1"], "dw_coeff_2": raw["dw_coeff_2"],
        "dw_coeff_3": raw["dw_coeff_3"],
    }
    for a in _OPTIONAL_ATTRS:
        if a in raw:
            props[a] = raw[a]

    def num(v):
        return repr(float(v))

    robot = ET.Element("robot", name=name)
    ET.SubElement(robot, "properties", {k: num(v) for k, v in props.items()})
    link = ET.SubElement(robot, "link", name="base_link")

    inertial = ET.SubElement(link, "inertial")
    ET.SubElement(inertial, "origin", rpy="0 0 0", xyz="0 0 0")
    ET.SubElement(inertial, "mass", value=num(raw["mass"]))
    J = raw["J"]
    ET.SubElement(inertial, "inertia", ixx=num(J[0]), ixy="0.0", ixz="0.0",
                  iyy=num(J[1]), iyz="0.0", izz=num(J[2]))

    cylinder = dict(length=num(raw["collision_h"]),
                    radius=num(raw["collision_r"]))
    visual = ET.SubElement(link, "visual")
    ET.SubElement(visual, "origin", rpy="0 0 0", xyz="0 0 0")
    ET.SubElement(ET.SubElement(visual, "geometry"), "cylinder", cylinder)

    collision = ET.SubElement(link, "collision")
    ET.SubElement(collision, "origin", rpy="0 0 0",
                  xyz=f"0 0 {num(raw['collision_z_offset'])}")
    ET.SubElement(ET.SubElement(collision, "geometry"), "cylinder", cylinder)

    ET.indent(robot)
    text = ('<?xml version="1.0" ?>\n'
            + ET.tostring(robot, encoding="unicode") + "\n")
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
