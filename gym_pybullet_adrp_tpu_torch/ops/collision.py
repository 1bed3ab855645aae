"""Analytic collision, proximity and gate-passage geometry.

Counterpart of gym_pybullet_adrp_tpu.ops.collision, function for
function (``point_segment_distance`` :32, ``gate_beam_segments`` :41,
``drone_gate_distance`` :91, ``drone_obstacle_distance`` :103,
``gate_pass_rays`` :117, ``drone_drone_collision`` :151, the cylinder
contact tests :166-232, ``ground_collision`` :235): the PyBullet ray
fan, contact and closest-point queries of the reference as closed-form
tests. A gate is a 0.5 m square opening of 0.05-thick beams at +-0.225
with a support below; an obstacle an r = 0.05, 0.8 m vertical cylinder;
the drone a flat cylinder (or sphere, for distances) of its collision
radius.

Plain PyTorch (the JAX package computes these in XLA). Every function
broadcasts over leading axes and is branchless.
"""

import torch

from ..utils.constants import (
    GATE_BEAM_HALF, GATE_EDGE_HALF_LEN, GATE_OPENING_HALF, GATE_RAY_HALF_LEN,
    GATE_SUPPORT_CENTER_DZ, GATE_SUPPORT_HALF_LEN, GATE_SUPPORT_RADIUS,
    GATE_Z_LOW, GATE_Z_TALL, OBSTACLE_HALF_LEN, OBSTACLE_RADIUS,
)
from ..utils.device_consts import const


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _up(center):
    up = torch.zeros_like(center)
    up[..., 2] = 1.0
    return up


def point_segment_distance(p, a, b):
    """Distance from point(s) p to segment(s) [a, b]."""
    ab = b - a
    denom = torch.clamp_min(torch.sum(ab * ab, dim=-1), 1e-12)
    t = torch.clamp(torch.sum((p - a) * ab, dim=-1) / denom, 0.0, 1.0)
    closest = a + t[..., None] * ab
    return _norm(p - closest)


def gate_beam_segments(gate_pose):
    """Capsule segments of a gate's frame: gate_pose (..., 6) [x, y, z,
    r, p, yaw] -> (a, b) (..., 5, 3) endpoints of 4 beams + support, and
    radius (5,)."""
    yaw = gate_pose[..., 5]
    c, s = torch.cos(yaw), torch.sin(yaw)
    ux = torch.stack([c, s, torch.zeros_like(c)], dim=-1)
    center = gate_pose[..., 0:3]
    up = _up(center)
    h, e = GATE_OPENING_HALF, GATE_EDGE_HALF_LEN
    sup_c = center + GATE_SUPPORT_CENTER_DZ * up
    a = torch.stack([
        center + h * up - e * ux, center - h * up - e * ux,
        center - h * ux - e * up, center + h * ux - e * up,
        sup_c - GATE_SUPPORT_HALF_LEN * up,
    ], dim=-2)
    b = torch.stack([
        center + h * up + e * ux, center - h * up + e * ux,
        center - h * ux + e * up, center + h * ux + e * up,
        sup_c + GATE_SUPPORT_HALF_LEN * up,
    ], dim=-2)
    radius = const((GATE_BEAM_HALF,) * 4 + (GATE_SUPPORT_RADIUS,),
                   gate_pose.dtype, gate_pose.device)
    return a, b, radius


def drone_gate_distance(drone_pos, gate_pose):
    """Surface distance from a drone center (..., 3) to a gate (..., 6)."""
    a, b, radius = gate_beam_segments(gate_pose)
    d = point_segment_distance(drone_pos[..., None, :], a, b) - radius
    return torch.amin(d, dim=-1)


def drone_obstacle_distance(drone_pos, obstacle_pose):
    """Surface distance to an obstacle cylinder centred at its z."""
    center = obstacle_pose[..., :3]
    up = _up(center)
    return (point_segment_distance(drone_pos,
                                   center - OBSTACLE_HALF_LEN * up,
                                   center + OBSTACLE_HALF_LEN * up)
            - OBSTACLE_RADIUS)


def gate_pass_rays(drone_pos, gate_pose, gate_type, drone_radius):
    """Does the drone body cut the gate's 7-ray fan (offsets i * 0.05, i =
    -3..3, along the gate's yaw; z at the gate type's fixed height
    +-0.1875)? drone_pos (..., 3), gate_pose (..., 6), gate_type (...,)
    int (0 tall, 1 low), drone_radius (...,). Returns bool (...,)."""
    x, y, yaw = gate_pose[..., 0], gate_pose[..., 1], gate_pose[..., 5]
    height = torch.where(gate_type == 0, GATE_Z_TALL, GATE_Z_LOW).to(
        drone_pos.dtype)
    dx = 0.05 * torch.cos(yaw)
    dy = 0.05 * torch.sin(yaw)
    i = torch.arange(-3, 4, dtype=drone_pos.dtype, device=drone_pos.device)
    rx = x[..., None] + i * dx[..., None]
    ry = y[..., None] + i * dy[..., None]
    lo = torch.broadcast_to(height[..., None] - GATE_RAY_HALF_LEN, rx.shape)
    hi = torch.broadcast_to(height[..., None] + GATE_RAY_HALF_LEN, rx.shape)
    a = torch.stack([rx, ry, lo], dim=-1)
    b = torch.stack([rx, ry, hi], dim=-1)
    d = point_segment_distance(drone_pos[..., None, :], a, b)
    return torch.any(d < drone_radius[..., None], dim=-1)


def drone_drone_collision(pos, radius, half_h=0.0125):
    """(..., N, N) bool pairwise contact of drones as flat cylinders
    (COMPETE elimination)."""
    delta = pos[..., :, None, :] - pos[..., None, :, :]
    dxy = _norm(delta[..., :2])
    dz = torch.abs(delta[..., 2])
    n = pos.shape[-2]
    hit = (dxy < 2.0 * radius) & (dz < 2.0 * half_h)
    return hit & ~torch.eye(n, dtype=torch.bool, device=pos.device)


def _vertical_capsule_hit(pos, center_xy, z_lo, z_hi, obs_r, drone_r,
                          half_h):
    """Drone cylinder vs vertical cylinder: xy overlap and z overlap."""
    dxy = _norm(pos[..., :2] - center_xy)
    z = pos[..., 2]
    return (dxy < obs_r + drone_r) & (z - half_h < z_hi) & (z + half_h > z_lo)


def drone_gate_collision(drone_pos, gate_pose, drone_r, half_h=0.0125):
    """Drone cylinder vs gate frame: each element as horizontal/vertical
    gap tests, so a drone skimming above the support is not flagged.
    drone_pos (..., 3), gate_pose (..., 6). Returns bool (...,)."""
    x, y, z, yaw = (gate_pose[..., 0], gate_pose[..., 1], gate_pose[..., 2],
                    gate_pose[..., 5])
    c, s = torch.cos(yaw), torch.sin(yaw)
    center_xy = torch.stack([x, y], dim=-1)
    rel_xy = drone_pos[..., :2] - center_xy
    along = rel_xy[..., 0] * c + rel_xy[..., 1] * s
    perp = torch.abs(rel_xy[..., 0] * (-s) + rel_xy[..., 1] * c)
    dz_center = drone_pos[..., 2] - z

    within_span = torch.abs(along) < GATE_EDGE_HALF_LEN + drone_r
    near_plane = perp < GATE_BEAM_HALF + drone_r
    horiz_hit = within_span & near_plane & (
        (torch.abs(dz_center - GATE_OPENING_HALF) < GATE_BEAM_HALF + half_h)
        | (torch.abs(dz_center + GATE_OPENING_HALF) < GATE_BEAM_HALF + half_h)
    )
    vert_hit = near_plane & (
        (torch.abs(along - GATE_OPENING_HALF) < GATE_BEAM_HALF + drone_r)
        | (torch.abs(along + GATE_OPENING_HALF) < GATE_BEAM_HALF + drone_r)
    ) & (torch.abs(dz_center) < GATE_EDGE_HALF_LEN + half_h)
    sup_hit = _vertical_capsule_hit(
        drone_pos, center_xy,
        z + GATE_SUPPORT_CENTER_DZ - GATE_SUPPORT_HALF_LEN,
        z + GATE_SUPPORT_CENTER_DZ + GATE_SUPPORT_HALF_LEN,
        GATE_SUPPORT_RADIUS, drone_r, half_h)
    return horiz_hit | vert_hit | sup_hit


def drone_obstacle_collision(drone_pos, obstacle_pose, drone_r,
                             half_h=0.0125):
    """Drone cylinder vs obstacle cylinder (r = 0.05, z +- 0.4)."""
    center = obstacle_pose[..., :3]
    return _vertical_capsule_hit(
        drone_pos, center[..., :2], center[..., 2] - OBSTACLE_HALF_LEN,
        center[..., 2] + OBSTACLE_HALF_LEN, OBSTACLE_RADIUS, drone_r, half_h)


def ground_collision(pos, collision_h, collision_z_offset):
    """Drone touching the plane."""
    return pos[..., 2] <= collision_h / 2.0 - collision_z_offset + 1e-6
