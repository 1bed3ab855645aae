"""Analytic ray-casting renderer: RGB, depth and segmentation frames.

Counterpart of gym_pybullet_adrp_tpu/ops/render.py (``Scene`` :26,
``scene_from_race_state`` :48, ``add_landmarks`` :96, ``empty_scene``
:117, ``_ray_plane_z0`` :135, ``_ray_sphere`` :140, ``_ray_capsule``
:150, ``render`` :179, ``drone_camera`` :292): the scene is a soup of
primitives (vertical capsules, spheres, general capsule segments over a
checkerboard ground plane) and each pixel traces one analytic ray.

Plain PyTorch: the JAX package renders in XLA, outside any Pallas kernel.
``render`` takes leading batch axes on the cameras and on the scene's
leaves (they broadcast against each other), so a batch of envs renders in
one call. The rays are held as three (..., H, W) component tensors, and
each primitive class is tested in chunks on a trailing axis, each
chunk's first nearest hit (``torch.min``) folded into the running
nearest hit where strictly nearer, as the JAX package's per-class
``argmin`` then strict ``<`` keeps the first of equal hits; a chunk is
sized so that a field of the frame batch times the chunk stays under
``_CHUNK_ELEMS`` elements (32 MiB in float32), which bounds the
render's memory whatever the batch.
"""

import math
from typing import NamedTuple

import torch

from ..utils.device_consts import const


class Scene(NamedTuple):
    """Primitive soup. Leaves may carry leading batch axes."""

    # vertical capsules: (M, 3) base center, (M,) half_len, (M,) radius
    cap_center: torch.Tensor
    cap_half: torch.Tensor
    cap_radius: torch.Tensor
    cap_color: torch.Tensor      # (M, 3)
    cap_valid: torch.Tensor      # (M,) bool
    # spheres (drones): (K, 3), (K,)
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_color: torch.Tensor
    sph_valid: torch.Tensor
    # general segments (gate beams): (S, 3) a, (S, 3) b, (S,) radius
    seg_a: torch.Tensor
    seg_b: torch.Tensor
    seg_radius: torch.Tensor
    seg_color: torch.Tensor
    seg_valid: torch.Tensor


_GATE_COLORS = ((0.5, 0.5, 0.5), (0.0, 0.0, 0.9), (0.0, 0.9, 0.0),
                (0.9, 0.0, 0.0), (0.1, 0.5, 0.7))
_OBSTACLE_COLOR = (0.1, 0.5, 0.7)
_DRONE_COLOR = (0.3, 0.3, 0.3)
_LANDMARKS = ((1.0, 0.0, 0.1), (0.0, 1.0, 0.1), (-1.0, 0.0, 0.1),
              (0.0, -1.0, 0.1))
_LANDMARK_COLORS = ((0.8, 0.2, 0.2), (0.2, 0.8, 0.2), (0.9, 0.8, 0.1),
                    (0.5, 0.3, 0.1))


def _full(n, value, dtype, device):
    return torch.full((n,), value, dtype=dtype, device=device)


def _rows(rows, n, dtype, device):
    """``rows`` (a tuple of 3-tuples) tiled to ``n`` rows."""
    t = torch.tensor(rows, dtype=dtype, device=device)
    return t.repeat(n // t.shape[0], 1)


def drone_spheres(scene: Scene, pos, radius=0.06, valid=None) -> Scene:
    """``scene`` with a sphere of ``radius`` per drone at ``pos`` (..., K,
    3); ``valid`` (K,) masks some out (default: all drawn)."""
    K = pos.shape[-2]
    dtype, device = pos.dtype, pos.device
    if valid is None:
        valid = torch.ones((K,), dtype=torch.bool, device=device)
    return scene._replace(
        sph_center=pos, sph_radius=_full(K, radius, dtype, device),
        sph_color=_rows((_DRONE_COLOR,), K, dtype, device),
        sph_valid=valid)


def scene_from_race_state(gates_actual, obstacles_actual, drone_pos,
                          drone_radius=0.06) -> Scene:
    """The race track as a scene: each gate's 4 beams and support
    (ops/collision.gate_beam_segments), each obstacle's cylinder, each
    drone's sphere. ``gates_actual`` (..., G, 7), ``obstacles_actual``
    (..., O, 6), ``drone_pos`` (..., N, 3)."""
    from ..utils.constants import OBSTACLE_HALF_LEN, OBSTACLE_RADIUS
    from .collision import gate_beam_segments

    dtype, device = drone_pos.dtype, drone_pos.device
    a, b, radius = gate_beam_segments(gates_actual[..., :6])
    G = gates_actual.shape[-2]
    O = obstacles_actual.shape[-2]
    scene = Scene(
        cap_center=obstacles_actual[..., :3],
        cap_half=_full(O, OBSTACLE_HALF_LEN, dtype, device),
        cap_radius=_full(O, OBSTACLE_RADIUS, dtype, device),
        cap_color=_rows((_OBSTACLE_COLOR,), O, dtype, device),
        cap_valid=torch.ones((O,), dtype=torch.bool, device=device),
        sph_center=None, sph_radius=None, sph_color=None, sph_valid=None,
        seg_a=a.reshape(a.shape[:-3] + (G * 5, 3)),
        seg_b=b.reshape(b.shape[:-3] + (G * 5, 3)),
        seg_radius=radius.repeat(G),
        seg_color=_rows(_GATE_COLORS, G * 5, dtype, device),
        seg_valid=torch.ones((G * 5,), dtype=torch.bool, device=device))
    return drone_spheres(scene, drone_pos, drone_radius)


def add_landmarks(scene: Scene) -> Scene:
    """``scene`` with its capsules replaced by the 4 coloured landmark
    pillars (the reference's RGB-mode props, BaseRLAviary._addObstacles:
    106-126), on the device and in the dtype of ``scene.cap_center``."""
    dtype, device = scene.cap_center.dtype, scene.cap_center.device
    return scene._replace(
        cap_center=torch.tensor(_LANDMARKS, dtype=dtype, device=device),
        cap_half=_full(4, 0.1, dtype, device),
        cap_radius=_full(4, 0.05, dtype, device),
        cap_color=torch.tensor(_LANDMARK_COLORS, dtype=dtype,
                               device=device),
        cap_valid=torch.ones((4,), dtype=torch.bool, device=device))


def empty_scene(dtype=torch.float32, device="cuda") -> Scene:
    """The ground plane alone (the RL hover envs), on ``device``, the card
    unless the caller asks for the CPU."""
    z3 = torch.zeros((0, 3), dtype=dtype, device=device)
    z1 = torch.zeros((0,), dtype=dtype, device=device)
    zb = torch.zeros((0,), dtype=torch.bool, device=device)
    return Scene(z3, z1, z1, z3, zb, z3, z1, z3, zb, z3, z3, z1, z3, zb)


# ---------------------------------------------------------------------------
# intersections on rays held as 3-tuples of (..., H, W) components; each
# returns the hit distance t, _FAR on a miss

_FAR = 1e9


def _sqrt(x):
    """The correctly rounded square root on every device: PyTorch's
    vectorised CPU sqrt is off by an ulp for ~0.7% of float32 inputs, and
    a grazing ray's hit moves by far more than an ulp of its direction."""
    return torch.sqrt(x.double()).to(x.dtype)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _cross3(a, b):
    """``a x b`` of (..., 3) tensors."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack(_cross(a.unbind(-1), b.unbind(-1)), dim=-1)


def _ray_plane_z0(o, d):
    dz = d[2]
    ok = torch.abs(dz) > 1e-9
    t = -o[2] / torch.where(ok, dz, 1e-9)
    return torch.where((t > 1e-4) & ok, t, _FAR)


def _ray_sphere(o, d, c, r):
    oc = _sub(o, c)
    b = _dot(oc, d)
    cc = _dot(oc, oc) - r * r
    disc = b * b - cc
    t = -b - _sqrt(torch.clamp_min(disc, 0.0))
    return torch.where((disc > 0) & (t > 1e-4), t, _FAR)


def _ray_capsule(o, d, a, b_end, r):
    """Ray vs the capsule of segment [a, b_end] and radius r: the
    infinite cylinder clipped to the segment, and the end spheres."""
    ab = _sub(b_end, a)
    ao = _sub(o, a)
    ab_len2 = torch.clamp_min(_dot(ab, ab), 1e-12)
    sd, so = _dot(d, ab), _dot(ao, ab)
    d_perp = tuple(d[i] - sd * ab[i] / ab_len2 for i in range(3))
    o_perp = tuple(ao[i] - so * ab[i] / ab_len2 for i in range(3))
    A = _dot(d_perp, d_perp)
    B = _dot(o_perp, d_perp)
    C = _dot(o_perp, o_perp) - r * r
    disc = B * B - A * C
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    a_ok = A > 1e-12
    t_cyl = (-B - sq) / torch.where(a_ok, A, 1e-12)
    hit = tuple(o[i] + t_cyl * d[i] for i in range(3))
    s = _dot(_sub(hit, a), ab) / ab_len2
    cyl_ok = (disc > 0) & a_ok & (t_cyl > 1e-4) & (s >= 0) & (s <= 1)
    t_cyl = torch.where(cyl_ok, t_cyl, _FAR)
    t_a = _ray_sphere(o, d, a, r)
    t_b = _ray_sphere(o, d, b_end, r)
    return torch.minimum(t_cyl, torch.minimum(t_a, t_b))


_CHUNK_ELEMS = 1 << 23
# the scene's (..., P, 3) leaves; the others are (..., P)
_VECTORS = ("cap_center", "cap_color", "sph_center", "sph_color", "seg_a",
            "seg_b", "seg_color")


def _prim(x, j0, j1):
    """Primitives j0..j1-1 of a per-primitive leaf (..., P) as (..., 1, 1,
    p): against a frame batch (..., H, W, 1)."""
    return x[..., None, None, j0:j1]


def _prim3(v, j0, j1):
    """Primitives j0..j1-1 of (..., P, 3) as a 3-tuple of (..., 1, 1, p)."""
    return tuple(v[..., None, None, j0:j1, i] for i in range(3))


def _gather_rows(rows, idx):
    """``rows`` (..., P, 3) at ``idx`` (..., H, W): (..., H, W, 3), the
    batch axes broadcast."""
    if rows.dim() == 2:
        return rows[idx]
    batch = torch.broadcast_shapes(rows.shape[:-2], idx.shape[:-2])
    i = idx.expand(batch + idx.shape[-2:]).reshape(batch + (-1, 1))
    out = torch.gather(rows.expand(batch + rows.shape[-2:]), -2,
                       i.expand(batch + (i.shape[-2], 3)))
    return out.reshape(batch + idx.shape[-2:] + (3,))


def _split(v):
    """(..., 3) -> 3-tuple of (..., 1, 1), to broadcast over a frame."""
    return tuple(v[..., i, None, None] for i in range(3))


def render(scene: Scene, cam_pos, cam_target, width=64, height=48,
           fov_deg=60.0, far=1000.0):
    """Render cameras at ``cam_pos`` looking at ``cam_target`` (..., 3),
    up = world +z, vertical field of view ``fov_deg``. The cameras'
    batch axes broadcast against the scene leaves'. Returns (rgba (...,
    H, W, 4) in [0, 255], depth (..., H, W) in meters, ``far`` on a miss,
    seg (..., H, W) int32: -1 sky, 0 ground, then capsules, spheres and
    segments in scene order, from 1)."""
    dtype, device = cam_pos.dtype, cam_pos.device
    forward = cam_target - cam_pos
    fn = norm3(forward)
    forward = forward / torch.clamp_min(fn, 1e-9)
    # cross products with each product rounded (torch.linalg.cross may
    # fuse them into multiply-adds on the CPU)
    right = _cross3(forward, const((0.0, 0.0, 1.0), dtype, device))
    rn = norm3(right)
    # a straight-up/down view takes world x as right, per camera
    right = torch.where(rn > 1e-6, right / torch.clamp_min(rn, 1e-9),
                        const((1.0, 0.0, 0.0), dtype, device))
    up = _cross3(right, forward)

    aspect = width / height
    tan_half = math.tan(math.radians(fov_deg / 2.0))
    # divisors as device tensors: PyTorch's CUDA division by a host
    # number multiplies by its reciprocal, which rounds otherwise
    h_, w_ = const(float(height), dtype, device), const(float(width), dtype,
                                                       device)
    ys = ((0.5 - (torch.arange(height, dtype=dtype, device=device) + 0.5)
           / h_) * 2 * tan_half)[:, None]
    xs = (((torch.arange(width, dtype=dtype, device=device) + 0.5) / w_
           - 0.5) * 2 * tan_half * aspect)[None, :]
    f, rt, u = _split(forward), _split(right), _split(up)
    dirs = tuple(f[i] + xs * rt[i] + ys * u[i] for i in range(3))
    dn = _sqrt(_dot(dirs, dirs))
    d = tuple(c / dn for c in dirs)
    o = _split(cam_pos)

    best_t = _ray_plane_z0(o, d)
    best_id = torch.where(best_t < _FAR, 0, -1).to(torch.int32)
    # primitives go through in chunks of a class, the chunk on a trailing
    # axis, sized so that one field of the frame batch x the chunk stays
    # under _CHUNK_ELEMS elements
    batch = torch.broadcast_shapes(best_t.shape[:-2], *(
        x.shape[:-2] if f in _VECTORS else x.shape[:-1]
        for f, x in zip(Scene._fields, scene)))
    chunk = max(1, _CHUNK_ELEMS // (math.prod(batch) * height * width))
    o1 = tuple(c[..., None] for c in o)
    d1 = tuple(c[..., None] for c in d)
    base = 1

    def fold(n, test, valid):
        """Fold a class of ``n`` primitives, ``test(j0, j1)`` giving the
        hits (..., H, W, j1 - j0) of primitives j0..j1-1."""
        nonlocal best_t, best_id, base
        for j0 in range(0, n, chunk):
            j1 = min(n, j0 + chunk)
            t = torch.where(_prim(valid, j0, j1), test(j0, j1), _FAR)
            tmin, arg = torch.min(t, dim=-1)
            better = tmin < best_t
            best_t = torch.where(better, tmin, best_t)
            best_id = torch.where(better, (arg + (base + j0)).to(torch.int32),
                                  best_id)
        base += n

    def capsule(j0, j1):
        c = _prim3(scene.cap_center, j0, j1)
        h = _prim(scene.cap_half, j0, j1)
        return _ray_capsule(o1, d1, (c[0], c[1], c[2] - h),
                            (c[0], c[1], c[2] + h),
                            _prim(scene.cap_radius, j0, j1))

    fold(scene.cap_center.shape[-2], capsule, scene.cap_valid)
    fold(scene.sph_center.shape[-2], lambda j0, j1: _ray_sphere(
        o1, d1, _prim3(scene.sph_center, j0, j1),
        _prim(scene.sph_radius, j0, j1)), scene.sph_valid)
    fold(scene.seg_a.shape[-2], lambda j0, j1: _ray_capsule(
        o1, d1, _prim3(scene.seg_a, j0, j1), _prim3(scene.seg_b, j0, j1),
        _prim(scene.seg_radius, j0, j1)), scene.seg_valid)

    # the ground's checkerboard: a floor modulo (negative squares too);
    # the int cast overflows on sky pixels, which take the sky's colour
    hx = o[0] + best_t * d[0]
    hy = o[1] + best_t * d[1]
    checker = (torch.floor(hx).to(torch.int32)
               + torch.floor(hy).to(torch.int32)) % 2
    ground = torch.where(checker[..., None] == 0,
                         const((0.8, 0.8, 0.8), dtype, device),
                         const((0.55, 0.55, 0.55), dtype, device))
    colors = [c for c in (scene.cap_color, scene.sph_color,
                          scene.seg_color) if c.shape[-2]]
    obj = ground
    if colors:
        cb = torch.broadcast_shapes(*(c.shape[:-2] for c in colors))
        colors = torch.cat([c.expand(cb + c.shape[-2:]) for c in colors],
                           dim=-2)
        obj = _gather_rows(colors, torch.clamp(best_id - 1, 0,
                                               colors.shape[-2] - 1))
    idx = best_id[..., None]
    rgb = torch.where(idx < 0, const((0.7, 0.85, 1.0), dtype, device),
                      torch.where(idx == 0, ground, obj))
    # depth-based shading
    shade = 1.0 / (1.0 + 0.08 * torch.clamp_max(best_t, 50.0))
    rgb = torch.where(idx >= 0, rgb * (0.55 + 0.45 * shade[..., None]), rgb)
    rgba = torch.cat([rgb * 255.0, torch.full_like(rgb[..., :1], 255.0)],
                     dim=-1)
    depth = torch.where(best_t < _FAR, best_t, far)
    return rgba, depth, best_id


def drone_camera(drone_pos, drone_quat, arm_len):
    """A drone's POV camera (reference _getDroneImages:596-603): the eye
    ``arm_len`` above the drone, the target 1000 m along its body x axis.
    ``arm_len`` is a number or a tensor broadcasting against
    ``drone_pos[..., 0]``. Returns (eye, target) (..., 3)."""
    forward = rotate(drone_quat, const((1000.0, 0.0, 0.0), drone_pos.dtype,
                                       drone_pos.device))
    return camera_above(drone_pos, arm_len), drone_pos + forward


def rotate(q, v):
    """``v`` rotated by the xyzw quaternion ``q`` (ops/quat.rotate's
    formula, each product rounded)."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * _cross3(qv, v)
    return v + qw * t + _cross3(qv, t)


def norm3(v):
    """|v| (..., 1) of (..., 3), correctly rounded on every device."""
    c = v.unbind(-1)
    return _sqrt(_dot(c, c))[..., None]


def camera_above(pos, height):
    """``pos`` (..., 3) raised by ``height`` (a number or (...,))."""
    height = torch.as_tensor(height, dtype=pos.dtype, device=pos.device)
    z = pos[..., 2] + height
    return torch.stack([pos[..., 0], pos[..., 1], z], dim=-1)
