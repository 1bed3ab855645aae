"""Port: the general race env's K3 route (envs/race_fast.py), on CPU.

* ``race_fast.batched_race_step_fast`` (the window kernel's plain version
  on CPU tensors) against the JAX package's
  ``race_fast.batched_race_step_fast(interpret=True)`` for one step from
  a shared mid-flight state (a planned TAKEOFF, FULLSTATE targets), at
  tests/test_torch_race_window.py's per-window tolerances on the
  gating-stable agents (``_torch_port.S_ABS``: pos/quat/vel 1e-5, rates
  and angles 1e-3, biquads 1e-3 / 0.2, integrals 1e-5, commands 20;
  rpms rtol 3e-4; ticks and gating stamps equal), obs at
  ``check_blocks``' tolerances, the discrete outputs equal.
* The K3 route against the port's own ``race_step`` in closed loop, the
  TAKEOFF + FULLSTATE sequence of tests/test_pallas_race.py:36-43 at its
  bounds (:52-59).
* The window wrapper's lane rule, packed arguments and folded constants.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_adrp_tpu.envs import race as jrace
from gym_pybullet_adrp_tpu.envs import race_fast as jfast
from gym_pybullet_adrp_tpu_torch.control import commander as pcmd
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.envs import race_fast as pfast
from gym_pybullet_adrp_tpu_torch.ops import race_window as rw
from gym_pybullet_adrp_tpu_torch.utils.enums import Command

from _torch_port import (
    assert_race_S, assert_race_obs, assert_trees, gating_stable, race_S,
    race_specs, tensor, to_port,
)

F32 = np.float32
T = tensor


def _cmd_batch(B, n, cmd, args):
    ids = np.zeros((B, n), np.int32)
    vec = np.zeros((B, n, 14), np.float32)
    for d in range(n):
        c, v = pcmd.pack_command(cmd[d] if isinstance(cmd, tuple) else cmd,
                                 args[d] if isinstance(cmd, tuple) else args)
        ids[:, d], vec[:, d] = c, v
    return ids, vec


def test_race_fast_matches_jax_interpret():
    pspec, ptrack, jspec, jtrack = race_specs("getting_started", 2)
    B, n = 16, 2
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    jst = jax.vmap(lambda k: jrace.race_reset(jspec, jtrack, k,
                                              dtype=jnp.float32))(keys)
    jstep = jax.jit(jax.vmap(lambda s, i, a: jrace.race_step(
        jspec, jtrack, s, i, a)))
    fullstate = (Command.FULLSTATE, ([0.3, -0.2, 0.4], [0, 0, 0],
                                     [0, 0, 0], 0.2, [0, 0, 0], 0.0))
    # drone 0 on a planned takeoff, drone 1 on a FULLSTATE target
    for cmd in ((Command.TAKEOFF, Command.FULLSTATE),
                (Command.NONE, Command.FULLSTATE)):
        ids, args = _cmd_batch(B, n, cmd, ((0.5, 1.5), fullstate[1]))
        jst = jstep(jst, jnp.asarray(ids), jnp.asarray(args))[0]
    ref = jax.jit(lambda s, i, a: jfast.batched_race_step_fast(
        jspec, jtrack, s, i, a, interpret=True))(jst, jnp.asarray(ids),
                                                 jnp.asarray(args))
    pl = prace.race_reset(pspec, ptrack, B, device="cpu")
    pst = to_port(jst, pl)
    before = rw.race_window.launches
    got = pfast.batched_race_step_fast(pspec, ptrack, pst, T(ids), T(args),
                                       consts=pfast.window_consts_of(pspec))
    assert rw.race_window.launches == before   # CPU: the plain version
    S0 = race_S(prace.process_commands(pspec, pst, T(ids), T(args)))
    stable = gating_stable(S0)
    assert stable.reshape(-1)[:B * n].all()   # a rounding-free window
    jrs = to_port(ref[0], pl)
    assert_race_S(race_S(got[0]), race_S(jrs), stable, "fast")
    assert_trees(got[0].cmdr, jrs.cmdr, "cmdr")
    for k in ("current_gate", "eliminated", "finished", "step_counter"):
        np.testing.assert_array_equal(getattr(got[0], k).numpy(),
                                      getattr(jrs, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    env_ok = stable.reshape(-1)[:B * n].reshape(B, n).all(-1)
    assert_race_obs(got[1].numpy()[env_ok], np.asarray(ref[1])[env_ok],
                pspec.num_gates, pspec.num_obstacles)
    # the planner ran: drone 0 is rising on its takeoff
    assert (got[0].phys.vel[:, 0, 2] > 0.05).all()


def test_race_fast_closed_loop_matches_race_step():
    """tests/test_pallas_race.py:30-59 on the port: takeoff + FULLSTATE,
    the K3 route against the port's per-tick race_step."""
    pspec, ptrack, _, _ = race_specs("getting_started", 2)
    B, n = 4, 2
    s_ref = prace.race_reset(pspec, ptrack, B, device="cpu")
    s_fast = prace.race_reset(pspec, ptrack, B, device="cpu")
    seq = ([(Command.TAKEOFF, (0.3, 1.0))] + [(Command.NONE, ())] * 12
           + [(Command.FULLSTATE, ([0.5, 0.5, 0.5], [0, 0, 0], [0, 0, 0],
                                   0.1, [0, 0, 0], 0.6))] * 5)
    consts = pfast.window_consts_of(pspec)
    for cmd, args in seq:
        ids, vec = _cmd_batch(B, n, cmd, args)
        s_ref = prace.race_step(pspec, ptrack, s_ref, T(ids), T(vec))[0]
        s_fast = pfast.batched_race_step_fast(pspec, ptrack, s_fast, T(ids),
                                              T(vec), consts)[0]
    dpos = float((s_ref.phys.pos - s_fast.phys.pos).abs().max())
    assert dpos < 0.05, dpos
    assert torch.equal(s_ref.eliminated, s_fast.eliminated)
    assert torch.equal(s_ref.current_gate, s_fast.current_gate)
    assert (0.12 < s_fast.phys.pos[:, 0, 2]).all()
    assert (s_fast.phys.pos[:, 0, 2] < 0.8).all()


def test_window_lane_rule_and_args():
    """K3's lane count (4 while the groups fit one wave of two 128-thread
    blocks per SM, then 1), its packed C arguments (``struct WindowArgs``:
    six pointers, ncols, lanes, 64 bytes) and its folded constants."""
    assert [rw.lane_count(a) for a in (128, 4096, 8192, 8448, 8576,
                                       65536)] == [4, 4, 4, 4, 1, 1]
    assert rw.lane_count(4096, n_sm=16) == 1
    assert rw._ARGS.size == 64
    c = rw.window_consts(3.16e-10, 7.94e-12, 0.0397, 0.0125, 0.002, 20)
    assert rw.window_consts_struct(c) is c.struct
    assert c.struct.tick_recip == pytest.approx(c["tick_recip"])
    with pytest.raises(TypeError):
        c["dt"] = 0.001
