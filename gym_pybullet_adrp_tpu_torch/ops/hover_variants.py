"""The hover rollout's A/B variants (K7, K8) as instantiations of K2.

Counterpart of results/hover_vpu/ab_v2.py (``hover_rollout_v2`` :163)
and results/hover_vpu/ab_v3.py (``hover_rollout_v3`` :164), which
restructured the TPU kernel K2 (ops/pallas_step.py::hover_rollout) and
changed one flag each:

* v2 (K7): the exact integrator (sqrt, sin, cos, div) with the
  termination test ``e2 < 1e-8`` in place of ``sqrt(e2) < 1e-4``;
  ``exact_sqrt=True`` keeps the sqrt, which makes it K2 with
  ``smallangle=False``. Its ``vmem_lift`` option raised the TPU's scoped
  VMEM limit; the card has no such setting, so it is left out.
* v3 (K8): the small-angle integrator with ``e2 < 1e-8``: K2's default.

Both launch csrc/hover_rollout.cu, the template K2 runs, with their own
flags and their own launch counts, and each has its plain version here.
Fixed settings, as in the A/B scripts: 8 substeps at 240 Hz, act_scale
0.05, target (0, 0, 1), 240 steps per episode, reset height 0.1125.
``actions`` (n_steps, 4, T, 128) replaces the in-kernel draws, as in
``hover_step.hover_rollout``; ``consts``, when given, is
``hover_step.hover_consts(params)``, folded once for a loop of launches.
"""

from .hover_step import hover_consts, launch_rollout, rollout_plain


def _flags(exact_sqrt):
    """(smallangle, near_sqrt) of v2, or of v3 for ``exact_sqrt`` None."""
    return (True, False) if exact_sqrt is None else (False, bool(exact_sqrt))


def _variant(fn, params, packed_state, seed, n_steps, exact_sqrt, actions,
             count_resets, consts):
    c = consts or hover_consts(params)
    flags = _flags(exact_sqrt)
    if packed_state.device.type == "cpu":
        return rollout_plain(c, packed_state, seed, n_steps, *flags,
                             actions, count_resets)
    out = launch_rollout(fn.__name__, c, packed_state, seed, n_steps, *flags,
                         actions, count_resets)
    fn.launches += 1
    return out


def hover_rollout_v2(params, packed_state, seed, n_steps, exact_sqrt=False,
                     actions=None, count_resets=False, consts=None):
    """K7: the exact integrator; the sqrt-free termination test unless
    ``exact_sqrt``. Returns (state, acc[, resets]). CPU tensors take the
    plain version; CUDA tensors launch the kernel, counted in
    ``hover_rollout_v2.launches``."""
    return _variant(hover_rollout_v2, params, packed_state, seed, n_steps,
                    bool(exact_sqrt), actions, count_resets, consts)


def hover_rollout_v3(params, packed_state, seed, n_steps, actions=None,
                     count_resets=False, consts=None):
    """K8: the small-angle integrator. Returns (state, acc[, resets]). CPU
    tensors take the plain version; CUDA tensors launch the kernel,
    counted in ``hover_rollout_v3.launches``."""
    return _variant(hover_rollout_v3, params, packed_state, seed, n_steps,
                    None, actions, count_resets, consts)


def hover_rollout_v2_plain(params, packed_state, seed, n_steps,
                           exact_sqrt=False, actions=None,
                           count_resets=False, consts=None):
    """Plain PyTorch version of ``hover_rollout_v2`` (any device)."""
    return rollout_plain(consts or hover_consts(params), packed_state, seed,
                         n_steps, *_flags(bool(exact_sqrt)), actions,
                         count_resets)


def hover_rollout_v3_plain(params, packed_state, seed, n_steps, actions=None,
                           count_resets=False, consts=None):
    """Plain PyTorch version of ``hover_rollout_v3`` (any device)."""
    return rollout_plain(consts or hover_consts(params), packed_state, seed,
                         n_steps, *_flags(None), actions, count_resets)


hover_rollout_v2.launches = 0
hover_rollout_v3.launches = 0
