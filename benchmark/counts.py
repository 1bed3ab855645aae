"""The work K5 (``race_rollout``) and the whole rollout must do, counted
from the benchmark's own reference and never read from the program.

* Operations per env-step: the reference's plain step (the env step of
  every drone of one env, and in policy mode the policy's forward and
  sample for each of them), counted by ``OpCount`` at ``CENSUS_ENVS``
  envs on the CPU: one per output element of each pointwise op, one per
  input element of a reduction. The program's kernels are built with
  ``-fmad=false``, so a counted op is at least one FP32 issue, and the
  currency of the peak is the issue (``peaks.json``). The counts are
  frozen in ``counts/<configuration>.json`` and
  ``tests/test_benchmark_reference.py`` recounts them.
* Bytes per launch: each operand of one K5 launch read once and each
  result written once, from the shapes the traffic sets.

``OpCount`` is a frozen copy of ``gym_pybullet_adrp_tpu_torch/utils/
profiling.py:OpCount`` (commit f8ae565) without the matrix-product
branch: the plain policy's dot products are elementwise multiplies and
adds, counted as such.

Recount: ``python -m benchmark.counts`` prints every configuration's
counts as the frozen files hold them.
"""

import json
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
CENSUS_ENVS = 128
F32 = 4
KINDS = ("policy_rollout", "action_rollout")


class OpCount(TorchDispatchMode):
    """Counts the operations a plain version performs: ``ops``, one per
    output element of every pointwise aten op and one per input element
    of a reduction; ``by_op`` splits them by aten op name."""

    REDUCTIONS = ("aten.amin", "aten.amax", "aten.sum", "aten.mean")

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.by_op = {}

    def _add(self, name, n):
        self.ops += n
        self.by_op[name] = self.by_op.get(name, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        name = str(func)
        if torch.Tag.pointwise in func.tags:
            self._add(name, sum(o.numel() for o in outs
                                if isinstance(o, torch.Tensor)))
        elif name.startswith(self.REDUCTIONS):
            self._add(name, args[0].numel())
        return out


def census_weights(config, device="cpu"):
    """Policy weights of the configuration's widths for the census (the
    count does not depend on their values)."""
    from .weights import make_weights
    from .reference.race_env import scenario_spec
    from .reference.plain_step import obs_channels

    sp = scenario_spec(config)
    C = obs_channels(sp["N"], sp["G"], sp["O"], sp["compete"])
    return make_weights(C, config["policy"]["hidden"], 0, device)


@torch.no_grad()
def count_ops(config, kind):
    """Operations per env-step of one K5 step of ``kind`` for the
    configuration ``config`` (a configuration file's dict)."""
    from .reference.race_env import RaceReference

    ref = RaceReference(config, CENSUS_ENVS, "cpu",
                        weights=census_weights(config))
    gen = ref.generator(0)
    st = ref.start(gen)
    inp = ref._step_inputs({k: st[f"state.{k}"] for k in
                            ("S", "R", "GG", "OO", "EP")},
                           ref.step_draws(gen))
    policy = kind == "policy_rollout"
    if policy:
        inp.update(obs=st["state.obs_rows"],
                   actn=torch.zeros((4, ref.T, 128)))
    else:
        inp["A"] = torch.zeros((4, ref.T, 128))
    with OpCount() as c:
        ref.step(inp, policy=policy)
    return c.ops / CENSUS_ENVS


def load(config_name):
    """The frozen counts of a configuration (``counts/<name>.json``)."""
    with open(ROOT / "counts" / f"{config_name}.json") as f:
        return json.load(f)


def k5_bytes_per_launch(dims, kind, K, hidden):
    """Bytes one K5 launch of ``K`` steps reads and writes, each operand
    once. ``dims``: N drones, Tb env rows, G gates, O obstacles, C obs
    channels, n_ticks, ``static`` (one shared block of reset rows) and
    ``noise`` (per-tick disturbance rows)."""
    N, Tb, G, O, C = (dims[k] for k in ("N", "Tb", "G", "O", "C"))
    T = N * Tb
    rows = 128 * F32                      # one (., 128) float32 row
    n_rst = 1 if dims["static"] else K
    agent_state = 58 + 14                 # S, R: (., T, 128)
    env_state = 3 * G + 2 * O + 1         # GG, OO, EP: (., Tb, 128)
    reset = T * 10 + Tb * (3 * G + 2 * O)  # RST; RSTG, RSTO
    noise = K * dims["n_ticks"] * 7 * T if dims["noise"] else 0
    read = T * agent_state + Tb * env_state + n_rst * reset + noise
    written = T * agent_state + Tb * env_state + K * (T + Tb)  # REW, DONE
    if kind == "policy_rollout":
        H1, H2 = hidden
        pack = (H1 * C + H2 * H1 + 4 * H2 + H1 * C + H2 * H1 + H2
                + 2 * (H1 + H2) + 4 + 1 + 4)
        read += T * C + K * 4 * T         # obs rows, Gaussian draws
        written += K * (C + 4 + 1 + 1) * T  # OBS, ACT, LOGP, VAL
        return read * rows + pack * F32 + written * rows
    read += K * 4 * T                     # action rows
    return (read + written) * rows


def main():
    from .harness import load_benchmark, load_config

    bench = load_benchmark()
    for c in bench["configs"]:
        cfg = load_config(c)
        print(c["name"], json.dumps(
            {k: {"ops_per_env_step": count_ops(cfg, k)} for k in KINDS}))


if __name__ == "__main__":
    main()
