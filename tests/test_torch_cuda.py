"""Port: the CUDA race kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip where no CUDA device is present.

This file imports no JAX, so it also runs on a machine without it:
  python -m pytest tests/test_torch_cuda.py --noconftest -q

Both sides round every + - * / and sqrt alike (kernels built with
-fmad=false), so the outputs are expected equal; the stated tolerance
(atol 1e-4 on S, 1e-3 on OBS/REW) leaves room for the last bit of a
libm sinf/cosf.
"""

import pytest
import torch

from gym_pybullet_adrp_tpu_torch import eval_race
from gym_pybullet_adrp_tpu_torch.ops import race_step, race_window

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("noise", [False, True], ids=["calm", "noise"])
def test_race_window_kernel_matches_plain(dev, noise):
    env = eval_race.make_eval_env("level1", 256, dev, seed=1, n_drones=2)
    st = env.reset()
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.rand((256, 2, 4), generator=gen, device=dev) * 2 - 1
    W = env.build_W(st, env.action_rows(a)).contiguous()
    W[16] = 1.0                                    # planner branch
    W[18] = 2.0
    W[20:52] = torch.randn((32,) + W.shape[1:], generator=gen, device=dev)
    nz = env.step_draws().noise_rows if noise else None
    before = race_window.race_window.launches
    got = race_window.race_window(env.kf, env.km, env.arm, env.ground_z,
                                  st.S, W, noise_rows=nz)
    ref = race_window.race_window_plain(env.kf, env.km, env.arm,
                                        env.ground_z, st.S, W, noise_rows=nz)
    torch.cuda.synchronize()
    assert race_window.race_window.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("cfg,n_drones", [("level1", 1),
                                          ("getting_started", 2)])
def test_race_step_kernel_matches_plain(dev, cfg, n_drones):
    env = eval_race.make_eval_env(cfg, 256, dev, seed=2, n_drones=n_drones)
    st = env.reset()
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(12):
        shape = (256, n_drones, 4) if n_drones > 1 else (256, 4)
        a = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        d = env.step_draws()
        args = (env.kf, env.km, env.arm, env.ground_z, st.S,
                env.action_rows(a), st.R, st.GG, st.OO, st.EP, d.RST,
                d.RSTG, d.RSTO)
        kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                  noise_rows=d.noise_rows, telemetry=True)
        got = race_step.race_step_fused(*args, **kw)
        ref = race_step.race_step_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], ref[0], atol=1e-4, rtol=1e-6)
        for j in (5, 6):
            torch.testing.assert_close(got[j], ref[j], atol=1e-3, rtol=0)
        for j in (1, 2, 3, 4, 7, 8):
            torch.testing.assert_close(got[j], ref[j], atol=1e-4, rtol=0)
        st = st._replace(S=ref[0], R=ref[1], GG=ref[2], OO=ref[3],
                         EP=ref[4])


def test_wrappers_validate_inputs(dev):
    S = torch.zeros((58, 1, 128), device=dev)
    W = torch.zeros((57, 1, 128), device=dev)
    with pytest.raises(TypeError):
        race_window.race_window(3.16e-10, 7.94e-12, 0.0397, 0.0125,
                                S.double(), W)
    with pytest.raises(ValueError):
        race_window.race_window(3.16e-10, 7.94e-12, 0.0397, 0.0125, S,
                                W[:, :, :64])
    with pytest.raises(ValueError):
        race_window.race_window(3.16e-10, 7.94e-12, 0.0397, 0.0125, S,
                                W.cpu())
