"""Offline race flight report: track map, telemetry and event timeline.

Counterpart of scripts/flight_report.py (``record_episode`` :37,
``render_report`` :98, ``main`` :194): the reference's live debug views
(PyBullet's GUI sliders, debug axes and race timer, BaseAviary.py:162-167,
:922-958, scripts/sim.py:82-90) as one figure made offline. It flies a
race episode through ``MultiRaceAviary`` on ``device`` (the card unless
the caller asks for the CPU), as sim.py does, records each step's
telemetry and the race's events, and draws

  * the top-down track map: oriented gate segments, obstacle footprints
    and each drone's trajectory (fixed colourblind-safe drone colours);
  * altitude and speed against time, gate passes marked;
  * the race timeline: per drone, its gate, finish and elimination
    events with their times.

matplotlib is imported by ``render_report`` only (the card's machine has
none); ``record_episode`` needs nothing beyond the port.

Usage:
  python -m gym_pybullet_adrp_tpu_torch.flight_report --config \\
      getting_started --controller hardcoded --n_drones 2 \\
      [--out results/flight_report.png] [--device cpu]
"""

import argparse
from pathlib import Path

import numpy as np

# Okabe-Ito: a fixed categorical order, colourblind-safe by construction
DRONE_COLORS = ["#0072B2", "#E69F00", "#009E73", "#CC79A7",
                "#56B4E9", "#D55E00"]
INK = "#333333"
MUTED = "#8a8a8a"


def record_episode(config, controller, n_drones=1, racemode="compare",
                   seed=None, device="cuda"):
    """Fly one episode through the class API. ``config`` is a bundled
    config's name, a YAML path or a loaded config; ``controller`` a port
    agent's name or a controller module's path. Returns (poses (T, N, 6)
    x y z vx vy vz, gates (T, N), events [(time, drone, kind, label)],
    track {"gates", "obstacles"}, control frequency)."""
    from .envs.race import MultiRaceAviary
    from .utils.config import load_config
    from .utils.enums import RaceMode
    from .utils.utils import load_controller

    cfg = load_config(config) if isinstance(config, (str, Path)) else config
    env = MultiRaceAviary(
        cfg, num_drones=n_drones,
        racemode=(RaceMode.COMPETE if racemode == "compete"
                  else RaceMode.COMPARE), device=device)
    obs, info = env.reset(seed=seed)
    cls = load_controller(controller)
    agents = []
    for drone_id in range(n_drones):
        info.update(delay=drone_id, device=str(env.device))
        agents.append(cls(drone_id, obs[drone_id], dict(info)))
    poses = []          # (T, N, 6): x y z vx vy vz
    gates_t = []        # (T, N)
    events = []         # (time, drone, kind, label)
    prev_gate = np.zeros(n_drones, int)
    prev_elim = np.zeros(n_drones, bool)
    prev_fin = np.zeros(n_drones, bool)
    terminated = truncated = False
    step = 0
    while not (terminated or truncated):
        t = step / env.CTRL_FREQ
        actions = [a.predict(obs[i], ep_time=t)
                   for i, a in enumerate(agents)]
        if all(isinstance(a, np.ndarray) for a in actions):
            actions = np.array(actions)
        obs, reward, terminated, truncated, _ = env.step(actions)
        t = (step + 1) / env.CTRL_FREQ
        poses.append([list(obs[i][0:3]) + list(obs[i][6:9])
                      for i in range(n_drones)])
        gate = np.asarray(env.current_gate, int)
        elim = np.asarray(env.drones_eliminated, bool)
        fin = np.asarray(env.drones_finished, bool)
        gates_t.append(gate.copy())
        for i in range(n_drones):
            if gate[i] > prev_gate[i]:
                events.append((t, i, "gate", f"G{gate[i]}"))
            if fin[i] and not prev_fin[i]:
                events.append((t, i, "finish", "FINISH"))
            if elim[i] and not prev_elim[i]:
                events.append((t, i, "elim", "ELIMINATED"))
        prev_gate, prev_elim, prev_fin = gate.copy(), elim, fin
        step += 1
    env.close()
    track = {
        "gates": np.asarray(cfg.gates, dtype=float),
        "obstacles": np.asarray(cfg.obstacles, dtype=float),
    }
    return (np.asarray(poses), np.asarray(gates_t), events, track,
            env.CTRL_FREQ)


def render_report(poses, gates_t, events, track, ctrl_freq, out_path,
                  title=""):
    """Draw the report figure to ``out_path`` (PNG); needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    T, N = poses.shape[:2]
    t_axis = (np.arange(T) + 1) / ctrl_freq
    fig = plt.figure(figsize=(13, 9))
    grid = fig.add_gridspec(3, 2, height_ratios=[3, 1.4, 1.1],
                            hspace=0.45, wspace=0.25)

    # --- track map (a spatial form: the data's job is geometry) -----------
    ax = fig.add_subplot(grid[0, :])
    for g_i, g in enumerate(track["gates"]):
        x, y, yaw = g[0], g[1], g[5]
        dx, dy = 0.25 * np.cos(yaw), 0.25 * np.sin(yaw)
        ax.plot([x - dx, x + dx], [y - dy, y + dy], color=INK, lw=3,
                solid_capstyle="butt")
        ax.annotate(f"gate {g_i + 1}", (x, y), textcoords="offset points",
                    xytext=(6, 6), fontsize=9, color=INK)
    for o in track["obstacles"]:
        ax.add_patch(plt.Circle((o[0], o[1]), 0.05, color=MUTED))
    for i in range(N):
        c = DRONE_COLORS[i % len(DRONE_COLORS)]
        ax.plot(poses[:, i, 0], poses[:, i, 1], color=c, lw=2,
                label=f"drone {i}")
        ax.plot(poses[0, i, 0], poses[0, i, 1], "o", color=c, ms=8)
        ax.plot(poses[-1, i, 0], poses[-1, i, 1], "s", color=c, ms=8)
    ax.set_xlabel("x [m]", color=INK)
    ax.set_ylabel("y [m]", color=INK)
    ax.set_title(title or "track map (o start, ■ end)", color=INK)
    ax.set_aspect("equal")
    ax.grid(alpha=0.2)
    if N > 1:
        ax.legend(frameon=False, fontsize=9)

    # --- altitude and speed (change over time; one axis each) -------------
    ax_z = fig.add_subplot(grid[1, 0])
    ax_v = fig.add_subplot(grid[1, 1])
    for i in range(N):
        c = DRONE_COLORS[i % len(DRONE_COLORS)]
        ax_z.plot(t_axis, poses[:, i, 2], color=c, lw=2)
        speed = np.linalg.norm(poses[:, i, 3:6], axis=-1)
        ax_v.plot(t_axis, speed, color=c, lw=2)
    for t, i, kind, label in events:
        if kind == "gate":
            ax_z.axvline(t, color=MUTED, lw=0.8, alpha=0.6)
    ax_z.set_xlabel("time [s]", color=INK)
    ax_z.set_ylabel("altitude [m]", color=INK)
    ax_z.set_title("altitude (gate passes marked)", fontsize=10, color=INK)
    ax_z.grid(alpha=0.2)
    ax_v.set_xlabel("time [s]", color=INK)
    ax_v.set_ylabel("speed [m/s]", color=INK)
    ax_v.set_title("speed", fontsize=10, color=INK)
    ax_v.grid(alpha=0.2)

    # --- race timeline (the GUI race timer, kept) -------------------------
    ax_e = fig.add_subplot(grid[2, :])
    marker = {"gate": "o", "finish": "*", "elim": "x"}
    span = float(t_axis[-1]) or 1.0
    last_label_t = {}
    for t, i, kind, label in sorted(events):
        c = DRONE_COLORS[i % len(DRONE_COLORS)]
        ax_e.plot(t, i, marker[kind], color=c,
                  ms=13 if kind == "finish" else 8)
        # labels within 5% of the previous one go below it
        below = (i in last_label_t
                 and t - last_label_t[i][0] < 0.05 * span
                 and last_label_t[i][1] > 0)
        ax_e.annotate(f"{label} {t:.2f}s", (t, i),
                      textcoords="offset points",
                      xytext=(0, -16 if below else 9),
                      fontsize=8, ha="center", color=INK)
        last_label_t[i] = (t, 0 if below else 9)
    ax_e.set_yticks(range(N))
    ax_e.set_yticklabels([f"drone {i}" for i in range(N)], color=INK)
    ax_e.set_ylim(-0.7, N - 0.3)
    ax_e.set_xlim(0, float(t_axis[-1]) + 0.5)
    ax_e.set_xlabel("time [s]", color=INK)
    ax_e.set_title("race timeline", fontsize=10, color=INK)
    ax_e.grid(alpha=0.2, axis="x")

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="getting_started",
                    help="a bundled config name or a YAML path")
    ap.add_argument("--controller", default="hardcoded",
                    help="a port agent's name or a controller module path")
    ap.add_argument("--n_drones", type=int, default=2)
    ap.add_argument("--racemode", default="compare",
                    choices=["compare", "compete"])
    ap.add_argument("--out", default="results/flight_report.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    poses, gates_t, events, track, freq = record_episode(
        args.config, args.controller, args.n_drones, args.racemode,
        device=args.device)
    out = render_report(
        poses, gates_t, events, track, freq, args.out,
        title=f"{Path(args.config).stem} — {Path(args.controller).stem}")
    for t, i, kind, label in events:
        print(f"[{t:6.2f}s] drone {i}: {label}")
    print("report:", out)
    return out


if __name__ == "__main__":
    main()
