"""Interactive wall-clock race replay (one self-contained HTML file).

Counterpart of scripts/replay_viewer.py (``_TEMPLATE`` :32, ``build_html``
:261, ``main`` :293): the live counterpart of the reference's GUI views
(PyBullet's sliders, debug axes and race timer, BaseAviary.py:162-167,
:922-958, scripts/sim.py:82-90) as an artifact made offline. It flies a
race episode through ``flight_report.record_episode`` (``MultiRaceAviary``
on ``device``, the card unless the caller asks for the CPU) and writes ONE
HTML file, with no network and no dependencies, that replays the episode
in wall-clock time: a top-down track canvas with the drones and their
trails, an altitude lane, play/pause (space), a scrub bar, 0.25-4x
speed, a race timer and each drone's gate, finish and elimination
events. ``build_html`` needs the standard library and numpy only.

Usage:
  python -m gym_pybullet_adrp_tpu_torch.replay_viewer --config \\
      getting_started --controller hardcoded --n_drones 2 \\
      [--out results/replay.html] [--device cpu]
"""

import argparse
import json
from pathlib import Path

import numpy as np

from .flight_report import DRONE_COLORS, record_episode

# the page, as the JAX package's :32-258, with __TITLE__, __PALETTE__,
# __DATA__ and __COLORS__ filled in by build_html
_TEMPLATE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>race replay — __TITLE__</title>
<style>
  :root {
    --surface: #ffffff; --panel: #f4f4f2; --ink: #333333;
    --muted: #8a8a8a; --grid: #e4e4e1; --accent: #0072B2;
  }
  @media (prefers-color-scheme: dark) {
    :root { --surface: #1a1a1e; --panel: #242428; --ink: #e8e8e6;
            --muted: #9a9a98; --grid: #34343a; }
  }
  html, body { margin: 0; background: var(--surface); color: var(--ink);
    font: 14px/1.45 -apple-system, "Segoe UI", Roboto, sans-serif; }
  .wrap { max-width: 980px; margin: 0 auto; padding: 16px; }
  h1 { font-size: 17px; font-weight: 600; margin: 4px 0 2px; }
  .sub { color: var(--muted); font-size: 12.5px; margin-bottom: 10px; }
  canvas { width: 100%; height: auto; background: var(--panel);
    border-radius: 10px; display: block; }
  #alt { margin-top: 8px; }
  .bar { display: flex; gap: 10px; align-items: center; margin: 12px 0; }
  button { background: var(--accent); border: 0; color: #fff;
    border-radius: 7px; padding: 6px 14px; font: inherit; cursor: pointer;
    min-width: 74px; }
  select { font: inherit; background: var(--panel); color: var(--ink);
    border: 1px solid var(--grid); border-radius: 7px; padding: 4px 6px; }
  input[type=range] { flex: 1; accent-color: var(--accent); }
  .clock { font-variant-numeric: tabular-nums; font-weight: 600;
    min-width: 72px; }
  .legend { display: flex; gap: 16px; flex-wrap: wrap; margin: 6px 0;
    font-size: 13px; }
  .legend .sw { display: inline-block; width: 10px; height: 10px;
    border-radius: 3px; margin-right: 6px; vertical-align: -1px; }
  .events { margin-top: 10px; font-size: 13px; max-height: 150px;
    overflow-y: auto; border-top: 1px solid var(--grid); padding-top: 6px; }
  .events div { padding: 1.5px 0; color: var(--muted); }
  .events .hit { color: var(--ink); }
  .events .t { display: inline-block; min-width: 58px;
    font-variant-numeric: tabular-nums; }
</style>
</head>
<body data-palette="__PALETTE__">
<div class="wrap">
  <h1>__TITLE__</h1>
  <div class="sub">interactive wall-clock replay — space = play/pause,
    drag to scrub. o start markers; gates numbered in pass order.</div>
  <div class="legend" id="legend"></div>
  <canvas id="map" width="1920" height="1080"></canvas>
  <canvas id="alt" width="1920" height="220"></canvas>
  <div class="bar">
    <button id="play">Play</button>
    <span class="clock" id="clock">0.00 s</span>
    <input type="range" id="scrub" min="0" max="1000" value="0">
    <select id="speed">
      <option value="0.25">0.25x</option><option value="0.5">0.5x</option>
      <option value="1" selected>1x</option><option value="2">2x</option>
      <option value="4">4x</option>
    </select>
  </div>
  <div class="events" id="events"></div>
</div>
<script>
const D = __DATA__;
const COLORS = __COLORS__;
const N = D.poses[0].length, T = D.poses.length, DT = 1.0 / D.ctrl_freq;
const DUR = T * DT;
const css = k => getComputedStyle(document.body).getPropertyValue(k);

// legend (identity never color-alone: swatch + name; >=2 series)
const legend = document.getElementById('legend');
for (let i = 0; i < N; i++) {
  const s = document.createElement('span');
  s.innerHTML = `<span class="sw" style="background:${COLORS[i]}"></span>` +
    `drone ${i}`;
  legend.appendChild(s);
}

// world->canvas transform (track bounds + margin)
const map = document.getElementById('map'), mc = map.getContext('2d');
const xs = [], ys = [];
for (const g of D.track.gates) { xs.push(g[0]); ys.push(g[1]); }
for (const o of D.track.obstacles) { xs.push(o[0]); ys.push(o[1]); }
for (const f of D.poses) for (const p of f) { xs.push(p[0]); ys.push(p[1]); }
const pad = 0.45;
const x0 = Math.min(...xs) - pad, x1 = Math.max(...xs) + pad;
const y0 = Math.min(...ys) - pad, y1 = Math.max(...ys) + pad;
const sc = Math.min(map.width / (x1 - x0), map.height / (y1 - y0));
const ox = (map.width - sc * (x1 - x0)) / 2;
const oy = (map.height - sc * (y1 - y0)) / 2;
const X = x => ox + sc * (x - x0);
const Y = y => map.height - (oy + sc * (y - y0));

const alt = document.getElementById('alt'), ac = alt.getContext('2d');
const zMax = Math.max(1.1, ...D.poses.flat().map(p => p[2])) * 1.1;

function frameAt(t) {
  return Math.max(0, Math.min(T - 1, Math.round(t / DT) - 1));
}

function drawMap(t) {
  const ink = css('--ink'), muted = css('--muted');
  mc.clearRect(0, 0, map.width, map.height);
  // gates: numbered oriented segments
  mc.lineWidth = 7; mc.strokeStyle = ink; mc.fillStyle = ink;
  mc.font = '600 26px sans-serif';
  D.track.gates.forEach((g, i) => {
    const dx = 0.25 * Math.cos(g[5]), dy = 0.25 * Math.sin(g[5]);
    mc.beginPath();
    mc.moveTo(X(g[0] - dx), Y(g[1] - dy));
    mc.lineTo(X(g[0] + dx), Y(g[1] + dy));
    mc.stroke();
    mc.fillText(String(i + 1), X(g[0]) + 10, Y(g[1]) - 10);
  });
  mc.fillStyle = muted;
  for (const o of D.track.obstacles) {
    mc.beginPath();
    mc.arc(X(o[0]), Y(o[1]), 0.06 * sc, 0, 7); mc.fill();
  }
  const k = frameAt(t);
  for (let i = 0; i < N; i++) {
    // trail up to now (thin line, series color)
    mc.lineWidth = 3; mc.strokeStyle = COLORS[i]; mc.globalAlpha = 0.55;
    mc.beginPath();
    for (let j = 0; j <= k; j++) {
      const p = D.poses[j][i];
      j ? mc.lineTo(X(p[0]), Y(p[1])) : mc.moveTo(X(p[0]), Y(p[1]));
    }
    mc.stroke(); mc.globalAlpha = 1;
    // start marker
    const s0 = D.poses[0][i];
    mc.beginPath(); mc.arc(X(s0[0]), Y(s0[1]), 7, 0, 7);
    mc.strokeStyle = COLORS[i]; mc.lineWidth = 3; mc.stroke();
    // drone: >=8px marker with 2px surface ring
    const p = D.poses[k][i];
    mc.beginPath(); mc.arc(X(p[0]), Y(p[1]), 11, 0, 7);
    mc.fillStyle = COLORS[i]; mc.fill();
    mc.lineWidth = 4; mc.strokeStyle = css('--panel'); mc.stroke();
    const st = D.status[k][i];   // 0 fly, 1 finished, 2 eliminated
    if (st) {  // status never color-alone: glyph on the mark
      mc.fillStyle = css('--panel');
      mc.font = '600 16px sans-serif'; mc.textAlign = 'center';
      mc.fillText(st === 1 ? '\\u2713' : '\\u00d7',
                  X(p[0]), Y(p[1]) + 5.5);
      mc.textAlign = 'start'; mc.font = '600 26px sans-serif';
    }
  }
}

function drawAlt(t) {
  ac.clearRect(0, 0, alt.width, alt.height);
  ac.strokeStyle = css('--grid'); ac.lineWidth = 2;
  ac.strokeRect(1, 1, alt.width - 2, alt.height - 2);
  ac.fillStyle = css('--muted'); ac.font = '22px sans-serif';
  ac.fillText('altitude [m]', 14, 30);
  const k = frameAt(t);
  for (let i = 0; i < N; i++) {
    ac.lineWidth = 3; ac.strokeStyle = COLORS[i];
    ac.beginPath();
    for (let j = 0; j <= k; j++) {
      const x = (j / (T - 1)) * (alt.width - 20) + 10;
      const y = alt.height - 12 - (D.poses[j][i][2] / zMax) *
        (alt.height - 44);
      j ? ac.lineTo(x, y) : ac.moveTo(x, y);
    }
    ac.stroke();
  }
  const cx = (k / (T - 1)) * (alt.width - 20) + 10;
  ac.strokeStyle = css('--muted'); ac.lineWidth = 2;
  ac.beginPath(); ac.moveTo(cx, 8); ac.lineTo(cx, alt.height - 8);
  ac.stroke();
}

// event ticker
const evDiv = document.getElementById('events');
const evRows = D.events.map(e => {
  const d = document.createElement('div');
  const icon = e[2] === 'finish' ? '\\u2713' :
    e[2] === 'elim' ? '\\u00d7' : '\\u25b8';
  d.innerHTML = `<span class="t">${e[0].toFixed(2)} s</span>` +
    `<span class="sw" style="background:${COLORS[e[1]]};display:` +
    `inline-block;width:9px;height:9px;border-radius:3px;margin:0 6px ` +
    `0 0;"></span>drone ${e[1]} ${icon} ${e[3]}`;
  evDiv.appendChild(d);
  return d;
});

let t = 0, playing = false, last = null;
const playBtn = document.getElementById('play');
const scrub = document.getElementById('scrub');
const speedSel = document.getElementById('speed');
const clock = document.getElementById('clock');

function render() {
  drawMap(t); drawAlt(t);
  clock.textContent = t.toFixed(2) + ' s';
  scrub.value = Math.round((t / DUR) * 1000);
  evRows.forEach((d, i) =>
    d.className = D.events[i][0] <= t ? 'hit' : '');
}

function tick(now) {
  if (playing) {
    if (last !== null) {
      t += (now - last) / 1000 * parseFloat(speedSel.value);
      if (t >= DUR) { t = DUR; playing = false; playBtn.textContent = 'Replay'; }
    }
    last = now; render();
  } else { last = null; }
  requestAnimationFrame(tick);
}
playBtn.onclick = () => {
  if (t >= DUR) t = 0;
  playing = !playing;
  playBtn.textContent = playing ? 'Pause' : 'Play';
};
document.addEventListener('keydown', e => {
  if (e.code === 'Space') { e.preventDefault(); playBtn.onclick(); }
});
scrub.oninput = () => { t = (scrub.value / 1000) * DUR; render(); };
render();
requestAnimationFrame(tick);
</script>
</body>
</html>
"""


def build_html(poses, gates_t, events, track, ctrl_freq, title):
    """The replay page of a recorded episode (``record_episode``'s
    outputs; ``gates_t`` is not read)."""
    T, N = poses.shape[:2]
    # each frame's drone status from the events (0 flying, 1 finished,
    # 2 eliminated)
    status = np.zeros((T, N), dtype=int)
    for t_e, drone, kind, _ in events:
        k = min(T - 1, max(0, int(round(t_e * ctrl_freq)) - 1))
        if kind == "finish":
            status[k:, drone] = 1
        elif kind == "elim":
            status[k:, drone] = 2
    data = {
        "ctrl_freq": float(ctrl_freq),
        "poses": np.round(poses[:, :, :3], 4).tolist(),
        "status": status.tolist(),
        "events": [[round(float(t), 3), int(d), k, str(lbl)]
                   for t, d, k, lbl in events],
        "track": {
            "gates": np.asarray(track["gates"]).tolist(),
            "obstacles": np.asarray(track["obstacles"]).tolist(),
        },
    }
    colors = DRONE_COLORS[:max(N, 1)]
    return (
        _TEMPLATE
        .replace("__TITLE__", title)
        .replace("__PALETTE__", ",".join(colors))
        .replace("__DATA__", json.dumps(data))
        .replace("__COLORS__", json.dumps(colors))
    )


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
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default="results/replay.html")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    poses, gates_t, events, track, ctrl_freq = record_episode(
        args.config, args.controller, args.n_drones, args.racemode,
        args.seed, device=args.device)
    title = (f"{Path(args.config).stem} — {args.n_drones} drone(s), "
             f"{args.racemode.upper()}, {Path(args.controller).stem}")
    html = build_html(poses, gates_t, events, track, ctrl_freq, title)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(html)
    print(f"wrote {out} ({poses.shape[0]} frames, {len(events)} events, "
          f"{poses.shape[0] / ctrl_freq:.2f} s episode)")
    return out


if __name__ == "__main__":
    main()
