"""Port: live_fly.py, the live RPM sliders over a running CtrlAviary, on
CPU: the assertions of the JAX script's test (tests/test_utils.py:197) on
``serve(port=0, device="cpu")`` (the OS picks a free port, so the test
never collides with another server), the frame a PNG written without PIL
and equal, decoded, to the renderer's frame at 4x; the page's slider
ranges from the env's RPMs; unknown paths 404.
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gym_pybullet_adrp_tpu_torch import live_fly
from gym_pybullet_adrp_tpu_torch.utils.rendering import read_png

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture()
def server():
    httpd = live_fly.serve(port=0, device="cpu")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)


def _post(url, data):
    return urllib.request.urlopen(urllib.request.Request(url, data=data,
                                                         method="POST"))


def test_live_fly_sliders_drive_running_sim(server):
    httpd, base = server
    assert httpd.server_address[1] != 0
    page = urllib.request.urlopen(base + "/").read().decode()
    assert "input type=range" in page and "/rpm" in page
    sim = httpd.sim
    assert f"max={int(sim.env.MAX_RPM)}" in page
    assert f"value={int(sim.env.HOVER_RPM)}" in page
    _post(base + "/rpm", b"[21000,21000,21000,21000]")
    s0 = json.loads(urllib.request.urlopen(base + "/state").read())
    time.sleep(0.3)
    s1 = json.loads(urllib.request.urlopen(base + "/state").read())
    time.sleep(0.3)
    s2 = json.loads(urllib.request.urlopen(base + "/state").read())
    assert s2["t"] > s0["t"]                       # the sim runs live
    assert s2["pos"][2] > s0["pos"][2] + 0.05      # the sliders act: climbs
    assert s2["rpm"] == [21000.0] * 4
    png = base64.b64decode(s1["png"])
    assert png[:8] == b"\x89PNG\r\n\x1a\n"          # the live frame streams
    img = read_png(png)
    assert img.shape == (384, 512, 3)
    small = sim.frame(np.asarray(s1["pos"], dtype=np.float32))
    np.testing.assert_array_equal(img, np.repeat(np.repeat(small, 4, 0), 4,
                                                 1))
    assert sim.n_steps > 0 and sim.step_seconds > 0
    assert sim.n_polls == 3 and sim.frame_seconds > 0
    _post(base + "/reset", b"")
    s3 = json.loads(urllib.request.urlopen(base + "/state").read())
    assert s3["pos"][2] < s2["pos"][2]


def test_live_fly_clips_rpm_and_404(server):
    httpd, base = server
    _post(base + "/rpm", b"[-5, 1e9, 100, 200]")
    assert httpd.sim.rpm.tolist() == [[0.0, httpd.sim.env.MAX_RPM, 100.0,
                                       200.0]]
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(base + "/nowhere")
