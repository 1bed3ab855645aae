"""Host-side flight logger: npy/csv export + matplotlib plots.

Counterpart of gym_pybullet_adrp_tpu.utils.logger (``Logger`` :17,
``log`` :36, ``save`` :62, ``save_as_csv`` :75, ``plot`` :93): the
reference's utils/logger.py:16-379 (preallocated per-drone state and
control timeseries, ``.npy`` save, per-channel CSV export with the
RPM -> PWM conversion, a 10 x 2 matplotlib grid). Logging is a host
concern: numpy only, fed the state vectors the envs return; matplotlib is
imported by ``plot`` alone (the card's machine has none).
"""

import os
from datetime import datetime

import numpy as np

from .constants import PWM2RPM_CONST, PWM2RPM_SCALE


class Logger:
    """Fixed-rate flight telemetry buffers (reference
    Logger.__init__:22-79)."""

    def __init__(self, logging_freq_hz: int, output_folder: str = "results",
                 num_drones: int = 1, duration_sec: int = 0,
                 colab: bool = False):
        self.COLAB = colab
        self.OUTPUT_FOLDER = output_folder
        os.makedirs(output_folder, exist_ok=True)
        self.LOGGING_FREQ_HZ = logging_freq_hz
        self.NUM_DRONES = num_drones
        self.PREALLOCATED_ARRAYS = duration_sec > 0
        self.counters = np.zeros(num_drones, dtype=int)
        steps = duration_sec * logging_freq_hz
        self.timestamps = np.zeros((num_drones, steps))
        # 16 channels: pos(3) vel(3) rpy(3) ang_vel(3) rpm(4)
        self.states = np.zeros((num_drones, 16, steps))
        # 12 channels: control reference trace
        self.controls = np.zeros((num_drones, 12, steps))

    def log(self, drone: int, timestamp, state, control=np.zeros(12)):
        """Append one sample (reference log:83-119; reorders the 20-dim env
        state vector into the 16-channel layout)."""
        if drone < 0 or drone >= self.NUM_DRONES or timestamp < 0 \
                or len(state) != 20 or len(control) != 12:
            print("[ERROR] in Logger.log(), invalid data")
            return
        current_counter = int(self.counters[drone])
        if current_counter >= self.timestamps.shape[1]:
            self.timestamps = np.concatenate(
                (self.timestamps, np.zeros((self.NUM_DRONES, 1))), axis=1
            )
            self.states = np.concatenate(
                (self.states, np.zeros((self.NUM_DRONES, 16, 1))), axis=2
            )
            self.controls = np.concatenate(
                (self.controls, np.zeros((self.NUM_DRONES, 12, 1))), axis=2
            )
        self.timestamps[drone, current_counter] = timestamp
        state = np.asarray(state)
        self.states[drone, :, current_counter] = np.hstack(
            [state[0:3], state[10:13], state[7:10], state[13:20]]
        )
        self.controls[drone, :, current_counter] = np.asarray(control)
        self.counters[drone] = current_counter + 1

    def save(self):
        """Save as compressed npy (reference save:123-127)."""
        path = os.path.join(
            self.OUTPUT_FOLDER,
            "save-flight-" + datetime.now().strftime("%m.%d.%Y_%H.%M.%S")
            + ".npy",
        )
        with open(path, "wb") as f:
            np.savez(
                f, timestamps=self.timestamps, states=self.states,
                controls=self.controls,
            )
        return path

    def save_as_csv(self, comment: str = ""):
        """Per-channel CSV export (reference save_as_csv:131-201)."""
        stamp = datetime.now().strftime("%m.%d.%Y_%H.%M.%S")
        dest = os.path.join(self.OUTPUT_FOLDER,
                            "save-flight-" + comment + "-" + stamp)
        os.makedirs(dest, exist_ok=True)
        t = np.arange(self.timestamps.shape[1]) / self.LOGGING_FREQ_HZ
        names = ["x", "y", "z", "vx", "vy", "vz", "r", "p", "ya",
                 "wx", "wy", "wz", "rpm0", "rpm1", "rpm2", "rpm3"]
        for i in range(self.NUM_DRONES):
            for ch, name in enumerate(names):
                with open(os.path.join(dest, f"{name}{i}.csv"), "wb") as f:
                    np.savetxt(f, np.transpose(
                        np.vstack([t, self.states[i, ch, :]])),
                        delimiter=",")
            for m in range(4):
                pwm = ((self.states[i, 12 + m, :] - PWM2RPM_CONST)
                       / PWM2RPM_SCALE)
                with open(os.path.join(dest, f"pwm{m}-{i}.csv"), "wb") as f:
                    np.savetxt(f, np.transpose(np.vstack([t, pwm])),
                               delimiter=",")
        return dest

    def plot(self, pwm=False):
        """10×2 grid of state channels (reference plot:205-379)."""
        import matplotlib.pyplot as plt

        t = np.arange(self.timestamps.shape[1]) / self.LOGGING_FREQ_HZ
        fig, axs = plt.subplots(10, 2, figsize=(12, 18))
        labels_left = ["x (m)", "y (m)", "z (m)", "r (rad)", "p (rad)",
                       "y (rad)", "wx", "wy", "wz", "rpm0"]
        channels_left = [0, 1, 2, 6, 7, 8, 9, 10, 11, 12]
        labels_right = ["vx (m/s)", "vy (m/s)", "vz (m/s)", "rpm1", "rpm2",
                        "rpm3", "ax", "ay", "az", "rpm0-pwm"]
        for row in range(10):
            for j in range(self.NUM_DRONES):
                axs[row, 0].plot(t, self.states[j, channels_left[row], :],
                                 label=f"drone_{j}")
            axs[row, 0].set_ylabel(labels_left[row])
            axs[row, 0].set_xlabel("time (s)")
        right_channels = [3, 4, 5, 13, 14, 15]
        for row, ch in enumerate(right_channels):
            for j in range(self.NUM_DRONES):
                val = self.states[j, ch, :]
                if pwm and ch >= 12:
                    val = (val - PWM2RPM_CONST) / PWM2RPM_SCALE
                axs[row, 1].plot(t, val, label=f"drone_{j}")
            axs[row, 1].set_ylabel(labels_right[row])
            axs[row, 1].set_xlabel("time (s)")
        # finite-difference accelerations (reference plots vx-derived accel)
        for k, ch in enumerate([3, 4, 5]):
            for j in range(self.NUM_DRONES):
                acc = np.gradient(self.states[j, ch, :],
                                  1.0 / self.LOGGING_FREQ_HZ)
                axs[6 + k, 1].plot(t, acc, label=f"drone_{j}")
            axs[6 + k, 1].set_ylabel(labels_right[6 + k])
        axs[0, 0].legend(loc="upper right", frameon=True)
        fig.subplots_adjust(left=0.06, bottom=0.05, right=0.99, top=0.98,
                            wspace=0.15, hspace=0.0)
        if self.COLAB:
            path = os.path.join(
                self.OUTPUT_FOLDER,
                "output_figure-"
                + datetime.now().strftime("%m.%d.%Y_%H.%M.%S") + ".png",
            )
            plt.savefig(path)
            print("saved figure:", path)
        else:
            plt.show(block=False)
        return fig
