"""Play-time state/reward logger (numpy only; copy of
legged_gym_custom_tpu/utils/logger.py, reference utils/logger.py:36-137).

Per-step state and reward accumulation with an optional 3x3 matplotlib
dashboard (rendered in-process or saved to file; the reference used a
subprocess, unnecessary here).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


class Logger:
    def __init__(self, dt: float):
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.dt = dt
        self.num_episodes = 0

    def log_state(self, key, value):
        self.state_log[key].append(value)

    def log_states(self, d: dict):
        for key, value in d.items():
            self.log_state(key, value)

    def log_rewards(self, d: dict, num_episodes: int):
        for key, value in d.items():
            if "rew" in key:
                self.rew_log[key].append(float(value) * num_episodes)
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()

    def plot_states(self, save_path=None):
        import matplotlib

        if save_path is not None:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nb_rows, nb_cols = 3, 3
        fig, axs = plt.subplots(nb_rows, nb_cols, figsize=(14, 10))
        log = self.state_log
        time = np.linspace(0, len(next(iter(log.values()), [0])) * self.dt,
                           max(len(next(iter(log.values()), [0])), 1))

        def plot(ax, keys, title, ylab):
            for k in keys:
                if log.get(k):
                    ax.plot(time[: len(log[k])], log[k], label=k)
            ax.set(xlabel="time [s]", ylabel=ylab, title=title)
            ax.legend(fontsize="x-small")

        plot(axs[0, 0], ["dof_pos", "dof_pos_target"], "DOF Position", "[rad]")
        plot(axs[0, 1], ["dof_vel"], "Joint Velocity", "[rad/s]")
        plot(axs[0, 2], ["base_vel_x", "command_x"], "Base velocity x", "[m/s]")
        plot(axs[1, 0], ["base_vel_y", "command_y"], "Base velocity y", "[m/s]")
        plot(axs[1, 1], ["base_vel_yaw", "command_yaw"], "Base velocity yaw", "[rad/s]")
        plot(axs[1, 2], ["base_vel_z"], "Base velocity z", "[m/s]")
        if log.get("contact_forces_z"):
            forces = np.array(log["contact_forces_z"])
            for i in range(forces.shape[1]):
                axs[2, 0].plot(time[: forces.shape[0]], forces[:, i], label=f"foot {i}")
            axs[2, 0].set(xlabel="time [s]", ylabel="[N]", title="Vertical contact forces")
            axs[2, 0].legend(fontsize="x-small")
        plot(axs[2, 1], ["dof_torque"], "Joint Torque", "[Nm]")
        if save_path is not None:
            fig.savefig(save_path, dpi=100)
            plt.close(fig)
        else:
            plt.show()

    def print_rewards(self):
        print("Average rewards per second:")
        for key, values in self.rew_log.items():
            mean = np.sum(np.array(values)) / max(self.num_episodes, 1)
            print(f" - {key}: {mean}")
        print(f"Total number of episodes: {self.num_episodes}")
