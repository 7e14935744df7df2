"""Classic-control environments (CartPole, Pendulum), batched over N envs.

Counterpart of `sample_factory_tpu/envs/builtin/classic_control.py`: the
standard published dynamics (Barto-Sutton-Anderson cart-pole; the
underactuated pendulum swing-up as in gymnasium), written from the equations
of motion for [N] tensors. The dynamics draw nothing; only the resets do.
"""

from __future__ import annotations

import math

import torch

from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec


def _uniform(shape, low, high, generator, device):
    return torch.rand(shape, generator=generator, device=device) * (high - low) + low


class CartPoleEnv(DeviceEnv):
    """Cart-pole balancing. Discrete(2); reward 1 per step; 500-step limit."""

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masscart + masspole
    length = 0.5  # half pole length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4
    max_steps = 500

    obs_space = make_dict_spec({"obs": Box((4,))})
    action_space = Discrete(2)

    def reset_draws(self, num_envs, generator, device):
        return {"s": _uniform((num_envs, 4), -0.05, 0.05, generator, device)}

    def _reset(self, num_envs, device, draws):
        s = draws["s"].to(device=device, dtype=torch.float32)
        return {"obs": s}, {"s": s, "steps": torch.zeros((num_envs,), dtype=torch.int32, device=device)}

    def _step(self, state, actions, draws, shaping):
        x, x_dot, theta, theta_dot = state["s"].unbind(-1)
        a = actions[..., 0] if actions.dim() > 1 else actions
        force = torch.where(a.long() == 1, self.force_mag, -self.force_mag)

        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        temp = (force + self.polemass_length * theta_dot**2 * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass

        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc

        s = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        steps = state["steps"] + 1
        terminated = (x.abs() > self.x_threshold) | (theta.abs() > self.theta_threshold)
        truncated = steps >= self.max_steps
        return {"obs": s}, {"s": s, "steps": steps}, torch.ones_like(x), terminated, truncated, {}


class PendulumEnv(DeviceEnv):
    """Pendulum swing-up. Box(1) torque in [-2, 2]; 200-step limit."""

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0
    max_steps = 200

    obs_space = make_dict_spec({"obs": Box((3,))})
    action_space = Box((1,), -2.0, 2.0)

    @staticmethod
    def _obs(th, thdot):
        return {"obs": torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)}

    def reset_draws(self, num_envs, generator, device):
        return {
            "th": _uniform((num_envs,), -math.pi, math.pi, generator, device),
            "thdot": _uniform((num_envs,), -1.0, 1.0, generator, device),
        }

    def _reset(self, num_envs, device, draws):
        th = draws["th"].to(device=device, dtype=torch.float32)
        thdot = draws["thdot"].to(device=device, dtype=torch.float32)
        state = {"th": th, "thdot": thdot, "steps": torch.zeros((num_envs,), dtype=torch.int32, device=device)}
        return self._obs(th, thdot), state

    def _step(self, state, actions, draws, shaping):
        th, thdot = state["th"], state["thdot"]
        u = (actions[..., 0] if actions.dim() > 1 else actions).float().clamp(-self.max_torque, self.max_torque)

        angle_norm = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = angle_norm**2 + 0.1 * thdot**2 + 0.001 * u**2

        newthdot = thdot + (3 * self.g / (2 * self.length) * torch.sin(th) + 3.0 / (self.m * self.length**2) * u) * self.dt
        newthdot = newthdot.clamp(-self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt

        steps = state["steps"] + 1
        truncated = steps >= self.max_steps
        terminated = torch.zeros_like(truncated)
        new_state = {"th": newth, "thdot": newthdot, "steps": steps}
        return self._obs(newth, newthdot), new_state, -cost, terminated, truncated, {}
