"""AntEnv: an on-device rigid-body quadruped with real physics, batched over N envs.

Counterpart of `sample_factory_tpu/envs/builtin/ant.py`: the same minimal
maximal-coordinate rigid-body simulator, written for [N, ...] tensors instead
of one instance under vmap. Not a port of any engine.

Model (the classic MuJoCo/IsaacGym ant topology):
  - 9 rigid bodies: spherical torso + 4 legs x (upper, lower) capsule links,
    each with position, quaternion, linear and angular velocity
  - 8 joints: per leg a hip (swing about the vertical axis) and an ankle
    (flexion about the horizontal axis perpendicular to the leg), modelled as
    stiff ball-socket spring-dampers (anchor coincidence) plus hinge-axis
    alignment torques: penalty-based articulation, no constraint solver
  - 8 torque actuators about the hinge axes, joint-angle soft limits
  - ground contact: per-body collision spheres with a normal spring-damper
    and Coulomb-clamped viscous tangential friction
  - semi-implicit Euler at dt = 1/(60*substeps), `substeps` inner steps per
    control step (a Python loop), quaternion integration + renormalization

Reward/termination follow the Ant convention: forward (+x) torso velocity
+ alive bonus - ctrl cost; unhealthy (torso z out of range, or flipped)
terminates, 1000 control steps truncate. Float32 throughout. The geometry
constants are built once with numpy and moved to the env's device at first use.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.spaces import Box, make_dict_spec

# ----------------------------------------------------------- quaternion utils
# scalar-first quaternions [w, x, y, z]


def cross(a, b):
    """Cross product over the last axis, broadcasting the leading ones."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q. Shapes [..., 4], [..., 3]."""
    w, xyz = q[..., :1], q[..., 1:]
    t = 2.0 * cross(xyz, v)
    return v + w * t + cross(xyz, t)


def quat_integrate(q, omega, dt):
    """q <- normalize(q + dt/2 * omega*q) for world-frame angular velocity."""
    w, x, y, z = q.unbind(-1)
    ox, oy, oz = omega.unbind(-1)
    dq = 0.5 * torch.stack(
        [
            -ox * x - oy * y - oz * z,
            ox * w + oy * z - oz * y,
            oy * w + oz * x - ox * z,
            oz * w + ox * y - oy * x,
        ],
        dim=-1,
    )
    q = q + dt * dq
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# ------------------------------------------------------------------- geometry


def _build_geometry() -> Dict[str, np.ndarray]:
    """Constant ant geometry (computed in numpy once at construction).

    Legs point along the 4 horizontal diagonals. Upper legs are horizontal,
    lower legs slope down-outward at 45 deg so the feet rest on the ground at
    the initial torso height.
    """
    torso_r = 0.25
    upper_len = 0.35
    lower_len = 0.45
    diag = np.asarray([[1, 1, 0], [-1, 1, 0], [-1, -1, 0], [1, -1, 0]], np.float64)
    diag /= np.linalg.norm(diag, axis=1, keepdims=True)
    down_out = diag * np.cos(np.pi / 4) + np.asarray([0.0, 0.0, -np.sin(np.pi / 4)])

    torso_z = lower_len * np.sin(np.pi / 4) + 0.08  # feet just at the ground
    bodies = [dict(pos=[0.0, 0.0, torso_z], mass=3.0, radius=torso_r)]
    joints = []
    for i in range(4):
        hip_anchor = diag[i] * torso_r  # on the torso surface (torso frame)
        upper_center = np.asarray([0.0, 0.0, torso_z]) + hip_anchor + diag[i] * (upper_len / 2)
        bodies.append(dict(pos=upper_center.tolist(), mass=0.5, radius=0.06))
        knee_world = np.asarray([0.0, 0.0, torso_z]) + hip_anchor + diag[i] * upper_len
        lower_center = knee_world + down_out[i] * (lower_len / 2)
        bodies.append(dict(pos=lower_center.tolist(), mass=0.4, radius=0.05))

        upper_idx, lower_idx = 1 + 2 * i, 2 + 2 * i
        # hip: torso <-> upper, swings about the vertical axis
        joints.append(
            dict(
                parent=0,
                child=upper_idx,
                anchor_p=hip_anchor.tolist(),  # parent-frame
                anchor_c=(-diag[i] * (upper_len / 2)).tolist(),  # child-frame
                axis=[0.0, 0.0, 1.0],
                limit=np.pi / 5,
            )
        )
        # ankle: upper <-> lower, flexes about the horizontal axis perpendicular to the
        # leg diagonal (tighter limit than the hip: the ankle carries the torso's weight,
        # so its free range bounds how far the stance can crouch)
        perp = np.cross([0.0, 0.0, 1.0], diag[i])
        joints.append(
            dict(
                parent=upper_idx,
                child=lower_idx,
                anchor_p=(diag[i] * (upper_len / 2)).tolist(),
                anchor_c=(-down_out[i] * (lower_len / 2)).tolist(),
                axis=(perp / np.linalg.norm(perp)).tolist(),
                limit=np.pi / 6,
            )
        )

    # collision spheres: torso + both capsule endpoints of every link
    col_body, col_off, col_r = [0], [[0.0, 0.0, 0.0]], [torso_r]
    for i in range(4):
        upper_idx, lower_idx = 1 + 2 * i, 2 + 2 * i
        col_body += [upper_idx, upper_idx, lower_idx, lower_idx]
        col_off += [
            (-diag[i] * (upper_len / 2)).tolist(),
            (diag[i] * (upper_len / 2)).tolist(),
            (-down_out[i] * (lower_len / 2)).tolist(),
            (down_out[i] * (lower_len / 2)).tolist(),
        ]
        col_r += [0.06, 0.06, 0.05, 0.05]

    # rest direction of each child link in the PARENT frame: hip joints swing the upper
    # leg (rest = horizontal diagonal), ankles flex the lower leg (rest = 45 deg
    # down-outward). Joint angles are the deviation of the link direction from this rest
    # direction about the hinge axis. The ankle rest is preloaded ~13 deg further down
    # ("muscle tone"): gravity flexes each ankle by ~asin(gravity_torque / k_rest), and
    # preloading by that angle makes the standing pose the loaded equilibrium.
    def _rodrigues(axis, theta, v):
        axis = axis / np.linalg.norm(axis)
        return v * np.cos(theta) + np.cross(axis, v) * np.sin(theta) + axis * np.dot(axis, v) * (1 - np.cos(theta))

    preload = np.arcsin(0.225)  # ~= gravity ankle torque (~4.5 N*m) / k_rest (20)
    jrest_p = []
    for i in range(4):
        jrest_p.append(diag[i].tolist())  # hip
        ax = np.cross([0.0, 0.0, 1.0], diag[i])
        ax /= np.linalg.norm(ax)
        cand_a = _rodrigues(ax, preload, down_out[i])
        cand_b = _rodrigues(ax, -preload, down_out[i])
        jrest_p.append((cand_a if cand_a[2] < cand_b[2] else cand_b).tolist())  # ankle, foot-down preload

    return dict(
        body_pos=np.asarray([b["pos"] for b in bodies], np.float32),
        body_mass=np.asarray([b["mass"] for b in bodies], np.float32),
        # isotropic inertia (solid-sphere approximation with a fattened radius floor; keeps
        # the angular update diagonal and the penalty articulation's angular stiffness
        # modes inside the integrator's stability region)
        body_inertia=np.asarray([0.4 * b["mass"] * max(b["radius"], 0.16) ** 2 for b in bodies], np.float32),
        jp=np.asarray([j["parent"] for j in joints], np.int64),
        jc=np.asarray([j["child"] for j in joints], np.int64),
        # one-hot accumulation matrices: force/torque contributions sum onto bodies via
        # dense [NB, NJ/NC] x [N, NJ/NC, 3] matmuls instead of scatter-adds
        acc_jp=np.eye(9, dtype=np.float32)[:, [j["parent"] for j in joints]],
        acc_jc=np.eye(9, dtype=np.float32)[:, [j["child"] for j in joints]],
        acc_cb=np.eye(9, dtype=np.float32)[:, col_body],
        ja_p=np.asarray([j["anchor_p"] for j in joints], np.float32),
        ja_c=np.asarray([j["anchor_c"] for j in joints], np.float32),
        jaxis=np.asarray([j["axis"] for j in joints], np.float32),
        jrest_p=np.asarray(jrest_p, np.float32),
        # limits stored as sin(limit): compared against the sine of the deviation angle
        jlimit_sin=np.asarray([np.sin(j["limit"]) for j in joints], np.float32),
        col_body=np.asarray(col_body, np.int64),
        col_off=np.asarray(col_off, np.float32),
        col_r=np.asarray(col_r, np.float32),
    )


class AntEnv(DeviceEnv):
    """On-device ant. Obs (59,): torso z + torso quat + torso lin/ang vel + per-joint
    [bend, twist about the hinge, relative angular velocity (3)] + per-foot contact
    signal + padding. Actions (8,): actuator torques in [-1, 1]."""

    NB = 9  # bodies
    NJ = 8  # joints

    def __init__(self, episode_len: int = 1000, substeps: int = 16, ctrl_hz: float = 60.0):
        self.episode_len = episode_len
        self.substeps = substeps
        self.dt = 1.0 / (ctrl_hz * substeps)
        self._geo_np = _build_geometry()
        self._geo: Dict[str, Dict[str, torch.Tensor]] = {}  # per device
        self.num_col = len(self._geo_np["col_body"])
        self.obs_space = make_dict_spec({"obs": Box((59,), -np.inf, np.inf)})
        self.action_space = Box((self.NJ,), -1.0, 1.0)
        # physics gains (penalty articulation), tuned so every spring-damper mode satisfies
        # omega*dt < ~0.25 and gamma*dt < ~0.5 at the default dt = 1/960 (the
        # semi-implicit-Euler stability budget; the binding mode is the angular joint
        # stiffness k_joint*arm^2/inertia). k_axis is the articulation's structural
        # rigidity (it resists any relative rotation off the hinge axis); it must
        # dominate gravity torques (~8 N*m)
        self.k_joint, self.c_joint = 3000.0, 30.0
        self.k_axis, self.c_axis = 150.0, 1.0
        self.k_contact, self.c_contact = 4000.0, 30.0
        self.friction_mu = 0.9
        self.gear = 6.0
        self.k_limit = 150.0
        # posture spring toward the rest pose (muscle tone; without it the penalty
        # articulation sags at the free hinge DoF until the soft limits engage and the
        # torso sinks into a crouch that kills the locomotion geometry)
        self.k_rest = 20.0
        self.reward_shaping = {"forward_w": 1.0, "ctrl_cost_w": 0.5, "alive_bonus": 0.5}

    def geo(self, device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._geo:
            self._geo[key] = {k: torch.as_tensor(v, device=device) for k, v in self._geo_np.items()}
        return self._geo[key]

    # --------------------------------------------------------------- dynamics

    def _joint_frames(self, geo, quat):
        """Per joint: the hinge axis and the rest direction carried by the parent, and the
        child link's direction, all in the world frame."""
        qp, qc = quat[:, geo["jp"]], quat[:, geo["jc"]]
        ax_p = quat_rotate(qp, geo["jaxis"])
        d_link = quat_rotate(qc, -geo["ja_c"])
        d_link = d_link / (torch.linalg.vector_norm(d_link, dim=-1, keepdim=True) + 1e-6)
        d_rest = quat_rotate(qp, geo["jrest_p"])
        return qp, qc, ax_p, d_link, d_rest

    def _substep(self, geo, pos, quat, vel, ang, torque_act):
        """One semi-implicit Euler step. pos/vel/ang [N, NB, 3], quat [N, NB, 4], torque_act [N, NJ]."""
        gravity = torch.zeros_like(pos)
        gravity[..., 2] = -9.81 * geo["body_mass"]

        # --- joints: ball-socket spring-damper + hinge alignment + actuation
        jp, jc = geo["jp"], geo["jc"]
        qp, qc, ax_p, d_link, d_rest = self._joint_frames(geo, quat)
        rp = quat_rotate(qp, geo["ja_p"])  # world anchor offsets
        rc = quat_rotate(qc, geo["ja_c"])
        wp = pos[:, jp] + rp
        wc = pos[:, jc] + rc
        vp = vel[:, jp] + cross(ang[:, jp], rp)
        vc = vel[:, jc] + cross(ang[:, jc], rc)
        f_j = self.k_joint * (wc - wp) + self.c_joint * (vc - vp)  # pulls anchors together
        force = gravity + (geo["acc_jp"] - geo["acc_jc"]) @ f_j
        torque = geo["acc_jp"] @ cross(rp, f_j) + geo["acc_jc"] @ cross(rc, -f_j)

        # hinge: keep child axis aligned with parent axis; damp relative spin
        ax_c = quat_rotate(qc, geo["jaxis"])
        t_align = self.k_axis * cross(ax_c, ax_p)
        rel_w = ang[:, jc] - ang[:, jp]
        t_damp = self.c_axis * rel_w
        # joint deviation about the hinge axis against the rest link direction carried in
        # the parent frame (exactly 0 at the rest pose): sin(angle) = (d_rest x d_link) . axis
        sin_angle = (cross(d_rest, d_link) * ax_p).sum(-1)
        over = (sin_angle.abs() - geo["jlimit_sin"]).clamp(min=0.0) * torch.sign(sin_angle)
        t_limit = -(self.k_limit * over + self.k_rest * sin_angle)[..., None] * ax_p
        t_act = (torque_act * self.gear)[..., None] * ax_p
        t_child = t_align - t_damp + t_act + t_limit
        torque = torque + (geo["acc_jc"] - geo["acc_jp"]) @ t_child

        # --- ground contact (z = 0 plane) on collision spheres
        cb = geo["col_body"]
        off_w = quat_rotate(quat[:, cb], geo["col_off"])
        cpos = pos[:, cb] + off_w
        cvel = vel[:, cb] + cross(ang[:, cb], off_w)
        depth = geo["col_r"] - cpos[..., 2]
        in_contact = depth > 0.0
        fn = (self.k_contact * depth - self.c_contact * cvel[..., 2]).clamp(min=0.0) * in_contact
        vt = cvel[..., :2]
        vt_norm = torch.linalg.vector_norm(vt, dim=-1, keepdim=True) + 1e-6
        ft_mag = torch.minimum(self.friction_mu * fn, 60.0 * vt_norm[..., 0])
        f_c = torch.cat([-ft_mag[..., None] * vt / vt_norm, fn[..., None]], dim=-1)
        force = force + geo["acc_cb"] @ f_c
        torque = torque + geo["acc_cb"] @ cross(off_w, f_c)

        # --- integrate (semi-implicit Euler, isotropic inertia)
        vel = vel + self.dt * force / geo["body_mass"][:, None]
        ang = ang + self.dt * torque / geo["body_inertia"][:, None]
        # mild global angular damping for numerical robustness
        ang = ang * (1.0 - 0.02 * self.dt * 60.0)
        pos = pos + self.dt * vel
        quat = quat_integrate(quat, ang, self.dt)
        return pos, quat, vel, ang, fn

    def _obs(self, geo, pos, quat, vel, ang, contact_fn):
        _, _, ax_p, d_link, d_rest = self._joint_frames(geo, quat)
        # per joint: rest-relative bend (cos of the deviation, 1 at rest), signed deviation
        # about the hinge axis (sin, 0 at rest) and the relative angular velocity
        bend = (d_rest * d_link).sum(-1)
        twist = (cross(d_rest, d_link) * ax_p).sum(-1)
        rel_w = ang[:, geo["jc"]] - ang[:, geo["jp"]]
        feet_fn = contact_fn[:, 3::4]  # lower-leg outer endpoints = the 4 feet
        obs = torch.cat(
            [
                pos[:, 0, 2:3],  # torso height
                quat[:, 0],  # torso orientation
                vel[:, 0],  # torso linear velocity
                ang[:, 0],  # torso angular velocity
                bend,  # 8
                twist,  # 8
                rel_w.reshape(rel_w.shape[0], -1),  # 24
                torch.tanh(feet_fn / 100.0),  # 4 foot-contact signals
                torch.zeros_like(feet_fn),  # padding to 59 (reserved)
            ],
            dim=-1,
        )
        return {"obs": obs.float()}

    # ---------------------------------------------------------------- env API

    def reset_draws(self, num_envs, generator, device):
        shape = (num_envs, self.NB, 3)
        return {
            "pos": torch.rand(shape, generator=generator, device=device) * 0.02 - 0.01,
            "vel": torch.rand(shape, generator=generator, device=device) * 0.1 - 0.05,
        }

    def _reset(self, num_envs, device, draws):
        geo = self.geo(device)
        pos = geo["body_pos"] + draws["pos"].to(device=device, dtype=torch.float32)
        quat = torch.zeros((num_envs, self.NB, 4), device=device)
        quat[..., 0] = 1.0
        vel = draws["vel"].to(device=device, dtype=torch.float32)
        ang = torch.zeros((num_envs, self.NB, 3), device=device)
        state = dict(pos=pos, quat=quat, vel=vel, ang=ang, steps=torch.zeros((num_envs,), dtype=torch.int32, device=device))
        fn0 = torch.zeros((num_envs, self.num_col), device=device)
        return self._obs(geo, pos, quat, vel, ang, fn0), state

    def _step(self, state, actions, draws, shaping):
        geo = self.geo(actions.device)
        action = actions.float().clamp(-1.0, 1.0)
        pos, quat, vel, ang = state["pos"], state["quat"], state["vel"], state["ang"]
        fn = torch.zeros((action.shape[0], self.num_col), device=action.device)
        for _ in range(self.substeps):
            pos, quat, vel, ang, fn = self._substep(geo, pos, quat, vel, ang, action)
        steps = state["steps"] + 1

        forward_v = vel[:, 0, 0]
        ctrl_cost = action.square().sum(-1)
        reward = shaping["forward_w"] * forward_v + shaping["alive_bonus"] - shaping["ctrl_cost_w"] * 0.1 * ctrl_cost

        z = pos[:, 0, 2]
        terminated = (z < 0.20) | (z > 1.2) | (quat[:, 0, 0] < 0.35)  # fallen or flipped
        truncated = ~terminated & (steps >= self.episode_len)
        new_state = dict(pos=pos, quat=quat, vel=vel, ang=ang, steps=steps)
        return self._obs(geo, pos, quat, vel, ang, fn), new_state, reward.float(), terminated, truncated, {}


def make_ant_env(full_env_name: str, cfg=None, env_config=None, render_mode=None) -> AntEnv:
    # "ant_short" truncates at 150 control steps: keeps learning tests, and runs that only
    # need steady-state stepping, cheap
    if full_env_name == "ant_short":
        return AntEnv(episode_len=150)
    return AntEnv()


def register_ant(env_name: str = "ant") -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    register_env(env_name, make_ant_env)
