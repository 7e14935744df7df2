"""Doom env wrapper stack.

Copy of `sf_examples_tpu/vizdoom/doom/wrappers.py` (reference `sf_examples/vizdoom/doom/wrappers/`):

- ``DoomRewardShapingWrapper`` (reward_shaping.py) — converts deltas of game
  variables (frags, damage, health, ammo, weapon pickups) into dense shaped
  reward, exposes the scheme through ``RewardShapingInterface`` so PBT can
  mutate it at runtime, and reports the unshaped "true objective" per episode.
- ``DoomAdditionalInput`` (additional_input.py) — game variables as a
  DFP-style scaled measurements vector alongside pixels.
- ``DoomGatheringRewardShaping`` (scenario_wrappers/gathering_reward_shaping.py)
  — +1 on health pickups for the two_colors/health_gathering scenarios.
- ``MultiplayerStatsWrapper`` (multiplayer_stats.py) — match placement, gap to
  leader and kill/death ratio in infos.
- ``SetResolutionWrapper`` (observation_space.py) — native render resolution.

All wrappers operate purely on the info dicts the env produces, so they are
unit-tested against synthetic envs without the vizdoom package. The wrappers are
gymnasium's; the module imports without it.
"""

from __future__ import annotations

import operator
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None

from sample_factory_tpu_torch.envs.env_utils import RewardShapingInterface
from sample_factory_tpu_torch.utils.utils import log

EPS = 1e-8
NUM_WEAPONS = 8

# relative usefulness of weapon slots; the per-weapon pickup/ammo shaping
# scales with it (PBT mutates the resulting scheme further at runtime)
WEAPON_PREFERENCE: Dict[int, int] = {2: 1, 3: 5, 4: 5, 5: 5, 6: 10, 7: 10}


def _weapon_rewards():
    delta, selected = {}, {}
    for weapon in range(NUM_WEAPONS):
        pref = WEAPON_PREFERENCE.get(weapon, 1)
        delta[f"WEAPON{weapon}"] = (+0.02 * pref, -0.01 * pref)  # find / lose a weapon
        delta[f"AMMO{weapon}"] = (+0.0002 * pref, -0.0001 * pref)  # pick up / spend ammo
        # reward for keeping one weapon ready (stops early-training weapon cycling)
        selected[f"SELECTED{weapon}"] = 0.0002 * pref
    return delta, selected


def _make_scheme(**delta_overrides):
    weapon_delta, selected = _weapon_rewards()
    delta = dict(
        FRAGCOUNT=(+1, -1.5),  # (reward per unit increase, penalty per unit decrease)
        DEATHCOUNT=(-0.75, +0.75),
        HITCOUNT=(+0.01, -0.01),
        DAMAGECOUNT=(+0.003, -0.003),
        HEALTH=(+0.005, -0.003),
        ARMOR=(+0.005, -0.001),
        **weapon_delta,
    )
    delta.update(delta_overrides)
    return dict(delta=delta, selected_weapon=dict(selected))


# bots scenarios: frag-centric
REWARD_SHAPING_DEATHMATCH_V0 = _make_scheme()
# self-play: near-zero-sum variant
REWARD_SHAPING_DEATHMATCH_V1 = _make_scheme(
    FRAGCOUNT=(+1, -0.001),
    DEATHCOUNT=(-1, +1),
    HITCOUNT=(0, 0),
    DAMAGECOUNT=(+0.01, -0.01),
    HEALTH=(+0.01, -0.01),
)
# battle scenarios expose few variables; the same scheme degrades gracefully
REWARD_SHAPING_BATTLE = _make_scheme()


def true_objective_winning_the_game(info) -> float:
    """1.0 iff the match was won outright (no reward for ties)."""
    if info["LEADER_GAP"] == 0:
        return 0.0
    return 1.0 if info["FINAL_PLACE"] == 1 else 0.0


def true_objective_frags(info) -> float:
    return float(info["FRAGCOUNT"])


# without gymnasium the class still defines (`object` first would leave no consistent MRO)
_SHAPING_BASES = (gym.Wrapper, RewardShapingInterface) if gym else (RewardShapingInterface,)


class DoomRewardShapingWrapper(*_SHAPING_BASES):
    """Dense shaping from game-variable deltas (reference reward_shaping.py:91-262)."""

    # caps against one-frame spikes (BFG hits etc. over-reward otherwise)
    reward_delta_limits = dict(DAMAGECOUNT=200, HITCOUNT=5)

    def __init__(self, env, reward_shaping_scheme=None, true_objective_func: Optional[Callable] = None):
        gym.Wrapper.__init__(self, env)
        RewardShapingInterface.__init__(self)
        self.reward_shaping_scheme = reward_shaping_scheme
        self.true_objective_func = true_objective_func

        self.prev_vars: Dict[str, float] = {}
        self.prev_dead = True
        self.orig_env_reward = 0.0
        self.total_shaping_reward = 0.0
        self.selected_weapon: deque = deque([], maxlen=5)
        self.reward_structure: Dict[str, float] = {}
        self._warned_large = False

        # other wrappers / PBT find the shaping interface through the base env
        self.env.unwrapped.reward_shaping_interface = self

    # -- RewardShapingInterface (PBT mutates the scheme through these)
    def get_default_reward_shaping(self):
        return self.reward_shaping_scheme

    def set_reward_shaping(self, reward_shaping: dict, agent_idx) -> None:
        self.reward_shaping_scheme = reward_shaping

    def _delta_rewards(self, info):
        reward = 0.0
        for var_name, (pos, neg) in self.reward_shaping_scheme["delta"].items():
            if var_name not in self.prev_vars:
                continue
            delta = info.get(var_name, 0.0) - self.prev_vars[var_name]
            if var_name in self.reward_delta_limits:
                delta = min(delta, self.reward_delta_limits[var_name])
            if abs(delta) <= EPS:
                continue
            r = delta * pos if delta > 0 else -delta * neg
            reward += r
            self.reward_structure[var_name] = self.reward_structure.get(var_name, 0.0) + r
        return reward

    def _selected_weapon_reward(self, weapon: int, ammo: float) -> float:
        # weapon must be held ready (not switched) for 5 consecutive frames
        unholstered = len(self.selected_weapon) > 4 and all(w == weapon for w in self.selected_weapon)
        if ammo <= 0 or not unholstered:
            return 0.0
        r = self.reward_shaping_scheme["selected_weapon"].get(f"SELECTED{weapon}", 0.0)
        key = f"weapon{weapon}"
        self.reward_structure[key] = self.reward_structure.get(key, 0.0) + r
        return r

    def _shaping_reward(self, info, done: bool) -> float:
        if self.reward_shaping_scheme is None:
            return 0.0

        weapon = int(max(0, info.get("SELECTED_WEAPON", 0.0)))
        ammo = float(max(0.0, info.get("SELECTED_WEAPON_AMMO", 0.0)))
        self.selected_weapon.append(weapon)

        just_respawned = self.prev_dead and not info.get("DEAD", 0.0)

        reward = 0.0
        if not done and not just_respawned:
            reward = self._delta_rewards(info) + self._selected_weapon_reward(weapon, ammo)
            if abs(reward) > 2.5 and not self._warned_large:
                log.info("Large shaping reward %.3f (structure: %r)", reward, self.reward_structure)
                self._warned_large = True

        if done and "FRAGCOUNT" in self.reward_structure:
            by_magnitude = sorted(self.reward_structure.items(), key=operator.itemgetter(1))
            log.info(
                "Shaping total %.3f: %r",
                sum(r for _, r in by_magnitude),
                {k: f"{r:.3f}" for k, r in by_magnitude},
            )
        return reward

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        self.prev_vars = {}
        self.prev_dead = True
        self.reward_structure = {}
        self.selected_weapon.clear()
        self.orig_env_reward = self.total_shaping_reward = 0.0
        self._warned_large = False
        return obs, info

    def step(self, action):
        obs, rew, terminated, truncated, info = self.env.step(action)
        if obs is None:
            return obs, rew, terminated, truncated, info
        done = terminated | truncated

        self.orig_env_reward += rew
        shaping = self._shaping_reward(info, done)
        rew += shaping
        self.total_shaping_reward += shaping

        for var_name in self.reward_shaping_scheme["delta"]:
            self.prev_vars[var_name] = info.get(var_name, 0.0)
        self.prev_dead = bool(info.get("DEAD", 0.0))

        if done:
            if self.true_objective_func is None:
                info["true_objective"] = self.orig_env_reward
            else:
                info["true_objective"] = self.true_objective_func(info)
        return obs, rew, terminated, truncated, info

    def close(self):
        self.env.unwrapped.reward_shaping_interface = None
        return self.env.close()


class DoomAdditionalInput(gym.Wrapper if gym else object):
    """Game variables -> scaled `measurements` obs key (reference additional_input.py).

    Scaling follows the DFP paper (arXiv:1611.01779): everything mapped into
    small O(1) ranges so the MLP branch trains without normalizers.
    """

    def __init__(self, env):
        super().__init__(env)
        self.num_weapons = NUM_WEAPONS
        n = 7 + 2 * self.num_weapons
        low = np.array([0.0, 0.0, -1.0, -1.0, -50.0, 0.0, 0.0] + [0.0] * 2 * self.num_weapons, np.float32)
        high = np.array(
            [20.0, 50.0, 50.0, 50.0, 50.0, 1.0, 10.0] + [5.0] * self.num_weapons + [50.0] * self.num_weapons,
            np.float32,
        )
        self.observation_space = gym.spaces.Dict(
            {"obs": env.observation_space, "measurements": gym.spaces.Box(low=low, high=high)}
        )
        self._measurements = np.zeros(n, np.float32)

    def _build_obs(self, obs, info):
        m = self._measurements
        ammo = min(max(0.0, info.get("SELECTED_WEAPON_AMMO", 0.0)) / 15.0, 5.0)
        m[0] = max(0, round(info.get("SELECTED_WEAPON", 0.0)))
        m[1] = ammo
        m[2] = max(0.0, info.get("HEALTH", 0.0)) / 30.0
        m[3] = info.get("ARMOR", 0.0) / 30.0
        m[4] = info.get("USER2", 0.0) / 10.0  # kill count (battle scenarios only)
        m[5] = info.get("ATTACK_READY", 0.0)
        m[6] = info.get("PLAYER_COUNT", 1) / 5.0
        for w in range(self.num_weapons):
            m[7 + w] = max(0.0, info.get(f"WEAPON{w}", 0.0))
            m[7 + self.num_weapons + w] = min(max(0.0, info.get(f"AMMO{w}", 0.0)) / 15.0, 5.0)
        return {"obs": obs, "measurements": m}

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        vars_info = self.env.unwrapped.get_info() if hasattr(self.env.unwrapped, "get_info") else info
        return self._build_obs(obs, vars_info), info

    def step(self, action):
        obs, rew, terminated, truncated, info = self.env.step(action)
        if obs is None:
            return obs, rew, terminated, truncated, info
        return self._build_obs(obs, info), rew, terminated, truncated, info


class DoomGatheringRewardShaping(gym.Wrapper if gym else object):
    """+1 per health pickup (reference scenario_wrappers/gathering_reward_shaping.py,
    following arXiv:1904.01806)."""

    def __init__(self, env):
        super().__init__(env)
        self._prev_health = None
        self.orig_env_reward = 0.0

    def reset(self, **kwargs):
        self._prev_health = None
        self.orig_env_reward = 0.0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, rew, terminated, truncated, info = self.env.step(action)
        self.orig_env_reward += rew
        done = terminated | truncated
        if info is not None and not done:
            health = info.get("HEALTH", 0.0)
            if self._prev_health is not None and health > self._prev_health:
                rew += 1.0
            self._prev_health = health
        if done:
            info["true_objective"] = self.orig_env_reward
        return obs, rew, terminated, truncated, info


class MultiplayerStatsWrapper(gym.Wrapper if gym else object):
    """Match placement / leader gap / KDR in infos (reference multiplayer_stats.py).

    Recomputed every 20 frames and on episode end (the sort is host-side cost).
    """

    STATS_EVERY = 20

    def __init__(self, env):
        super().__init__(env)
        self._t = 0
        self._prev = {}

    def _match_stats(self, info):
        kdr = info.get("FRAGCOUNT", 0.0) / (info.get("DEATHCOUNT", 0.0) + 1)
        extra = {"KDR": float(kdr)}

        player_count = int(info.get("PLAYER_COUNT", 1))
        player_num = int(info.get("PLAYER_NUMBER", 0))
        frags = [int(info.get(f"PLAYER{i}_FRAGCOUNT", -(10**6))) for i in range(1, player_count + 1)]
        order = list(np.argsort(frags))
        final_place = player_count - order.index(player_num)  # 1 = most frags
        extra["FINAL_PLACE"] = final_place

        if final_place > 1:
            extra["LEADER_GAP"] = max(frags) - frags[player_num]
        elif player_count > 1:
            top_two = sorted(frags, reverse=True)
            extra["LEADER_GAP"] = top_two[1] - top_two[0]  # <= 0: our margin
        else:
            extra["LEADER_GAP"] = 0
        return extra

    def reset(self, **kwargs):
        self._t = 0
        self._prev = {}
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, rew, terminated, truncated, info = self.env.step(action)
        if obs is None:
            return obs, rew, terminated, truncated, info
        done = terminated | truncated
        if (self._t % self.STATS_EVERY == 0 or done) and "FRAGCOUNT" in info:
            self._prev = self._match_stats(info)
        info.update(self._prev)
        self._t += 1
        return obs, rew, terminated, truncated, info


# the set of render resolutions the engine supports (reference observation_space.py)
DOOM_RESOLUTIONS = (
    "160x120", "200x125", "200x150", "256x144", "256x160", "256x192",
    "320x180", "320x200", "320x240", "320x256", "400x225", "400x250",
    "400x300", "512x288", "512x320", "512x384", "640x360", "640x400",
    "640x480", "800x450", "800x500", "800x600", "1024x576", "1024x640",
    "1024x768", "1280x720", "1280x800", "1280x960", "1280x1024", "1400x787",
    "1400x875", "1400x1050", "1600x900", "1600x1000", "1600x1200", "1920x1080",
)


class SetResolutionWrapper(gym.Wrapper if gym else object):
    """Select the engine render resolution before game init (reference
    observation_space.py:42-75). Must wrap the bare VizdoomEnv."""

    def __init__(self, env, target_resolution: str):
        super().__init__(env)
        if target_resolution not in DOOM_RESOLUTIONS:
            raise ValueError(f"Unsupported Doom resolution {target_resolution}")
        w, h = (int(x) for x in target_resolution.lower().split("x"))

        import vizdoom

        base = self.env.unwrapped
        base.screen_w, base.screen_h = w, h
        base.screen_resolution = getattr(vizdoom.ScreenResolution, f"RES_{w}X{h}")
        base.calc_observation_space()
        self.observation_space = base.observation_space
