"""The stand-in's gymnasium envs, one class per NLE task, over `nethack_sim.NetHackSim`.

As NLE's base env: the constructor takes NLE's keyword arguments; `last_observation` is the full
observation tuple and `_glyph_index`, `_blstats_index`, `_message_index` and `_internal_index`
index it; `_check_abort(observation)` decides a truncation (`_steps >= _max_episode_steps`; the
integration's NoProgressTimeout replaces it on the instance); `info["end_status"]` is -1
(aborted), 0 (running) or 1 (died or task done); the observation dict holds the
`observation_keys`. Rewards: the score's change (NetHackScore, NetHackChallenge), gold picked up,
food eaten, map cells explored, and `reward_win` on a staircase (the staircase tasks, which end
there).
"""

import gymnasium as gym
import numpy as np

import nethack_sim as sim

SPACES = {
    "glyphs": gym.spaces.Box(0, 5976, (sim.MAP_ROWS, sim.MAP_COLS), np.int16),
    "blstats": gym.spaces.Box(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (27,), np.int64),
    "message": gym.spaces.Box(0, 255, (256,), np.uint8),
    "internal": gym.spaces.Box(np.iinfo(np.int32).min, np.iinfo(np.int32).max, (9,), np.int32),
    "tty_chars": gym.spaces.Box(0, 255, (sim.ROWS, sim.COLS), np.uint8),
    "tty_colors": gym.spaces.Box(0, 31, (sim.ROWS, sim.COLS), np.int8),
    "tty_cursor": gym.spaces.Box(0, 255, (2,), np.uint8),
}
KEYS = ("glyphs", "blstats", "message", "internal", "tty_chars", "tty_colors", "tty_cursor")  # the tuple's order


class NLE(gym.Env):
    metadata = {"render_modes": ["human", "ansi"]}
    reward_kind = "score"
    ends_on_stairs = False

    def __init__(self, character="mon-hum-neu-mal", max_episode_steps=5000, observation_keys=("tty_chars",), actions=None,
                 penalty_step=-0.01, penalty_time=0.0, penalty_mode="constant", savedir=None, save_ttyrec_every=0,
                 allow_all_yn_questions=False, allow_all_modes=False, reward_win=1.0, reward_lose=0.0, render_mode=None):
        self.character = character
        self._max_episode_steps = max_episode_steps
        self._observation_keys = tuple(observation_keys)
        self.actions = tuple(actions) if actions is not None else tuple(range(23))
        self.penalty_step, self.reward_win, self.reward_lose = penalty_step, reward_win, reward_lose
        self.render_mode = render_mode
        self.observation_space = gym.spaces.Dict({k: SPACES[k] for k in self._observation_keys})
        self.action_space = gym.spaces.Discrete(len(self.actions))
        self._glyph_index, self._blstats_index, self._message_index, self._internal_index = 0, 1, 2, 3
        self._sim = sim.NetHackSim()
        self._steps = 0
        self.last_observation = None

    def _get_observation(self, observation):
        return {k: observation[KEYS.index(k)] for k in self._observation_keys}

    def _check_abort(self, observation):
        return self._steps >= self._max_episode_steps

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self._sim.reset(self.np_random)
        self._steps = 0
        self.last_observation = self._sim.observation
        return self._get_observation(self.last_observation), {}

    def _reward(self, last, observation, stairs):
        b0, b1 = last[self._blstats_index], observation[self._blstats_index]
        if self.reward_kind == "gold":
            return float(b1[sim.BL["GOLD"]] - b0[sim.BL["GOLD"]])
        if self.reward_kind == "eat":
            return float(observation[self._internal_index][7] - last[self._internal_index][7])
        if self.reward_kind == "scout":
            return float(np.sum(observation[0] != sim.GLYPH_CMAP_OFF) - np.sum(last[0] != sim.GLYPH_CMAP_OFF))
        if self.ends_on_stairs:
            return self.reward_win if stairs else 0.0
        return float(b1[sim.BL["SCORE"]] - b0[sim.BL["SCORE"]])

    def step(self, action):
        last = self.last_observation
        died = self._sim.step(self.actions[int(action)])
        self._steps += 1
        observation = self.last_observation = self._sim.observation
        stairs = bool(observation[self._internal_index][4]) and self.ends_on_stairs
        aborted = self._check_abort(observation)
        end_status = 1 if died or stairs else (-1 if aborted else 0)
        reward = self._reward(last, observation, stairs)
        if died and self.ends_on_stairs:
            reward = self.reward_lose
        info = {"end_status": end_status, "is_ascended": False}
        return self._get_observation(observation), reward, bool(died or stairs), bool(aborted and not (died or stairs)), info

    def render(self):
        return None


class NetHackScore(NLE):
    pass


class NetHackChallenge(NetHackScore):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("actions", tuple(range(sim.NUM_ACTIONS)))
        super().__init__(*args, **kwargs)


class NetHackStaircase(NLE):
    ends_on_stairs = True


class NetHackStaircasePet(NetHackStaircase):
    pass


class NetHackOracle(NetHackStaircase):
    pass


class NetHackGold(NLE):
    reward_kind = "gold"


class NetHackEat(NLE):
    reward_kind = "eat"


class NetHackScout(NLE):
    reward_kind = "scout"
