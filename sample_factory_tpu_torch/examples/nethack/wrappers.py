"""NetHack env wrappers.

Copy of `sf_examples_tpu/nethack/wrappers.py` (reference `sf_examples/nethack/utils/wrappers/*`):
cursor-centered tty tiling into a pixel-ish image (TileTTY), previous-action
observation, no-progress episode abort, and end-of-episode blstats/task-reward
extra stats. TileTTY/PrevActions are engine-agnostic (pure numpy/gymnasium);
the info wrappers read NLE internals and are only constructed when nle is
installed (nethack_env.py gates them).

The wrappers are gymnasium's, and the image is HWC [crop*ph, crop*pw, 2] as on the JAX side.
The module imports without torch and without gymnasium: host-env workers import it through
`train_nethack.register_nethack_components`.
"""

from __future__ import annotations

import re
from collections import namedtuple
from typing import Tuple

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None

# without gymnasium the classes still define; constructing one needs it
_Wrapper = gym.Wrapper if gym else object


def crop_around_cursor(array: np.ndarray, cursor_pos, crop_size: int) -> np.ndarray:
    """Crop a [..., rows, cols] array to [..., crop, crop] centered on
    cursor_pos=(row, col), zero-padding out-of-bounds regions."""
    rows, cols = array.shape[-2:]
    half = crop_size // 2
    start_h = max(0, int(cursor_pos[0]) - half)
    end_h = min(rows, int(cursor_pos[0]) + half + (crop_size % 2))
    start_w = max(0, int(cursor_pos[1]) - half)
    end_w = min(cols, int(cursor_pos[1]) + half + (crop_size % 2))

    out = np.zeros(array.shape[:-2] + (crop_size, crop_size), dtype=array.dtype)
    os_h = max(0, half - int(cursor_pos[0]))
    os_w = max(0, half - int(cursor_pos[1]))
    out[..., os_h : os_h + (end_h - start_h), os_w : os_w + (end_w - start_w)] = array[
        ..., start_h:end_h, start_w:end_w
    ]
    return out


class TileTTY(_Wrapper):
    """Render the tty around the cursor as a 2-channel (chars, colors) image.

    As on the JAX side the image is HWC [crop*ph, crop*pw, 2]; the reference emits CHW.
    """

    def __init__(self, env, crop_size: int = 12, rescale_font_size: Tuple[int, int] = (6, 6)):
        super().__init__(env)
        self.crop_size = crop_size
        self.char_width, self.char_height = rescale_font_size
        shape = (crop_size * self.char_height, crop_size * self.char_width, 2)
        spaces = {"screen_image": gym.spaces.Box(0, 255, shape, np.uint8)}
        spaces.update([(k, self.env.observation_space[k]) for k in self.env.observation_space])
        self.observation_space = gym.spaces.Dict(spaces)

    def _populate(self, obs):
        # chars are 0..255, colors 0..31: both fit uint8 (stacking mixed
        # uint8/int8 would otherwise promote to int16)
        tty = np.stack(
            [obs["tty_chars"].astype(np.uint8), obs["tty_colors"].astype(np.uint8)], axis=0
        )  # [2, R, C]
        cropped = crop_around_cursor(tty, obs["tty_cursor"], self.crop_size)
        screen = np.tile(cropped, (1, self.char_height, self.char_width))  # [2, H, W]
        obs["screen_image"] = np.ascontiguousarray(np.transpose(screen, (1, 2, 0)))  # HWC

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        self._populate(obs)
        return obs, info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self._populate(obs)
        return obs, reward, term, trunc, info


class PrevActionsWrapper(_Wrapper):
    """Expose the previous action as obs['prev_actions'] (int, [1])."""

    def __init__(self, env):
        super().__init__(env)
        self.prev_action = 0
        spaces = {"prev_actions": gym.spaces.Box(0, int(env.action_space.n), (1,), np.int32)}
        spaces.update([(k, self.env.observation_space[k]) for k in self.env.observation_space])
        self.observation_space = gym.spaces.Dict(spaces)

    def reset(self, **kwargs):
        self.prev_action = 0
        obs, info = self.env.reset(**kwargs)
        obs["prev_actions"] = np.array([self.prev_action], np.int32)
        return obs, info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self.prev_action = int(action)
        obs["prev_actions"] = np.array([self.prev_action], np.int32)
        return obs, reward, term, trunc, info


class NoProgressTimeout(_Wrapper):
    """Abort episodes when the in-game clock stalls for `no_progress_timeout`
    consecutive steps (stuck menus/prompts); hooks NLE's _check_abort."""

    def __init__(self, env, no_progress_timeout: int = 150):
        super().__init__(env)
        self.no_progress_timeout = no_progress_timeout
        self._turns = None
        self._no_progress_count = 0
        self.env.unwrapped._check_abort = self._check_abort

    def reset(self, *args, **kwargs):
        self._turns = None
        self._no_progress_count = 0
        return super().reset(*args, **kwargs)

    def _check_abort(self, observation):
        from nle import nethack

        base = self.env.unwrapped
        turns = observation[base._blstats_index][nethack.NLE_BL_TIME]
        if self._turns == turns:
            self._no_progress_count += 1
        else:
            self._turns = turns
            self._no_progress_count = 0
        return base._steps >= base._max_episode_steps or self._no_progress_count >= self.no_progress_timeout


BLStats = namedtuple(
    "BLStats",
    "x y strength_percentage strength dexterity constitution intelligence wisdom charisma score "
    "hitpoints max_hitpoints depth gold energy max_energy armor_class monster_level experience_level "
    "experience_points time hunger_state carrying_capacity dungeon_number level_number prop_mask align_bits",
)


class BlstatsInfoWrapper(_Wrapper):
    """End-of-episode character stats into episode_extra_stats (score, turns,
    dlvl, hp/energy/ac/xp) taken from the LAST pre-terminal observation."""

    def step(self, action):
        last_observation = tuple(a.copy() for a in self.env.unwrapped.last_observation)
        obs, reward, term, trunc, info = self.env.step(action)
        if term or trunc:
            info["episode_extra_stats"] = self.add_more_stats(info, last_observation)
        return obs, reward, term, trunc, info

    def add_more_stats(self, info, last_observation):
        blstats = BLStats(*last_observation[self.env.unwrapped._blstats_index])
        extra = dict(info.get("episode_extra_stats", {}))
        extra.update(
            score=blstats.score,
            turns=blstats.time,
            dlvl=blstats.depth,
            max_hitpoints=blstats.max_hitpoints,
            max_energy=blstats.max_energy,
            armor_class=blstats.armor_class,
            experience_level=blstats.experience_level,
            experience_points=blstats.experience_points,
        )
        return extra


# ------------------------------------------------------------- task rewards


class TaskScore:
    """Accumulates an auxiliary task metric over one episode."""

    def __init__(self):
        self.score = 0
        self.name = re.sub("(?!^)([A-Z]+)", r"_\1", self.__class__.__name__).lower()

    def reset_score(self):
        self.score = 0

    def reward(self, env, last_observation, observation, end_status):
        raise NotImplementedError


class GoldScore(TaskScore):
    def reward(self, env, last_observation, observation, end_status):
        from nle import nethack

        old = last_observation[env.unwrapped._blstats_index][nethack.NLE_BL_GOLD]
        new = observation[env.unwrapped._blstats_index][nethack.NLE_BL_GOLD]
        r = abs(int(new) - int(old))
        self.score += r
        return r


class EatingScore(TaskScore):
    def reward(self, env, last_observation, observation, end_status):
        old = last_observation[env.unwrapped._internal_index][7]
        new = observation[env.unwrapped._internal_index][7]
        r = max(0, int(new) - int(old))
        self.score += r
        return r


class ScoutScore(TaskScore):
    def __init__(self):
        super().__init__()
        self.dungeon_explored = {}

    def reward(self, env, last_observation, observation, end_status):
        from nle import nethack

        glyphs = observation[env.unwrapped._glyph_index]
        blstats = observation[env.unwrapped._blstats_index]
        key = (int(blstats[nethack.NLE_BL_DNUM]), int(blstats[nethack.NLE_BL_DLEVEL]))
        explored = int(np.sum(glyphs != nethack.GLYPH_CMAP_OFF))
        r = explored - self.dungeon_explored.get(key, 0)
        self.dungeon_explored[key] = explored
        self.score += r
        return r

    def reset_score(self):
        super().reset_score()
        self.dungeon_explored = {}


class StaircaseScore(TaskScore):
    """1 per step spent standing on a staircase down."""

    def reward(self, env, last_observation, observation, end_status):
        r = 1 if observation[env.unwrapped._internal_index][4] else 0
        self.score += r
        return r


class StaircasePetScore(TaskScore):
    """Staircase down with the pet adjacent."""

    def reward(self, env, last_observation, observation, end_status):
        from nle import nethack

        r = 0
        if observation[env.unwrapped._internal_index][4]:
            glyphs = observation[env.unwrapped._glyph_index]
            blstats = observation[env.unwrapped._blstats_index]
            x, y = int(blstats[0]), int(blstats[1])
            neighbors = glyphs[y - 1 : y + 2, x - 1 : x + 2]
            if np.any(nethack.glyph_is_pet(neighbors)):
                r = 1
        self.score += r
        return r


class SokobanFillPitScore(TaskScore):
    def reward(self, env, last_observation, observation, end_status):
        message = bytes(observation[env.unwrapped._message_index]).decode("latin-1")
        r = int(
            message.startswith("The boulder fills a pit.")
            or message.startswith("The boulder falls into and plugs a hole in the floor!")
        )
        self.score += r
        return r


class SokobanReachedScore(TaskScore):
    SOKOBAN_LEVELS = ((4, 4), (4, 3), (4, 2), (4, 1))

    def __init__(self):
        super().__init__()
        self.reached = set()

    def reward(self, env, last_observation, observation, end_status):
        from nle import nethack

        blstats = observation[env.unwrapped._blstats_index]
        self.reached.add((int(blstats[nethack.NLE_BL_DNUM]), int(blstats[nethack.NLE_BL_DLEVEL])))
        self.score = sum(1 for k in self.reached if k in self.SOKOBAN_LEVELS)
        return 0

    def reset_score(self):
        super().reset_score()
        self.reached = set()


class TaskRewardsInfoWrapper(_Wrapper):
    """Track auxiliary task metrics every step; report them as
    episode_extra_stats on episode end (cross-task progress diagnostics)."""

    def __init__(self, env):
        super().__init__(env)
        self.tasks = [
            EatingScore(),
            GoldScore(),
            ScoutScore(),
            SokobanFillPitScore(),
            SokobanReachedScore(),
            StaircasePetScore(),
            StaircaseScore(),
        ]

    def reset(self, **kwargs):
        out = self.env.reset(**kwargs)
        for task in self.tasks:
            task.reset_score()
        return out

    def step(self, action):
        last_observation = tuple(a.copy() for a in self.env.unwrapped.last_observation)
        obs, reward, term, trunc, info = self.env.step(action)
        observation = tuple(a.copy() for a in self.env.unwrapped.last_observation)
        if term or trunc:
            extra = dict(info.get("episode_extra_stats", {}))
            extra.update({task.name: task.score for task in self.tasks})
            info["episode_extra_stats"] = extra
        for task in self.tasks:
            task.reward(self.env, last_observation, observation, info.get("end_status"))
        return obs, reward, term, trunc, info
