"""An env-level stand-in for `nethack_challenge`, for the card's machine: it has neither gymnasium
(NLE's envs and the integration's wrappers are gymnasium's) nor nle. One env emits what
`make_nethack_env("nethack_challenge", ...)` emits at the integration's defaults
(`examples/nethack/nethack_env.py`: NoProgressTimeout, TileTTY with crop 18 and pixel 6,
PrevActionsWrapper, BlstatsInfoWrapper, TaskRewardsInfoWrapper), declared in the port's specs:

- `tty_chars` [24, 80] uint8, `tty_colors` [24, 80] int8, `tty_cursor` [2] uint8, `message` [256]
  uint8, `blstats` [27] int64, `screen_image` [108, 108, 2] uint8 (the crop around the cursor tiled
  6 x 6, through the port's `crop_around_cursor`), `prev_actions` [1] int32;
- the challenge task's action set (121 actions of the stand-in engine);
- seeded episodes of the numpy game model `nethack_sim.py`, the score's change as reward, and at
  each episode's end `episode_extra_stats` with the blstats keys and the seven task scores,
  computed by the port's `BLStats` and `TaskScore` classes.

`register_nethack_standin` is the `register_fn` of a run: spawned host-env workers import this
module from `PYTHONPATH`. It registers the stand-in under `nethack_challenge` and the NetHack
encoder factory of `train_nethack`, and not `register_nethack_envs`, which would register the
gymnasium-backed env. `tests/test_torch_nethack.py` checks these spaces and stat keys against the
real stack's over the engine stand-in `nle/`.
"""

import numpy as np

import nethack_sim as sim
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec

ENV_NAME = "nethack_challenge"
CROP, PIXEL = 18, 6
NO_PROGRESS_TIMEOUT = 150
MAX_EPISODE_STEPS = 100000
_I64 = np.iinfo(np.int64)


class NetHackStandIn:
    gymnasium_api = True  # reset(seed=...) and the 5-tuple step

    def __init__(self, seed: int = 0):
        self.observation_space = make_dict_spec({
            "message": Box((256,), 0.0, 255.0, "uint8"),
            "blstats": Box((27,), float(_I64.min), float(_I64.max), "int64"),
            "tty_chars": Box((sim.ROWS, sim.COLS), 0.0, 255.0, "uint8"),
            "tty_colors": Box((sim.ROWS, sim.COLS), 0.0, 31.0, "int8"),
            "tty_cursor": Box((2,), 0.0, 255.0, "uint8"),
            "screen_image": Box((CROP * PIXEL, CROP * PIXEL, 2), 0.0, 255.0, "uint8"),
            "prev_actions": Box((1,), 0.0, float(sim.NUM_ACTIONS), "int32"),
        })
        self.action_space = Discrete(sim.NUM_ACTIONS)
        self._glyph_index, self._blstats_index = sim.GLYPH_INDEX, sim.BLSTATS_INDEX
        self._message_index, self._internal_index = sim.MESSAGE_INDEX, sim.INTERNAL_INDEX
        self.task_scores = _task_scores()
        self.rng = np.random.default_rng(seed)
        self.game = sim.NetHackSim()

    @property
    def unwrapped(self):
        return self

    def _obs(self, prev_action: int):
        from sample_factory_tpu_torch.examples.nethack.wrappers import crop_around_cursor

        _, blstats, message, _, chars, colors, cursor = self.game.observation
        tty = np.stack([chars, colors.astype(np.uint8)], axis=0)
        screen = np.tile(crop_around_cursor(tty, cursor, CROP), (1, PIXEL, PIXEL))
        return {"message": message, "blstats": blstats, "tty_chars": chars, "tty_colors": colors, "tty_cursor": cursor,
                "screen_image": np.ascontiguousarray(np.transpose(screen, (1, 2, 0))),
                "prev_actions": np.array([prev_action], np.int32)}

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.game.reset(self.rng)
        self.steps, self.turns, self.no_progress = 0, None, 0
        for task in self.task_scores:
            task.reset_score()
        return self._obs(0), {}

    def step(self, action):
        from sample_factory_tpu_torch.examples.nethack.wrappers import BLStats

        action = int(np.asarray(action).reshape(-1)[0])
        last = tuple(a.copy() for a in self.game.observation)
        died = self.game.step(action)
        self.steps += 1
        observation = self.game.observation
        turns = observation[self._blstats_index][sim.BL["TIME"]]
        self.no_progress = self.no_progress + 1 if turns == self.turns else 0
        self.turns = turns
        aborted = self.steps >= MAX_EPISODE_STEPS or self.no_progress >= NO_PROGRESS_TIMEOUT
        reward = float(observation[self._blstats_index][sim.BL["SCORE"]] - last[self._blstats_index][sim.BL["SCORE"]])
        info = {"end_status": 1 if died else (-1 if aborted else 0)}
        if died or aborted:
            b = BLStats(*last[self._blstats_index])
            info["episode_extra_stats"] = dict(
                score=b.score, turns=b.time, dlvl=b.depth, max_hitpoints=b.max_hitpoints, max_energy=b.max_energy,
                armor_class=b.armor_class, experience_level=b.experience_level, experience_points=b.experience_points,
                **{task.name: task.score for task in self.task_scores})
        for task in self.task_scores:
            task.reward(self, last, observation, info["end_status"])
        return self._obs(action), reward, died, bool(aborted and not died), info

    def close(self):
        pass


def _task_scores():
    from sample_factory_tpu_torch.examples.nethack import wrappers

    return [wrappers.EatingScore(), wrappers.GoldScore(), wrappers.ScoutScore(), wrappers.SokobanFillPitScore(),
            wrappers.SokobanReachedScore(), wrappers.StaircasePetScore(), wrappers.StaircaseScore()]


def make_nethack_standin(env_name, cfg=None, env_config=None, render_mode=None):
    seed = int(getattr(cfg, "seed", 0) or 0) if cfg is not None else 0
    if env_config is not None:
        seed = seed * 100003 + int(env_config.get("env_id", 0))
    return NetHackStandIn(seed)


def register_nethack_standin() -> None:
    from sample_factory_tpu_torch.algo.context import global_model_factory
    from sample_factory_tpu_torch.envs.env_utils import register_env
    from sample_factory_tpu_torch.examples.nethack.train_nethack import nethack_encoder_factory

    register_env(ENV_NAME, make_nethack_standin)
    global_model_factory().register_encoder_factory(nethack_encoder_factory)
