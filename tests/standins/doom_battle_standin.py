"""An env-level stand-in for `doom_battle`, for the card's machine: it has neither gymnasium (the
Doom wrapper stack is gymnasium's) nor vizdoom. One env emits what `doom_battle`'s stack emits
(`examples/vizdoom/doom_utils.py`: resolution 160x120 resized to 128x72, the measurements of
`DoomAdditionalInput`, battle reward shaping), declared in the port's specs:

- `obs` [72, 128, 3] uint8 (seeded noise frames from a small bank), `measurements` [7 + 2 * 8]
  float32 inside `DoomAdditionalInput`'s bounds;
- the action space of `doom_action_space_discretized_no_weap()` as `from_gym_space` gives it;
- episodes of a seeded random length up to the 525-step timeout, shaping-sized rewards;
- frameskip handled inside, as the engine does.

`register_doom_battle_standin` is the `register_fn` of a run: the spawned host-env workers import
this module from `PYTHONPATH`. It registers the stand-in under `doom_battle` and the Vizdoom
encoder, and not `register_vizdoom_envs`, which would register the gymnasium-backed env.
`tests/test_torch_vizdoom.py` checks these spaces against the real stack's over the vizdoom
stand-in.
"""

import numpy as np

from sample_factory_tpu_torch.envs.spaces import Box, Discrete, TupleSpec, make_dict_spec

ENV_NAME = "doom_battle"
RES_H, RES_W = 72, 128
NUM_MEASUREMENTS = 7 + 2 * 8
TIMEOUT_STEPS = 2100 // 4
FRAME_BANK = 8
_LOW = np.array([0.0, 0.0, -1.0, -1.0, -50.0, 0.0, 0.0] + [0.0] * 16, np.float32)
_HIGH = np.array([20.0, 50.0, 50.0, 50.0, 50.0, 1.0, 10.0] + [5.0] * 8 + [50.0] * 8, np.float32)


class DoomBattleStandIn:
    gymnasium_api = True  # reset(seed=...) and the 5-tuple step
    _sf_handles_frameskip = True  # the engine repeats the action, as VizdoomEnv's make_action does

    def __init__(self, seed: int = 0):
        self.observation_space = make_dict_spec({"obs": Box((RES_H, RES_W, 3), 0.0, 255.0, "uint8"),
                                                 "measurements": Box((NUM_MEASUREMENTS,), -50.0, 50.0, "float32")})
        self.action_space = TupleSpec((Discrete(3), Discrete(3), Discrete(2), Discrete(2), Discrete(11)))
        self.rng = np.random.default_rng(seed)
        self.frames = self.rng.integers(0, 256, (FRAME_BANK, RES_H, RES_W, 3), dtype=np.uint8)
        self.t, self.length = 0, 0

    def get_default_reward_shaping(self):
        from sample_factory_tpu_torch.examples.vizdoom.doom.wrappers import REWARD_SHAPING_BATTLE

        return REWARD_SHAPING_BATTLE

    def _obs(self):
        m = (_LOW + (_HIGH - _LOW) * self.rng.random(NUM_MEASUREMENTS)).astype(np.float32)
        return {"obs": self.frames[self.t % FRAME_BANK], "measurements": m}

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.t, self.length = 0, int(self.rng.integers(64, TIMEOUT_STEPS + 1))
        return self._obs(), {}

    def step(self, action):
        assert len(action) == 5, action
        self.t += 1
        reward = float(self.rng.normal() * 0.01 + (1.0 if self.rng.random() < 0.01 else 0.0))
        terminated = self.t >= self.length
        return self._obs(), reward, terminated, False, {"num_frames": 4}

    def close(self):
        pass


def make_doom_battle_standin(env_name, cfg=None, env_config=None, render_mode=None):
    seed = int(getattr(cfg, "seed", 0) or 0) if cfg is not None else 0
    if env_config is not None:
        seed = seed * 100003 + int(env_config.get("env_id", 0))
    return DoomBattleStandIn(seed)


def register_doom_battle_standin() -> None:
    from sample_factory_tpu_torch.algo.context import global_model_factory
    from sample_factory_tpu_torch.envs.env_utils import register_env
    from sample_factory_tpu_torch.examples.vizdoom.doom_utils import make_vizdoom_encoder

    register_env(ENV_NAME, make_doom_battle_standin)
    global_model_factory().register_encoder_factory(make_vizdoom_encoder)
