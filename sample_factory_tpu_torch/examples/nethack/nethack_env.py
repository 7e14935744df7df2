"""NetHack env registry (gated on the nle package).

Counterpart of `sf_examples_tpu/nethack/nethack_env.py` (reference
`sf_examples/nethack/nethack_env.py`): the NLE task suite
(staircase/score/pet/oracle/gold/eat/scout/challenge), the tty-focused
observation set, and the standard wrapper stack (no-progress abort, tty
tiling, prev-action, end-of-episode stats). The module imports neither torch nor
gymnasium: host-env workers import it for `register_nethack_envs`. Without nle an env
raises on creation, as on the JAX side.
"""

from __future__ import annotations

from typing import Optional

from sample_factory_tpu_torch.examples.nethack.wrappers import (
    BlstatsInfoWrapper,
    NoProgressTimeout,
    PrevActionsWrapper,
    TaskRewardsInfoWrapper,
    TileTTY,
)
from sample_factory_tpu_torch.utils.utils import log


def nethack_available() -> bool:
    try:
        import nle  # noqa: F401

        return True
    except ImportError:
        return False


class NetHackSpec:
    def __init__(self, name: str, env_id: str):
        self.name = name
        self.env_id = env_id


NETHACK_ENVS = [
    NetHackSpec("nethack_staircase", "NetHackStaircase-v0"),
    NetHackSpec("nethack_score", "NetHackScore-v0"),
    NetHackSpec("nethack_pet", "NetHackStaircasePet-v0"),
    NetHackSpec("nethack_oracle", "NetHackOracle-v0"),
    NetHackSpec("nethack_gold", "NetHackGold-v0"),
    NetHackSpec("nethack_eat", "NetHackEat-v0"),
    NetHackSpec("nethack_scout", "NetHackScout-v0"),
    NetHackSpec("nethack_challenge", "NetHackChallenge-v0"),
]

OBSERVATION_KEYS = ("message", "blstats", "tty_chars", "tty_colors", "tty_cursor")


def nethack_env_by_name(name: str) -> NetHackSpec:
    for spec in NETHACK_ENVS:
        if spec.name == name:
            return spec
    raise KeyError(f"Unknown NetHack env {name}; known: {[s.name for s in NETHACK_ENVS]}")


def make_nethack_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    if not nethack_available():
        raise RuntimeError("nle is not installed; the NetHack integration requires `pip install nle`.")
    import gymnasium as gym
    from nle import nethack

    spec = nethack_env_by_name(env_name)
    kwargs = dict(
        character=cfg.character,
        max_episode_steps=cfg.max_episode_steps,
        observation_keys=OBSERVATION_KEYS,
        penalty_step=cfg.penalty_step,
        penalty_time=cfg.penalty_time,
        penalty_mode=cfg.fn_penalty_step,
        savedir=cfg.savedir,
        save_ttyrec_every=cfg.save_ttyrec_every,
        allow_all_yn_questions=True,
        allow_all_modes=True,
    )
    if env_name in ("nethack_staircase", "nethack_pet", "nethack_oracle"):
        kwargs.update(reward_win=cfg.reward_win, reward_lose=cfg.reward_lose)
    if env_name != "nethack_challenge":
        kwargs.update(actions=nethack.ACTIONS)

    env = gym.make(spec.env_id, render_mode=render_mode, **kwargs)
    env = NoProgressTimeout(env, no_progress_timeout=150)
    if cfg.add_image_observation:
        env = TileTTY(env, crop_size=cfg.crop_dim, rescale_font_size=(cfg.pixel_size, cfg.pixel_size))
    if cfg.use_prev_action:
        env = PrevActionsWrapper(env)
    if cfg.add_stats_to_info:
        env = BlstatsInfoWrapper(env)
        env = TaskRewardsInfoWrapper(env)
    return env


def register_nethack_envs() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    for spec in NETHACK_ENVS:
        register_env(spec.name, make_nethack_env)
    if not nethack_available():
        log.debug("nle not installed; nethack envs registered but will raise on creation")
