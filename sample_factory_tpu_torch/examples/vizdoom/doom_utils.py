"""ViZDoom env specs, wrapper stack assembly and registry.

Copy of `sf_examples_tpu/vizdoom/doom_utils.py` (reference `sf_examples/vizdoom/doom/doom_utils.py`):
the same named scenario suite (basic / gathering / battle / duel /
deathmatch / benchmark variants), the same wrapper order (multiplayer stats →
resolution → resize → time limit → scenario extras → reward scaling), and the
same DoomSpec fields (action space, reward scaling, timeout, agents, bots,
respawn delay, extra wrappers).

Everything except the engine itself works without the vizdoom package
(specs, action spaces, registry); env construction is gated. The module imports
without gymnasium (host-env workers import it for `register_vizdoom_components`):
`DOOM_ENVS` is built at first use, since its action spaces are gymnasium's. The
encoder is a torch module in `examples/custom_encoders.py`, imported by
`make_vizdoom_encoder` when the learner builds its model.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

try:
    import gymnasium as gym
    from gymnasium.spaces import Discrete
except ImportError:  # pragma: no cover
    gym = None
    Discrete = None

from sample_factory_tpu_torch.envs.gym_wrappers import ResizeWrapper, RewardScalingWrapper, TimeLimitWrapper
from sample_factory_tpu_torch.examples.vizdoom.doom.action_space import (
    doom_action_space,
    doom_action_space_basic,
    doom_action_space_discretized_no_weap,
    doom_action_space_extended,
    doom_action_space_full_discretized,
    doom_turn_and_attack_only,
)
from sample_factory_tpu_torch.examples.vizdoom.doom.wrappers import (
    REWARD_SHAPING_BATTLE,
    REWARD_SHAPING_DEATHMATCH_V0,
    REWARD_SHAPING_DEATHMATCH_V1,
    DOOM_RESOLUTIONS,
    DoomAdditionalInput,
    DoomGatheringRewardShaping,
    DoomRewardShapingWrapper,
    MultiplayerStatsWrapper,
    SetResolutionWrapper,
    true_objective_frags,
    true_objective_winning_the_game,
)


def vizdoom_available() -> bool:
    from sample_factory_tpu_torch.examples.vizdoom.doom.doom_env import doom_available

    return doom_available()


@dataclass
class DoomSpec:
    name: str
    env_spec_file: str
    action_space: Any
    reward_scaling: float = 1.0
    default_timeout: int = -1
    num_agents: int = 1  # >1 = networked multi-agent match
    num_bots: int = 0
    respawn_delay: int = 0
    timelimit: float = 4.0
    extra_wrappers: List[Tuple[type, dict]] = field(default_factory=list)


ADDITIONAL_INPUT = (DoomAdditionalInput, {})
BATTLE_REWARD_SHAPING = (
    DoomRewardShapingWrapper,
    dict(reward_shaping_scheme=REWARD_SHAPING_BATTLE, true_objective_func=None),
)
BOTS_REWARD_SHAPING = (
    DoomRewardShapingWrapper,
    dict(reward_shaping_scheme=REWARD_SHAPING_DEATHMATCH_V0, true_objective_func=true_objective_frags),
)
DEATHMATCH_REWARD_SHAPING = (
    DoomRewardShapingWrapper,
    dict(reward_shaping_scheme=REWARD_SHAPING_DEATHMATCH_V1, true_objective_func=true_objective_winning_the_game),
)
GATHERING_REWARD_SHAPING = (DoomGatheringRewardShaping, {})


@functools.lru_cache(maxsize=1)
def _doom_specs() -> List[DoomSpec]:
    return [
        DoomSpec("doom_basic", "basic.cfg", Discrete(1 + 3), reward_scaling=0.01, default_timeout=300),
        DoomSpec("doom_two_colors_easy", "two_colors_easy.cfg", doom_action_space_basic(),
                 extra_wrappers=[GATHERING_REWARD_SHAPING]),
        DoomSpec("doom_two_colors_hard", "two_colors_hard.cfg", doom_action_space_basic(),
                 extra_wrappers=[GATHERING_REWARD_SHAPING]),
        # flat-action variants for cross-framework wall-time comparisons
        DoomSpec("doom_my_way_home_flat_actions", "my_way_home.cfg", Discrete(1 + 4)),
        DoomSpec("doom_defend_the_center_flat_actions", "defend_the_center.cfg", Discrete(1 + 3)),
        # basic single-player scenarios
        DoomSpec("doom_my_way_home", "my_way_home.cfg", doom_action_space_basic()),
        DoomSpec("doom_deadly_corridor", "deadly_corridor.cfg", doom_action_space_extended(), reward_scaling=0.01),
        DoomSpec("doom_defend_the_center", "defend_the_center.cfg", doom_turn_and_attack_only()),
        DoomSpec("doom_defend_the_line", "defend_the_line.cfg", doom_turn_and_attack_only()),
        DoomSpec("doom_health_gathering", "health_gathering.cfg", Discrete(1 + 4),
                 extra_wrappers=[GATHERING_REWARD_SHAPING]),
        DoomSpec("doom_health_gathering_supreme", "health_gathering_supreme.cfg", Discrete(1 + 4),
                 extra_wrappers=[GATHERING_REWARD_SHAPING]),
        # the paper's "challenging" scenarios
        DoomSpec("doom_battle", "battle_continuous_turning.cfg", doom_action_space_discretized_no_weap(),
                 default_timeout=2100, extra_wrappers=[ADDITIONAL_INPUT, BATTLE_REWARD_SHAPING]),
        DoomSpec("doom_battle2", "battle2_continuous_turning.cfg", doom_action_space_discretized_no_weap(),
                 default_timeout=2100, extra_wrappers=[ADDITIONAL_INPUT, BATTLE_REWARD_SHAPING]),
        # single agent vs engine bots
        DoomSpec("doom_duel_bots", "ssl2.cfg", doom_action_space_full_discretized(with_use=True),
                 default_timeout=int(1e9), num_agents=1, num_bots=1, respawn_delay=2,
                 extra_wrappers=[ADDITIONAL_INPUT, BOTS_REWARD_SHAPING]),
        DoomSpec("doom_deathmatch_bots", "dwango5_dm_continuous_weap.cfg", doom_action_space_full_discretized(),
                 default_timeout=int(1e9), num_agents=1, num_bots=7,
                 extra_wrappers=[ADDITIONAL_INPUT, BOTS_REWARD_SHAPING]),
        # full multiplayer: self-play / PBT matches
        DoomSpec("doom_dm", "cig.cfg", doom_action_space(), default_timeout=int(1e9), num_agents=8,
                 extra_wrappers=[ADDITIONAL_INPUT, DEATHMATCH_REWARD_SHAPING]),
        DoomSpec("doom_dwango5", "dwango5_dm.cfg", doom_action_space(), default_timeout=int(1e9), num_agents=8,
                 extra_wrappers=[ADDITIONAL_INPUT, DEATHMATCH_REWARD_SHAPING]),
        DoomSpec("doom_duel", "ssl2.cfg", doom_action_space_full_discretized(with_use=True),
                 default_timeout=int(1e9), num_agents=2, num_bots=0, respawn_delay=2,
                 extra_wrappers=[ADDITIONAL_INPUT, DEATHMATCH_REWARD_SHAPING]),
        DoomSpec("doom_deathmatch_full", "freedm.cfg", doom_action_space_full_discretized(with_use=True),
                 default_timeout=int(1e9), num_agents=4, num_bots=4, respawn_delay=2,
                 extra_wrappers=[ADDITIONAL_INPUT, DEATHMATCH_REWARD_SHAPING]),
        # throughput benchmark scenario (plain pixels, flat actions)
        DoomSpec("doom_benchmark", "battle.cfg", Discrete(1 + 8), default_timeout=2100),
    ]


def __getattr__(name: str):
    if name == "DOOM_ENVS":  # List[DoomSpec], built at first use
        return _doom_specs()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def doom_env_by_name(name: str) -> DoomSpec:
    for spec in _doom_specs():
        if spec.name == name:
            return spec
    raise RuntimeError(f"Unknown Doom env {name}")


def _apply_wrapper_stack(env, spec: DoomSpec, cfg, custom_resolution: Optional[str] = None):
    """MultiplayerStats → SetResolution → Resize → TimeLimit → extras → scaling
    (reference doom_utils.py:225-320; CHW conversion dropped — the framework
    keeps observations HWC, the trajectory's layout in both packages)."""
    env = MultiplayerStatsWrapper(env)

    resolution = custom_resolution
    if resolution is None:
        resolution = "256x144" if getattr(cfg, "wide_aspect_ratio", False) else "160x120"
    assert resolution in DOOM_RESOLUTIONS
    env = SetResolutionWrapper(env, resolution)

    h, w, _ = env.observation_space.shape
    if (w, h) != (cfg.res_w, cfg.res_h):
        env = ResizeWrapper(env, cfg.res_w, cfg.res_h, grayscale=False)

    timeout = spec.default_timeout
    if getattr(cfg, "episode_horizon", 0):
        timeout = cfg.episode_horizon
    if timeout > 0:
        env = TimeLimitWrapper(env, limit=timeout, random_variation_steps=0)

    for wrapper_cls, wrapper_kwargs in spec.extra_wrappers:
        env = wrapper_cls(env, **wrapper_kwargs)

    if spec.reward_scaling != 1.0:
        env = RewardScalingWrapper(env, spec.reward_scaling)
    return env


def make_doom_env_impl(
    spec: DoomSpec,
    cfg,
    env_config=None,
    player_id: Optional[int] = None,
    num_agents: Optional[int] = None,
    max_num_players: Optional[int] = None,
    num_bots: int = 0,
    port: Optional[int] = None,
    custom_resolution: Optional[str] = None,
    render_mode: Optional[str] = None,
):
    from sample_factory_tpu_torch.examples.vizdoom.doom.doom_env import VizdoomEnv

    skip_frames = getattr(cfg, "env_frameskip", 4)
    record_to = getattr(cfg, "record_to", None)
    if record_to and env_config is not None:
        # only one copy records (worker 0, env 0, player 0)
        if env_config.get("worker_index", 0) != 0 or env_config.get("vector_index", 0) != 0 or (player_id or 0) != 0:
            record_to = None

    if player_id is None:
        env = VizdoomEnv(
            spec.action_space, spec.env_spec_file, skip_frames=skip_frames,
            record_to=record_to, render_mode=render_mode,
        )
    else:
        from sample_factory_tpu_torch.examples.vizdoom.doom.multiplayer import VizdoomEnvMultiplayer

        timelimit = cfg.timelimit if getattr(cfg, "timelimit", None) is not None else spec.timelimit
        # in multi-agent matches the wrapper emulates frameskip tick-by-tick
        is_multiagent = (num_agents or 1) > 1
        env = VizdoomEnvMultiplayer(
            spec.action_space, spec.env_spec_file,
            player_id=player_id, num_agents=num_agents, max_num_players=max_num_players,
            num_bots=num_bots, skip_frames=1 if is_multiagent else skip_frames,
            respawn_delay=spec.respawn_delay, timelimit=timelimit, port=port,
            record_to=record_to, render_mode=render_mode,
        )

    return _apply_wrapper_stack(env, spec, cfg, custom_resolution)


def make_doom_multiplayer_env(spec: DoomSpec, cfg, env_config=None, render_mode: Optional[str] = None):
    from sample_factory_tpu_torch.examples.vizdoom.doom.multiplayer import MultiAgentDoomEnv, udp_port_for_env

    num_bots = spec.num_bots if getattr(cfg, "num_bots", -1) < 0 else cfg.num_bots
    num_agents = spec.num_agents if getattr(cfg, "num_agents", -1) <= 0 else cfg.num_agents
    max_num_players = num_agents + getattr(cfg, "num_humans", 0)
    skip_frames = getattr(cfg, "env_frameskip", 4)
    port = udp_port_for_env(env_config)

    def make_player(player_id: int):
        return make_doom_env_impl(
            spec, cfg, env_config=env_config,
            player_id=player_id, num_agents=num_agents, max_num_players=max_num_players,
            num_bots=num_bots, port=port, render_mode=render_mode,
        )

    if num_agents > 1:
        return MultiAgentDoomEnv(num_agents=num_agents, make_env_func=make_player,
                                 env_config=env_config, skip_frames=skip_frames)
    return make_player(0)


def make_doom_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    spec = doom_env_by_name(env_name)
    return make_doom_env_from_spec(spec, env_name, cfg, env_config, render_mode)


def make_doom_env_from_spec(spec: DoomSpec, _env_name: str, cfg=None, env_config=None,
                            render_mode: Optional[str] = None):
    if not vizdoom_available():
        raise RuntimeError(
            "vizdoom is not installed. The ViZDoom integration (including the battle "
            "throughput benchmark and multiplayer self-play) requires `pip install vizdoom`."
        )
    if spec.num_agents > 1 or spec.num_bots > 0:
        return make_doom_multiplayer_env(spec, cfg, env_config, render_mode)
    return make_doom_env_impl(spec, cfg, env_config, render_mode=render_mode)


def register_vizdoom_envs() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    for spec in _doom_specs():
        register_env(spec.name, make_doom_env)


def make_vizdoom_encoder(cfg, obs_space):
    """Counterpart of `sf_examples_tpu/vizdoom/doom_model.py:make_vizdoom_encoder`."""
    from sample_factory_tpu_torch.examples.custom_encoders import VizdoomEncoder

    return VizdoomEncoder(cfg, obs_space)


def register_vizdoom_components() -> None:
    from sample_factory_tpu_torch.algo.context import global_model_factory

    register_vizdoom_envs()
    global_model_factory().register_encoder_factory(make_vizdoom_encoder)
