"""DMLab environment integration (gated on the `deepmind_lab` package).

Copy of `sf_examples_tpu/dmlab/dmlab_env.py` (reference `sf_examples/dmlab/dmlab_env.py` +
`dmlab_gym.py`: named env specs (dmlab_benchmark, dmlab_30, sparse/watermaze/
nonmatch single tasks), per-env task assignment for multi-task training,
discrete action sets (standard 9-action and extended 15-action from the
PopART/R2D2 papers), instruction tokenization into a fixed [16] int32 vector,
internal frameskip via DMLab's num_steps, the IMPALA optimistic-asymmetric
reward clip, and per-episode raw-score extra stats for human-normalized
summaries). Envs run on the host and feed the device through the host pipeline;
level generation is cached via DmlabLevelCache. `DmlabEnv` declares its spaces in
the port's own specs, so it runs where gymnasium is not installed.
"""

from __future__ import annotations

import hashlib
import math
import random
from typing import Any, Dict, List, Optional

import numpy as np

from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.utils.utils import log
from sample_factory_tpu_torch.examples.dmlab.dmlab30 import (
    DMLAB30_LEVELS,
    DMLAB30_LEVELS_THAT_USE_LEVEL_CACHE,
    DMLAB_INSTRUCTIONS,
    DMLAB_MAX_INSTRUCTION_LEN,
    DMLAB_VOCABULARY_SIZE,
    dmlab30_level_name_to_level,
    dmlab_level_to_level_name,
)
from sample_factory_tpu_torch.examples.dmlab.dmlab_level_cache import DmlabLevelCache

RAW_SCORE_SUMMARY_KEY_SUFFIX = "dmlab_raw_score"

# DMLab native action vector: (look_lr, look_ud, strafe, move, fire, jump, crouch).
# These discretizations are the published IMPALA (9 actions) and PopART/R2D2
# (15 actions) action sets.
ACTION_SET = (
    (0, 0, 0, 1, 0, 0, 0),  # forward
    (0, 0, 0, -1, 0, 0, 0),  # backward
    (0, 0, -1, 0, 0, 0, 0),  # strafe left
    (0, 0, 1, 0, 0, 0, 0),  # strafe right
    (-20, 0, 0, 0, 0, 0, 0),  # look left
    (20, 0, 0, 0, 0, 0, 0),  # look right
    (-20, 0, 0, 1, 0, 0, 0),  # look left + forward
    (20, 0, 0, 1, 0, 0, 0),  # look right + forward
    (0, 0, 0, 0, 1, 0, 0),  # fire
)

EXTENDED_ACTION_SET = (
    (0, 0, 0, 1, 0, 0, 0),
    (0, 0, 0, -1, 0, 0, 0),
    (0, 0, -1, 0, 0, 0, 0),
    (0, 0, 1, 0, 0, 0, 0),
    (-10, 0, 0, 0, 0, 0, 0),
    (10, 0, 0, 0, 0, 0, 0),
    (-60, 0, 0, 0, 0, 0, 0),
    (60, 0, 0, 0, 0, 0, 0),
    (0, 10, 0, 0, 0, 0, 0),
    (0, -10, 0, 0, 0, 0, 0),
    (-10, 0, 0, 1, 0, 0, 0),
    (10, 0, 0, 1, 0, 0, 0),
    (-60, 0, 0, 1, 0, 0, 0),
    (60, 0, 0, 1, 0, 0, 0),
    (0, 0, 0, 0, 1, 0, 0),
)


def dmlab_available() -> bool:
    try:
        import deepmind_lab  # noqa: F401

        return True
    except ImportError:
        return False


def string_to_hash_bucket(s: str, vocabulary_size: int) -> int:
    """Stable word->token hashing (same scheme as the reference/IMPALA so
    instruction vocabularies match across implementations; dmlab_utils.py)."""
    return (int(hashlib.md5(s.encode("utf-8")).hexdigest(), 16) % (vocabulary_size - 1)) + 1


def tokenize_instructions(instr: Optional[str], out: Optional[np.ndarray] = None) -> np.ndarray:
    """Instruction string -> fixed-length int32 token vector, 0-padded."""
    if out is None:
        out = np.zeros([DMLAB_MAX_INSTRUCTION_LEN], dtype=np.int32)
    out[:] = 0
    if instr:
        for i, word in enumerate(instr.split()[:DMLAB_MAX_INSTRUCTION_LEN]):
            out[i] = string_to_hash_bucket(word, DMLAB_VOCABULARY_SIZE)
    return out


def optimistic_asymmetric_clip(rew: float) -> float:
    """IMPALA's reward shaping: tanh squeeze, negative part attenuated 0.3x."""
    squeezed = math.tanh(rew / 5.0)
    clipped = 0.3 * squeezed if rew < 0.0 else squeezed
    return clipped * 5.0


# ------------------------------------------------------------------ env specs


class DmlabSpec:
    def __init__(self, name: str, levels, extra_cfg: Optional[Dict[str, Any]] = None):
        self.name = name
        # normalized to a list: single-task specs are a 1-element list
        self.levels: List[str] = [levels] if isinstance(levels, str) else list(levels)
        self.extra_cfg = extra_cfg or {}


DMLAB_ENVS = [
    DmlabSpec("dmlab_benchmark", dmlab30_level_name_to_level("rooms_collect_good_objects_train")),
    DmlabSpec("dmlab_30", [dmlab30_level_name_to_level(lvl) for lvl in DMLAB30_LEVELS]),
    DmlabSpec("dmlab_level_cache", [dmlab30_level_name_to_level(lvl) for lvl in DMLAB30_LEVELS_THAT_USE_LEVEL_CACHE]),
    DmlabSpec("dmlab_benchmark_slow_reset", dmlab30_level_name_to_level("rooms_keys_doors_puzzle")),
    DmlabSpec("dmlab_sparse", dmlab30_level_name_to_level("explore_goal_locations_large")),
    DmlabSpec(
        "dmlab_very_sparse",
        dmlab30_level_name_to_level("explore_goal_locations_large"),
        extra_cfg={"minGoalDistance": "10"},
    ),
    DmlabSpec("dmlab_sparse_doors", dmlab30_level_name_to_level("explore_obstructed_goals_large")),
    DmlabSpec("dmlab_nonmatch", dmlab30_level_name_to_level("rooms_select_nonmatching_object")),
    DmlabSpec("dmlab_watermaze", dmlab30_level_name_to_level("rooms_watermaze")),
    DmlabSpec("dmlab_collect_good_objects", dmlab30_level_name_to_level("rooms_collect_good_objects_train")),
]


def dmlab_env_by_name(name: str) -> DmlabSpec:
    for spec in DMLAB_ENVS:
        if spec.name == name:
            return spec
    # fall through: interpret "dmlab_<level>" as a raw DMLab-30 level name
    log.warning("No predefined spec for %s; treating the suffix as a DMLab-30 level name", name)
    return DmlabSpec(name, dmlab30_level_name_to_level(name.split("dmlab_", 1)[1]))


def list_all_levels_for_experiment(env_name: str) -> List[str]:
    return list(dmlab_env_by_name(env_name).levels)


def task_id_for_env(spec: DmlabSpec, env_config, cfg) -> int:
    """Deterministic multi-task assignment: round-robin levels over env slots
    (or over workers with --dmlab_one_task_per_worker, so slow levels don't
    throttle fast ones — same regimes as the reference)."""
    n = len(spec.levels)
    if env_config is None or n == 1:
        return 0
    if getattr(cfg, "dmlab_one_task_per_worker", False):
        return int(env_config.get("worker_index", 0)) % n
    return int(env_config.get("env_id", 0)) % n


# -------------------------------------------------------------- gym adapter


class DmlabEnv:
    """gymnasium-API adapter over a deepmind_lab.Lab instance (spaces in the port's specs).

    Observation dict: {"obs": [H, W, 3] uint8, "INSTR": [16] int32 (optional)}.
    Handles frameskip internally (DMLab num_steps), so the framework's
    FrameskipWrapper is bypassed via _sf_handles_frameskip.
    """

    _sf_handles_frameskip = True

    def __init__(
        self,
        task_id: int,
        level: str,
        cfg,
        level_cache: Optional[DmlabLevelCache] = None,
        extra_cfg: Optional[Dict[str, Any]] = None,
        render_mode: Optional[str] = None,
    ):
        import deepmind_lab

        self.task_id = task_id
        self.level = level
        self.level_name = dmlab_level_to_level_name(level)
        self.render_mode = render_mode
        self.action_repeat = max(1, cfg.env_frameskip)
        self.benchmark_mode = bool(getattr(cfg, "dmlab_throughput_benchmark", False))
        self.with_instructions = bool(getattr(cfg, "dmlab_with_instructions", True)) and not self.benchmark_mode
        self.level_cache = level_cache
        self.last_reset_seed: Optional[int] = None
        self.rng = random.Random()

        observations = ["RGB_INTERLEAVED"]
        if self.with_instructions:
            observations.append(DMLAB_INSTRUCTIONS)
        config = {
            "width": str(cfg.res_w),
            "height": str(cfg.res_h),
            "datasetPath": str(getattr(cfg, "dmlab30_dataset", "")),
            "gpuDeviceIndex": "0",
        }
        for k, v in (extra_cfg or {}).items():
            config[k] = str(v)

        self.dmlab = deepmind_lab.Lab(
            level,
            observations,
            config=config,
            renderer=getattr(cfg, "dmlab_renderer", "software"),
            level_cache=self if level_cache is not None else None,
        )

        action_set = EXTENDED_ACTION_SET if getattr(cfg, "dmlab_extended_action_set", False) else ACTION_SET
        self.action_list = np.array(action_set, dtype=np.intc)
        self.action_space = Discrete(len(action_set))
        spaces = {"obs": Box((cfg.res_h, cfg.res_w, 3), 0.0, 255.0, "uint8")}
        if self.with_instructions:
            spaces[DMLAB_INSTRUCTIONS] = Box((DMLAB_MAX_INSTRUCTION_LEN,), 0.0, float(DMLAB_VOCABULARY_SIZE), "int32")
        self.observation_space = make_dict_spec(spaces)

        self._instr_buf = np.zeros([DMLAB_MAX_INSTRUCTION_LEN], dtype=np.int32)
        self._last_obs: Optional[Dict[str, np.ndarray]] = None
        self.raw_episode_return = 0.0
        self.episode_length = 0

    # DeepMind Lab level_cache hooks (the Lab object calls fetch/write on us)
    def fetch(self, key, pk3_path):
        return self.level_cache.fetch(key, pk3_path)

    def write(self, key, pk3_path):
        self.level_cache.write(self.level, self.last_reset_seed, key, pk3_path)

    def _format_obs(self) -> Dict[str, np.ndarray]:
        raw = self.dmlab.observations()
        obs = {"obs": raw["RGB_INTERLEAVED"]}
        if self.with_instructions:
            obs[DMLAB_INSTRUCTIONS] = tokenize_instructions(raw.get(DMLAB_INSTRUCTIONS), self._instr_buf).copy()
        return obs

    def seed(self, seed=None):
        self.rng = random.Random(42 if self.benchmark_mode else seed)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.seed(seed)
        if self.level_cache is not None:
            self.last_reset_seed = self.level_cache.get_unused_seed(self.level, self.rng)
        else:
            self.last_reset_seed = self.rng.randint(0, 2**31 - 1)
        self.dmlab.reset(seed=self.last_reset_seed)
        self.raw_episode_return = 0.0
        self.episode_length = 0
        self._last_obs = self._format_obs()
        return self._last_obs, {}

    def step(self, action):
        if self.benchmark_mode:
            # random policy for throughput measurement: DMLab step cost depends
            # heavily on agent behavior, so a fixed policy would skew numbers
            action = self.rng.randrange(0, len(self.action_list))
        raw_reward = float(self.dmlab.step(self.action_list[action], num_steps=self.action_repeat))
        terminated = not self.dmlab.is_running()
        if not terminated:
            self._last_obs = self._format_obs()

        self.raw_episode_return += raw_reward
        self.episode_length += self.action_repeat
        reward = optimistic_asymmetric_clip(raw_reward)

        info: Dict[str, Any] = {"num_frames": self.action_repeat}
        if terminated:
            # per-episode raw score for human-normalized summaries; key format
            # shared with the reference for TB/model-card compatibility
            key = f"z_{self.task_id:02d}_{self.level_name}"
            info["episode_extra_stats"] = {
                f"{key}_{RAW_SCORE_SUMMARY_KEY_SUFFIX}": self.raw_episode_return,
                f"{key}_len": self.episode_length,
            }
        return self._last_obs, reward, terminated, False, info

    def render(self):
        if self._last_obs is not None:
            return self._last_obs["obs"]
        return None

    def close(self):
        self.dmlab.close()


# ---------------------------------------------------------------- factories

_LEVEL_CACHES: Dict[int, DmlabLevelCache] = {}


def _get_level_cache(cfg, spec: DmlabSpec, policy_idx: int = 0) -> Optional[DmlabLevelCache]:
    """Per-process lazy cache construction (workers build their own on attach;
    coordination happens through the file locks, not through shared objects)."""
    if not getattr(cfg, "dmlab_use_level_cache", True):
        return None
    if policy_idx not in _LEVEL_CACHES:
        from sample_factory_tpu_torch.utils.utils import experiment_dir

        _LEVEL_CACHES[policy_idx] = DmlabLevelCache(
            cfg.dmlab_level_cache_path, experiment_dir(cfg), spec.levels, policy_idx
        )
    return _LEVEL_CACHES[policy_idx]


def make_dmlab_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    if not dmlab_available():
        raise RuntimeError(
            "deepmind_lab is not installed. The DMLab integration (dmlab_30 benchmark, level "
            "cache, instruction-conditioned policies) requires the deepmind_lab pip package."
        )
    spec = dmlab_env_by_name(env_name)
    task_id = task_id_for_env(spec, env_config, cfg)
    level = spec.levels[task_id]
    needs_cache = dmlab_level_to_level_name(level) in DMLAB30_LEVELS_THAT_USE_LEVEL_CACHE
    cache = _get_level_cache(cfg, spec) if needs_cache else None
    env = DmlabEnv(task_id, level, cfg, level_cache=cache, extra_cfg=spec.extra_cfg, render_mode=render_mode)
    if env_config and "env_id" in env_config:
        env.seed(env_config["env_id"])
    return env


def register_dmlab_envs() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    for spec in DMLAB_ENVS:
        register_env(spec.name, make_dmlab_env)
    if not dmlab_available():
        log.debug("deepmind_lab not installed; dmlab envs registered but will raise on creation")
