"""DMLab-30 benchmark metadata.

Copy of `sf_examples_tpu/dmlab/dmlab30.py`.

The level list, train->test mapping, human/random baseline scores and
random-policy episode lengths are the published constants of the DMLab-30
benchmark (DeepMind IMPALA, arXiv:1802.01561, scalable_agent repo); the
reference carries the same tables in `sf_examples/dmlab/dmlab30.py`. They are
benchmark facts, reproduced here as a single per-level metadata table.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

DMLAB_INSTRUCTIONS = "INSTR"
DMLAB_VOCABULARY_SIZE = 1000
DMLAB_MAX_INSTRUCTION_LEN = 16


class LevelMeta(NamedTuple):
    """Per-level DMLab-30 benchmark constants."""

    test_level: str  # evaluation variant used for human-normalized scoring
    human: float  # human baseline score (on the test variant)
    random: float  # random-policy score (on the test variant)
    episode_len: int  # approx random-policy episode length in frames
    cache_episodes: Optional[int]  # ~episodes/1B frames if level-cache-bound, else None


# fmt: off
DMLAB30: Dict[str, LevelMeta] = {
    "rooms_collect_good_objects_train":     LevelMeta("rooms_collect_good_objects_test", 10.0, 0.073, 3600, None),
    "rooms_exploit_deferred_effects_train": LevelMeta("rooms_exploit_deferred_effects_test", 85.65, 8.501, 3600, None),
    "rooms_select_nonmatching_object":      LevelMeta("rooms_select_nonmatching_object", 65.9, 0.312, 720, None),
    "rooms_watermaze":                      LevelMeta("rooms_watermaze", 54.0, 4.065, 7200, None),
    "rooms_keys_doors_puzzle":              LevelMeta("rooms_keys_doors_puzzle", 53.8, 4.135, 3468, 11200),
    "language_select_described_object":     LevelMeta("language_select_described_object", 389.5, -0.07, 3600, None),
    "language_select_located_object":       LevelMeta("language_select_located_object", 280.7, 1.929, 7200, None),
    "language_execute_random_task":         LevelMeta("language_execute_random_task", 254.05, -5.913, 7200, None),
    "language_answer_quantitative_question": LevelMeta("language_answer_quantitative_question", 184.5, -0.33, 3600, None),
    "lasertag_one_opponent_small":          LevelMeta("lasertag_one_opponent_small", 12.65, -0.224, 14400, 2400),
    "lasertag_three_opponents_small":       LevelMeta("lasertag_three_opponents_small", 18.55, -0.214, 14400, 2400),
    "lasertag_one_opponent_large":          LevelMeta("lasertag_one_opponent_large", 18.6, -0.083, 14400, 2400),
    "lasertag_three_opponents_large":       LevelMeta("lasertag_three_opponents_large", 31.5, -0.102, 14400, 2400),
    "natlab_fixed_large_map":               LevelMeta("natlab_fixed_large_map", 36.9, 2.173, 7200, None),
    "natlab_varying_map_regrowth":          LevelMeta("natlab_varying_map_regrowth", 24.45, 2.989, 7200, None),
    "natlab_varying_map_randomized":        LevelMeta("natlab_varying_map_randomized", 42.35, 7.346, 7200, None),
    "skymaze_irreversible_path_hard":       LevelMeta("skymaze_irreversible_path_hard", 100.0, 0.1, 3600, 11200),
    "skymaze_irreversible_path_varied":     LevelMeta("skymaze_irreversible_path_varied", 100.0, 14.4, 3372, 13500),
    "psychlab_arbitrary_visuomotor_mapping": LevelMeta("psychlab_arbitrary_visuomotor_mapping", 58.75, 0.163, 18000, None),
    "psychlab_continuous_recognition":      LevelMeta("psychlab_continuous_recognition", 58.3, 0.224, 18000, None),
    "psychlab_sequential_comparison":       LevelMeta("psychlab_sequential_comparison", 39.5, 0.129, 18000, None),
    "psychlab_visual_search":               LevelMeta("psychlab_visual_search", 78.5, 0.085, 9000, None),
    "explore_object_locations_small":       LevelMeta("explore_object_locations_small", 74.45, 3.575, 5400, 6200),
    "explore_object_locations_large":       LevelMeta("explore_object_locations_large", 65.65, 4.673, 7200, 4700),
    "explore_obstructed_goals_small":       LevelMeta("explore_obstructed_goals_small", 206.0, 6.76, 5400, 6200),
    "explore_obstructed_goals_large":       LevelMeta("explore_obstructed_goals_large", 119.5, 2.61, 7200, 4700),
    "explore_goal_locations_small":         LevelMeta("explore_goal_locations_small", 267.5, 7.66, 5400, 6200),
    "explore_goal_locations_large":         LevelMeta("explore_goal_locations_large", 194.5, 3.14, 7200, 4700),
    "explore_object_rewards_few":           LevelMeta("explore_object_rewards_few", 77.7, 2.073, 5400, 6200),
    "explore_object_rewards_many":          LevelMeta("explore_object_rewards_many", 106.7, 2.438, 7200, 4700),
}
# fmt: on

DMLAB30_LEVELS = tuple(DMLAB30.keys())
DMLAB30_LEVELS_THAT_USE_LEVEL_CACHE = tuple(name for name, m in DMLAB30.items() if m.cache_episodes is not None)


def dmlab30_level_name_to_level(level_name: str) -> str:
    return f"contributed/dmlab30/{level_name}"


def dmlab_level_to_level_name(level: str) -> str:
    return level.split("/")[-1]


def human_normalized_score(level_name: str, raw_score: float) -> float:
    """IMPALA human-normalized score in percent: 100*(score-random)/(human-random)."""
    meta = DMLAB30[level_name]
    return (raw_score - meta.random) / (meta.human - meta.random) * 100.0
