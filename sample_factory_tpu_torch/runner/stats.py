"""Runner-side stats: windowed episode metrics, FPS windows, summary writers.

Counterpart of `sample_factory_tpu/runner/stats.py` (reference
`sample_factory/algo/runners/runner.py:119-142,291-343,368-423`). Summaries go
to a JSONL file, which is the record. Beside it, where `tensorboardX` imports,
the same scalars go to TensorBoard event files in the same directory, and with
`--with_wandb` to the open W&B run (`step=env_steps`; keys prefixed `p<id>/` in a
population). The JAX package writes its events through
`torch.utils.tensorboard`; the port never imports that module, because it imports
TensorFlow, which imports JAX where it is installed. Under a process group only rank 0
writes (`SummaryWriter` is a no-op elsewhere, as the JAX one :82-84): the stats it is
given are global, and the ranks share the experiment directory.
"""

from __future__ import annotations

import json
import time
from collections import deque
from os.path import join
from typing import Deque, Dict, Optional, Tuple

from sample_factory_tpu_torch.parallel.multihost import is_primary_host
from sample_factory_tpu_torch.utils.utils import log, summaries_dir
from sample_factory_tpu_torch.utils.wandb_utils import wandb_run


class FpsTracker:
    def __init__(self, windows=(10, 60, 300)):
        self.windows = windows
        self.history: Deque[Tuple[float, int]] = deque(maxlen=10000)

    def add(self, now: float, env_steps: int) -> None:
        self.history.append((now, env_steps))

    def fps(self, window: float) -> float:
        if not self.history:
            return 0.0
        now, latest = self.history[-1]
        past = None
        for t, steps in self.history:
            if now - t <= window:
                past = (t, steps)
                break
        if past is None or now - past[0] <= 0:
            return 0.0
        return (latest - past[1]) / (now - past[0])


class EpisodeStats:
    """Windowed averages over completed episodes (reference stats_avg deques)."""

    def __init__(self, stats_avg: int = 100):
        self.rewards: Deque[float] = deque(maxlen=stats_avg)
        self.lengths: Deque[float] = deque(maxlen=stats_avg)
        self.total_episodes = 0

    def add_rollout_stats(self, count: float, return_sum: float, len_sum: float) -> None:
        # the sampler sums over the episodes completed in a rollout; they enter the
        # window as `count` identical pseudo-episodes, which keeps the average faithful
        n = int(count)
        if n <= 0:
            return
        avg_r, avg_l = return_sum / n, len_sum / n
        for _ in range(min(n, self.rewards.maxlen)):
            self.rewards.append(avg_r)
            self.lengths.append(avg_l)
        self.total_episodes += n

    @property
    def avg_reward(self) -> Optional[float]:
        return sum(self.rewards) / len(self.rewards) if self.rewards else None

    @property
    def avg_length(self) -> Optional[float]:
        return sum(self.lengths) / len(self.lengths) if self.lengths else None


def _event_writer(logdir: str):
    """A tensorboardX event writer in `logdir`, or None where tensorboardX is missing."""
    try:
        from tensorboardX import SummaryWriter as EventWriter
    except ImportError:
        log.debug("tensorboardX is not installed: summaries go to JSONL only")
        return None
    return EventWriter(logdir=logdir)


class SummaryWriter:
    def __init__(self, cfg, policy_id: int = 0):
        self.cfg = cfg
        self._noop = not is_primary_host()
        if self._noop:
            return
        self.dir = summaries_dir(cfg, policy_id)
        self.jsonl_path = join(self.dir, "summaries.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._events = _event_writer(self.dir)
        self._wandb = wandb_run(cfg)  # init_wandb runs before the runners make their writers
        self._wandb_prefix = f"p{policy_id}/" if cfg.num_policies > 1 else ""

    def _mirror(self, env_steps: int, scalars: Dict[str, float]) -> None:
        if self._events is not None:
            for k, v in scalars.items():
                self._events.add_scalar(k, v, env_steps)
        if self._wandb is not None:
            self._wandb.log({self._wandb_prefix + k: v for k, v in scalars.items()}, step=env_steps)

    def write(self, env_steps: int, scalars: Dict[str, float], prefix: str = "train") -> None:
        if self._noop:
            return
        named = {f"{prefix}/{k}": v for k, v in scalars.items()}
        self._jsonl.write(json.dumps({"env_steps": env_steps, "time": time.time(), **named}) + "\n")
        self._mirror(env_steps, named)

    def add_scalar(self, key: str, value: float, env_steps: int) -> None:
        """tensorboardX-compatible single-scalar write (AlgoObserver.extra_summaries hooks)."""
        if self._noop:
            return
        self._jsonl.write(json.dumps({"env_steps": env_steps, "time": time.time(), key: float(value)}) + "\n")
        self._mirror(env_steps, {key: float(value)})

    def flush(self) -> None:
        if self._noop:
            return
        self._jsonl.flush()
        if self._events is not None:
            self._events.flush()

    def close(self) -> None:
        if self._noop:
            return
        self.flush()
        self._jsonl.close()
        if self._events is not None:
            self._events.close()
