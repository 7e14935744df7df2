"""DMLab level cache: reuse pre-generated maps instead of regenerating them.

Copy of `sf_examples_tpu/dmlab/dmlab_level_cache.py`. Role (parity with reference
`sf_examples/dmlab/dmlab_level_cache.py`): many
DMLab-30 levels procedurally generate a .pk3 map per (level, seed) which can
take minutes; DeepMind Lab exposes a `level_cache` hook (fetch/write by content
key) so generated maps can be stored and reused. A training run must also make
sure (a) different env instances never consume the same seed and (b) a resumed
experiment does not replay seeds it already used.

Redesign (of the JAX package, kept): the reference coordinates seed allocation with an
mp.RawValue counter + lock *inherited* through fork, which does not survive
this framework's spawn-based host workers (and cannot span multiple
hosts on a shared filesystem). Instead the allocator is a small file-locked
cursor: pre-generated seeds live in one `<level>.seeds` file per level inside
the cache dir, and the per-experiment cursor (`<level>.used`) is advanced
under `fcntl.flock`, which is correct across processes AND across hosts on
NFS. No state needs to be pickled into workers — they attach by path.
"""

from __future__ import annotations

import os
import random
import shutil
from os.path import join
from typing import Dict, List, Optional, Tuple

SEEDS_FILE_EXT = "seeds"
USED_FILE_EXT = "used"


def _locked(path: str):
    """Context manager: an exclusive advisory lock on `path` (created empty)."""
    import contextlib
    import fcntl

    @contextlib.contextmanager
    def cm():
        fd = os.open(path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield fd
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    return cm()


class DmlabLevelCache:
    """Seed allocator + pk3 store for one policy's envs.

    Layout:
      <cache_dir>/maps/<key>                 the cached .pk3 files (content-addressed)
      <cache_dir>/<level>.seeds              "seed key" lines for pre-generated levels
      <experiment_dir>/dmlab_used_seeds_p<k>/<level>.used   seeds consumed by this experiment
    """

    def __init__(self, cache_dir: str, experiment_dir: str, levels: List[str], policy_idx: int = 0):
        self.cache_dir = cache_dir
        self.policy_idx = policy_idx
        self.maps_dir = join(cache_dir, "maps")
        os.makedirs(self.maps_dir, exist_ok=True)
        self.used_dir = join(experiment_dir, f"dmlab_used_seeds_p{policy_idx:02d}")
        os.makedirs(self.used_dir, exist_ok=True)

        # available = pre-generated minus already-used (resume safety), shuffled
        self.available: Dict[str, List[int]] = {}
        self.used: Dict[str, set] = {}
        for level in levels:
            pre = self._read_seed_keys(self._seeds_path(level))
            used = self._read_used(self._used_path(level))
            remaining = list(set(s for s, _ in pre) - used)
            random.shuffle(remaining)
            self.available[level] = remaining
            self.used[level] = used

    # ---------------------------------------------------------------- paths

    def _seeds_path(self, level: str) -> str:
        return join(self.cache_dir, f"{level.replace('/', '_')}.{SEEDS_FILE_EXT}")

    def _used_path(self, level: str) -> str:
        return join(self.used_dir, f"{level.replace('/', '_')}.{USED_FILE_EXT}")

    @staticmethod
    def _read_seed_keys(path: str) -> List[Tuple[int, str]]:
        out: List[Tuple[int, str]] = []
        if not os.path.isfile(path):
            return out
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 1:
                    try:
                        out.append((int(parts[0]), parts[1] if len(parts) > 1 else ""))
                    except ValueError:
                        continue  # tolerate a torn line from a crashed writer
        return out

    @staticmethod
    def _read_used(path: str) -> set:
        used = set()
        if not os.path.isfile(path):
            return used
        with open(path) as f:
            for line in f:
                try:
                    used.add(int(line.split()[0]))
                except (ValueError, IndexError):
                    continue
        return used

    # ------------------------------------------------------------ allocation

    def get_unused_seed(self, level: str, rng: Optional[random.Random] = None) -> int:
        """Claim the next unused seed for `level` atomically across processes.

        Pre-generated seeds are consumed first (cursor line-count under a file
        lock); once exhausted, fresh random seeds are drawn, skipping any seed
        this experiment already used."""
        rng = rng or random
        used_path = self._used_path(level)
        with _locked(used_path + ".lock"):
            used = self._read_used(used_path)
            candidates = [s for s in self.available.get(level, []) if s not in used]
            if candidates:
                seed = candidates[0]
            else:
                while True:
                    seed = rng.randint(0, 2**31 - 1)
                    if seed not in used:
                        break
            with open(used_path, "a") as f:
                f.write(f"{seed}\n")
        self.used.setdefault(level, set()).add(seed)
        return seed

    # -------------------------------------------------------------- pk3 store

    def fetch(self, key: str, pk3_path: str) -> bool:
        """DeepMind Lab level_cache hook: copy a cached map to pk3_path."""
        src = join(self.maps_dir, key)
        if os.path.isfile(src):
            shutil.copyfile(src, pk3_path)
            return True
        return False

    def write(self, level: str, seed: int, key: str, pk3_path: str) -> None:
        """DeepMind Lab level_cache hook: store a newly generated map and
        record its seed so future experiments find it pre-generated."""
        dst = join(self.maps_dir, key)
        if not os.path.isfile(dst):
            tmp = dst + f".tmp{os.getpid()}"
            shutil.copyfile(pk3_path, tmp)
            os.replace(tmp, dst)  # atomic publish
        seeds_path = self._seeds_path(level)
        with _locked(seeds_path + ".lock"):
            known = {s for s, _ in self._read_seed_keys(seeds_path)}
            if seed not in known:
                with open(seeds_path, "a") as f:
                    f.write(f"{seed} {key}\n")


def make_dmlab_caches(cache_dir: str, experiment_dir: str, levels: List[str], num_policies: int) -> Dict[int, DmlabLevelCache]:
    return {p: DmlabLevelCache(cache_dir, experiment_dir, levels, p) for p in range(num_policies)}
