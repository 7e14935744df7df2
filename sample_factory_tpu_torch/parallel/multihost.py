"""Multi-process coordination on `torch.distributed`.

Counterpart of `sample_factory_tpu/parallel/multihost.py`. The JAX package runs one
SPMD program over the processes of `jax.distributed`; the port runs one process per
device in a process group (NCCL on CUDA, gloo on the CPU), started by a launcher such
as `python -m torch.distributed.run`, which sets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR` and `MASTER_PORT`. These helpers are the host-side residue: stats
aggregation, checkpoint gating and control broadcast. Each one is a no-op without a
process group, and calls no `torch.distributed` collective then.

`globalize_host_trajectory`, `globalize_replicated` and `localize_replicated` (:160-211)
have no counterpart: they move between JAX's global arrays and process-local ones, and
here each rank holds only its local shard to begin with.

Two faults of the JAX helpers are not copied: bool stats are not summed as ints
(:115), and `AmortizedEpisodeSums` keeps sums of keys absent on the flush iteration
(:128).

`is_multihost`, `aggregate_scalar_stats`, `aggregate_episode_sums` and
`AmortizedEpisodeSums` have no caller in the port yet: they wait for the host runners'
multi-process branches (ROADMAP A13b). The device-env runners reduce their episode sums
with `all_reduce` on the device, in the iteration's one collective.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def has_group() -> bool:
    """Whether this process belongs to a process group (a world of 1 included)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if has_group() else 1


def process_index() -> int:
    return dist.get_rank() if has_group() else 0


def local_rank() -> int:
    """The rank within this host, which picks the card: the launcher's `LOCAL_RANK`."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def is_multihost() -> bool:
    return world_size() > 1


def is_primary_host() -> bool:
    return process_index() == 0


def init_distributed(cfg=None, backend: Optional[str] = None) -> None:
    """Join the process group that the launcher's environment describes. The backend is
    NCCL when the run is on CUDA (`--device=gpu`) and gloo on the CPU; a harness may pass
    another, for example gloo for two ranks that share one card. Does nothing in a process
    that has already joined one."""
    if has_group():
        return
    missing = [name for name in LAUNCHER_VARIABLES if name not in os.environ]
    if missing:
        raise RuntimeError(
            f"--jax_distributed=True needs the launcher's environment; {', '.join(missing)} not set. Start the "
            "run with `python -m torch.distributed.run --nproc_per_node=R -m sample_factory_tpu_torch.train ...`"
        )
    if backend is None:
        backend = "gloo" if getattr(cfg, "device", "gpu") == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend=backend, init_method="env://", rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"])
    )


def shutdown() -> None:
    if has_group():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a host value goes for a collective: NCCL reduces on the card only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _reduce_op(op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


def all_reduce(tensors: Sequence[torch.Tensor], op: str = "sum", dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """One collective over several tensors of one device: they are packed into one buffer of
    `dtype`, reduced (`sum` or `max`) and handed back in their shapes and dtypes. Without a
    group they come back as they are."""
    if not has_group():
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, op=_reduce_op(op))
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset : offset + t.numel()].reshape(t.shape).to(t.dtype))
        offset += t.numel()
    return out


def agree_on_stop(stop: bool) -> bool:
    """True on every rank when any rank wants to stop, so that all run the same iterations:
    a rank that stops alone leaves the others waiting in a collective."""
    if not has_group():
        return stop
    flag = torch.full((), float(stop), device=_comm_device())
    return bool(all_reduce([flag], "max")[0].item() > 0)


def _is_numeric(v: Any) -> bool:
    """Numbers and numeric arrays; bools (an int subclass) and bool arrays are flags, not sums."""
    if isinstance(v, (bool, np.bool_)):
        return False
    if isinstance(v, np.ndarray):
        return v.dtype != np.bool_ and np.issubdtype(v.dtype, np.number)
    return isinstance(v, (int, float, np.floating, np.integer))


def _numeric_keys(ep: Dict[str, Any]) -> List[str]:
    return sorted(k for k, v in ep.items() if _is_numeric(v))


def _host_all_reduce(values: List[np.ndarray], op: str) -> List[np.ndarray]:
    """Reduce host arrays across ranks in float64, in one collective."""
    device = _comm_device()
    tensors = [torch.from_numpy(np.asarray(v, np.float64)).to(device) for v in values]
    return [t.cpu().numpy() for t in all_reduce(tensors, op, dtype=torch.float64)]


def aggregate_scalar_stats(stats: Dict[str, float], reduce: str = "mean") -> Dict[str, float]:
    """Scalar host stats reduced across ranks (`mean` or `sum`); unchanged without a group."""
    if not has_group():
        return stats
    if reduce not in ("mean", "sum"):
        raise ValueError(reduce)
    keys = sorted(stats)
    (summed,) = _host_all_reduce([np.asarray([float(stats[k]) for k in keys])], "sum")
    if reduce == "mean":
        summed = summed / world_size()
    return {k: float(v) for k, v in zip(keys, summed)}


def broadcast_from_primary(tree: Any) -> Any:
    """Rank 0's value of a picklable tree (arrays, numbers, lists, dicts) on every rank."""
    if not has_group():
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]


def aggregate_episode_sums(ep: Dict[str, Any]) -> Dict[str, Any]:
    """Numeric episode sums (count, return_sum, len_sum; scalars or per-policy arrays) summed
    across ranks, so that every rank's windows, reports and PBT objectives agree. Other
    entries (the per-episode `extra_stats` list, bool flags) stay rank-local. A collective:
    every rank calls it at the same point, with the same numeric keys and shapes."""
    if not has_group():
        return ep
    keys = _numeric_keys(ep)
    if not keys:
        return ep
    summed = _host_all_reduce([np.asarray(ep[k]) for k in keys], "sum")
    out = dict(ep)
    for k, value in zip(keys, summed):
        out[k] = _like(ep[k], value)
    return out


def _like(original: Any, value: np.ndarray) -> Any:
    if isinstance(original, np.ndarray):
        return value.astype(original.dtype, copy=False)
    return type(original)(value.reshape(()))


class AmortizedEpisodeSums:
    """Episode sums accumulated on each rank and reduced across ranks every `every`
    lockstep iterations (`parallel/multihost.py:88-144`): the collective is a barrier, so
    the host runners pay it 1/`every` as often. On other iterations the numeric fields come
    back as zeros; on the flush iteration they are the global sums since the last flush,
    keys absent on that iteration included. Non-numeric fields pass through rank-local.
    `flush()` hands back what is still pending. Without a group it passes `ep` through."""

    def __init__(self, every: int = 8):
        self.every = max(1, int(every))
        self._acc: Dict[str, np.ndarray] = {}
        self._like: Dict[str, Any] = {}
        self._n = 0

    def add(self, ep: Dict[str, Any]) -> Dict[str, Any]:
        if not has_group() or self.every == 1:
            return aggregate_episode_sums(ep)
        keys = _numeric_keys(ep)
        for k in keys:
            v = np.asarray(ep[k], np.float64)
            self._acc[k] = self._acc[k] + v if k in self._acc else v.copy()
            self._like[k] = ep[k]
        self._n += 1
        out = dict(ep)
        flushed = self.flush() if self._n >= self.every else None
        for k in keys:
            out[k] = _like(ep[k], np.zeros(np.shape(ep[k])))
        if flushed is not None:
            out.update(flushed)
        return out

    def flush(self) -> Optional[Dict[str, Any]]:
        """Global sums of what is pending, or None when nothing is; a lockstep collective."""
        if not has_group() or self._n == 0:
            return None
        keys = sorted(self._acc)
        summed = _host_all_reduce([self._acc[k] for k in keys], "sum")
        out = {k: _like(self._like[k], v) for k, v in zip(keys, summed)}
        self._acc, self._like, self._n = {}, {}, 0
        return out


def broadcast_objectives(objectives: list) -> list:
    """Rank 0's PBT objectives on every rank (None travels as NaN). With the PBT generator
    seeded alike everywhere, every rank then takes the same exploit and explore decisions."""
    if not has_group():
        return objectives
    arr = np.asarray([np.nan if o is None else float(o) for o in objectives], np.float64)
    arr = np.asarray(broadcast_from_primary(arr))
    return [None if np.isnan(v) else float(v) for v in arr]


def sync_barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others (`name` labels it for a reader of the code)."""
    if has_group():
        dist.barrier()
