"""Multi-process coordination on `torch.distributed`.

Counterpart of `sample_factory_tpu/parallel/multihost.py`. The JAX package runs one
SPMD program over the processes of `jax.distributed`; the port runs one process per
device in a process group (NCCL on CUDA, gloo on the CPU), started by a launcher such
as `python -m torch.distributed.run`, which sets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR` and `MASTER_PORT`. These helpers are the host-side residue: the packed
all-reduce, checkpoint gating and control broadcast. Each one is a no-op without a
process group, and calls no `torch.distributed` collective then.

`globalize_host_trajectory`, `globalize_replicated` and `localize_replicated` (:160-211)
have no counterpart: they move between JAX's global arrays and process-local ones, and
here each rank holds only its local shard to begin with.

What the runners call: `all_reduce` (the learner's sums and maxima over the data group, and the
iteration's one reduce of the episode sums with the stop, `runner/runner.py:_reduce_across_ranks`,
for the device-env and the host runners alike), `agree_on_stop` (before the first iteration),
`broadcast_objectives` (PBT), `is_primary_host` (the writes) and `sync_barrier`; the host
runners decorrelate their ranks by RANK_SEED_STRIDE. `is_multihost`, `aggregate_scalar_stats`,
`aggregate_episode_sums` and `AmortizedEpisodeSums` (:88-144) have no counterpart: the episode
sums join the stop's all-reduce every iteration instead of a collective of their own every
8 iterations (ROADMAP C, deviations), so the two faults of the JAX helpers (bool stats summed
as ints, :115; sums of keys absent on the flush iteration dropped, :128) cannot arise.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
RANK_SEED_STRIDE = 1000003  # rank r's envs and action draws are seeded r * this apart (`host_runner.py:101`)


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


def all_reduce(tensors: Sequence[torch.Tensor], op: str = "sum", dtype: torch.dtype = torch.float32,
               group=None) -> List[torch.Tensor]:
    """One collective over several tensors of one device: they are packed into one buffer of
    `dtype`, reduced (`sum` or `max`) over `group` (None: the world) and handed back in their
    shapes and dtypes. Without a process group they come back as they are."""
    if not has_group():
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, op=_reduce_op(op), group=group)
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


def broadcast_from_primary(tree: Any) -> Any:
    """Rank 0's value of a picklable tree (arrays, numbers, lists, dicts) on every rank."""
    if not has_group():
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]


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
