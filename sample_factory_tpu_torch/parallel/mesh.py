"""The device mesh of a run: which rank this process is, and the slice of the envs it steps.

Counterpart of `sample_factory_tpu/parallel/mesh.py`. The JAX package builds a mesh over
all devices and lets GSPMD place the envs on the 'data' axis, replicate the train state
and turn the learner's reductions into all-reduces. The port runs one process per device
in a `torch.distributed` process group (`parallel/multihost.py`): rank r of R steps envs
[r·N/R, (r+1)·N/R) of the N that `--num_envs` names, holds a full replica of the train
state, and the learner reduces across ranks by hand (`algo/learning.py`), so that R ranks
compute what one rank with N envs computes. The 'model' axis (tensor parallelism,
`shard_params_tp`) is not ported yet (ROADMAP A13c).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist

from sample_factory_tpu_torch.parallel.multihost import has_group, local_rank, process_index, world_size
from sample_factory_tpu_torch.utils.utils import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the run. `distributed` says whether a process group exists:
    only then do the runners and the learner call collectives (a world of 1 included)."""

    world: int
    rank: int
    data: int
    model: int
    device: torch.device
    distributed: bool

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


@dataclass(frozen=True)
class EnvShard:
    """This rank's rows [start, stop) of the env axis of `total` envs."""

    start: int
    stop: int
    total: int

    @property
    def size(self) -> int:
        return self.stop - self.start


def mesh_axes(cfg, world: int) -> Tuple[int, int]:
    """(data, model) from --mesh_data/--mesh_model over `world` devices; -1 for data means
    all of them over the model axis (`make_mesh` :23-33)."""
    model = getattr(cfg, "mesh_model", 1) if cfg is not None else 1
    data = getattr(cfg, "mesh_data", -1) if cfg is not None else -1
    if data <= 0:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover {world} devices; set --mesh_data/--mesh_model")
    return data, model


def _rank_device(cfg) -> torch.device:
    """cuda:LOCAL_RANK under a group on --device=gpu: never the CPU, never another card."""
    device = resolve_device(cfg)
    if device.type != "cuda":
        return device
    index = local_rank()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={index} but this host has {torch.cuda.device_count()} CUDA device(s)")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def make_mesh(cfg=None) -> Mesh:
    distributed = has_group()
    world = world_size()
    data, model = mesh_axes(cfg, world)
    device = _rank_device(cfg) if distributed else resolve_device(cfg)
    return Mesh(world=world, rank=process_index(), data=data, model=model, device=device, distributed=distributed)


def num_data_shards(mesh) -> int:
    return mesh.data if mesh is not None else 1


def shard_env_axis(mesh: Mesh, num_envs: int) -> EnvShard:
    """The rank's slice of the env axis (`shard_env_axis` :45-62 places it on the 'data' axis)."""
    shards = num_data_shards(mesh)
    if num_envs % shards:
        raise ValueError(f"num_envs ({num_envs}) must divide over {shards} data shards")
    per_rank = num_envs // shards
    return EnvShard(mesh.rank * per_rank, (mesh.rank + 1) * per_rank, num_envs)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate_tree(train_state, mesh: Mesh) -> None:
    """Broadcast a train state from rank 0, in place: the parameters and buffers, the
    optimizer's state and the normalizers. A tensor where the backend cannot take it (a
    CPU step count under NCCL) goes through the rank's device. No-op without a group."""
    if not mesh.distributed:
        return
    rms = [train_state.returns_rms] + list((train_state.obs_rms or {}).values())
    tensors = list(train_state.model.state_dict().values())
    tensors += list(_tensors(list(train_state.optimizer.state.values())))
    tensors += [t for s in rms if s is not None for t in s.state_dict().values()]
    nccl = dist.get_backend() == "nccl"
    for t in tensors:
        if nccl and t.device != mesh.device:
            staged = t.to(mesh.device)
            dist.broadcast(staged, src=0)
            t.copy_(staged)
        else:
            dist.broadcast(t, src=0)


def shard_params_tp(tree, mesh: Mesh, min_width: int = 512):
    raise NotImplementedError("tensor parallelism over the 'model' axis is not ported yet (ROADMAP A13c)")
