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

from sample_factory_tpu_torch.parallel.multihost import broadcast_from_primary, has_group, local_rank, process_index, world_size
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


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def replicate_tree(train_state, mesh: Mesh) -> None:
    """Rank 0's train state on every rank, in place: the parameters and buffers, the
    optimizer's state, the normalizers, the learning rate, the train step and the PBT
    hyperparameters. It travels as rank 0's checkpoint payload, so that a rank that restored
    no checkpoint (an empty optimizer state, step 0) or another one takes rank 0's all the
    same. No-op without a group."""
    if not mesh.distributed:
        return
    payload = broadcast_from_primary(_to_cpu(train_state.state_dict()) if mesh.rank == 0 else None)
    if mesh.rank != 0:
        train_state.load_state_dict(payload)


def shard_params_tp(tree, mesh: Mesh, min_width: int = 512):
    raise NotImplementedError("tensor parallelism over the 'model' axis is not ported yet (ROADMAP A13c)")
