"""The learner: PPO/APPO over one collected trajectory.

Counterpart of `sample_factory_tpu/algo/learning.py`, with the same math:
`prepare_batch` (:238-317: valids from policy id and policy lag, obs
normalization, T+1 bootstrap value, GAE, returns normalization),
`compute_losses` (:127-205, with per-minibatch V-trace under --with_vtrace), `sgd_step` (:209-236: manual clip by
max_grad_norm, LR x valid fraction) and `make_train_fn` (:322-405:
contiguous or shuffled minibatches over epochs, early stop on a policy-loss
plateau of 1e-6, summary stats from a random minibatch). The JAX package fuses
all of it into one XLA program; here it is eager PyTorch, and the BPTT
recurrence runs the CUDA kernels of `ops/cuda_rnn.py`.

Host syncs per train call: the valid fraction (it scales the learning rate),
the epoch loss after every epoch of several (early stop), and the KL value under
a KL-adaptive schedule, each through `utils/timing.tracer().host_read`. An sgd
step has none: host scalars that become stats are filled on the device
(`torch.full`), not copied to it (`torch.tensor(x, device=...)` waits for the
stream), so that the host can run ahead of the learner's device work.
Spans (`utils/timing.py`, recorded while a torch.profiler session records): `learner`
around a train call; in it `learner.prepare_batch` (with `learner.normalize`,
`learner.bootstrap`, `learner.advantages`) and each `learner.epoch`; in an epoch each
`learner.minibatch`, of `learner.forward`, `learner.backward` and `learner.optimizer`.

On one CUDA rank with contiguous minibatches, a minibatch's work before the optimizer's
step is the replay of a CUDA graph (`minibatch_graphs.py`): its `learner.minibatch` then
holds no `learner.forward` or `learner.backward`, only `learner.optimizer` around the eager
step, and its time is the host's to enqueue the replay and the step.

Data parallelism (a `mesh` with a process group, `parallel/mesh.py`): each of R ranks
holds the rows of its own envs, and the learner computes what one rank with every
env computes, as GSPMD does for the JAX package. Every reduction is global: the valid
fraction, the normalizers' moments, the minibatch's valid count (each rank's masked
means are its own sums over it), the advantages' mean and std, the gradients (summed
before the clip by the global norm), the stats and the early stop. Minibatch i is rows
[i·B, (i+1)·B) of the global env-major dataset, or the i-th slice of one global
permutation drawn from the generator that every rank seeds alike (`select_minibatches`,
which the quantized learner calls too); a rank computes the loss over the rows of it that
it holds, none included, and joins every collective. Shuffled minibatches take one more
host sync an epoch on more than one rank, to split the permutation.

Tensor parallelism (a mesh with a 'model' axis, `parallel/tensor_parallel.py`): the ranks of
a model group hold the same rows and compute the same loss, each with its shards of the wide
leaves. So every reduction above runs over the data group alone (a sum over the world would
count each row M times), and so does the gradients' sum; the clip's norm counts a sharded
leaf's squares over the model group once and a replicated leaf's once. The replicas' gradients
of the replicated leaves, and the stats, are averaged over the model group: on the card the
replicas' backward is not bit-identical (the encoder's weight gradients differ in the last bits
between two processes fed the same inputs), and the replicas must not drift apart.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from sample_factory_tpu_torch.algo.advantages import gae_advantages, vtrace
from sample_factory_tpu_torch.algo.distributions import get_action_distribution
from sample_factory_tpu_torch.algo.losses import (
    clamp_ratio,
    entropy_exploration_loss,
    kl_loss as kl_loss_fn,
    masked_mean,
    normalize_advantages,
    policy_loss,
    symmetric_kl_exploration_loss,
    value_loss,
)
from sample_factory_tpu_torch.algo.minibatch_graphs import MinibatchGraphs, graph_key, replays_minibatches
from sample_factory_tpu_torch.algo.optimizers import make_optimizer, set_lr
from sample_factory_tpu_torch.algo.running_mean_std import (
    obs_rms_init,
    obs_rms_normalize,
    obs_rms_update,
    rms_denormalize,
    rms_init,
    rms_normalize,
    rms_update,
)
from sample_factory_tpu_torch.algo.sampling import _static_preprocess
from sample_factory_tpu_torch.algo.schedules import lr_after_epoch, lr_after_minibatch
from sample_factory_tpu_torch.envs.spaces import num_action_parameters
from sample_factory_tpu_torch.parallel.multihost import all_reduce
from sample_factory_tpu_torch.parallel.tensor_parallel import TPLayout
from sample_factory_tpu_torch.utils.timing import tracer

PBT_HPARAMS = (
    "learning_rate",
    "exploration_loss_coeff",
    "value_loss_coeff",
    "max_grad_norm",
    "ppo_clip_ratio",
    "ppo_clip_value",
    "gamma",
)

EARLY_STOPPING_TOLERANCE = 1e-6

# data parallelism: stats that are sums of the ranks' parts, and those that are maxima (ratio_min negated)
SUMMED_STATS = ("loss", "policy_loss", "value_loss", "exploration_loss", "kl_loss", "kl_divergence", "entropy", "value",
                "ratio_mean", "fraction_clipped", "value_delta")
MAXED_STATS = ("kl_divergence_max", "ratio_max", "max_abs_logprob")


def default_hparams(cfg) -> Dict[str, float]:
    return {name: float(getattr(cfg, name)) for name in PBT_HPARAMS}


@dataclass
class PolicyTrainState:
    """All learner state of one policy. The model and optimizer are updated in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    obs_rms: Any  # dict[str, RunningMeanStdState] or None
    returns_rms: Any  # RunningMeanStdState or None
    curr_lr: float
    train_step: int  # policy version: one per SGD step
    hparams: Dict[str, float]
    tp: Optional[TPLayout] = None  # the leaves sharded over the 'model' axis (`parallel/mesh.py:shard_train_state`)

    def state_dict(self) -> Dict[str, Any]:
        """Checkpoint payload: tensors, numbers and dicts only (loads with weights_only=True)."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "obs_rms": None if self.obs_rms is None else {k: v.state_dict() for k, v in self.obs_rms.items()},
            "returns_rms": None if self.returns_rms is None else self.returns_rms.state_dict(),
            "curr_lr": self.curr_lr,
            "train_step": self.train_step,
            "hparams": dict(self.hparams),
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.model.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        if self.obs_rms is not None:
            self.obs_rms = {k: v.load_state_dict(d["obs_rms"][k]) for k, v in self.obs_rms.items()}
        if self.returns_rms is not None:
            self.returns_rms = self.returns_rms.load_state_dict(d["returns_rms"])
        self.curr_lr = float(d["curr_lr"])
        self.train_step = int(d["train_step"])
        self.hparams = dict(d["hparams"])


def init_train_state(cfg, env_info, model: nn.Module, device) -> PolicyTrainState:
    obs_rms = (
        obs_rms_init(env_info.obs_space, keys_to_normalize=cfg.normalize_input_keys, device=device)
        if cfg.normalize_input
        else None
    )
    return PolicyTrainState(
        model=model,
        optimizer=make_optimizer(cfg, model.parameters()),
        obs_rms=obs_rms,
        returns_rms=rms_init((1,), device=device) if cfg.normalize_returns else None,
        curr_lr=float(cfg.learning_rate),
        train_step=0,
        hparams=default_hparams(cfg),
    )


def _data_parallel(mesh):
    """(all_sum, all_max, data index, data shards) of a run under a process group, the
    reductions over this rank's data group; all_sum is None without a group."""
    if mesh is None or not mesh.distributed:
        return None, None, 0, 1
    group = mesh.data_group
    return partial(all_reduce, op="sum", group=group), partial(all_reduce, op="max", group=group), mesh.data_index, mesh.data


def build_train_pieces(cfg, env_info, policy_id: int = 0, mesh=None):
    """The learner in two pieces: prepare_batch(ts, traj, pid) -> (dataset, valid_frac)
    and sgd_step(ts, valid_frac, minibatch) -> aux. With a data-parallel `mesh` the
    reductions of both are global (the module's docstring)."""
    action_space = env_info.action_space
    use_rnn = cfg.use_rnn
    recurrence = max(1, cfg.recurrence)
    all_sum, all_max, _, world = _data_parallel(mesh)

    def forward_seq(model, norm_obs, init_rnn_state, reset_flags):
        """norm_obs: dict [S, R, ...]; init_rnn_state [S, H]; reset_flags [S, R] -> ([S*R, P], [S*R])."""
        S, R = reset_flags.shape
        if S == 0:  # a data-parallel rank that holds no row of this minibatch
            params = torch.zeros((0, num_action_parameters(action_space)), device=reset_flags.device, requires_grad=True)
            return params, params.detach()[:, 0]
        head_out = model.forward_head(norm_obs)  # [S, R, D]
        if use_rnn:
            # BPTT: input projections for all R steps in one matmul, the recurrence in the kernel
            outs, _ = model.forward_core_seq(head_out.transpose(0, 1), init_rnn_state, reset_flags.transpose(0, 1))
            core_out = outs.transpose(0, 1).reshape(S * R, -1)
        else:
            flat = head_out.reshape(S * R, -1)
            core_out, _ = model.forward_core(flat, torch.zeros((S * R, 1), device=flat.device))
        return model.forward_tail(core_out)

    def _max(x):
        """x.max(); on a data-parallel rank that holds no row, -inf (the all-reduce takes the maximum)."""
        return x.max() if x.numel() else x.new_full((), float("-inf"))

    def compute_losses(model, mb, hp):
        """mb: dict of [B, ...] tensors (B = batch, segments contiguous), and `init_rnn_states` [S, H], the
        recurrent state entering each of its S segments."""
        B = mb["valids"].shape[0]
        S = B // recurrence

        def seg(x):
            return x.reshape((S, recurrence) + tuple(x.shape[1:]))

        norm_obs = {k: seg(v) for k, v in mb["normalized_obs"].items()}
        init_rnn = mb["init_rnn_states"]
        # reset AFTER consuming step t where the episode ended or the step is invalid
        done_or_invalid = torch.maximum(seg(mb["dones"]), 1.0 - seg(mb["valids"]))
        action_params, new_values = forward_seq(model, norm_obs, init_rnn, done_or_invalid)

        dist = get_action_distribution(action_space, action_params)
        log_probs = dist.log_prob(mb["actions"])
        ratio = clamp_ratio(torch.exp(log_probs - mb["log_prob_actions"]))
        valids = mb["valids"]

        if cfg.with_vtrace:
            # per-minibatch V-trace on fresh values and ratios (reference :602-639);
            # segments are whole rollouts (recurrence == rollout, checked by verify_cfg)
            def time_major(x):
                return seg(x).transpose(0, 1)  # [R, S]

            with torch.no_grad():
                vs, adv_tm = vtrace(
                    time_major(mb["rewards"]), time_major(mb["dones"]), time_major(new_values), time_major(ratio),
                    hp["gamma"], cfg.vtrace_rho, cfg.vtrace_c,
                )
            targets = vs.transpose(0, 1).reshape(B)
            adv = adv_tm.transpose(0, 1).reshape(B)
        else:
            adv, targets = mb["advantages"], mb["returns"]
        # the minibatch's valid count over every rank: each rank's masked means are its parts
        count = None if all_sum is None else all_sum([valids.sum()])[0].clamp(min=1.0)
        adv, adv_mean, adv_std = normalize_advantages(adv, valids, all_sum)

        clip_ratio_high = 1.0 + hp["ppo_clip_ratio"]
        clip_ratio_low = 1.0 / clip_ratio_high
        p_loss = policy_loss(ratio, adv, clip_ratio_low, clip_ratio_high, valids, count)

        entropy = dist.entropy()
        if cfg.exploration_loss == "entropy":
            expl_loss = entropy_exploration_loss(entropy, valids, hp["exploration_loss_coeff"], count)
        else:
            expl_loss = symmetric_kl_exploration_loss(
                dist.symmetric_kl_with_uniform_prior(), valids, hp["exploration_loss_coeff"], count, all_sum, world
            )

        old_dist = get_action_distribution(action_space, mb["action_logits"])
        kl_old = dist.kl_divergence(old_dist)
        kl_old_mean, kl_penalty = kl_loss_fn(kl_old, valids, cfg.kl_loss_coeff, count)

        v_loss = value_loss(new_values, mb["values"], targets, hp["ppo_clip_value"], valids, hp["value_loss_coeff"], count)
        loss = p_loss + expl_loss + kl_penalty + v_loss

        with torch.no_grad():
            inf = torch.full_like(ratio, float("inf"))
            aux = {
                "loss": loss,
                "policy_loss": p_loss,
                "value_loss": v_loss,
                "exploration_loss": expl_loss,
                "kl_loss": kl_penalty,
                "kl_divergence": kl_old_mean,
                "kl_divergence_max": _max(kl_old * valids),
                "entropy": masked_mean(entropy, valids, count),
                "value": masked_mean(new_values, valids, count),
                "adv_mean": adv_mean,
                "adv_std": adv_std,
                "ratio_mean": masked_mean((1.0 - ratio).abs(), valids, count),
                "ratio_min": -_max(-torch.where(valids > 0, ratio, inf)),
                "ratio_max": _max(torch.where(valids > 0, ratio, -inf)),
                "fraction_clipped": masked_mean(((ratio < clip_ratio_low) | (ratio > clip_ratio_high)).float(), valids, count),
                "max_abs_logprob": _max(mb["action_logits"].abs()),
                "value_delta": masked_mean((new_values - mb["values"]).abs(), valids, count),
            }
            aux = {k: v.detach() for k, v in aux.items()}
        return loss, aux

    def backward(ts: PolicyTrainState, loss, aux):
        """The gradients of `loss` in the parameters' .grad (zeroed first), exchanged between the ranks -> (grads,
        the leaves' sharded dims under tensor parallelism)."""
        model = ts.model
        ts.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        params = list(model.parameters())
        for p in params:  # as optax: every parameter gets a gradient, zero if unused
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads, dims = [p.grad for p in params], None
        if all_sum is not None:
            # each rank's loss is its part of the global one: the parts' gradients and stats add up
            summed = all_sum(grads + [aux[k] for k in SUMMED_STATS])
            torch._foreach_copy_(grads, summed[: len(grads)])
            aux.update(zip(SUMMED_STATS, summed[len(grads) :]))
            maxed = all_max([aux[k] for k in MAXED_STATS] + [-aux["ratio_min"]])
            aux.update(zip(MAXED_STATS, maxed))
            aux["ratio_min"] = -maxed[-1]
        if ts.tp is not None:
            # the model group's replicas compute the same backward, but not bit for bit on the card: their
            # mean keeps the replicated leaves, and every decision taken from the stats, equal on its ranks
            dims, size = ts.tp.param_dims(model), ts.tp.axis.size
            shared = [g for g, d in zip(grads, dims) if d is None]
            means = all_reduce(shared + list(aux.values()), group=ts.tp.axis.group)
            torch._foreach_copy_(shared, [m / size for m in means[: len(shared)]])
            aux.update((k, m / size) for k, m in zip(list(aux), means[len(shared) :]))
        return grads, dims

    def clip(ts: PolicyTrainState, grads, dims):
        """The gradients' global norm; the gradients scaled in place to at most `max_grad_norm`."""
        if ts.tp is None:
            grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        else:
            grad_norm = ts.tp.global_sq_norm(grads, dims).sqrt()
        if cfg.max_grad_norm > 0.0:
            # manual clip so the bound can be a per-policy (PBT) value
            scale = (ts.hparams["max_grad_norm"] / (grad_norm + 1e-6)).clamp(max=1.0)
            torch._foreach_mul_(grads, scale)
        return grad_norm

    def gradients(ts: PolicyTrainState, mb):
        """What a minibatch's graph holds: the losses, the clipped gradients -> (aux, grad_norm)."""
        loss, aux = compute_losses(ts.model, mb, ts.hparams)
        return aux, clip(ts, *backward(ts, loss, aux))

    def optimizer_step(ts: PolicyTrainState, valid_frac: float, aux, grad_norm):
        """The eager rest of a minibatch: the rate, Adam's step, the schedule; -> aux with the norm and the rate."""
        # invalid-data LR scaling (reference :789-794)
        actual_lr = ts.curr_lr * valid_frac
        set_lr(ts.optimizer, actual_lr)
        ts.optimizer.step()
        ts.curr_lr = lr_after_minibatch(cfg, ts.curr_lr, aux["kl_divergence"], ts.train_step)
        ts.train_step += 1
        aux["grad_norm"] = grad_norm.detach()
        aux["actual_lr"] = grad_norm.new_full((), actual_lr)  # filled on the device: no copy for the host to wait on
        return aux

    def sgd_step(ts: PolicyTrainState, valid_frac: float, mb,
                 graphs: Optional[MinibatchGraphs] = None) -> Dict[str, torch.Tensor]:
        """One minibatch; with `graphs`, everything before the optimizer's step by the replay of the model's graph
        (`minibatch_graphs.py`)."""
        trace = tracer()
        with trace.span("learner.minibatch"):
            if graphs is not None:
                aux, grad_norm = graphs.run(ts, mb, partial(gradients, ts))
                with trace.span("learner.optimizer"):
                    return optimizer_step(ts, valid_frac, aux, grad_norm)
            with trace.span("learner.forward"):
                loss, aux = compute_losses(ts.model, mb, ts.hparams)
            with trace.span("learner.backward"):
                grads, dims = backward(ts, loss, aux)
            with trace.span("learner.optimizer"):
                return optimizer_step(ts, valid_frac, aux, clip(ts, grads, dims))

    @torch.no_grad()
    def prepare_batch(ts: PolicyTrainState, traj: Dict[str, Any], pid: int):
        """Reference _prepare_batch (:943-1030), on time-major tensors. Updates the
        train state's normalizers; returns (dataset, valid_frac)."""
        trace = tracer()
        with trace.span("learner.prepare_batch"):
            T, N = traj["rewards"].shape[:2]

            with trace.span("learner.normalize"):
                # valids: same policy & within lag budget (reference :949-955)
                same_policy = traj["policy_id"] == pid
                within_lag = (ts.train_step - traj["policy_version"]) < cfg.max_policy_lag
                valids_t = (same_policy & within_lag).float()  # [T, N]
                valids = torch.cat([valids_t, valids_t[-1:]], dim=0)  # [T+1, N]

                # obs normalization: update running stats, then normalize (training mode)
                pre_obs = _static_preprocess(cfg, traj["obs"])
                if ts.obs_rms is not None:
                    flat_obs = {k: pre_obs[k].reshape((-1,) + tuple(pre_obs[k].shape[2:])) for k in ts.obs_rms}
                    ts.obs_rms = obs_rms_update(ts.obs_rms, flat_obs, mask=valids.reshape(-1), all_sum=all_sum)
                    normalized_obs = obs_rms_normalize(ts.obs_rms, pre_obs)
                else:
                    normalized_obs = pre_obs

            with trace.span("learner.bootstrap"):
                # T+1 bootstrap values with the current policy (reference :964-967)
                last_obs = {k: v[-1] for k, v in normalized_obs.items()}
                _, next_values, _ = ts.model(last_obs, traj["rnn_states"][-1])
                values = torch.cat([traj["values"], next_values[None]], dim=0)  # [T+1, N]

            with trace.span("learner.advantages"):
                # denormalize values for GAE (reference :969-978)
                if cfg.normalize_returns and ts.returns_rms is not None:
                    denorm_values = rms_denormalize(ts.returns_rms, values[..., None])[..., 0]
                else:
                    denorm_values = values

                rewards = traj["rewards"]
                gamma = ts.hparams["gamma"]
                if cfg.value_bootstrap:
                    # count only timeouts in terminal states (reference :980-990)
                    rewards = rewards + gamma * denorm_values[:-1] * traj["time_outs"] * traj["dones"]

                if not cfg.with_vtrace:
                    advantages = gae_advantages(rewards, traj["dones"], denorm_values, valids, gamma, cfg.gae_lambda)
                    returns = advantages + valids[:-1] * denorm_values[:-1]
                    if cfg.normalize_returns and ts.returns_rms is not None:
                        # masked by valids: invalid slots carry structurally-zero returns
                        ts.returns_rms = rms_update(ts.returns_rms, returns.reshape(-1, 1), mask=valids_t.reshape(-1), all_sum=all_sum)
                        returns = rms_normalize(ts.returns_rms, returns[..., None])[..., 0]
                else:
                    # V-trace computes both per minibatch, from fresh values and ratios
                    advantages = torch.zeros_like(rewards)
                    returns = torch.zeros_like(rewards)

            # flatten to an env-major dataset [N*T] with each env's rollout contiguous
            def to_dataset(x):
                x = x.transpose(0, 1)
                return x.reshape((N * T,) + tuple(x.shape[2:]))

            # of the recurrent states, only the one entering each segment of `recurrence` rows of the dataset
            starts = torch.arange(0, N * T, recurrence, device=traj["rnn_states"].device)
            dataset = {
                "normalized_obs": {k: to_dataset(v[:T]) for k, v in normalized_obs.items()},
                "init_rnn_states": traj["rnn_states"][starts % T, starts // T],
                "actions": to_dataset(traj["actions"]),
                "action_logits": to_dataset(traj["action_logits"]),
                "log_prob_actions": to_dataset(traj["log_prob_actions"]),
                "values": to_dataset(traj["values"]),
                "rewards": to_dataset(rewards),
                "dones": to_dataset(traj["dones"]),
                "advantages": to_dataset(advantages),
                "returns": to_dataset(returns),
                "valids": to_dataset(valids[:T]),
            }

            # neutralize invalid slots so logprob math can't NaN (reference :1020-1028)
            invalid = dataset["valids"] == 0
            dataset["actions"] = torch.where(invalid[:, None], torch.zeros_like(dataset["actions"]), dataset["actions"])
            dataset["log_prob_actions"] = torch.where(invalid, torch.full_like(dataset["log_prob_actions"], -1.0), dataset["log_prob_actions"])
            if all_sum is None:
                return dataset, trace.host_read("valid_frac", dataset["valids"].mean())
            (num_valid,) = all_sum([dataset["valids"].sum()])
            return dataset, trace.host_read("valid_frac", num_valid) / (dataset["valids"].numel() * world)

    return sgd_step, prepare_batch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def select_minibatches(dataset, rank: int, world: int, batch_size: int, recurrence: int, shuffle: bool,
                       generator: Optional[torch.Generator] = None):
    """This rank's rows of every global minibatch of one epoch, in order: a list of
    `dataset`-shaped dicts, empty where the rank holds no row of a minibatch.

    `dataset` holds this rank's `local` rows of the global env-major dataset of `local * world`
    rows, rank-major, and under `init_rnn_states` one row for each segment of `recurrence` rows;
    `batch_size` is already clipped to the global dataset. Contiguous minibatches are rows
    [i·B, (i+1)·B) (views, no data movement: the reference default); shuffled ones are the i-th
    slice of one permutation of the global segments drawn from `generator`, which every rank
    seeds alike (one host sync to split it on more than one rank)."""
    local_size = dataset["valids"].shape[0]
    dataset_size = local_size * world
    num_minibatches = dataset_size // batch_size
    first_row, local_segments = rank * local_size, local_size // recurrence

    def select(rows, segments):
        """`rows` applied to the row leaves, `segments` to the segment leaf."""
        return {k: segments(v) if k == "init_rnn_states" else _tree_map(rows, v) for k, v in dataset.items()}

    if not shuffle:
        def own_rows(i):
            lo, hi = max(i * batch_size, first_row), min((i + 1) * batch_size, first_row + local_size)
            lo, hi = lo - first_row, max(lo, hi) - first_row
            return select(lambda x: x[lo:hi], lambda x: x[lo // recurrence : hi // recurrence])

        return [own_rows(i) for i in range(num_minibatches)]

    segs_per_mb = batch_size // recurrence
    device = dataset["valids"].device
    perm = torch.randperm(dataset_size // recurrence, generator=generator, device=device)[: num_minibatches * segs_per_mb]
    selections = [perm[i * segs_per_mb : (i + 1) * segs_per_mb] for i in range(num_minibatches)]
    if world > 1:
        # the segments of each slice of the global permutation that this rank holds, in its order
        first_segment = rank * local_segments
        selections = [
            (sel[(sel >= first_segment) & (sel < first_segment + local_segments)] - first_segment).to(device)
            for sel in tracer().host_read("perm", perm).split(segs_per_mb)
        ]

    def gather(x, sel):
        seg_view = x.reshape((local_segments, recurrence) + tuple(x.shape[1:]))
        return seg_view[sel].reshape((sel.shape[0] * recurrence,) + tuple(x.shape[1:]))

    return [select(lambda x: gather(x, sel), lambda x: x[sel]) for sel in selections]


def make_train_fn(cfg, env_info, policy_id: int = 0, mesh=None) -> Callable:
    """Build train(ts, traj, generator) -> stats. traj is time-major [T(+1), N, ...];
    `generator` draws the minibatch shuffle and the summary minibatch. With a data-parallel
    `mesh`, traj holds this rank's envs and the generator is seeded alike on every rank."""
    recurrence = max(1, cfg.recurrence)
    sgd_step, prepare_batch = build_train_pieces(cfg, env_info, policy_id, mesh)
    _, all_max, rank, world = _data_parallel(mesh)
    graphs = MinibatchGraphs()

    def train(ts: PolicyTrainState, traj: Dict[str, Any], generator: Optional[torch.Generator] = None, pid: int = policy_id):
        trace = tracer()
        with trace.span("learner"):
            graphed = replays_minibatches(cfg, traj["rewards"].device, all_max is not None, ts.tp)
            dataset, valid_frac = prepare_batch(ts, traj, pid)
            device = dataset["valids"].device
            batch_size = min(cfg.batch_size, dataset["valids"].shape[0] * world)
            if graphed:
                for p in ts.model.parameters():  # the graph accumulates into gradients that exist before it
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                graphs.begin(ts, graph_key(ts, dataset, batch_size))

            def run_epoch():
                with trace.span("learner.epoch"):
                    minibatches = select_minibatches(dataset, rank, world, batch_size, recurrence, cfg.shuffle_minibatches,
                                                     generator)
                    auxes = [sgd_step(ts, valid_frac, mb, graphs if graphed else None) for mb in minibatches]
                    aux_seq = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
                    ts.curr_lr = lr_after_epoch(cfg, ts.curr_lr, aux_seq["kl_divergence"].mean())
                return aux_seq

            # epoch 0 always runs; later epochs stop once the epoch-mean policy loss
            # plateaus (reference learner.py:676,827-837)
            aux_seq = run_epoch()
            epochs_executed = 1
            if cfg.num_epochs > 1:
                prev_epoch_loss = trace.host_read("epoch_loss", aux_seq["policy_loss"].mean())
                for _ in range(1, cfg.num_epochs):
                    aux_seq = run_epoch()
                    epochs_executed += 1
                    epoch_loss = trace.host_read("epoch_loss", aux_seq["policy_loss"].mean())
                    if abs(prev_epoch_loss - epoch_loss) < EARLY_STOPPING_TOLERANCE:
                        break
                    prev_epoch_loss = epoch_loss

            # summaries from a random minibatch of the last executed epoch (reference learner.py:693-703)
            mb_idx = torch.randint(0, aux_seq["loss"].shape[0], (), generator=generator, device=device)
            stats = {k: v[mb_idx] for k, v in aux_seq.items()}
            stats["epochs_executed"] = torch.full((), float(epochs_executed), device=device)
            stats["valids_fraction"] = torch.full((), valid_frac, device=device)
            stats["lr"] = torch.full((), ts.curr_lr, device=device)
            stats["version_diff_max"] = (ts.train_step - traj["policy_version"]).max().float()
            if all_max is not None:
                (stats["version_diff_max"],) = all_max([stats["version_diff_max"]])
            return stats

    train.graphs = graphs
    return train
