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
one per extra epoch (early stop), and the KL value under a KL-adaptive
schedule. An sgd step has none: host scalars that become stats are filled on the
device (`torch.full`), not copied to it (`torch.tensor(x, device=...)` waits for
the stream), so that the host can run ahead of the learner's device work.
"""

from __future__ import annotations

from dataclasses import dataclass
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


def build_train_pieces(cfg, env_info, policy_id: int = 0):
    """The learner in two pieces: prepare_batch(ts, traj, pid) -> (dataset, valid_frac)
    and sgd_step(ts, valid_frac, minibatch) -> aux."""
    action_space = env_info.action_space
    use_rnn = cfg.use_rnn
    recurrence = max(1, cfg.recurrence)

    def forward_seq(model, norm_obs, init_rnn_state, reset_flags):
        """norm_obs: dict [S, R, ...]; init_rnn_state [S, H]; reset_flags [S, R] -> ([S*R, P], [S*R])."""
        S, R = reset_flags.shape
        head_out = model.forward_head(norm_obs)  # [S, R, D]
        if use_rnn:
            # BPTT: input projections for all R steps in one matmul, the recurrence in the kernel
            outs, _ = model.forward_core_seq(head_out.transpose(0, 1), init_rnn_state, reset_flags.transpose(0, 1))
            core_out = outs.transpose(0, 1).reshape(S * R, -1)
        else:
            flat = head_out.reshape(S * R, -1)
            core_out, _ = model.forward_core(flat, torch.zeros((S * R, 1), device=flat.device))
        return model.forward_tail(core_out)

    def compute_losses(model, mb, hp):
        """mb: dict of [B, ...] tensors (B = batch, segments contiguous)."""
        B = mb["valids"].shape[0]
        S = B // recurrence

        def seg(x):
            return x.reshape((S, recurrence) + tuple(x.shape[1:]))

        norm_obs = {k: seg(v) for k, v in mb["normalized_obs"].items()}
        init_rnn = seg(mb["rnn_states"])[:, 0]
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
        adv, adv_mean, adv_std = normalize_advantages(adv, valids)

        clip_ratio_high = 1.0 + hp["ppo_clip_ratio"]
        clip_ratio_low = 1.0 / clip_ratio_high
        p_loss = policy_loss(ratio, adv, clip_ratio_low, clip_ratio_high, valids)

        entropy = dist.entropy()
        if cfg.exploration_loss == "entropy":
            expl_loss = entropy_exploration_loss(entropy, valids, hp["exploration_loss_coeff"])
        else:
            expl_loss = symmetric_kl_exploration_loss(
                dist.symmetric_kl_with_uniform_prior(), valids, hp["exploration_loss_coeff"]
            )

        old_dist = get_action_distribution(action_space, mb["action_logits"])
        kl_old = dist.kl_divergence(old_dist)
        kl_old_mean, kl_penalty = kl_loss_fn(kl_old, valids, cfg.kl_loss_coeff)

        v_loss = value_loss(new_values, mb["values"], targets, hp["ppo_clip_value"], valids, hp["value_loss_coeff"])
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
                "kl_divergence_max": (kl_old * valids).max(),
                "entropy": masked_mean(entropy, valids),
                "value": masked_mean(new_values, valids),
                "adv_mean": adv_mean,
                "adv_std": adv_std,
                "ratio_mean": masked_mean((1.0 - ratio).abs(), valids),
                "ratio_min": torch.where(valids > 0, ratio, inf).min(),
                "ratio_max": torch.where(valids > 0, ratio, -inf).max(),
                "fraction_clipped": masked_mean(((ratio < clip_ratio_low) | (ratio > clip_ratio_high)).float(), valids),
                "max_abs_logprob": mb["action_logits"].abs().max(),
                "value_delta": masked_mean((new_values - mb["values"]).abs(), valids),
            }
            aux = {k: v.detach() for k, v in aux.items()}
        return loss, aux

    def sgd_step(ts: PolicyTrainState, valid_frac: float, mb) -> Dict[str, torch.Tensor]:
        model = ts.model
        loss, aux = compute_losses(model, mb, ts.hparams)
        ts.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        params = list(model.parameters())
        for p in params:  # as optax: every parameter gets a gradient, zero if unused
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if cfg.max_grad_norm > 0.0:
            # manual clip so the bound can be a per-policy (PBT) value
            scale = (ts.hparams["max_grad_norm"] / (grad_norm + 1e-6)).clamp(max=1.0)
            torch._foreach_mul_(grads, scale)

        # invalid-data LR scaling (reference :789-794)
        actual_lr = ts.curr_lr * valid_frac
        set_lr(ts.optimizer, actual_lr)
        ts.optimizer.step()

        ts.curr_lr = lr_after_minibatch(cfg, ts.curr_lr, aux["kl_divergence"], ts.train_step)
        ts.train_step += 1
        aux["grad_norm"] = grad_norm.detach()
        aux["actual_lr"] = grad_norm.new_full((), actual_lr)  # filled on the device: no copy for the host to wait on
        return aux

    @torch.no_grad()
    def prepare_batch(ts: PolicyTrainState, traj: Dict[str, Any], pid: int):
        """Reference _prepare_batch (:943-1030), on time-major tensors. Updates the
        train state's normalizers; returns (dataset, valid_frac)."""
        T, N = traj["rewards"].shape[:2]

        # valids: same policy & within lag budget (reference :949-955)
        same_policy = traj["policy_id"] == pid
        within_lag = (ts.train_step - traj["policy_version"]) < cfg.max_policy_lag
        valids_t = (same_policy & within_lag).float()  # [T, N]
        valids = torch.cat([valids_t, valids_t[-1:]], dim=0)  # [T+1, N]

        # obs normalization: update running stats, then normalize (training mode)
        pre_obs = _static_preprocess(cfg, traj["obs"])
        if ts.obs_rms is not None:
            flat_obs = {k: pre_obs[k].reshape((-1,) + tuple(pre_obs[k].shape[2:])) for k in ts.obs_rms}
            ts.obs_rms = obs_rms_update(ts.obs_rms, flat_obs, mask=valids.reshape(-1))
            normalized_obs = obs_rms_normalize(ts.obs_rms, pre_obs)
        else:
            normalized_obs = pre_obs

        # T+1 bootstrap values with the current policy (reference :964-967)
        last_obs = {k: v[-1] for k, v in normalized_obs.items()}
        _, next_values, _ = ts.model(last_obs, traj["rnn_states"][-1])
        values = torch.cat([traj["values"], next_values[None]], dim=0)  # [T+1, N]

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
                ts.returns_rms = rms_update(ts.returns_rms, returns.reshape(-1, 1), mask=valids_t.reshape(-1))
                returns = rms_normalize(ts.returns_rms, returns[..., None])[..., 0]
        else:
            # V-trace computes both per minibatch, from fresh values and ratios
            advantages = torch.zeros_like(rewards)
            returns = torch.zeros_like(rewards)

        # flatten to an env-major dataset [N*T] with each env's rollout contiguous
        def to_dataset(x):
            x = x.transpose(0, 1)
            return x.reshape((N * T,) + tuple(x.shape[2:]))

        dataset = {
            "normalized_obs": {k: to_dataset(v[:T]) for k, v in normalized_obs.items()},
            "rnn_states": to_dataset(traj["rnn_states"][:T]),
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
        return dataset, float(dataset["valids"].mean())

    return sgd_step, prepare_batch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_train_fn(cfg, env_info, policy_id: int = 0) -> Callable:
    """Build train(ts, traj, generator) -> stats. traj is time-major [T(+1), N, ...];
    `generator` draws the minibatch shuffle and the summary minibatch."""
    recurrence = max(1, cfg.recurrence)
    sgd_step, prepare_batch = build_train_pieces(cfg, env_info, policy_id)

    def train(ts: PolicyTrainState, traj: Dict[str, Any], generator: Optional[torch.Generator] = None, pid: int = policy_id):
        dataset, valid_frac = prepare_batch(ts, traj, pid)
        device = dataset["valids"].device

        dataset_size = dataset["valids"].shape[0]
        batch_size = min(cfg.batch_size, dataset_size)
        num_minibatches = dataset_size // batch_size
        num_segments = dataset_size // recurrence
        segs_per_mb = batch_size // recurrence

        def epoch_minibatches():
            if not cfg.shuffle_minibatches:
                # contiguous minibatches: views, no data movement (the reference default)
                return [_tree_map(lambda x: x[i * batch_size : (i + 1) * batch_size], dataset) for i in range(num_minibatches)]
            perm = torch.randperm(num_segments, generator=generator, device=device)[: num_minibatches * segs_per_mb]

            def gather(x, sel):
                seg_view = x.reshape((num_segments, recurrence) + tuple(x.shape[1:]))
                return seg_view[sel].reshape((batch_size,) + tuple(x.shape[1:]))

            return [
                _tree_map(lambda x: gather(x, perm[i * segs_per_mb : (i + 1) * segs_per_mb]), dataset)
                for i in range(num_minibatches)
            ]

        def run_epoch():
            auxes = [sgd_step(ts, valid_frac, mb) for mb in epoch_minibatches()]
            aux_seq = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
            ts.curr_lr = lr_after_epoch(cfg, ts.curr_lr, aux_seq["kl_divergence"].mean())
            return aux_seq

        # epoch 0 always runs; later epochs stop once the epoch-mean policy loss
        # plateaus (reference learner.py:676,827-837)
        aux_seq = run_epoch()
        epochs_executed = 1
        if cfg.num_epochs > 1:
            prev_epoch_loss = float(aux_seq["policy_loss"].mean())
            for _ in range(1, cfg.num_epochs):
                aux_seq = run_epoch()
                epochs_executed += 1
                epoch_loss = float(aux_seq["policy_loss"].mean())
                if abs(prev_epoch_loss - epoch_loss) < EARLY_STOPPING_TOLERANCE:
                    break
                prev_epoch_loss = epoch_loss

        # summaries from a random minibatch of the last executed epoch (reference learner.py:693-703)
        mb_idx = torch.randint(0, num_minibatches, (), generator=generator, device=device)
        stats = {k: v[mb_idx] for k, v in aux_seq.items()}
        stats["epochs_executed"] = torch.full((), float(epochs_executed), device=device)
        stats["valids_fraction"] = torch.full((), valid_frac, device=device)
        stats["lr"] = torch.full((), ts.curr_lr, device=device)
        stats["version_diff_max"] = (ts.train_step - traj["policy_version"]).max().float()
        return stats

    return train
