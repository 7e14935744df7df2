"""Learning-rate schedules (counterpart of `sample_factory_tpu/algo/schedules.py`;
reference `sample_factory/algo/learning/learner.py:35-113`). The learning rate is a
Python float held by the train state and set on the optimizer before each step."""

from __future__ import annotations


def kl_adaptive_lr_update(curr_lr: float, mean_kl: float, kl_threshold: float, min_lr: float, max_lr: float) -> float:
    """If KL > 2*threshold: lr /= 1.5; if KL < 0.5*threshold: lr *= 1.5 (reference :57-66)."""
    lr = max(curr_lr / 1.5, min_lr) if mean_kl > 2.0 * kl_threshold else curr_lr
    if mean_kl < 0.5 * kl_threshold:
        lr = min(lr * 1.5, max_lr)
    return lr


def linear_decay_lr(base_lr: float, sgd_step: int, total_sgd_steps: int) -> float:
    frac = min(max(1.0 - sgd_step / max(1, total_sgd_steps), 0.0), 1.0)
    return base_lr * frac


def total_sgd_steps_for_linear_decay(cfg) -> int:
    """num_updates in the reference LinearDecayScheduler (:89-92)."""
    return max(1, cfg.train_for_env_steps // cfg.batch_size * cfg.num_epochs)


def lr_after_minibatch(cfg, curr_lr: float, mean_kl, sgd_step: int) -> float:
    """LR after each minibatch; `mean_kl` is read (a device sync) only by the KL schedule."""
    if cfg.lr_schedule == "kl_adaptive_minibatch":
        return kl_adaptive_lr_update(
            curr_lr, float(mean_kl), cfg.lr_schedule_kl_threshold, cfg.lr_adaptive_min, cfg.lr_adaptive_max
        )
    if cfg.lr_schedule == "linear_decay":
        return linear_decay_lr(cfg.learning_rate, sgd_step, total_sgd_steps_for_linear_decay(cfg))
    return curr_lr


def lr_after_epoch(cfg, curr_lr: float, mean_kl_over_epoch) -> float:
    if cfg.lr_schedule == "kl_adaptive_epoch":
        return kl_adaptive_lr_update(
            curr_lr, float(mean_kl_over_epoch), cfg.lr_schedule_kl_threshold, cfg.lr_adaptive_min, cfg.lr_adaptive_max
        )
    return curr_lr
