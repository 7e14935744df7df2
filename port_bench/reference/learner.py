"""The PPO learner of a configuration in plain PyTorch, over the trajectories a run recorded; the model is the
reference module that the configuration names (`reference/__init__.py`).

`follow(config, module, leaves, records, prec, seed, device)` replays the first training iterations of a run: for
each, the rollout's policy step over the recorded observations and actions (from its own parameters, normalizers and
carried recurrent state), then the train call: the update of each normalized observation key's moments (the keys
that the flags' `normalize_input_keys` names, every key where it names none; the static subtract-mean and scale on the
key "obs" before), the bootstrap value, GAE with value
bootstrap on time-outs, the returns normalizer, contiguous minibatches of whole segments over the epochs, the clipped
PPO losses with per-minibatch advantage normalization, the gradient clip, Adam, the KL-adaptive learning rate after
each epoch and the early stop on a flat epoch policy loss. Its outputs are what the program's run is judged by:

- `rollouts`: per iteration the values, action log-probabilities, action parameters [T, N, ...] and the recurrent
  states [T + 1, n, state] of the sampled envs;
- `losses`: per iteration the loss of the minibatch that the train call reports (its index drawn from the generator
  seeded `seed + 2` on the device, once a train call, as the trainer draws it);
- `first_moment`: Adam's first moment of every leaf after the first optimizer step, (1 - beta1) times the first
  gradient as the optimizer got it;
- `first_moment_norms`: the norm of each leaf's first moment, for this side's first gradient and for each other that
  rounding could give: a sample of the first minibatch whose ratio lies within CLIP_TIE of a PPO clip bound where its
  advantage's sign makes the bound decide, is either in the gradient or clipped out of it by rounding alone, so each
  such sample's term is taken both ways (at most MAX_TIES samples, the nearest to the bound);
- `leaves`: the parameters after the last followed iteration;
- `lrs`, `step_lrs`, `epoch_kls`: the learning rate after each train call and at each optimizer step, and each epoch's
  mean KL (what the schedule read);
- `lr_mismatches`: with a judged side, the epochs after which its learning rate was not this side's decision (nor,
  within NEAR_THRESHOLD of a threshold, the other one), and the train calls in which it ran another number of epochs.

The records' rewards, dones and time-outs are the env's outputs, taken as given with the actions.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from port_bench.reference import observations

RATIO_MIN, RATIO_MAX = 0.05, 20.0
NORM_EPS, NORM_CLIP = 1e-5, 5.0
EARLY_STOP = 1e-6
NEAR_THRESHOLD = 0.01  # an epoch KL within this share of a schedule threshold: either decision is rounding's
CLIP_TIE = 3e-5  # a ratio within this share of a PPO clip bound: in the gradient or out of it by rounding alone
MAX_TIES = 6  # such samples taken both ways, the nearest to the bound first


class Moments:
    """Running mean and variance with the parallel merge; the count starts at 1, the mean at 0, the variance at 1."""

    def __init__(self, shape, device, dtype=torch.float32):
        self.mean = torch.zeros(shape, device=device, dtype=dtype)
        self.var = torch.ones(shape, device=device, dtype=dtype)
        self.count = torch.ones((), device=device, dtype=dtype)

    def update(self, x: torch.Tensor) -> None:
        axes = tuple(range(x.dim() - self.mean.dim()))
        n = torch.tensor(float(math.prod(x.shape[a] for a in axes)), device=x.device, dtype=self.count.dtype)
        mean = x.mean(dim=axes)
        var = (x - mean).square().mean(dim=axes)
        delta, total = mean - self.mean, self.count + n
        self.mean = self.mean + delta * n / total
        self.var = (self.var * self.count + var * n + delta.square() * self.count * n / total) / total
        self.count = total

    def normalize(self, x):
        return ((x - self.mean) / torch.sqrt(self.var + NORM_EPS)).clamp(-NORM_CLIP, NORM_CLIP)

    def denormalize(self, x):
        return x.clamp(-NORM_CLIP, NORM_CLIP) * torch.sqrt(self.var + NORM_EPS) + self.mean


class Adam:
    def __init__(self, leaves: Dict[str, torch.Tensor], beta1: float, beta2: float, eps: float):
        self.b1, self.b2, self.eps, self.t = beta1, beta2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self, leaves, grads, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            leaves[k].sub_(lr / c1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + self.eps))


def gae(rewards, dones, values, gamma: float, lam: float):
    """rewards, dones [T, N]; values [T + 1, N] -> advantages [T, N]."""
    T = rewards.shape[0]
    adv, acc = [None] * T, torch.zeros_like(rewards[0])
    for t in reversed(range(T)):
        delta = rewards[t] - values[t] + (1.0 - dones[t]) * gamma * values[t + 1]
        acc = delta + gamma * lam * (1.0 - dones[t]) * acc
        adv[t] = acc
    return torch.stack(adv)


def kl_adaptive(lr: float, kl_mean: float, f: Dict) -> float:
    threshold = f["lr_schedule_kl_threshold"]
    if kl_mean > 2.0 * threshold:
        lr = max(lr / 1.5, f["lr_adaptive_min"])
    if kl_mean < 0.5 * threshold:
        lr = min(lr * 1.5, f["lr_adaptive_max"])
    return lr


class Learner:
    def __init__(self, config: Dict, module, leaves: Dict[str, torch.Tensor], prec, seed: int, device):
        self.f, self.model, self.M, self.prec, self.device = config["flags"], config["model"], module, prec, device
        f = self.f
        assert f["lr_schedule"] in ("constant", "kl_adaptive_epoch") and f["exploration_loss"] == "entropy"
        assert not f["with_vtrace"] and not f["shuffle_minibatches"] and f["optimizer"] == "adam"
        self.leaves = {k: v.detach().clone().to(prec.dtype) for k, v in leaves.items()}
        self.adam = Adam(self.leaves, f["adam_beta1"], f["adam_beta2"], f["adam_eps"])
        self.keys = observations(config)
        named = f.get("normalize_input_keys")
        self.obs_moments = {k: Moments(spec["shape"], device, prec.dtype) for k, spec in self.keys.items()
                            if f["normalize_input"] and k != "action_mask" and (named is None or k in named)}
        self.ret_moments = Moments((1,), device, prec.dtype) if f["normalize_returns"] else None
        self.lr = float(f["learning_rate"])
        self.summary_gen = torch.Generator(device=device).manual_seed(seed + 2)
        self.first_moment = None
        self.first_moment_norms: List[Dict[str, float]] = []
        self.state = None  # the recurrent state carried between rollouts
        self.epoch_kls: List[float] = []  # the epochs' mean KL, which the KL-adaptive learning rate reads
        self.step_lrs: List[List[float]] = []  # the learning rate of each optimizer step, a list a train call
        self.lr_mismatches = 0

    def _obs(self, record: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Recorded observations on the device: an int32 key that is not normalized as recorded, every other key in
        the precision's dtype, the key "obs" less `obs_subtract_mean` and over `obs_scale`, as the program's sampler
        takes them."""
        out = {}
        for k, x in record.items():
            x = x.to(self.device)
            if self.keys[k]["store"] == "int32" and k not in self.obs_moments:
                out[k] = x
                continue
            x = x.to(self.prec.dtype)
            subtract, scale = self.f.get("obs_subtract_mean", 0.0), self.f.get("obs_scale", 1.0)  # the port's defaults
            if k == "obs" and subtract != 0.0:
                x = x - subtract
            if k == "obs" and scale != 1.0:
                x = x / scale
            out[k] = x
        return out

    def _norm(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.obs_moments[k].normalize(x) if k in self.obs_moments else x for k, x in obs.items()}

    @torch.no_grad()
    def rollout(self, rec: Dict, sample: torch.Tensor) -> Dict:
        """The policy step over a recorded rollout: rec["obs"] [T+1, N, ...], rec["actions"], rec["dones"] [T, N]."""
        T, N = rec["dones"].shape
        p, m, M, dev = self.leaves, self.model, self.M, self.device
        if self.state is None:
            self.state = torch.zeros((N, M.state_width(m)), device=dev, dtype=self.prec.dtype)
        out = {"values": [], "log_probs": [], "params": [], "states": [self.state[sample].cpu()], "all_states": [self.state]}
        for t in range(T):
            obs = self._norm(self._obs({k: x[t] for k, x in rec["obs"].items()}))
            params, values, new_state = M.policy_step(p, m, obs, self.state, self.prec)
            actions = rec["actions"][t].to(dev)
            out["values"].append(values)
            out["log_probs"].append(M.log_prob(m, params, actions.float()))
            out["params"].append(params)
            done = rec["dones"][t].to(dev)
            self.state = torch.where(done[:, None] > 0, torch.zeros_like(new_state), new_state)
            out["states"].append(self.state[sample].cpu())
            out["all_states"].append(self.state)
        return {"values": torch.stack(out["values"]), "log_probs": torch.stack(out["log_probs"]),
                "params": torch.stack(out["params"]), "states": torch.stack(out["states"]),
                "all_states": torch.stack(out["all_states"])}

    def _losses(self, mb: Dict, count_kl: List, find_ties: bool = False):
        f, m, M, R = self.f, self.model, self.M, int(self.f["recurrence"])
        B = mb["dones"].shape[0]
        S = B // R

        def seg(x):
            if isinstance(x, dict):
                return {k: seg(v) for k, v in x.items()}
            return x.reshape((S, R) + tuple(x.shape[1:]))

        params, values = M.forward_seq(self.leaves, m, seg(mb["obs"]), seg(mb["states"])[:, 0], seg(mb["dones"]), self.prec)
        lp = M.log_prob(m, params, mb["actions"].float())
        ratio = torch.exp(lp - mb["log_probs"]).clamp(RATIO_MIN, RATIO_MAX)
        adv = mb["advantages"]
        mean = adv.mean()
        std = ((adv - mean).square().sum() / max(B - 1, 1)).sqrt()
        adv = (adv - mean) / std.clamp(min=1e-7)
        high = 1.0 + f["ppo_clip_ratio"]
        low = 1.0 / high
        policy_loss = -torch.minimum(ratio * adv, ratio.clamp(low, high) * adv).mean()
        exploration = -f["exploration_loss_coeff"] * M.entropy(m, params).mean()
        kl_mean = M.kl(m, params, mb["old_params"]).mean()
        clipped = mb["values"] + (values - mb["values"]).clamp(-f["ppo_clip_value"], f["ppo_clip_value"])
        value_loss = torch.maximum((values - mb["returns"]).square(), (clipped - mb["returns"]).square()).mean()
        loss = policy_loss + exploration + kl_mean * f["kl_loss_coeff"] + value_loss * f["value_loss_coeff"]
        count_kl.append(kl_mean.detach())
        if not find_ties:
            return loss, policy_loss.detach(), []
        # the samples whose policy term rounding may keep or clip: the ratio at a bound that decides for its advantage
        r, dist_high, dist_low = ratio.detach(), (ratio.detach() / high - 1.0).abs(), (ratio.detach() / low - 1.0).abs()
        near = ((adv > 0) & (dist_high < CLIP_TIE)) | ((adv < 0) & (dist_low < CLIP_TIE))
        idx = near.nonzero().flatten()
        idx = idx[torch.minimum(dist_high, dist_low)[idx].argsort()][:MAX_TIES]
        ties = [(-(ratio[i] * adv[i]) / B, bool((adv[i] > 0 and r[i] <= high) or (adv[i] < 0 and r[i] >= low)))
                for i in idx.tolist()]
        return loss, policy_loss.detach(), ties

    def _next_lr(self, kl: float, judged, at: int) -> float:
        """The learning rate after an epoch whose mean KL is `kl`. With `judged` (the judged side's learning rate at each
        optimizer step of this call and after it), the judged side's rate must be this decision's, and where `kl` lies
        within NEAR_THRESHOLD of a threshold, where rounding decides, it may be either decision's and is taken over."""
        f = self.f
        own = kl_adaptive(self.lr, kl, f) if f["lr_schedule"] == "kl_adaptive_epoch" else self.lr
        if judged is None:
            return own
        theirs = judged["step_lrs"][at] if at < len(judged["step_lrs"]) else judged["final_lr"]

        def same(a, b):
            return abs(a - b) <= 1e-6 * abs(b)

        if f["lr_schedule"] == "kl_adaptive_epoch":
            for t in (0.5 * f["lr_schedule_kl_threshold"], 2.0 * f["lr_schedule_kl_threshold"]):
                if abs(kl / t - 1.0) < NEAR_THRESHOLD and any(
                        same(theirs, kl_adaptive(self.lr, t * (1.0 + side * 1e-9), f)) for side in (-1, 1)):
                    return theirs
        if not same(theirs, own):
            self.lr_mismatches += 1
        return own

    def _grads(self, names, grads) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros_like(self.leaves[k]) if g is None else g for k, g in zip(names, grads)}

    def _clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.f["max_grad_norm"] <= 0:
            return grads
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = (self.f["max_grad_norm"] / (norm + 1e-6)).clamp(max=1.0)
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def _first_moment_norms(self, grads: Dict[str, torch.Tensor], ties) -> None:
        """Each leaf's first-moment norm for the first gradient and for every choice that rounding could make of the
        tied samples' terms (`ties`: each term's gradient and whether this side kept it)."""
        choices = [grads]
        for term, kept in ties:
            sign = -1.0 if kept else 1.0
            choices += [{k: g[k] + sign * term[k] for k in g} for g in choices]
        self.first_moment_norms = [
            {k: float(torch.linalg.vector_norm((1.0 - self.adam.b1) * v.double())) for k, v in self._clip(g).items()}
            for g in choices]

    def train(self, rec: Dict, ro: Dict, judged=None) -> float:
        """One train call on a recorded rollout and this side's rollout outputs `ro`; returns the reported loss. With
        `judged` (the judged side's learning rate at each optimizer step of the call, "step_lrs", and after it,
        "final_lr") the schedule's decisions are held to the judged side's (`_next_lr`), and the epochs it ran."""
        f, dev = self.f, self.device
        T, N = rec["dones"].shape
        gamma = f["gamma"]
        with torch.no_grad():
            obs = self._obs(rec["obs"])  # a key [T+1, N, ...]
            for k, moments in self.obs_moments.items():
                moments.update(obs[k])
            norm_obs = self._norm(obs)
            last_obs = {k: x[-1] for k, x in norm_obs.items()}
            _, last_values, _ = self.M.policy_step(self.leaves, self.model, last_obs, ro["all_states"][-1], self.prec)
            values = torch.cat([ro["values"], last_values[None]], dim=0)
            if self.ret_moments is not None:
                values = self.ret_moments.denormalize(values[..., None])[..., 0]
            rewards, dones = rec["rewards"].to(dev), rec["dones"].to(dev)
            if f["value_bootstrap"]:
                rewards = rewards + gamma * values[:-1] * rec["time_outs"].to(dev) * dones
            advantages = gae(rewards, dones, values, gamma, f["gae_lambda"])
            returns = advantages + values[:-1]
            if self.ret_moments is not None:
                self.ret_moments.update(returns.reshape(-1, 1))
                returns = self.ret_moments.normalize(returns[..., None])[..., 0]

            def rows(x):  # time-major [T, N, ...] -> env-major [N*T, ...]
                return x.transpose(0, 1).reshape((N * T,) + tuple(x.shape[2:]))

            data = {"obs": {k: rows(x[:T]) for k, x in norm_obs.items()}, "states": rows(ro["all_states"][:T]),
                    "actions": rows(rec["actions"].to(dev)), "old_params": rows(ro["params"]),
                    "log_probs": rows(ro["log_probs"]), "values": rows(ro["values"]), "dones": rows(dones),
                    "advantages": rows(advantages), "returns": rows(returns)}
        batch = min(int(f["batch_size"]), N * T)
        num_mb = N * T // batch
        names = list(self.leaves)
        prev_epoch_loss, losses = None, None
        self.step_lrs.append([])
        for epoch in range(int(f["num_epochs"])):
            kls, policy_losses, losses = [], [], []
            for i in range(num_mb):
                mb = {k: v[i * batch : (i + 1) * batch] for k, v in data.items() if k != "obs"}
                mb["obs"] = {k: v[i * batch : (i + 1) * batch] for k, v in data["obs"].items()}
                for v in self.leaves.values():
                    v.requires_grad_(True)
                first = self.first_moment is None
                loss, pl, ties = self._losses(mb, kls, find_ties=first)
                leaves = [self.leaves[k] for k in names]
                grads = self._grads(names, torch.autograd.grad(loss, leaves, allow_unused=True, retain_graph=first))
                if first:
                    self._first_moment_norms(grads, [(self._grads(names, torch.autograd.grad(
                        term, leaves, allow_unused=True, retain_graph=True)), kept) for term, kept in ties])
                for v in self.leaves.values():
                    v.requires_grad_(False)
                self.adam.step(self.leaves, self._clip(grads), self.lr)
                self.step_lrs[-1].append(self.lr)
                if first:
                    self.first_moment = {k: v.detach().cpu().clone() for k, v in self.adam.m.items()}
                losses.append(loss.detach())
                policy_losses.append(pl)
            self.epoch_kls.append(float(torch.stack(kls).mean()))
            self.lr = self._next_lr(self.epoch_kls[-1], judged, (epoch + 1) * num_mb)
            epoch_loss = float(torch.stack(policy_losses).mean())
            if prev_epoch_loss is not None and abs(prev_epoch_loss - epoch_loss) < EARLY_STOP:
                break
            prev_epoch_loss = epoch_loss
        if judged is not None and len(judged["step_lrs"]) != len(self.step_lrs[-1]):
            self.lr_mismatches += 1  # another number of epochs: the early stop decided otherwise
        index = int(torch.randint(0, num_mb, (), generator=self.summary_gen, device=dev))
        return float(losses[index])


def follow(config: Dict, module, leaves: Dict[str, torch.Tensor], records: List[Dict], prec, seed: int, device,
           sample: torch.Tensor, judged: Dict = None) -> Dict:
    """Replay the recorded iterations (see the module's docstring) with the reference module `module` and a
    `model.Precision` `prec`; each record's "obs" a dict of the configuration's observation keys. `judged`: the judged
    side's "step_lrs" (a list a train call) and "lrs" (after each call), to which the schedule's decisions are held
    (`Learner._next_lr`)."""
    out = {"rollouts": [], "losses": [], "lrs": []}
    with prec.active():
        learner = Learner(config, module, leaves, prec, seed, device)
        for i, rec in enumerate(records):
            ro = learner.rollout(rec, sample)
            call = None if judged is None else {"step_lrs": judged["step_lrs"][i], "final_lr": judged["lrs"][i]}
            loss = learner.train(rec, ro, call)
            out["rollouts"].append({k: ro[k].cpu() for k in ("values", "log_probs", "params", "states")})
            out["losses"].append(loss)
            out["lrs"].append(learner.lr)
            del ro
        out["first_moment"] = learner.first_moment
        out["first_moment_norms"] = learner.first_moment_norms
        out["epoch_kls"] = learner.epoch_kls
        out["step_lrs"] = learner.step_lrs
        out["lr_mismatches"] = learner.lr_mismatches
        out["leaves"] = {k: v.cpu() for k, v in learner.leaves.items()}
    return out
