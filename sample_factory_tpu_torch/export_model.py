"""Model export for deployment: a `torch.export` program of the policy.

Counterpart of `sample_factory_tpu/export_model.py` (`build_inference_fn` :34-53,
`export_model` :56-88, `load_exported_model` :91-97, `main` :182-209). The JAX
package serializes StableHLO through `jax.export`; the port serializes an
`torch.export.ExportedProgram` (`torch.export.save`, `<experiment>/policy_p<i>.pt2`),
which `torch.export.load` reads back without the model's Python code. The program
is exported on the device of `--device`: on the card it runs on `cuda:0`. For
ONNX see `export_onnx.py`. The JAX package's `export_tf_saved_model` (a `jax2tf`
route) has no counterpart here.

The exported function is

    (obs dict, rnn_state[, noise]) -> (actions, new_rnn_state)

with the static preprocessing and the observation normalizer folded in, the
`action_mask` taken from the raw obs dict, and actions of the dtype
`action_dtype` gives. A deterministic policy (`--eval_deterministic=True`) takes
the argmax or the means. A sampling policy takes its random draws as the input
`noise`, uniform in (0, 1) of shape [batch, `noise_width(action_space)`]: one draw
a category, used through Gumbel-max, and one a dimension of a Box, used through
the inverse normal CDF. JAX takes a PRNG key there; `torch.export` cannot take a
`torch.Generator`, and with the draws as an input the program is a pure function.
"""

from __future__ import annotations

import sys
from os.path import join
from typing import Optional

import torch
from torch import nn

from sample_factory_tpu_torch.algo.distributions import argmax_actions, get_action_distribution, noise_width
from sample_factory_tpu_torch.algo.learning import init_train_state
from sample_factory_tpu_torch.algo.sampling import normalize_obs
from sample_factory_tpu_torch.cfg.arguments import load_from_checkpoint
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.envs.spaces import action_dtype, obs_space_as_dict
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic, initial_actor_critic_state
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint
from sample_factory_tpu_torch.utils.utils import experiment_dir, log, resolve_device


class InferencePolicy(nn.Module):
    """The policy of one train state as one module (see the module docstring)."""

    def __init__(self, cfg, env_info, model: nn.Module, obs_rms, deterministic: bool):
        super().__init__()
        self.cfg = cfg
        self.action_space = env_info.action_space
        self.model = model
        self.obs_rms = obs_rms
        self.deterministic = deterministic
        self.action_dtype = torch.int32 if action_dtype(self.action_space) == "int32" else torch.float32
        self.noise_width = noise_width(self.action_space)

    def draw_noise(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """The `noise` input for `batch` actions, drawn from `generator` on its device."""
        return torch.rand((batch, self.noise_width), generator=generator, device=generator.device)

    def forward(self, obs, rnn_state, noise: Optional[torch.Tensor] = None):
        action_params, _, new_rnn = self.model(normalize_obs(self.cfg, self.obs_rms, obs), rnn_state)
        # action_mask rides in the raw obs dict, as in the sampler's policy step
        dist = get_action_distribution(self.action_space, action_params, obs.get("action_mask"))
        actions = argmax_actions(dist) if self.deterministic else dist.sample(uniform=noise)
        return actions.to(self.action_dtype), new_rnn


def build_inference_fn(cfg, env_info, model, train_state, deterministic: bool = True) -> InferencePolicy:
    """The exported policy of `train_state` (whose module `model` is)."""
    return InferencePolicy(cfg, env_info, model, train_state.obs_rms, deterministic).eval()


def example_inputs(cfg, env_info, policy: InferencePolicy, batch_size: int, device) -> tuple:
    """Inputs of the exported program's shapes: float32 observations, the zero rnn state and,
    for a sampling policy, the noise."""
    obs = {k: torch.zeros((batch_size,) + tuple(s.shape), device=device) for k, s in obs_space_as_dict(env_info.obs_space).items()}
    args = (obs, initial_actor_critic_state(cfg, batch_size, device))
    if not policy.deterministic:
        args += (torch.full((batch_size, policy.noise_width), 0.5, device=device),)
    return args


def load_policy(cfg, register_fn=None):
    """The merged config, env info and train state of a run's checkpoint (`--policy_index`),
    on the device of `--device`; `register_fn` registers a host env in the probe process.
    Raises FileNotFoundError when there is no checkpoint."""
    cfg = load_from_checkpoint(cfg)
    device = resolve_device(cfg)
    env_info = obtain_env_info(cfg, register_fn=register_fn)
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space).to(device)
    train_state = init_train_state(cfg, env_info, model, device)
    if load_checkpoint(cfg, cfg.policy_index, train_state) is None:
        raise FileNotFoundError(f"no checkpoint to export in {experiment_dir(cfg, mkdir=False)}")
    return cfg, env_info, train_state


def export_model(cfg, batch_size: int = 1, output_path: Optional[str] = None, register_fn=None) -> str:
    """Write the policy of the run's checkpoint as a `torch.export` program; returns its path."""
    cfg, env_info, ts = load_policy(cfg, register_fn)
    device = next(ts.model.parameters()).device
    policy = build_inference_fn(cfg, env_info, ts.model, ts, deterministic=cfg.eval_deterministic)
    with torch.no_grad():
        program = torch.export.export(policy, example_inputs(cfg, env_info, policy, batch_size, device))
    output_path = output_path or join(experiment_dir(cfg), f"policy_p{cfg.policy_index}.pt2")
    torch.export.save(program, output_path)
    log.info("Exported policy (torch.export, batch %d, %s) to %s", batch_size, device, output_path)
    return output_path


def load_exported_model(path: str) -> nn.Module:
    """A module (obs, rnn_state[, noise]) -> (actions, new_rnn_state), on the device it was
    exported on."""
    return torch.export.load(path).module()


def main() -> int:
    """Export a trained policy:
    python -m sample_factory_tpu_torch.export_model --env=... --experiment=... [--export_batch_size=N]
    [--export_output=path] [--eval_deterministic=True] [--device=cpu]"""
    import argparse

    from sample_factory_tpu_torch.enjoy import register_env_by_name
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--export_batch_size", type=int, default=1)
    extra.add_argument("--export_output", type=str, default=None)
    known, rest = extra.parse_known_args()
    cfg = parse_custom_args(rest, evaluation=True)
    register_fn = register_env_by_name(cfg.env)
    print(export_model(cfg, known.export_batch_size, known.export_output, register_fn=register_fn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
