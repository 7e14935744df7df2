"""The port's copy of the config surface against the JAX package's: the same flags and
defaults (but --device), the same cross-field checks, the same resume-merge."""

import json

import pytest
import torch

from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.cfg.arguments import verify_cfg as jax_verify_cfg
from sample_factory_tpu_torch.cfg.arguments import default_cfg, load_from_checkpoint, verify_cfg
from sample_factory_tpu_torch.utils.attr_dict import AttrDict
from sample_factory_tpu_torch.utils.utils import cfg_file, resolve_device

torch.set_num_threads(1)

ARGV = ["--seed=1", "--rollout=16"]


def test_same_flags_and_defaults_except_device():
    jcfg, tcfg = jax_default_cfg(env="e", argv=ARGV), default_cfg(env="e", argv=ARGV)
    assert set(jcfg) == set(tcfg)
    differ = {k for k in jcfg if jcfg[k] != tcfg[k]}
    assert differ == {"device"}
    assert (jcfg.device, tcfg.device) == ("tpu", "gpu")


@pytest.mark.parametrize(
    "argv",
    [
        ["--async_rl=False", "--num_envs=3", "--batch_size=64"],  # sync divisibility
        ["--with_vtrace=True", "--recurrence=8"],  # vtrace needs recurrence == rollout
        ["--batch_size=100", "--recurrence=16"],  # batch not a multiple of recurrence
        ["--rollout=16", "--recurrence=5"],  # rollout not a multiple of recurrence
        ["--num_epochs=0"],
    ],
)
def test_verify_cfg_refuses_what_jax_refuses(argv):
    argv = ARGV + argv
    with pytest.raises(ValueError):
        jax_verify_cfg(jax_default_cfg(env="e", argv=argv))
    with pytest.raises(ValueError):
        verify_cfg(default_cfg(env="e", argv=argv))


def test_resume_merge_keeps_saved_values_and_cli_flags(tmp_path):
    saved = default_cfg(env="e", argv=[f"--train_dir={tmp_path}", "--experiment=x", "--rnn_size=64", "--gamma=0.9"])
    with open(cfg_file(saved), "w") as f:
        json.dump(dict(saved), f)
    cli = default_cfg(env="e", argv=[f"--train_dir={tmp_path}", "--experiment=x", "--gamma=0.95"])
    merged = load_from_checkpoint(cli)
    assert merged.rnn_size == 64 and merged.gamma == 0.95


def test_resolve_device():
    assert resolve_device(AttrDict(device="cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="tpu"):
        resolve_device(AttrDict(device="tpu"))  # e.g. merged from a JAX-side config.json
    if torch.cuda.is_available():
        assert resolve_device(AttrDict(device="gpu")).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device=cpu"):
            resolve_device(AttrDict(device="gpu"))
