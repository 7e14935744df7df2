"""The plain reference of the benchmark's training cells: the actor-critic's forward and the PPO learner in plain
PyTorch, float32 with TF32 off, written from the configuration file alone. It imports nothing of the measured package
or of JAX. A precision other than "float32" (TF32 on, or float8 operands in every product) makes it the control that
the comparison has to fail.

The learner (`learner.py`) is the same for every model. The model is a module of this directory that the
configuration names in its `model` block (`"reference": "<module>"`, `model.py` where it names none), found by that
name (`of`), with these functions of the model block `model` and a dict of leaves `p`:

- `make_leaves(model, seed, device)`: the weights from the seed, on the device, named as the program's parameters;
- `state_width(model)`: the recurrent state's width, 0 where there is no core;
- `policy_step(p, model, obs, state, prec)`: one rollout step over [N] envs -> (action parameters, values, new state);
- `forward_seq(p, model, obs, state0, resets, prec)`: BPTT over segments, obs [S, R, ...] a key -> (action parameters
  [S*R, P], values [S*R]);
- `log_prob(model, params, actions)`, `entropy(model, params)`, `kl(model, new, old)`: the action distribution's;
- `forward_flops_per_sample(model)`: 2 x the multiply-adds of one forward of one sample (`flops.py`);
- `rnn_sites(config)`: its recurrent sequences as (per, kind, T, B, H, dtype), `per` "minibatch" (a forward and a
  backward in each minibatch of each epoch) or "rollout_step" (a forward in each step of the rollout)
  (`roofline.learner_rnn_bound_ms`).

`obs` is a dict of the configuration's observation keys (`observations`): a float key in the precision's dtype,
statically preprocessed and normalized as the flags say, an int32 key as recorded (token ids, whole). `prec` is a
`model.Precision`, the one class through which every module computes its products, so that a control reaches every
model unchanged.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
STORES = ("uint8", "int32", "float32")


def of(model: Dict):
    """The reference module that a model block names, `reference/<module>.py`: of this directory, or of the one that
    a run of another copy of the benchmark searches (`searched`)."""
    return importlib.import_module(f"{__name__}.{model.get('reference', 'model')}")


@contextlib.contextmanager
def searched(root):
    """For the block, `<root>/port_bench/reference/` searched after this directory for the modules that configurations
    name (a run of a copy of the benchmark at `root`), and the modules found there forgotten after it."""
    extra = (Path(root) / "port_bench" / "reference").resolve()
    if extra == HERE:
        yield
        return
    __path__.append(str(extra))
    importlib.invalidate_caches()
    try:
        yield
    finally:
        __path__.remove(str(extra))
        for name, module in list(sys.modules.items()):
            if name.startswith(f"{__name__}.") and Path(getattr(module, "__file__", None) or "/").parent == extra:
                del sys.modules[name]
                globals().pop(name.rsplit(".", 1)[1], None)


def observations(config: Dict) -> Dict[str, Dict]:
    """The configuration's observation keys, each {"shape": (...), "store": "uint8" | "int32" | "float32"}: its
    `observations` where it declares them, else the one key `model.obs_key` with the encoder's input shape and
    `obs_store`."""
    if "observations" in config:
        out = {k: {"shape": tuple(v["shape"]), "store": v["store"]} for k, v in config["observations"].items()}
    else:
        enc = config["model"]["encoder"]
        shape = (enc["obs_dim"],) if enc["type"] == "mlp" else tuple(enc["obs_hwc"])
        out = {config["model"]["obs_key"]: {"shape": shape, "store": config["obs_store"]}}
    for key, spec in out.items():
        if spec["store"] not in STORES:
            raise ValueError(f"observation {key!r}: store {spec['store']!r} is none of {STORES}")
    return out
