"""A stand-in for hydra's compose API (`initialize`, `compose`), enough for IsaacGymEnvs' configs.

- `initialize(config_path=..., job_name=...)` sets the one global configuration directory
  (`core.global_hydra.GlobalHydra`), relative to the calling module's file, as hydra does; a second
  `initialize` while one is active raises hydra's ValueError. Used as a context manager it clears
  the state on exit; `GlobalHydra.instance().clear()` does so by hand.
- `compose(config_name, overrides)` reads `<dir>/<config_name>.yaml` and the group files it names.
  The files are JSON (a subset of YAML, so no YAML parser is needed). Overrides: `group=option`
  picks a group file (`task=Ant` reads `task/Ant.yaml`), `group/sub=option` merges
  `group/sub/option.yaml` into `group[sub]`, and `key=value` sets a top-level key. IsaacGymEnvs'
  `${resolve_default:4096,${...num_envs}}` is modelled by writing a non-empty top-level
  `num_envs` into `task.env.numEnvs`. A string `${oc.env:NAME,default}` is OmegaConf's
  environment resolver.
- The result is a dict with attribute access.
"""

import inspect
import json
import os
import re

from hydra.core.global_hydra import GlobalHydra

_ENV = re.compile(r"\$\{oc\.env:([^,}]+),([^}]*)\}")


class _Config(dict):
    __getattr__ = dict.__getitem__


class initialize:
    def __init__(self, config_path=None, job_name=None, caller_stack_depth=1, version_base=None):
        if GlobalHydra.instance().is_initialized():
            raise ValueError("GlobalHydra is already initialized, call GlobalHydra.instance().clear() if you want to re-initialize")
        caller = inspect.stack()[caller_stack_depth].filename
        self.job_name = job_name
        GlobalHydra.instance().config_dir = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(caller)), config_path))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        GlobalHydra.instance().clear()


def _read(path):
    with open(path) as f:
        return json.load(f)


def _resolve(node):
    if isinstance(node, dict):
        return _Config({k: _resolve(v) for k, v in node.items()})
    if isinstance(node, str):
        m = _ENV.fullmatch(node)
        if m:
            return os.environ.get(m.group(1), m.group(2))
    return node


def compose(config_name=None, overrides=()):
    root = GlobalHydra.instance().config_dir
    if root is None:
        raise ValueError("GlobalHydra is not initialized, use @hydra.main() or call one of the hydra initialization methods first")
    cfg = _read(os.path.join(root, f"{config_name}.yaml"))
    groups = {}
    for entry in cfg.pop("defaults", []):
        groups.update(entry)
    sub_overrides = []
    for item in overrides:
        key, value = item.split("=", 1)
        if "/" in key:
            sub_overrides.append((key, value))
        elif key in groups:
            groups[key] = value
        else:
            cfg[key] = value
    for group, option in groups.items():
        cfg[group] = _read(os.path.join(root, group, f"{option}.yaml"))
    for key, option in sub_overrides:
        group, sub = key.split("/", 1)
        cfg[group].setdefault(sub, {}).update(_read(os.path.join(root, group, sub, f"{option}.yaml")))
    if cfg.get("num_envs") not in (None, ""):
        cfg["task"]["env"]["numEnvs"] = int(cfg["num_envs"])
    return _resolve(cfg)
