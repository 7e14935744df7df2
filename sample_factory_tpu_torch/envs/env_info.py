"""EnvInfo: static metadata extracted from one probe env instance
(counterpart of `sample_factory_tpu/envs/env_info.py`; reference
`sample_factory/algo/utils/env_info.py:22-134`).

On-device envs are stateless containers and are probed inline. A host env is
probed in a spawned throwaway process (reference
`obtain_env_info_in_a_separate_process`), so that engine, GL or env-library
initialisation cannot pollute the trainer process; the child imports no torch
and creates no CUDA context. In `--serial_mode` the probe runs inline. With
`--use_env_info_cache` the result is pickled per env name and config
fingerprint under `<train_dir>/.env_info_cache/` (the JAX package writes it
under the home directory; the port writes nothing outside its train_dir).
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
import pickle
from dataclasses import dataclass
from typing import Any, Dict, Optional

from sample_factory_tpu_torch.envs.env_utils import create_env, is_device_env
from sample_factory_tpu_torch.envs.spaces import from_gym_space, obs_space_as_dict
from sample_factory_tpu_torch.utils.utils import log

ENV_INFO_PROTOCOL_VERSION = 1
PROBE_TIMEOUT_S = 180.0


@dataclass
class EnvInfo:
    obs_space: Any
    action_space: Any
    num_agents: int
    is_device_env: bool
    frameskip: int = 1
    reward_shaping_scheme: Optional[Dict[str, float]] = None
    env_info_protocol_version: int = ENV_INFO_PROTOCOL_VERSION


def extract_env_info(env, cfg) -> EnvInfo:
    if is_device_env(env):
        return EnvInfo(
            obs_space=obs_space_as_dict(env.obs_space),
            action_space=env.action_space,
            num_agents=env.num_agents,
            is_device_env=True,
            frameskip=getattr(env, "frameskip", 1) if cfg is None else cfg.env_frameskip,
            reward_shaping_scheme=dict(env.reward_shaping) if env.reward_shaping else None,
        )

    # host env: gymnasium spaces (or the port's own specs) become static specs here
    reward_shaping = None
    if hasattr(env, "get_default_reward_shaping"):
        try:
            reward_shaping = env.get_default_reward_shaping()
        except Exception:  # noqa: BLE001 - env may not implement the interface fully
            pass
    return EnvInfo(
        obs_space=obs_space_as_dict(from_gym_space(env.observation_space)),
        action_space=from_gym_space(env.action_space),
        num_agents=getattr(env, "num_agents", 1),
        is_device_env=False,
        frameskip=cfg.env_frameskip if cfg is not None else 1,
        reward_shaping_scheme=reward_shaping,
    )


def _probe_inline(cfg) -> EnvInfo:
    env = create_env(cfg.env, cfg=cfg, env_config=None)
    info = extract_env_info(env, cfg)
    if hasattr(env, "close"):
        try:
            env.close()
        except Exception:  # noqa: BLE001
            log.warning("Probe env close() failed")
    return info


def _probe_worker(cfg, register_payload, conn) -> None:
    """Probe-process body: create one env, extract its info, ship it back. Nothing here
    touches torch.cuda, so the child creates no CUDA context."""
    try:
        if register_payload is not None:
            kind, data = register_payload
            if kind == "call":
                pickle.loads(data)()
            else:  # ("register", pickled factory for cfg.env)
                from sample_factory_tpu_torch.envs.env_utils import register_env

                register_env(cfg.env, pickle.loads(data))
        conn.send(("ok", _probe_inline(cfg)))
    except Exception as e:  # noqa: BLE001
        import traceback

        conn.send(("error", f"{e}\n{traceback.format_exc()}"))
    finally:
        conn.close()


def _probe_in_process(cfg, register_fn=None) -> Optional[EnvInfo]:
    """Spawn a throwaway process for the probe. Returns None when the probe process fails
    for any reason (the caller then probes inline)."""
    try:
        if register_fn is not None:
            register_payload = ("call", pickle.dumps(register_fn))
        else:
            # propagate the factory registered in THIS process so that the child can create
            # the env (the registry is per-process state)
            from sample_factory_tpu_torch.algo.context import global_env_registry

            entry = global_env_registry().get(cfg.env)
            register_payload = ("register", pickle.dumps(entry.make_env_func)) if entry is not None else None
        pickle.dumps(cfg)
    except Exception:  # noqa: BLE001 - unpicklable cfg/factory: probe inline
        return None

    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    p = ctx.Process(target=_probe_worker, args=(cfg, register_payload, child), daemon=True)
    p.start()
    child.close()
    try:
        if not parent.poll(PROBE_TIMEOUT_S):
            log.warning("env info probe process timed out; probing inline")
            return None
        status, payload = parent.recv()
    except (EOFError, OSError):
        log.warning("env info probe process died; probing inline")
        return None
    finally:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
        parent.close()
    if status != "ok":
        log.warning("env info probe process failed (%s); probing inline", str(payload).splitlines()[0])
        return None
    return payload


def _cache_path(cfg) -> str:
    # EnvInfo depends on env-shaping cfg fields; key the cache by their fingerprint so that a
    # different cfg never reuses stale shapes (reference check_env_info, env_info.py:74-92)
    fp_fields = ("env_frameskip", "env_framestack", "pixel_format", "env_gpu_observations", "num_policies")
    fingerprint = "|".join(f"{k}={cfg.get(k)}" for k in fp_fields)
    digest = hashlib.sha1(fingerprint.encode()).hexdigest()[:12]
    cache_dir = os.path.join(cfg.train_dir, ".env_info_cache")
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"{cfg.env}_{digest}.pkl")


def _registered_env_is_on_device(cfg) -> bool:
    """Whether cfg.env's factory is one of the port's built-in on-device envs, told from
    where the factory lives, without building an env. They are stateless containers with
    nothing to pollute the trainer, and probing them in a child would load torch there."""
    from sample_factory_tpu_torch.algo.context import global_env_registry

    entry = global_env_registry().get(cfg.env)
    module = getattr(getattr(entry, "make_env_func", None), "__module__", "") or ""
    return module.startswith("sample_factory_tpu_torch.envs.builtin")


def obtain_env_info(cfg, register_fn=None) -> EnvInfo:
    """Build one probe env, extract the info, close it. `register_fn` registers the env
    inside the probe process, as it does inside the host-env workers."""
    cache_path = None
    if cfg is not None and getattr(cfg, "use_env_info_cache", False):
        cache_path = _cache_path(cfg)
        if os.path.isfile(cache_path):
            try:
                with open(cache_path, "rb") as f:
                    info = pickle.load(f)
                if getattr(info, "env_info_protocol_version", 0) == ENV_INFO_PROTOCOL_VERSION:
                    log.debug("Loaded cached env info for %s", cfg.env)
                    return info
            except Exception:  # noqa: BLE001 - stale cache
                pass

    info = None
    if not getattr(cfg, "serial_mode", False) and not _registered_env_is_on_device(cfg):
        info = _probe_in_process(cfg, register_fn)
    if info is None:
        info = _probe_inline(cfg)

    if cache_path is not None:
        try:
            with open(cache_path, "wb") as f:
                pickle.dump(info, f)
        except Exception:  # noqa: BLE001
            pass
    return info
