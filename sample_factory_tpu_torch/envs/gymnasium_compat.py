"""Legacy gym -> gymnasium API shims.

Copy of `sample_factory_tpu/envs/gymnasium_compat.py`; reference `sample_factory/algo/utils/gymnasium_utils.py:22-93`
(patch_non_gymnasium_env): user env factories may return envs written against
the old OpenAI `gym` API (reset() -> obs, step() -> (obs, r, done, info)).
These adapters detect the legacy surface and present the gymnasium 5-tuple /
(obs, info) contract to the rest of the framework. Unlike the reference we do
not depend on `shimmy` — the adapter is a small duck-typing wrapper, since all
the framework needs is the step/reset call convention, not full gym.Env
inheritance.
"""

from __future__ import annotations

import inspect
from typing import Any

from sample_factory_tpu_torch.utils.utils import log


class LegacyGymAdapter:
    """Presents the gymnasium API over a legacy-gym-style env.

    Handles, per call and dynamically (some envs mix conventions):
      - reset() returning obs only vs (obs, info); seed via env.seed() when the
        reset signature does not accept a `seed` kwarg
      - step() returning 4-tuple (obs, reward, done, info) vs the 5-tuple;
        done is split into terminated/truncated using the old
        `info["TimeLimit.truncated"]` convention (reference
        gymnasium_utils.py:60-80)
    """

    def __init__(self, env: Any):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.metadata = getattr(env, "metadata", {})
        self.render_mode = getattr(env, "render_mode", None)
        self._reset_accepts_seed = _accepts_kwarg(env.reset, "seed")

    def reset(self, *, seed=None, options=None):
        kwargs = {}
        if seed is not None:
            if self._reset_accepts_seed:
                kwargs["seed"] = seed
            elif hasattr(self.env, "seed"):
                try:
                    self.env.seed(seed)
                except Exception:  # noqa: BLE001 - best-effort legacy seeding
                    pass
        if options is not None and _accepts_kwarg(self.env.reset, "options"):
            kwargs["options"] = options
        out = self.env.reset(**kwargs)
        if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
            return out
        return out, {}

    def step(self, action):
        out = self.env.step(action)
        if len(out) == 5:
            return out
        obs, reward, done, info = out
        truncated = bool(info.get("TimeLimit.truncated", False)) if isinstance(info, dict) else False
        terminated = bool(done) and not truncated
        return obs, reward, terminated, truncated, info

    def render(self, *args, **kwargs):
        return self.env.render(*args, **kwargs)

    def close(self):
        if hasattr(self.env, "close"):
            self.env.close()

    def __getattr__(self, name):
        return getattr(self.env, name)


def _accepts_kwarg(fn, name: str) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = sig.parameters
    if name in params:
        return True
    return any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())


def ensure_gymnasium_env(env: Any):
    """Wrap `env` in LegacyGymAdapter when it exposes the old gym API.

    Detection: a gymnasium.Env subclass whose reset accepts `seed` is passed
    through untouched; anything else (old `gym` package envs, plain duck-typed
    envs with 4-tuple step) gets the adapter.
    """
    if not hasattr(env, "step") or not hasattr(env, "reset"):
        return env  # DeviceEnv or exotic object; leave alone

    if getattr(env, "is_multiagent", False):
        # multi-agent host envs speak the per-agent-LIST contract (reference
        # non_batched_sampling.py): obs/rewards/terms/truncs/infos are lists,
        # infos is not a dict: the legacy-gym heuristics below would mangle
        # reset()'s (obs_list, infos_list) into ((obs, infos), {})
        return env

    # duck-typed env that already follows gymnasium conventions (reset(seed=...)
    # supported AND declared 5-tuple step): answered before gymnasium is
    # imported, so that the numpy envs run where it is not installed
    if _accepts_kwarg(env.reset, "seed") and getattr(env, "gymnasium_api", False):
        return env

    try:
        import gymnasium

        if isinstance(env, gymnasium.Env) or isinstance(env, gymnasium.Wrapper):
            return env
    except ImportError:  # pragma: no cover
        pass

    log.debug("Wrapping env %s with LegacyGymAdapter (old gym API detected)", type(env).__name__)
    return LegacyGymAdapter(env)
