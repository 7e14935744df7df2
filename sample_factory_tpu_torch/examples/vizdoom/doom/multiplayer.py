"""Multiplayer ViZDoom: networked matches as one multi-agent host env.

Copy of `sf_examples_tpu/vizdoom/doom/multiplayer.py` (reference `sf_examples/vizdoom/doom/multiplayer/`):
player 0 hosts a deathmatch game over UDP (forced respawn, no autoaim, spawn
protection...), players 1..N-1 join it, classic engine bots can be added, and
the whole match is exposed to the framework as ONE multi-agent env following
the host-pipeline convention (`num_agents`, `is_multiagent`,
``step(list) -> lists``, same as the PettingZoo adapter).

Design difference: the reference runs each player env on its own
process/thread pair coordinated by task queues (doom_multiagent_wrapper.py);
here each player env lives on a dedicated thread driven by per-tick
command/result queues — simpler, and sufficient because the engine's
make_action/advance_action release the GIL while the game advances. In
multi-agent mode frameskip is emulated tick-by-tick (``advance_action(1,
update_state=last_tick)``) because networked games must advance in lockstep
(reference doom_multiagent.py:200-231).

Unlike the JAX class, the last tic of each step goes through the player's wrapper stack
(`step`), and only the tics before it reach the base env directly: gymnasium's wrappers do
not forward `step_tick`, so the JAX class's `step` raises AttributeError on its first call,
and under a gym that forwarded it the outputs would have skipped the wrappers (measurements,
resize, reward shaping).
"""

from __future__ import annotations

import socket
import threading
from queue import Queue
from typing import Callable, List, Optional

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None

from sample_factory_tpu_torch.envs.env_utils import RewardShapingInterface
from sample_factory_tpu_torch.utils.utils import log
from sample_factory_tpu_torch.examples.vizdoom.doom.action_space import flatten_doom_action
from sample_factory_tpu_torch.examples.vizdoom.doom.doom_env import VizdoomEnv, _InitLock

DEFAULT_UDP_PORT = 40300
CONNECT_TIMEOUT_S = 4


def is_udp_port_available(port: int) -> bool:
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False


def find_available_udp_port(start_port: int = DEFAULT_UDP_PORT, increment: int = 1000) -> int:
    port = start_port
    while port < 65535 and not is_udp_port_available(port):
        port += increment
    return port


def udp_port_for_env(env_config) -> int:
    """Deterministic per-env-instance port so vectorized matches don't collide."""
    if env_config is None:
        return find_available_udp_port()
    offset = int(env_config.get("worker_index", 0)) * 100 + int(env_config.get("vector_index", 0))
    return find_available_udp_port(DEFAULT_UDP_PORT + offset, increment=1000)


class VizdoomEnvMultiplayer(VizdoomEnv):
    """One player's view of a networked match (reference doom_multiagent.py)."""

    def __init__(
        self,
        action_space,
        config_file: str,
        player_id: int,
        num_agents: int,
        max_num_players: int,
        num_bots: int,
        skip_frames: int,
        respawn_delay: int = 0,
        timelimit: float = 0.0,
        port: Optional[int] = None,
        record_to: Optional[str] = None,
        render_mode: Optional[str] = None,
    ):
        super().__init__(
            action_space, config_file, skip_frames=skip_frames, record_to=record_to, render_mode=render_mode
        )
        self.player_id = player_id
        self.num_agents = num_agents
        self.max_num_players = max_num_players
        self.num_bots = num_bots
        self.respawn_delay = respawn_delay
        self.timelimit = timelimit
        self.port = port if port is not None else DEFAULT_UDP_PORT
        self.is_multiplayer = True
        self.update_state = True

    def _is_host(self) -> bool:
        return self.player_id == 0

    def initialize(self):
        self.game = self._create_game()
        if self._is_host():
            if not is_udp_port_available(self.port):
                raise RuntimeError(f"UDP port {self.port} unavailable for Doom host")
            host_args = [
                f"-host {self.max_num_players}",
                f"-port {self.port}",
                "-deathmatch",
                f"+timelimit {self.timelimit}",
                "+sv_forcerespawn 1",
                "+sv_noautoaim 1",
                "+sv_respawnprotect 1",
                "+sv_spawnfarthest 1",
                "+sv_nocrouch 1",
                "+sv_nojump 1",
                "+sv_nofreelook 1",
                "+sv_noexit 1",
                f"+viz_respawn_delay {self.respawn_delay}",
                f"+viz_connect_timeout {CONNECT_TIMEOUT_S}",
            ]
            self.game.add_game_args(" ".join(host_args))
            self.game.add_game_args(f"+name AI{self.player_id}_host +colorset 0")
        else:
            self.game.add_game_args(
                f"-join 127.0.0.1:{self.port} +viz_connect_timeout {CONNECT_TIMEOUT_S}"
            )
            self.game.add_game_args(f"+name AI{self.player_id} +colorset 0")

        self.game.set_episode_timeout(int(self.timelimit * 60 * self.game.get_ticrate()))
        # no init lock: all players of one match must init together to connect;
        # cross-match throttling happens in MultiAgentDoomEnv
        self.game.init()
        self.initialized = True

    def reset(self, **kwargs):
        obs, info = super().reset(**kwargs)
        if self._is_host() and self.num_bots > 0:
            self.game.send_game_command("removebots")
            for _ in range(self.num_bots):
                self.game.send_game_command("addbot")
        self.update_state = True
        return obs, info

    def step_tick(self, actions, update_state: bool):
        """Advance exactly one engine tic; only produce outputs when
        update_state is set (the last tic of an emulated frameskip)."""
        self._ensure_initialized()
        self.game.set_action(flatten_doom_action(self.action_space, actions))
        self.game.advance_action(1, update_state)
        if not update_state:
            return None, None, None, None, None

        state = self.game.get_state()
        reward = self.game.get_last_reward()
        done = self.game.is_episode_finished()
        info = {"num_frames": self.skip_frames}
        if not done:
            obs = self._screen(state)
            info.update(self.get_info(self._variables(state)))
            self._prev_info = dict(info)
        else:
            obs = self._black_screen()
            if self._prev_info:
                info.update(self._prev_info)
        self._fix_sticky_variables(info)
        return obs, reward, done, False, info

    def step(self, actions):
        if self.num_agents == 1:
            # single agent + bots: the engine handles frameskip natively
            return super().step(actions)
        out = None
        for tic in range(self.skip_frames):
            out = self.step_tick(actions, update_state=(tic == self.skip_frames - 1))
        return out


class _PlayerThread(threading.Thread):
    """Owns one player's env; executes (method, args) commands in order."""

    def __init__(self, player_id: int, make_env_func: Callable):
        super().__init__(daemon=True, name=f"doom_player_{player_id}")
        self.player_id = player_id
        self.make_env_func = make_env_func
        self.commands: Queue = Queue()
        self.results: Queue = Queue()
        self.env = None
        self.start()

    def run(self):
        while True:
            method, args = self.commands.get()
            try:
                if method == "init":
                    self.env = self.make_env_func(self.player_id)
                    self.env.unwrapped._ensure_initialized()
                    self.results.put(("ok", None))
                elif method == "step_tick":  # a tic before the last: the base env, no outputs
                    self.results.put(("ok", self.env.unwrapped.step_tick(*args)))
                elif method == "close":
                    if self.env is not None:
                        self.env.close()
                    self.results.put(("ok", None))
                    return
                else:
                    self.results.put(("ok", getattr(self.env, method)(*args)))
            except Exception as exc:  # surface errors on the caller side
                log.exception("Doom player %d failed in %s", self.player_id, method)
                self.results.put(("error", exc))

    def call(self, method, *args):
        self.commands.put((method, args))

    def result(self, timeout: float = 120.0):
        status, value = self.results.get(timeout=timeout)
        if status == "error":
            raise value
        return value


class MultiAgentDoomEnv(RewardShapingInterface):
    """N networked player envs presented as one multi-agent host env
    (reference doom_multiagent_wrapper.py:177-383)."""

    def __init__(self, num_agents: int, make_env_func: Callable, env_config=None, skip_frames: int = 4):
        self.num_agents = num_agents
        self.is_multiagent = True
        self.skip_frames = skip_frames

        with _InitLock():  # throttle: one match boots its N engines at a time
            self._players = [_PlayerThread(i, make_env_func) for i in range(num_agents)]
            for p in self._players:
                p.call("init")
            for p in self._players:
                p.result()

        probe = self._players[0]
        probe.call("__getattribute__", "observation_space")
        self.observation_space = probe.result()
        probe.call("__getattribute__", "action_space")
        self.action_space = probe.result()

    def _broadcast(self, method, args_per_player):
        for p, args in zip(self._players, args_per_player):
            p.call(method, *args)
        return [p.result() for p in self._players]

    def reset(self, seed=None, **kwargs):
        results = self._broadcast("reset", [() for _ in self._players])
        obs = [r[0] for r in results]
        infos = [r[1] for r in results]
        return obs, infos

    def step(self, actions: List):
        # lockstep: every player advances one tic at a time so the networked
        # game stays synchronized; outputs only materialize on the last tic, which
        # runs through each player's wrapper stack (its base env steps one tic)
        for _ in range(self.skip_frames - 1):
            self._broadcast("step_tick", [(a, False) for a in actions])
        results = self._broadcast("step", [(a,) for a in actions])
        obs, rews, terms, truncs, infos = map(list, zip(*results))

        if all(terms):
            obs, _ = self.reset()
            for info in infos:
                info["episode_done"] = True
        return obs, rews, terms, truncs, infos

    # -- PBT reward shaping fans out to every player's wrapper stack
    def get_default_reward_shaping(self):
        self._players[0].call("__getattribute__", "unwrapped")
        base = self._players[0].result()
        iface = getattr(base, "reward_shaping_interface", None)
        return iface.get_default_reward_shaping() if iface else None

    def set_reward_shaping(self, reward_shaping: dict, agent_idx) -> None:
        indices = range(self.num_agents) if agent_idx is None else [agent_idx]
        for i in indices:
            self._players[i].call("__getattribute__", "unwrapped")
            base = self._players[i].result()
            iface = getattr(base, "reward_shaping_interface", None)
            if iface is not None:
                iface.set_reward_shaping(reward_shaping, i)

    def render(self):
        self._players[0].call("render")
        return self._players[0].result()

    def close(self):
        for p in self._players:
            p.call("close")
        for p in self._players:
            try:
                p.result(timeout=30.0)
            except Exception:
                pass
