"""A stand-in for the `vizdoom` package, for machines without it: neither the CPU test machine
nor the card's machine has vizdoom (or the scenario .wad files). The Doom envs of the JAX package
and of the port are held against each other over it, value for value.

What it provides is what `examples/vizdoom/doom/doom_env.py` and `multiplayer.py` call:
`DoomGame`, `Mode`, `ScreenResolution`, `GameState` and `scenarios_path` (the minimal scenario
`.cfg` files beside this module: their `available_buttons` and `available_game_variables` are what
the envs read). The game is seeded and deterministic: frames are an episode's seeded noise image
shifted by the tic, game variables follow seeded walks by kind (counters, health and death,
ammo, weapons), the reward is the cfg's living reward plus frags plus a term in the flat action,
and an episode lasts a seeded number of tics or the episode timeout. DEATHCOUNT, HITCOUNT and
DAMAGECOUNT survive `new_episode()`, as in the engine. A networked game (`-host N`, `-join
host:port` in the game args) takes its seed from the port and the player's name, so that every
player of a match agrees whatever seed each env drew; `addbot` commands add players to the host's
count. Put this directory's parent on `sys.path` (and `PYTHONPATH` for spawned workers) so that
`import vizdoom` finds it.
"""

import os
import re

import numpy as np

scenarios_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios")

TICRATE = 35
_RESOLUTIONS = (
    (160, 120), (200, 125), (200, 150), (256, 144), (256, 160), (256, 192), (320, 180), (320, 200), (320, 240),
    (320, 256), (400, 225), (400, 250), (400, 300), (512, 288), (512, 320), (512, 384), (640, 360), (640, 400),
    (640, 480), (800, 450), (800, 500), (800, 600), (1024, 576), (1024, 640), (1024, 768), (1280, 720), (1280, 800),
    (1280, 960), (1280, 1024), (1400, 787), (1400, 875), (1400, 1050), (1600, 900), (1600, 1000), (1600, 1200),
    (1920, 1080),
)
ScreenResolution = type("ScreenResolution", (), {f"RES_{w}X{h}": (w, h) for w, h in _RESOLUTIONS})


class Mode:
    PLAYER, SPECTATOR, ASYNC_PLAYER, ASYNC_SPECTATOR = range(4)


class GameState:
    def __init__(self, number, screen_buffer, game_variables):
        self.number = number
        self.screen_buffer = screen_buffer
        self.game_variables = game_variables


STICKY = ("DEATHCOUNT", "HITCOUNT", "DAMAGECOUNT")


def _kind(name):
    if name in ("HEALTH", "DEAD", "ARMOR", "SELECTED_WEAPON", "ATTACK_READY", "PLAYER_NUMBER", "PLAYER_COUNT", "DAMAGECOUNT"):
        return name
    if name == "SELECTED_WEAPON_AMMO" or re.fullmatch(r"AMMO\d", name):
        return "AMMO"
    if re.fullmatch(r"WEAPON\d", name):
        return "WEAPON"
    if name.endswith("COUNT") or re.fullmatch(r"USER\d+", name):
        return "COUNTER"
    return "WALK"


class DoomGame:
    def __init__(self):
        self.buttons, self.variables = [], []
        self.living_reward = 0.0
        self.episode_timeout = 0
        self.resolution = ScreenResolution.RES_320X240
        self.seed = 0
        self.mode = Mode.PLAYER
        self.window_visible = False
        self.game_args = []
        self.commands = []
        self.bots = 0
        self.initialized = False
        self._finished = True
        self._action = None
        self._last_reward = 0.0
        self._values = None

    # -- configuration
    def load_config(self, path):
        with open(path) as f:
            text = f.read()

        def block(key):
            m = re.search(key + r"\s*=\s*\{([^}]*)\}", text)
            return m.group(1).split() if m else []

        def number(key, default):
            m = re.search(r"^\s*" + key + r"\s*=\s*(-?[\d.]+)", text, re.MULTILINE)
            return float(m.group(1)) if m else default

        self.buttons, self.variables = block("available_buttons"), block("available_game_variables")
        self.living_reward = number("living_reward", 0.0)
        self.episode_timeout = int(number("episode_timeout", 0))
        return True

    def set_screen_resolution(self, resolution):
        self.resolution = resolution

    def set_seed(self, seed):
        self.seed = int(seed)

    def set_window_visible(self, visible):
        self.window_visible = visible

    def set_mode(self, mode):
        self.mode = mode

    def add_game_args(self, args):
        self.game_args.append(args)

    def set_episode_timeout(self, tics):
        self.episode_timeout = int(tics)

    def get_ticrate(self):
        return TICRATE

    def send_game_command(self, command):
        self.commands.append(command)
        if command == "removebots":
            self.bots = 0
        elif command == "addbot":
            self.bots += 1

    # -- the match
    def _network(self):
        args = " ".join(self.game_args)
        host = re.search(r"-host (\d+)", args)
        port = re.search(r"-port (\d+)", args) or re.search(r"-join [\d.]+:(\d+)", args)
        name = re.search(r"\+name AI(\d+)", args)
        player = int(name.group(1)) if name else 0
        return (int(host.group(1)) if host else None), (int(port.group(1)) if port else None), player

    def _players(self):
        hosts, port, player = self._network()
        if hosts is not None:
            return hosts + self.bots
        return 2 if port is not None else 1 + self.bots  # a joining player counts the host and itself

    def init(self):
        _, port, player = self._network()
        seed = [port, player] if port is not None else [self.seed]
        self._rng = np.random.default_rng(seed)
        self._values = {}
        self.initialized = True
        self._start_episode()

    def new_episode(self, recording_path=""):
        self._start_episode()

    def _start_episode(self):
        rng = self._rng
        sticky = {k: self._values.get(k, 0.0) for k in STICKY}
        w, h = self.resolution
        self._frame = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
        self._tic, self._state_number = 0, 0
        self._length = int(rng.integers(60, 400))
        if self.episode_timeout > 0:
            self._length = min(self._length, self.episode_timeout)
        _, _, player = self._network()
        start = {"HEALTH": 100.0, "ARMOR": 0.0, "DEAD": 0.0, "SELECTED_WEAPON": 2.0, "ATTACK_READY": 1.0, "AMMO": 50.0,
                 "PLAYER_NUMBER": float(player), "PLAYER_COUNT": float(self._players())}
        self._values = {v: start.get(v, start.get(_kind(v), 0.0)) for v in self.variables}
        for k in STICKY:
            if k in self._values:
                self._values[k] = sticky[k]
        self._dead_for = 0
        self._finished = False

    def _advance_tic(self):
        rng, values = self._rng, self._values
        u = rng.random(len(self.variables) + 2)
        reward = self.living_reward
        for i, name in enumerate(self.variables):
            kind, v = _kind(name), values[name]
            if kind == "COUNTER" and u[i] < 0.03:
                values[name] = v + 1.0
                if name == "FRAGCOUNT":
                    reward += 1.0
            elif kind == "DAMAGECOUNT" and u[i] < 0.05:
                values[name] = v + float(int(u[i] * 600) + 5)
            elif kind == "HEALTH" and self._dead_for == 0:
                v = v - 7.0 if u[i] < 0.2 else (v + 15.0 if u[i] > 0.97 else v)
                values[name] = float(min(max(v, 0.0), 100.0))
            elif kind == "ARMOR" and u[i] < 0.01:
                values[name] = min(v + 25.0, 200.0)
            elif kind == "AMMO":
                values[name] = v - 1.0 if (u[i] < 0.1 and v > 0) else (v + 20.0 if u[i] > 0.99 else v)
            elif kind == "WEAPON" and u[i] < 0.005:
                values[name] = 1.0 - v
            elif kind == "SELECTED_WEAPON" and u[i] < 0.01:
                values[name] = float(1 + int(u[i] * 700))
            elif kind == "ATTACK_READY":
                values[name] = float(u[i] < 0.8)
            elif kind == "WALK":
                values[name] = v + (u[i] - 0.5)
        if values.get("HEALTH", 1.0) <= 0.0 and self._dead_for == 0:
            self._dead_for = 10
            if "DEATHCOUNT" in values:
                values["DEATHCOUNT"] += 1.0
        if self._dead_for > 0:
            self._dead_for -= 1
            if self._dead_for == 0 and "HEALTH" in values:
                values["HEALTH"] = 100.0
        if "DEAD" in values:
            values["DEAD"] = float(self._dead_for > 0)
        if "PLAYER_COUNT" in values:
            values["PLAYER_COUNT"] = float(self._players())  # bots join after init
        if self._action is not None:
            reward += 0.01 * sum((k + 1) * float(a) for k, a in enumerate(self._action))
        self._tic += 1
        if self._tic >= self._length:
            self._finished = True
        return reward

    def set_action(self, action):
        action = list(action)
        if len(action) != len(self.buttons):
            raise ValueError(f"{len(action)} action values for {len(self.buttons)} buttons {self.buttons}")
        self._action = action

    def advance_action(self, tics=1, update_state=True):
        self._last_reward = 0.0
        for _ in range(tics):
            if self._finished:
                break
            self._last_reward += self._advance_tic()
        if update_state:
            self._state_number += 1

    def make_action(self, action, tics=1):
        self.set_action(action)
        self.advance_action(tics)
        return self._last_reward

    def get_last_reward(self):
        return self._last_reward

    def is_episode_finished(self):
        return self._finished

    def get_state(self):
        if self._finished:
            return None
        screen = self._frame + np.uint8(self._tic % 256)
        variables = np.array([self._values[v] for v in self.variables], dtype=np.float64)
        return GameState(self._state_number, screen, variables)

    def replay_episode(self, path):
        self._start_episode()

    def close(self):
        self.initialized = False
