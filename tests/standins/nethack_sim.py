"""A seeded numpy model of the NetHack engine, behind the two NetHack stand-ins: the engine
stand-in `nle/` (gymnasium envs under NLE's ids, for the CPU tests) and the env-level
`nethack_standin.py` (for the card's machine, which has no gymnasium).

It is not NetHack. It produces what the integration reads, with NLE's shapes and dtypes:
`tty_chars` [24, 80] uint8 (a message line, a 21-row map with the player `@`, a pet `d`, stairs
`>`, and two status lines with digits), `tty_colors` [24, 80] int8 in [0, 15], `tty_cursor` [2]
uint8, `message` [256] uint8, `blstats` [27] int64 (NLE's field order), `glyphs` [21, 79] int16 and
`internal` [9] int32 (index 4: on a staircase down, index 7: the eating counter). The cursor sits
on the player, on the message line after a prompt, or on a status line after `--More--`, so the
crop of a cursor at the edge is exercised. Each step moves the player by the action's direction,
advances the turn counter unless the action takes no time, and changes gold, score, hit points,
the level and the messages from the seeded generator; an episode ends when hit points reach 0.

The numbers of actions (121), glyph offsets and the layout are the stand-in's own.
"""

from __future__ import annotations

import numpy as np

ROWS, COLS = 24, 80
MAP_ROWS, MAP_COLS = 21, 79
NUM_ACTIONS = 121
NO_TIME_ACTIONS = range(100, NUM_ACTIONS)  # menus and look-arounds: the turn counter stays
GLYPH_PET_OFF, NUMMONS = 381, 381
GLYPH_CMAP_OFF = 2359
BL = dict(X=0, Y=1, STR25=2, STR125=3, DEX=4, CON=5, INT=6, WIS=7, CHA=8, SCORE=9, HP=10, HPMAX=11, DEPTH=12, GOLD=13, ENE=14,
          ENEMAX=15, AC=16, HD=17, XP=18, EXP=19, TIME=20, HUNGER=21, CAP=22, DNUM=23, DLEVEL=24, CONDITION=25, ALIGN=26)
MESSAGES = ("", "You see here a gold piece.", "The boulder fills a pit.", "You hear some noises.", "This food is delicious!",
            "The boulder falls into and plugs a hole in the floor!", "Really attack the dog? [yn] (n)")
DIRECTIONS = ((-1, 0), (0, 1), (1, 0), (0, -1), (-1, 1), (1, 1), (1, -1), (-1, -1))
GLYPH_INDEX, BLSTATS_INDEX, MESSAGE_INDEX, INTERNAL_INDEX, CHARS_INDEX, COLORS_INDEX, CURSOR_INDEX = range(7)


def glyph_is_pet(glyph):
    glyph = np.asarray(glyph)
    return (glyph >= GLYPH_PET_OFF) & (glyph < GLYPH_PET_OFF + NUMMONS)


class NetHackSim:
    """One game. `reset(rng)` starts it; `step(action)` returns True when the player died.
    `observation` is the tuple NLE keeps as `last_observation`, in the order of the *_INDEX fields."""

    def __init__(self):
        self.rng = np.random.default_rng(0)
        self.observation = None

    def reset(self, rng: np.random.Generator):
        self.rng = rng
        self.layout = np.where(rng.random((MAP_ROWS, MAP_COLS)) < 0.55, ord("."), ord(" ")).astype(np.uint8)
        self.layout[rng.integers(0, MAP_ROWS, 12), rng.integers(0, MAP_COLS, 12)] = ord("#")
        self.stairs = (int(rng.integers(1, MAP_ROWS - 1)), int(rng.integers(1, MAP_COLS - 1)))
        self.pos = [int(rng.integers(0, MAP_ROWS)), int(rng.integers(0, MAP_COLS))]
        self.explored = np.zeros((MAP_ROWS, MAP_COLS), bool)
        self.blstats = np.zeros(27, np.int64)
        b = self.blstats
        b[BL["STR25"]], b[BL["STR125"]], b[BL["DEX"]], b[BL["CON"]] = 16, 16, 14, 15
        b[BL["INT"]], b[BL["WIS"]], b[BL["CHA"]] = 9, 11, 8
        b[BL["HP"]] = b[BL["HPMAX"]] = int(rng.integers(12, 20))
        b[BL["ENE"]] = b[BL["ENEMAX"]] = 4
        b[BL["DEPTH"]] = b[BL["DLEVEL"]] = 1
        b[BL["AC"]], b[BL["XP"]], b[BL["TIME"]], b[BL["HUNGER"]], b[BL["ALIGN"]] = 6, 1, 1, 1, 0
        self.eaten = 0
        self.message = ""
        self.cursor_mode = 0  # 0: on the player, 1: after a prompt on the message line, 2: on a status line
        self._render()

    def step(self, action: int) -> bool:
        rng, b = self.rng, self.blstats
        action = int(action)
        if action not in NO_TIME_ACTIONS:
            dr, dc = DIRECTIONS[action % 8]
            self.pos = [int(np.clip(self.pos[0] + dr, 0, MAP_ROWS - 1)), int(np.clip(self.pos[1] + dc, 0, MAP_COLS - 1))]
            b[BL["TIME"]] += 1
        draw = rng.random(6)
        if draw[0] < 0.05:
            b[BL["GOLD"]] += int(rng.integers(1, 30))
        if draw[1] < 0.03:
            self.eaten += 1
        if draw[2] < 0.02:
            b[BL["DLEVEL"]] += 1
            b[BL["DEPTH"]] += 1
            b[BL["DNUM"]] = 4 if draw[3] < 0.5 else 0
        b[BL["HP"]] -= int(draw[4] < 0.08) * int(rng.integers(1, 4))
        b[BL["SCORE"]] += int(rng.integers(0, 3)) + 50 * int(draw[2] < 0.02)
        b[BL["EXP"]] += int(draw[5] < 0.1)
        self.message = MESSAGES[int(rng.integers(0, len(MESSAGES)))] if draw[5] < 0.3 else ""
        self.cursor_mode = int(rng.choice(3, p=(0.8, 0.12, 0.08)))
        self._render()
        return b[BL["HP"]] <= 0

    def _render(self):
        rng, b = self.rng, self.blstats
        r, c = self.pos
        b[BL["X"]], b[BL["Y"]] = c, r
        self.explored[max(0, r - 2):r + 3, max(0, c - 3):c + 4] = True
        chars = np.full((ROWS, COLS), ord(" "), np.uint8)
        chars[1:1 + MAP_ROWS, :MAP_COLS] = np.where(self.explored, self.layout, ord(" "))
        chars[1 + self.stairs[0], self.stairs[1]] = ord(">")
        pet = (min(MAP_ROWS - 1, r + 1), c)
        chars[1 + pet[0], pet[1]] = ord("d")
        chars[1 + r, c] = ord("@")
        text = self.message.encode("latin-1")
        chars[0, :len(text)] = np.frombuffer(text, np.uint8)
        status = [f"Agent the Stripling  St:{b[BL['STR25']]} Dx:{b[BL['DEX']]} Co:{b[BL['CON']]} In:{b[BL['INT']]} Neutral S:{b[BL['SCORE']]}",
                  f"Dlvl:{b[BL['DEPTH']]} $:{b[BL['GOLD']]} HP:{max(0, b[BL['HP']])}({b[BL['HPMAX']]}) Pw:{b[BL['ENE']]}({b[BL['ENEMAX']]}) "
                  f"AC:{b[BL['AC']]} Xp:{b[BL['XP']]}/{b[BL['EXP']]} T:{b[BL['TIME']]}"]
        for i, line in enumerate(status):
            line = line.encode("latin-1")[:COLS]
            chars[ROWS - 2 + i, :len(line)] = np.frombuffer(line, np.uint8)
        colors = (chars.astype(np.int64) % 16).astype(np.int8)
        colors[rng.random((ROWS, COLS)) < 0.02] = 1
        if self.cursor_mode == 1:
            cursor = (0, min(COLS - 1, len(text)))
        elif self.cursor_mode == 2:
            cursor = (ROWS - 2 + int(rng.integers(0, 2)), int(rng.integers(0, COLS)))
        else:
            cursor = (1 + r, c)
        glyphs = np.full((MAP_ROWS, MAP_COLS), GLYPH_CMAP_OFF, np.int16)
        glyphs[self.explored] = GLYPH_CMAP_OFF + 19
        glyphs[pet] = GLYPH_PET_OFF + 17
        glyphs[r, c] = 333
        on_stairs = (r, c) == self.stairs
        internal = np.array([0, 0, 0, 0, int(on_stairs), 0, 0, self.eaten, 0], np.int32)
        message = np.zeros(256, np.uint8)
        message[:len(text)] = np.frombuffer(text, np.uint8)
        self.observation = (glyphs, b.copy(), message, internal, chars, colors, np.array(cursor, np.uint8))
