"""A stand-in for the `nle` package (the NetHack Learning Environment), which neither the sandbox
nor the card's machine has. Importing it registers NLE's eight task ids with gymnasium, as `nle`
does, where gymnasium imports; `nle.nethack` holds the constants the NetHack integration reads
(`ACTIONS`, `NLE_BL_*`, `GLYPH_CMAP_OFF`, `glyph_is_pet`). The game itself is the seeded numpy
model of `tests/standins/nethack_sim.py`.
"""

from nle import nethack  # noqa: F401

TASKS = {
    "NetHackStaircase-v0": "NetHackStaircase",
    "NetHackScore-v0": "NetHackScore",
    "NetHackStaircasePet-v0": "NetHackStaircasePet",
    "NetHackOracle-v0": "NetHackOracle",
    "NetHackGold-v0": "NetHackGold",
    "NetHackEat-v0": "NetHackEat",
    "NetHackScout-v0": "NetHackScout",
    "NetHackChallenge-v0": "NetHackChallenge",
}

try:
    import gymnasium
except ImportError:  # pragma: no cover - the card's machine: the constants only
    gymnasium = None

if gymnasium is not None:
    for _env_id, _cls in TASKS.items():
        if _env_id not in gymnasium.registry:
            gymnasium.register(id=_env_id, entry_point=f"nle.env:{_cls}")
