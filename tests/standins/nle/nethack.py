"""`nle.nethack` of the stand-in: the constants and helpers the NetHack integration reads."""

import nethack_sim as _sim

ACTIONS = tuple(range(_sim.NUM_ACTIONS))
GLYPH_CMAP_OFF = _sim.GLYPH_CMAP_OFF
glyph_is_pet = _sim.glyph_is_pet
for _name, _index in _sim.BL.items():
    globals()[f"NLE_BL_{_name}"] = _index
