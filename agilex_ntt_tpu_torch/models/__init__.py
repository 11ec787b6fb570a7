"""Ring presets: the named transform sizes of the reference's size menu."""

from .presets import PRESETS, preset_ring, preset_rns
