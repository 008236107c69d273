"""NumPy oracle — the executable specification of the codec.

Until `/root/reference` is populated, this package is the behavioral contract
that "bit-exact decode" is measured against (SURVEY.md §7 risk R1): the device
path must produce streams that decode — on any backend — to exactly the bytes
this oracle's decoder produces.
"""

from .mp import (
    correlate_bank,
    mp_encode,
    mp_decode,
    hierarchical_encode,
    hierarchical_decode,
    feature_map_from_events,
    to_distributed,
    to_top_level,
)

__all__ = [
    "correlate_bank",
    "mp_encode",
    "mp_decode",
    "hierarchical_encode",
    "hierarchical_decode",
    "feature_map_from_events",
    "to_distributed",
    "to_top_level",
]
