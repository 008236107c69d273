"""hsc_tpu — hierarchical sparse-coding codec for accelerators.

A from-scratch JAX/XLA rebuild of the capabilities of
`sbrodeur/hierarchical-sparse-coding` (see SURVEY.md): greedy convolutional
matching-pursuit encoding on the device, multi-level atoms-of-atoms dictionaries,
distributed dictionary learning, and a real bit-packed stream format with
bit-exact decode.

Layering (SURVEY.md §1):
  config        — frozen codec contract, serialized into the stream header
  utils         — host-side numeric helpers (normalize, overlap-add, ...)
  dictionary    — MultilevelDictionary (+ singletons, representations, Grams)
  signal        — SignalGenerator fixture factory
  oracle        — NumPy executable spec (the bit-exactness contract)
  ops           — device compute: correlation, greedy loop (XLA or CUDA), decode
  models        — ConvolutionalSparseCoder / Hierarchical... (device classes)
  learn         — sharded convolutional dictionary learning
  io            — bitstream pack/unpack, resume journal
  parallel      — mesh helpers, data-parallel & halo-exchange encode
  analysis      — information-rate / distortion-rate accounting
"""

from .config import CodecConfig, make_test_config
from .dictionary import MultilevelDictionary
from .signal import SignalGenerator

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "make_test_config",
    "MultilevelDictionary",
    "SignalGenerator",
    "CorpusEncoder",
    "CorpusReader",
]


def __getattr__(name):
    # lazy: the runtime pulls jax/device machinery, which the light surface
    # (config/dictionary/signal) should not pay for at import time
    if name in ("CorpusEncoder", "CorpusReader"):
        from . import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
