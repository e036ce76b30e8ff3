"""Multichannel channelizers (liquid firpfbch family; yagi stub filled in)."""

from .firpfbch import Firpfbch, Firpfbch2  # noqa: F401
from .firpfbchr import Firpfbchr  # noqa: F401
from .ofdm import OfdmFrameGen, OfdmFrameSync, default_sctype  # noqa: F401
from .ofdmflexframe import OfdmFlexFrameGen, OfdmFlexFrameSync  # noqa: F401
