"""Device-mesh streaming distribution (no reference equivalent)."""

from .stream import (  # noqa: F401
    halo_exchange_left,
    make_stream_mesh,
    time_sharded_fir,
)
from .channelizer import (  # noqa: F401
    sharded_channelize,
    sharded_channelize_fm,
    sharded_channelize_to_channels,
    sharded_channelize_fm_to_channels,
    sharded_channelize_stream_to_channels,
    sharded_channelize_stream_fm_to_channels,
)
