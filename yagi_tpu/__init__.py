"""yagi_tpu — a DSP/SDR framework in JAX/XLA/Pallas.

A from-scratch reimagination of liquid-dsp (as realized by the Rust rewrite
"yagi", see SURVEY.md) for accelerators: batched, block-streaming kernels with
explicit state pytrees instead of per-sample mutable objects; XLA convolutions
and FFTs plus Pallas kernels on the hot path; multi-device scaling via
jax.sharding / shard_map with overlap-save halo exchange.

Layer map (mirrors SURVEY.md §1):
  math/       L0 scalar math (host-side design-time, float64)
  sequence/   L0 m-sequences / binary sequences
  random/     L0 seeded distributions + scramblers
  matrix/     L0 dense/sparse matrix ops
  optim/      L0 1-D derivative-free search
  fft/        L2 transforms + spectral periodogram
  design/     L3 FIR/IIR filter design (host-side)
  filter/     L4 streaming filter kernels (FIR/IIR/resamplers/symsync)
  nco/        L5 oscillators, PLL, mixers
  agc/        L5 automatic gain control
  equalization/ L5 LMS/RLS equalizers
  modem/      L6 linear modems, FM, FSK
  framing/    L7 symbol stream generators
  multichannel/  polyphase channelizers (firpfbch) — the flagship workload
  kernels/    Pallas (Triton route) kernels for the hot paths
  parallel/   device-mesh sharding, halo exchange, streaming block runner
"""

__version__ = "0.1.0"

from . import errors  # noqa: F401
from . import math  # noqa: F401
from . import sequence  # noqa: F401
from . import utils  # noqa: F401


def __getattr__(name):
    # lazy subpackage access (importing jax-heavy modules on demand)
    import importlib

    if name in (
        "fft", "design", "filter", "nco", "agc", "equalization", "modem",
        "framing", "multichannel", "random", "matrix", "optim",
        "quantization", "channel", "chains", "parallel", "fec", "audio",
    ):
        return importlib.import_module(f"yagi_tpu.{name}")
    raise AttributeError(f"module 'yagi_tpu' has no attribute {name!r}")
