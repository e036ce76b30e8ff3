"""Pallas kernels (Triton route) for the hot paths, and their routing rule.

Each kernel has a plain XLA formulation beside it; the objects that use a
kernel take ``backend="auto" | "xla" | "triton"``. A kernel runs in Pallas
interpret mode only when the caller passes ``interpret=True``.
"""

import jax

from ..errors import ConfigError

BACKENDS = ("auto", "xla", "triton")


def use_kernel(backend: str, supported: bool) -> bool:
    """Whether an object takes its Triton kernel.

    ``"xla"`` never does; ``"triton"`` does whenever the shape is
    ``supported``; ``"auto"`` does when the shape is supported and JAX's
    default backend is a GPU.
    """
    if backend not in BACKENDS:
        raise ConfigError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "xla" or not supported:
        return False
    return backend == "triton" or jax.default_backend() == "gpu"


from .chain import chain_taps, fused_chain_apply  # noqa: E402,F401
