"""Planar (re/im) boundary adapters for complex pytrees.

A planar layout carries a complex array as two real planes (re, im) across
host↔device and jit boundaries; complex math *inside* a program is
unchanged — XLA lowers it to planar pairs anyway. Kernels take the planes
directly (Pallas kernels have no complex dtype).

``planar_jit(f)`` wraps any state-threading function (e.g.
``lambda chain, x: chain.step(x)``) so that every complex leaf of its inputs
and outputs is replaced by a :class:`Planar` pair of real arrays at the jit
boundary; inside the traced program the original complex-typed code runs
unchanged. Streaming state pytrees round-trip planar between steps without
ever materializing complex at the boundary.

There is no reference counterpart (the reference is single-threaded host Rust
with native Complex32, /root/reference/src/lib.rs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Planar", "planarize", "unplanarize", "planar", "planar_jit",
           "planar_scan", "loop_constants"]


@jax.tree_util.register_pytree_node_class
class Planar:
    """A complex leaf split into (re, im) real leaves."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Planar(re={self.re!r}, im={self.im!r})"


def _is_complex_leaf(x) -> bool:
    if isinstance(x, complex):
        return True
    dt = getattr(x, "dtype", None)
    return dt is not None and jnp.issubdtype(dt, jnp.complexfloating)


def planarize(tree):
    """Replace every complex leaf with a :class:`Planar` (re, im) pair.

    On host numpy arrays this is a pure-numpy split (no device op); on traced
    / device values it emits ``real``/``imag`` ops (use inside jit).
    """

    def split(x):
        if not _is_complex_leaf(x):
            return x
        if isinstance(x, (np.ndarray, np.generic, complex)):
            x = np.asarray(x)
            return Planar(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
        return Planar(jnp.real(x), jnp.imag(x))

    return jax.tree_util.tree_map(split, tree)


def unplanarize(tree):
    """Inverse of :func:`planarize`: join Planar pairs back to complex leaves."""

    def join(n):
        if isinstance(n, Planar):
            if isinstance(n.re, (np.ndarray, np.generic)):
                return np.asarray(n.re) + 1j * np.asarray(n.im)
            return jax.lax.complex(jnp.asarray(n.re), jnp.asarray(n.im))
        return n

    return jax.tree_util.tree_map(join, tree, is_leaf=lambda n: isinstance(n, Planar))


def planar(f):
    """Wrap ``f`` so its boundary values are planar while its body sees complex."""

    @functools.wraps(f)
    def wrapped(*args, **kwargs):
        args, kwargs = unplanarize((args, kwargs))
        return planarize(f(*args, **kwargs))

    return wrapped


def planar_jit(f, **jit_kwargs):
    """``jax.jit`` with planar complex boundaries."""
    return jax.jit(planar(f), **jit_kwargs)


# ---------------------------------------------------------------------------
# Feedback-scan boundary rules: a lax.scan carries planar f32 / int32
# leaves in its xs and carry and emits ONE packed f32 ys array per step (no
# complex, bool or tuple-of-arrays boundaries). planar_scan() enforces the
# rules mechanically for any body.
# ---------------------------------------------------------------------------


def _encode_boundary(tree):
    """complex → Planar pairs, bool → int32 (for carry / xs)."""

    def enc(x):
        if _is_complex_leaf(x):
            return Planar(jnp.real(x), jnp.imag(x))
        if getattr(x, "dtype", None) == jnp.bool_:
            return _BoolInt(x.astype(jnp.int32))
        return x

    return jax.tree_util.tree_map(enc, tree)


def _decode_boundary(tree):
    def dec(n):
        if isinstance(n, Planar):
            return jax.lax.complex(jnp.asarray(n.re), jnp.asarray(n.im))
        if isinstance(n, _BoolInt):
            return n.v != 0
        return n

    return jax.tree_util.tree_map(
        dec, tree, is_leaf=lambda n: isinstance(n, (Planar, _BoolInt))
    )


@jax.tree_util.register_pytree_node_class
class _BoolInt:
    """A bool leaf carried across a scan boundary as int32."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def tree_flatten(self):
        return (self.v,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _pack_ys(tree):
    """Flatten a ys pytree into ONE f32 vector per step + recovery spec."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    parts = []
    spec = []
    for leaf in leaves:
        leaf = jnp.asarray(leaf)
        dt = leaf.dtype
        if jnp.issubdtype(dt, jnp.complexfloating):
            parts.append(jnp.real(leaf).reshape(-1))
            parts.append(jnp.imag(leaf).reshape(-1))
            spec.append(("c", leaf.shape, leaf.size))
        elif dt == jnp.bool_:
            parts.append(leaf.astype(jnp.float32).reshape(-1))
            spec.append(("b", leaf.shape, leaf.size))
        elif jnp.issubdtype(dt, jnp.integer):
            # bitcast keeps 32-bit ints exact through the f32 channel
            parts.append(
                jax.lax.bitcast_convert_type(
                    leaf.astype(jnp.int32), jnp.float32
                ).reshape(-1)
            )
            spec.append(("i", leaf.shape, leaf.size, dt))
        else:
            parts.append(leaf.astype(jnp.float32).reshape(-1))
            spec.append(("f", leaf.shape, leaf.size, dt))
    return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.float32), (
        treedef,
        spec,
    )


def _unpack_ys(packed, recover):
    """Inverse of :func:`_pack_ys` over the stacked [T, K] scan output."""
    treedef, spec = recover
    T = packed.shape[0]
    leaves = []
    off = 0
    for entry in spec:
        kind, shape, size = entry[0], entry[1], entry[2]
        if kind == "c":
            re = packed[:, off : off + size].reshape((T,) + shape)
            im = packed[:, off + size : off + 2 * size].reshape((T,) + shape)
            leaves.append(jax.lax.complex(re, im))
            off += 2 * size
        elif kind == "b":
            leaves.append(packed[:, off : off + size].reshape((T,) + shape) > 0.5)
            off += size
        elif kind == "i":
            v = jax.lax.bitcast_convert_type(
                packed[:, off : off + size], jnp.int32
            ).astype(entry[3])
            leaves.append(v.reshape((T,) + shape))
            off += size
        else:
            leaves.append(
                packed[:, off : off + size].reshape((T,) + shape).astype(entry[3])
            )
            off += size
    return jax.tree_util.tree_unflatten(treedef, leaves)


def loop_constants(*vals, like):
    """Materialize loop-invariant scalars as vectors before a lax.scan.

    XLA may sink input-derived computations — even a rank-0 dynamic-slice
    like ``coeffs[1]`` — into the while-loop body, re-executing them every
    iteration. Broadcasting to the batch shape and fencing with an
    optimization barrier forces one materialization outside the loop.

    Returns the values broadcast to ``like``'s shape, barrier-fenced; pass
    each into the scan body instead of indexing arrays there.
    """
    out = jax.lax.optimization_barrier(tuple(
        jnp.broadcast_to(jnp.asarray(v), jnp.shape(like)) for v in vals
    ))
    return out if len(vals) != 1 else (out[0],)[0]


def planar_scan(f, init, xs, *, unroll: int = 1, reverse: bool = False):
    """``jax.lax.scan`` with planar boundary dtypes (see module rules).

    ``f(carry, x) -> (carry, ys)`` sees ordinary complex/bool values; the
    scan itself only ever carries planar f32 / int32 leaves and emits one
    packed f32 ys array per step.
    """
    recover = []

    def body(carry_e, x_e):
        carry, x = _decode_boundary((carry_e, x_e))
        carry2, ys = f(carry, x)
        packed, rec = _pack_ys(ys)
        if not recover:
            recover.append(rec)
        return _encode_boundary(carry2), packed

    carry_e, packed = jax.lax.scan(
        body, _encode_boundary(init), _encode_boundary(xs),
        unroll=unroll, reverse=reverse,
    )
    ys = _unpack_ys(packed, recover[0]) if recover else None
    return _decode_boundary(carry_e), ys
