"""MsResamp end-to-end jit (valid-prefix composite, msresamp.rs:126-164).

An earlier implementation was host-orchestrated (a host sync per block to
compact the arbitrary stage's variable-length output); execute_block now
threads exact traced counts through fixed-capacity buffers, so a streaming
pipeline containing MsResamp stays on-device for its whole life.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yagi_tpu.filter import MsResamp


def _stream(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )


@pytest.mark.parametrize("rate", [3.7, 2.0, 1.3, 0.71, 0.3, 0.17, 0.06])
@pytest.mark.slow
def test_jitted_blocks_match_host_path(rate):
    """jit(execute_block) across uneven blocks == host execute() stream."""
    rng = np.random.default_rng(11)
    blocks = [97, 64, 33, 128]

    step = jax.jit(lambda q, x: q.execute_block(x))

    q_jit = MsResamp.create(rate)
    q_host = MsResamp.create(rate)
    out_jit, out_host = [], []
    for n in blocks:
        x = _stream(rng, n)
        y, k, q_jit = step(q_jit, jnp.asarray(x))
        k = int(np.asarray(k))
        assert k == q_host.get_num_output(n)  # exact count predictor
        out_jit.append(np.asarray(y)[:k])
        # invalid tail must be zeroed (fixed-capacity contract)
        assert np.all(np.asarray(y)[k:] == 0)
        yh, q_host = q_host.execute(x)
        out_host.append(yh)
    a = np.concatenate(out_jit)
    b = np.concatenate(out_host)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_block_split_invariance_jitted():
    """One big jitted block == many small jitted blocks (state carry)."""
    rate = 0.23
    rng = np.random.default_rng(12)
    x = _stream(rng, 240)
    step = jax.jit(lambda q, v: q.execute_block(v))

    q = MsResamp.create(rate)
    y_all, k_all, _ = step(q, jnp.asarray(x))
    whole = np.asarray(y_all)[: int(np.asarray(k_all))]

    q = MsResamp.create(rate)
    parts = []
    for lo, hi in ((0, 60), (60, 61), (61, 150), (150, 240)):
        y, k, q = step(q, jnp.asarray(x[lo:hi]))
        parts.append(np.asarray(y)[: int(np.asarray(k))])
    np.testing.assert_allclose(
        np.concatenate(parts), whole, rtol=0, atol=1e-5
    )


def test_symstreamr_pipeline_single_jit():
    """A symbol-source → MsResamp pipeline runs as ONE jitted step per block
    (the SymStreamR composition, symstreamr.rs:10-16) with no host sync."""
    from yagi_tpu.design import FirFilterShape
    from yagi_tpu.filter import FirInterpolationFilter
    from yagi_tpu.modem import Modem

    rate = 0.5 / 0.37  # SymStreamR(bw=0.37)
    k_sps = 2
    modem = Modem.create("qpsk")
    interp = FirInterpolationFilter.create_prototype(FirFilterShape.ARKAISER, k_sps, 7, 0.3)
    ms = MsResamp.create(rate)

    def step(carry, sym_bits):
        interp_f, msr, mdm = carry
        syms, mdm = mdm.modulate(sym_bits)
        samp, interp_f = interp_f.execute_block(syms)
        y, k, msr = msr.execute_block(samp)
        return (interp_f, msr, mdm), (y, k)

    jstep = jax.jit(step)
    rng = np.random.default_rng(13)
    carry = (interp, ms, modem)
    total = []
    for _ in range(4):
        bits = jnp.asarray(rng.integers(0, 4, size=32), dtype=jnp.uint32)
        carry, (y, k) = jstep(carry, bits)
        total.append(np.asarray(y)[: int(np.asarray(k))])
    out = np.concatenate(total)
    # 4 blocks × 32 symbols × 2 sps × rate ≈ 346 samples, finite and nonzero
    assert out.size > 300 and np.all(np.isfinite(out))
    assert np.abs(out).max() > 0.1
