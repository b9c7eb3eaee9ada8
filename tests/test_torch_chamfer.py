"""Port parity: Chamfer distance vs shwd_tpu.ops.chamfer.

The JAX tiled kernel runs as its own test runs it here: in interpret mode
with 32 x 32 tiles. The CUDA kernel itself is held against the plain
version on the card in test_torch_kernels_gpu.py.
"""

import torch_cpu  # noqa: F401  (first: one intra-op thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shwd_torch.ops.chamfer import (chamfer, chamfer_directional,
                                    chamfer_tiled, chamfer_tiled_reference)
import importlib

jc = importlib.import_module("shwd_tpu.ops.chamfer")   # the name is shadowed by the function


def _clouds(b, n, m, seed=31):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3)).astype(np.float32),
            rng.normal(size=(b, m, 3)).astype(np.float32))


def test_chamfer_matches_jax():
    """The dense form, value and gradient: rtol 1e-5 (the same direct
    squared differences on both sides)."""
    import jax
    x, y = _clouds(3, 40, 33)
    want, gwant = jax.value_and_grad(jc.chamfer)(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = chamfer(xt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), rtol=1e-5, atol=1e-7)


def test_chamfer_directional_matches_jax():
    x, y = _clouds(3, 40, 33, seed=32)
    want = jc.chamfer_directional(jnp.asarray(x), jnp.asarray(y))
    got = chamfer_directional(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 100, 100), (3, 70, 45), (1, 33, 64)])
def test_tiled_plain_version_matches_pallas_interpret(shape):
    """The kernel's plain version (32 x 32 tiles, sliced ragged edges,
    direct differences) vs chamfer_pallas in interpret mode (padded tiles,
    the x^2 + y^2 - 2xy expansion): atol 2e-5 on values of size ~1, the
    rounding of the expansion."""
    x, y = _clouds(*shape, seed=33)
    want = jc.chamfer_pallas(jnp.asarray(x), jnp.asarray(y), tile_n=32,
                             tile_m=32, interpret=True)
    got = chamfer_tiled_reference(torch.from_numpy(x), torch.from_numpy(y),
                                  tile_n=32, tile_m=32)
    np.testing.assert_allclose(float(got), float(want), atol=2e-5)


def test_tiled_equals_dense_and_cpu_wrapper_takes_the_plain_version():
    """Tiling changes nothing but the order of the minima: the tiled plain
    version equals the dense form to rtol 1e-6, and the wrapper on a CPU
    tensor runs the plain version without counting a launch."""
    x, y = (torch.from_numpy(a) for a in _clouds(2, 130, 70, seed=34))
    dense = float(chamfer(x, y))
    np.testing.assert_allclose(float(chamfer_tiled_reference(x, y, 32, 48)), dense, rtol=1e-6)
    before = chamfer_tiled.launches
    np.testing.assert_allclose(float(chamfer_tiled(x, y)), dense, rtol=1e-6)
    assert chamfer_tiled.launches == before


@pytest.mark.parametrize("b,n,m,sms", [
    (1, 1200, 1200, 132), (2, 5000, 4099, 132), (128, 128, 128, 132),
    (1, 7, 3, 132), (1, 40000, 8, 132), (4, 3000, 2000, 132), (1, 1200, 1200, 1),
])
def test_chamfer_chunks_fill_the_card_within_shared_memory(b, n, m, sms):
    """The kernel's slices of the other cloud hold at most 1024 points (its
    shared memory); its units (slices x items x row tiles of both sides)
    give every SM one, unless slices would fall below 32 points."""
    from shwd_torch.ops.chamfer import MAX_CHUNK, MIN_CHUNK, TILE_ROWS, chamfer_chunks
    k = chamfer_chunks(b, n, m, sms)
    assert k >= 1
    assert -(-n // k) <= MAX_CHUNK and -(-m // k) <= MAX_CHUNK
    units = k * b * (-(-n // TILE_ROWS) + -(-m // TILE_ROWS))
    assert units >= sms or -(-min(n, m) // k) <= MIN_CHUNK or k == 1
    if (b, n, m, sms) == (1, 1200, 1200, 132):
        assert k == 33 and units == 132


@pytest.mark.parametrize("chunks", [1, 3, 7])
def test_chunked_minima_match_pallas_interpret(chunks):
    """The minima taken over the kernel's slices (each side's rows against
    `chunks` equal slices of the other cloud) equal chamfer_pallas in
    interpret mode: atol 2e-5, the rounding of its x^2 + y^2 - 2xy."""
    x, y = _clouds(2, 90, 61, seed=35)
    want = jc.chamfer_pallas(jnp.asarray(x), jnp.asarray(y), tile_n=32,
                             tile_m=32, interpret=True)
    got = chamfer_tiled_reference(torch.from_numpy(x), torch.from_numpy(y),
                                  tile_n=-(-90 // chunks), tile_m=-(-61 // chunks))
    np.testing.assert_allclose(float(got), float(want), atol=2e-5)
