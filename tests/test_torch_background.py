"""PyTorch port vs the JAX reference: background / rms mesh (H2's plain
version and the mesh tail), on the CPU.

Tolerance: ``back``, ``rms`` and both meshes rtol 1e-4. The port adds the
cell sums in the reference's order (zuds_tpu_torch/ops/ordered.py), so the
meshes come out equal in practice; the one-pass variance cancels to ~1e-4
per ulp of its sums, which is why the order is kept.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import background as jb
from zuds_tpu_torch.ops import background as tb
from zuds_tpu_torch.ops import ordered

torch.set_num_threads(2)


def T(a):
    return torch.as_tensor(np.array(a))


def _frame(H, W, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = (150.0 + 0.02 * xx - 0.015 * yy
           + rng.normal(0, 5, (H, W))).astype('f4')
    for _ in range(40):                       # a crowded corner + stars
        x0, y0 = rng.uniform(0, W), rng.uniform(0, H / 3)
        img += (3e3 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 8.0)
                ).astype('f4')
    img[rng.random((H, W)) < 1e-3] = np.nan
    valid = rng.random((H, W)) > 0.05
    valid[:, :9] = False                      # a masked strip
    return img, valid


@pytest.mark.parametrize('shape,box', [((256, 256), 64), ((200, 136), 64),
                                       ((264, 256), 128)])
def test_background_mesh(shape, box):
    img, valid = _frame(*shape, seed=shape[0] + box)
    j = jb.background_mesh(jnp.asarray(img), jnp.asarray(valid), box=box)
    t = tb.background_mesh(T(img), T(valid), box=box)
    for k in ('back', 'rms', 'back_mesh', 'rms_mesh'):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-4, err_msg=k)


def test_background_cells_plain_counts():
    """H2's plain version: per-cell kept-pixel counts drive good_cell and
    must be exact."""
    img, valid = _frame(256, 256, seed=3)
    back, sigma, n = tb.background_cells_plain(T(img), T(valid), box=64)
    assert n.dtype == torch.int32 and n.shape == (4, 4)
    assert int(n.min()) > 64 and int(n.max()) <= 64 * 64
    assert bool(torch.isfinite(back).all() & (sigma > 0).all())


def test_empty_cells_take_the_global_median():
    img, valid = _frame(256, 256, seed=5)
    valid[:64, :64] = False                   # one empty cell
    j = jb.background_mesh(jnp.asarray(img), jnp.asarray(valid), box=64)
    t = tb.background_mesh(T(img), T(valid), box=64)
    np.testing.assert_allclose(t['back_mesh'].numpy(),
                               np.asarray(j['back_mesh']), rtol=1e-4)


def test_bisect_median_matches_reference_not_torch_median():
    """Trap: bisect_median is approximate by design (12 value-space
    halvings); torch.median is exact and gives another answer."""
    rng = np.random.default_rng(0)
    x = rng.normal(150, 5, (6, 3001)).astype('f4')
    ok = rng.random(x.shape) > 0.2
    j = np.asarray(jb.bisect_median(jnp.asarray(x), jnp.asarray(ok)))
    t = tb.bisect_median(T(x), T(ok)).numpy()
    np.testing.assert_array_equal(t, j)
    exact = np.array([np.median(r[o]) for r, o in zip(x, ok)], 'f4')
    assert np.abs(t - exact).max() > 1e-4


def test_masked_median_even_count_averages():
    """Trap: jnp.nanmedian / masked_median average the two middle values
    of an even count; torch.nanmedian returns the lower one."""
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0, 9.0]])
    ok = torch.tensor([[True, True, True, True, False]])
    assert float(tb.masked_median(x, ok)) == 2.5
    assert float(torch.nanmedian(torch.tensor([4.0, 1.0, 3.0, 2.0]))) == 2.0
    j = jb.masked_median(jnp.asarray(x.numpy()), jnp.asarray(ok.numpy()))
    assert float(j[0]) == 2.5


def test_median_filter_and_interpolate_mesh():
    rng = np.random.default_rng(2)
    mesh = rng.normal(150, 3, (5, 7)).astype('f4')
    np.testing.assert_array_equal(
        tb.median_filter_mesh(T(mesh)).numpy(),
        np.asarray(jb.median_filter_mesh(jnp.asarray(mesh))))
    np.testing.assert_allclose(
        tb.interpolate_mesh(T(mesh), (300, 430), 64).numpy(),
        np.asarray(jb.interpolate_mesh(jnp.asarray(mesh), (300, 430), 64)),
        rtol=1e-6)


@pytest.mark.parametrize('n', [5, 32, 33, 100, 3277, 16384])
def test_ordered_sum_is_the_references(n):
    """The reference's CPU sums, reproduced bit for bit."""
    rng = np.random.default_rng(n)
    x = (rng.normal(150, 5, (4, n)) ** 2).astype('f4')
    np.testing.assert_array_equal(ordered.sum_last(T(x)).numpy(),
                                  np.asarray(jnp.sum(jnp.asarray(x), -1)))
