"""The port's single-layer arts-crossfit cross sections against the JAX
package's.

Ports of tests/test_arts_crossfit.py:58, :69, :80 and :89 on the same
synthetic coefficient files: ``CrossSection.absorption_coefficient``,
``calculate_xsec`` and ``calculate_xsec_fullmodel`` (float64 numpy on the
host) against the JAX functions and the scipy transcription of the
reference algorithm at rtol 1e-12, and the batched and device evaluators
against the single-layer one.
"""
import numpy as np
import torch

from pylbl_tpu.models.arts_crossfit import CrossSection as JCrossSection
from pylbl_tpu.models.arts_crossfit import calculate_xsec as j_xsec
from pylbl_tpu.models.arts_crossfit import \
    calculate_xsec_fullmodel as j_fullmodel

from pylbl_tpu_torch.models.arts_crossfit import (CrossSection,
                                                  calculate_xsec,
                                                  calculate_xsec_fullmodel)

from test_arts_crossfit import make_coeff_file, reference_eval

torch.set_num_threads(1)


def test_cross_section_matches_reference_algorithm(tmp_path):
    """Port of tests/test_arts_crossfit.py:58."""
    path = tmp_path / "XYZ.nc"
    make_coeff_file(path, bands=3, seed=42)
    xsec = CrossSection("XYZ", str(path))
    jxsec = JCrossSection("XYZ", str(path))
    grid = np.arange(600.0, 1500.0, 0.7)
    for t, p in [(288.99, 98388.0), (203.37, 11419.0)]:
        got = xsec.absorption_coefficient(grid, t, p)
        assert got.dtype == np.float64 and got.shape == grid.shape
        np.testing.assert_allclose(got, reference_eval(path, grid, t, p),
                                   rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(got, jxsec.absorption_coefficient(
            grid, t, p), rtol=1e-12, atol=1e-300)
    assert len(xsec._interp_cache) == 1   # one grid, one set of weights.


def test_negative_clipping_conserves_integral():
    """Port of tests/test_arts_crossfit.py:69, with both packages' fits."""
    rng = np.random.default_rng(3)
    coeffs = np.zeros((4, 50))
    coeffs[0] = rng.uniform(-2e-22, 5e-22, 50)
    coeffs[1:] = rng.uniform(-1e-26, 1e-26, (3, 50))
    raw = calculate_xsec(250.0, 5e4, coeffs)
    np.testing.assert_allclose(raw, j_xsec(250.0, 5e4, coeffs), rtol=1e-12)
    assert np.sum(raw < 0) > 0 and np.sum(raw) >= 0
    clipped = calculate_xsec_fullmodel(250.0, 5e4, coeffs)
    assert np.all(clipped >= 0)
    np.testing.assert_allclose(np.sum(clipped), np.sum(raw), rtol=1e-12)
    np.testing.assert_allclose(clipped, j_fullmodel(250.0, 5e4, coeffs),
                               rtol=1e-12, atol=1e-300)
    # A fit whose total is negative is clipped but not rescaled; one with
    # no negatives is returned as is.
    negative = -np.abs(coeffs)
    negative[0, :3] = 1e-30
    np.testing.assert_allclose(
        calculate_xsec_fullmodel(250.0, 5e4, negative),
        j_fullmodel(250.0, 5e4, negative), rtol=1e-12, atol=1e-300)
    positive = np.abs(coeffs)
    np.testing.assert_array_equal(
        calculate_xsec_fullmodel(250.0, 5e4, positive),
        calculate_xsec(250.0, 5e4, positive))


def test_out_of_band_grid_is_zero(tmp_path):
    """Port of tests/test_arts_crossfit.py:80."""
    path = tmp_path / "Z.nc"
    make_coeff_file(path, bands=1, seed=7)
    xsec = CrossSection("Z", str(path))
    grid = np.arange(1.0, 10.0, 1.0)  # far below the band frequencies
    got = xsec.absorption_coefficient(grid, 288.0, 1e5)
    assert np.array_equal(got, np.zeros(grid.size))
    assert np.array_equal(got, JCrossSection("Z", str(path))
                          .absorption_coefficient(grid, 288.0, 1e5))


def test_batched_and_device_xsec_match_scalar(tmp_path):
    """Port of tests/test_arts_crossfit.py:89: the layer-batched and the
    device (CPU tensor) evaluators reproduce the single-layer one,
    including clip-rescale layers, and the single layer matches JAX."""
    path = tmp_path / "xsb.nc"
    make_coeff_file(path, bands=3, seed=7)
    xs = CrossSection("CFC11", str(path))
    jxs = JCrossSection("CFC11", str(path))
    grid = np.arange(1.0, 3000.0, 2.0)
    t = np.asarray([288.99, 203.37, 1000.0])  # hot layer forces clipping
    p = np.asarray([98388.0, 11419.0, 101300.0])
    want = np.stack([xs.absorption_coefficient(grid, t[i], p[i])
                     for i in range(t.size)])
    np.testing.assert_allclose(want, np.stack([
        jxs.absorption_coefficient(grid, t[i], p[i])
        for i in range(t.size)]), rtol=1e-12, atol=1e-300)
    got = xs.absorption_coefficient_batch(grid, t, p)
    np.testing.assert_allclose(got, want, rtol=1e-13)
    fn = xs.device_absorption_fn(grid, "cpu")
    dev = fn(t, p).numpy()
    np.testing.assert_allclose(dev, want, rtol=1e-12,
                               atol=np.abs(want).max() * 1e-14)
