"""The port's wings and core passes against the JAX Pallas kernels.

The port's pipeline assembles a stacked SoA and core-parameter block; the
same numpy arrays and CSRs go through the Pallas kernels in interpret mode
(``_pallas_pass_strided``, ``_pallas_pass_batched`` with the prepacked
splat line function, ``_pallas_seg_pass_mixed``) and through the port's
wrappers, which on CPU tensors run the plain versions.  rel < 5e-6 with the
1e-7 * max floor of tests/test_lineshape_pallas.py (the core alone, which
cancels to near zero at points, to 1e-6 of its scale).  The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import lineshape_pallas as jlp

from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel.lines import make_multigas_batched_fn

torch.set_num_threads(1)

GRID = np.arange(1.0, 220.0, 0.2)
T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
VMR = np.asarray([[6.637074e-03, 3.9e-04, 6.7e-08],
                  [4.2e-06, 3.9e-04, 7.8e-06]])


def packs():
    return {
        "H2O": synthetic_line_pack("H2O", num_lines=300, nu_min=0.6,
                                   nu_max=260.0, seed=21,
                                   band_centers=(150.0,)),
        "CO2": synthetic_line_pack("CO2", num_lines=200, nu_min=0.6,
                                   nu_max=260.0, seed=22,
                                   band_centers=(60.0, 200.0)),
        "O3": synthetic_line_pack("O3", num_lines=100, nu_min=0.6,
                                  nu_max=260.0, seed=23,
                                  band_centers=(100.0,)),
    }


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(
        np.abs(want), np.abs(want).max() * 1e-7)).max())


def pipeline(tile, tail, device="cpu"):
    fn = make_multigas_batched_fn(packs(), GRID, tile=tile, chunk=128,
                                  wings_tail=tail, device=device)
    soa, core = fn.assemble(T, P, VMR)
    return fn, soa, core


@pytest.mark.parametrize("tile,tail", [(512, 128), (512, None)])
def test_strided_wings_match_pallas(tile, tail):
    fn, soa, _ = pipeline(tile, tail)
    assert fn.wings_stride is not None
    assert (fn.wings_tail_csr is not None) == (tail is not None)
    lc.reset_launches()
    got = fn.wings_pass(soa).numpy()
    assert lc.LAUNCHES["wings_strided"] == 0   # CPU tensors: plain version
    w_start, w_n = fn.wings_csr
    t_start, t_n = fn.wings_tail_csr or (None, None)
    want = jlp._pallas_pass_strided(
        jnp.asarray(soa.numpy()), w_start, w_n, fn.core_plan.num_points,
        tile, fn.wings_stride, chunk=fn.wings_chunk, interpret=True,
        prepacked=True, t_start=t_start, t_n=t_n, tail=tail or 128)
    assert got.shape == want.shape
    assert rel_err(got, want) < 5e-6


def test_splat_wings_match_pallas():
    fn, soa, _ = pipeline(256, 128)
    assert fn.wings_stride is None
    got = fn.wings_pass(soa).numpy()
    w_start, w_n = fn.wings_csr
    batch = soa.shape[0]
    want = jlp._pallas_pass_batched(
        jnp.asarray(soa.numpy()), np.broadcast_to(w_start, (batch,)
                                                  + w_start.shape),
        np.broadcast_to(w_n, (batch,) + w_n.shape),
        fn.core_plan.num_points, 256, fn.wings_chunk, "wings_pre",
        interpret=True)
    assert got.shape == want.shape
    assert rel_err(got, want) < 5e-6
    # A [B, T] broadcast CSR is taken like the shared [T] one.
    bcast = [torch.as_tensor(a).expand(batch, -1) for a in fn.wings_csr]
    again = lc.wings_splat_pass(soa, *bcast, fn.core_plan.num_points, 256,
                                fn.wings_chunk).numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("tile,tail", [(512, 128), (256, 128)])
def test_segmix_core_matches_pallas(tile, tail):
    """The core correction alone cancels to near zero at points (it is
    K_full - K_lorentz), so it is held to 1e-6 of its scale in absolute
    terms (the JAX package's own segmix test uses 1e-5); the spectrum it
    produces with the wings is held to rel < 5e-6."""
    fn, soa, core = pipeline(tile, tail)
    plan = fn.core_plan
    got = fn.core_pass(core).numpy()
    want = np.asarray(jlp._pallas_seg_pass_mixed(
        jnp.asarray(core.numpy()), plan.t_start, plan.t_chunks,
        plan.num_points, plan.tile, plan.chunk, interpret=True))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)
    wings = fn.wings_pass(soa).numpy()
    assert rel_err(wings + got, wings + want) < 5e-6


def test_plain_float64_matches_float32_path():
    """The plain versions run in float64 too (the parity reference the
    card checks the float32 kernels against)."""
    fn, soa, core = pipeline(512, 128)
    k32 = fn.wings_pass(soa) + fn.core_pass(core)
    k64 = fn.wings_pass(soa.double()) + fn.core_pass(core.double())
    assert k64.dtype == torch.float64
    assert rel_err(k32.numpy(), k64.numpy()) < 5e-6


def test_wrappers_refuse_other_devices():
    fn, soa, core = pipeline(512, 128)
    with pytest.raises(ValueError, match="device"):
        fn.wings_pass(soa.to("meta"))
    with pytest.raises(ValueError, match="device"):
        fn.core_pass(core.to("meta"))
