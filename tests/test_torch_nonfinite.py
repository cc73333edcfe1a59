"""Every Pallas kernel family against the port on non-finite lines.

Each case is ``pylbl_tpu_torch.tools.nonfinite.family_case``'s input: one
set of lines made from a numpy seed, a few of them poisoned in every
layer and packed as the family packs its lines:

- a prefactor of +inf, one of -inf and one of NaN;
- a NaN y (finite prefactor), and a NaN y with an infinite prefactor;
- y = 0 at x = 0 (the center on a grid point of its window);
- a NaN srw, a NaN window start and a NaN window end.

The CSRs and plans come from the clean windows.  The port's plain version
(what its wrapper runs on a CPU tensor, and what each kernel is held to
bit for bit on the card) and the JAX launcher in interpret mode take the
same arrays: NaN, +inf and -inf must sit at exactly JAX's points, and the
finite points must lie within 1e-6 of the scale of the same input without
the poison.  ``assert_allclose`` takes -0.0 and +0.0 as equal: the two
packages' summation orders may legitimately give zeros of opposite sign.

The mixed-slot core and the segment passes are held against their Pallas
kernels on non-finite inputs in tests/test_torch_seg_walk.py
``test_plain_matches_pallas_on_non_finite_inputs`` (the mixed-slot
core's one-hot slot select spreads a non-finite value's NaN over its
tile's other slots, which would hide the rest of these poisons); here
every kernel's case (the inputs of ``chip_smoke.py``'s non-finite phase)
is built and run through its wrapper on the CPU.  A new kernel family
gets its case here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import lineshape_pallas as jlp

from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.tools import nonfinite as nf

torch.set_num_threads(1)


def pallas(case):
    """The JAX launcher of ``case``'s family in interpret mode."""
    i = case.inputs
    batched = case.layers > 1
    if case.family == "own":
        return jlp._pallas_pass_strided(
            jnp.asarray(i["soa"]), *i["csr"], i["n"], i["tile"],
            i["stride"], chunk=i["chunk"], interpret=True)
    if case.family in ("pre_strided", "pre_strided_tail"):
        t_start, t_n = i["tail_csr"]
        return jlp._pallas_pass_strided(
            jnp.asarray(i["soa"]), *i["csr"], i["n"], i["tile"],
            i["stride"], chunk=i["chunk"], interpret=True, prepacked=True,
            t_start=t_start, t_n=t_n)
    if case.family in ("pre_splat", "raw", "corr"):
        csr = i["csr"]
        if batched:
            csr = [np.ascontiguousarray(np.stack([a] * case.layers))
                   for a in csr]
        launch = jlp._pallas_pass_batched if batched else jlp._pallas_pass
        return launch(jnp.asarray(i["soa"]), *csr, i["n"], i["tile"],
                      i["chunk"], i["kind"], interpret=True)
    if case.family == "rows_vmem":
        return jlp._pallas_rows_pass_vmem(
            jnp.asarray(i["groups"]), jnp.asarray(i["ymin"]), *i["csr"],
            i["n"], i["tile"], i["chunk"], interpret=True)
    return jlp._pallas_rows_pass(jnp.asarray(i["groups"]), *i["csr"],
                                 i["n"], i["tile"], i["chunk"],
                                 interpret=True)


@pytest.mark.parametrize("family,layers", [
    ("pre_strided", 2), ("pre_strided_tail", 1), ("pre_strided_tail", 2),
    ("pre_splat", 1), ("pre_splat", 2), ("raw", 1), ("raw", 2),
    ("own", 1), ("own", 2), ("corr", 1), ("corr", 2), ("rows", 1),
    ("rows", 2), ("rows_vmem", 1)])
def test_plain_matches_pallas_on_non_finite_lines(family, layers):
    """PRE strided (with and without the tail), PRE splat, RAW, OWN, CORR
    and the rows core (row 56 and the separate min-y block), one layer
    and a batch, against their JAX launchers: NaN and each signed
    infinity where JAX's are, the finite points within 1e-6 of the clean
    input's scale, and the poison not hidden (NaN, +inf and -inf in the
    output, most points finite)."""
    case = nf.family_case(family, layers)
    got = case.plain().numpy()
    want = np.asarray(pallas(case))
    scale = np.abs(nf.family_case(family, layers, poison=False).plain()
                   .numpy()).max()
    assert got.shape == want.shape and scale > 0
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
        assert test(want).any()
    finite = np.isfinite(want)
    assert finite.mean() > 0.5
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=scale * 1e-6)


@pytest.mark.parametrize("family,layers", nf.KERNEL_CASES)
def test_every_kernel_has_a_poisoned_case(family, layers):
    """Every launch counter has a case (chip_smoke.py's non-finite phase
    runs them on the card); on the CPU the wrapper runs the plain version
    and launches nothing, and the poison shows: NaN beside finite
    non-zero points."""
    case = nf.family_case(family, layers)
    lc.reset_launches()
    got = case.run()
    assert sum(lc.LAUNCHES.values()) == 0
    want = case.plain()
    assert got.shape == want.shape and got.shape[:-1] == (
        (layers,) if layers > 1 else ())
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    assert bool(nan.any()) and bool((want[torch.isfinite(want)] != 0).any())
    counters = {nf.FAMILIES[f][n > 1] for f, n in nf.KERNEL_CASES}
    assert counters == set(lc.LAUNCHES)
