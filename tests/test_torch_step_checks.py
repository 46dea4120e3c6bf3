"""The rule that holds the fused step kernels against their plain versions on
the card (``repro_torch.tools.step_checks``), exercised here on CPU tensors:
it accepts the plain version against itself and refuses a wrong value in any
one output.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import get_tableau, integral_controller  # noqa: E402
from repro_torch.core.stepper import _tableau_arrays  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.tools import step_checks  # noqa: E402

NAMES = step_checks.STEP_OUTS + step_checks.COEFF_OUTS


def _step(dtype, want_coeffs=True):
    tab = get_tableau("dopri5")
    _, _, b_sol, b_err = _tableau_arrays(tab, dtype)
    g = torch.Generator(device="cpu").manual_seed(0)
    y, K, cols, failed = step_checks.step_inputs(16, 5, tab.stages, dtype, "cpu", g)
    atol, rtol = 1e-2, 1e-3
    out = ref.fused_step(y, K, K[-1], *cols, atol, rtol, b_sol=b_sol, b_err=b_err,
                         ctrl=integral_controller().filter_params(tab.error_order),
                         want_coeffs=want_coeffs, failed=failed)
    floor = step_checks.ratio_floor(y, out[0], K, cols[3], b_err, atol, rtol)
    return out, floor


def _replace(out, name, fn):
    """``out`` with the output ``name`` replaced by ``fn(copy of it)``."""
    outs, coeffs = list(out[:9]), list(out[9]) if out[9] is not None else None
    if name in step_checks.COEFF_OUTS:
        j = step_checks.COEFF_OUTS.index(name)
        coeffs[j] = fn(coeffs[j].clone())
    else:
        j = step_checks.STEP_OUTS.index(name)
        outs[j] = fn(outs[j].clone())
    return (*outs, tuple(coeffs) if coeffs is not None else None)


def _first_accepted_finite_row(out):
    return int(torch.nonzero(out[2] & torch.isfinite(out[1]))[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_holds_against_itself(dtype):
    out, floor = _step(dtype)
    worst, rel, edge = step_checks.hold_to_plain("same", out, out, floor)
    assert (worst, rel, edge) == (0.0, 0.0, 0)
    assert step_checks.bitwise_mismatches(out, out) == {}


@pytest.mark.parametrize("name", [n for n in NAMES if n != "accept"])
def test_a_wrong_output_is_refused(name):
    out, floor = _step(torch.float32)
    row = _first_accepted_finite_row(out)

    def spoil(x):
        x[row] = 1.5 * x[row] + 1.0
        return x
    bad = _replace(out, name, spoil)
    with pytest.raises(AssertionError, match=name):
        step_checks.hold_to_plain("case", bad, out, floor)
    assert list(step_checks.bitwise_mismatches(bad, out)) == [name]


def test_a_flipped_decision_away_from_ratio_one_is_refused():
    out, floor = _step(torch.float64)
    ratio = out[1]
    row = int(torch.nonzero(torch.isfinite(ratio) & ((ratio - 1).abs() > 0.1))[0])

    def flip(x):
        x[row] = ~x[row]
        return x
    with pytest.raises(AssertionError, match="accept"):
        step_checks.hold_to_plain("case", _replace(out, "accept", flip), out, floor)


def test_missing_coefficients_are_refused():
    out, floor = _step(torch.float64)
    bare = (*out[:9], None)
    with pytest.raises(AssertionError, match="coefficients"):
        step_checks.hold_to_plain("case", bare, out, floor)
    assert step_checks.bitwise_mismatches(bare, out) == {"coeffs": "present in one only"}
