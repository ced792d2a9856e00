"""``chip_smoke.py``'s kernel comparison, read on CPU tensors.

Every kernel case of ``chip_smoke.py`` passes through ``_compare``: a
kernel output that is NaN or infinite where the plain value is finite
must read as an infinite difference, never as none (Python's ``max``
and ``float(t.max())`` let a NaN through as a pass)."""
import importlib.util
import math
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def bf16_rule(out):
    """B5's bf16 per-element rule, as ``chip_smoke.attention_case``."""
    return 2.0 ** -7 * out.float().abs() + 2.0 ** -12


PLAIN = torch.tensor([[0.5, -1.25], [0.0, 3.0]], dtype=torch.bfloat16)


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("tol", [bf16_rule, None],
                         ids=["per-element", "bit-exact"])
def test_compare_fails_non_finite_kernel_output(bad, tol):
    kernel = PLAIN.clone()
    kernel[1, 0] = bad
    err, share = chip_smoke._compare(kernel, PLAIN, tol)
    assert err == math.inf and share == math.inf


def test_compare_reads_equal_outputs_as_zero():
    """Equal outputs read 0 even where the allowed difference is 0, and
    one bf16 ulp of the plain value reads at most the whole rule."""
    assert chip_smoke._compare(PLAIN, PLAIN.clone(),
                               lambda out: torch.zeros_like(out.float())
                               ) == (0.0, 0.0)
    ulp = PLAIN.clone()
    ulp[0, 0] = 0.5 + 2.0 ** -8           # the next bf16 above 0.5
    err, share = chip_smoke._compare(ulp, PLAIN, bf16_rule)
    assert err == 2.0 ** -8 and 0 < share <= 1
