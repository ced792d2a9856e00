"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's ``repro/launch/roofline.py``: every case of
``tests/test_roofline.py`` on the same synthetic HLO (nothing in the
port produces HLO; its parsers are kept to match the reference), each
result equal to the reference's; ``roofline_terms`` the reference's
formula (equal under the reference's constants) on the H100's
constants, asserted by name; ``model_flops`` equal to the reference's,
as floats compared with ``==``, for every architecture × shape."""
import pytest

from repro.config import SHAPES as J_SHAPES
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import roofline as jroof
from repro_torch.config import SHAPES
from repro_torch.configs import get_config
from repro_torch.launch import roofline
from test_roofline import HLO


def test_h100_constants():
    """NVIDIA H100 80GB HBM3 (SXM5), 700 W: 989 TFLOP/s dense bf16,
    3.35 TB/s HBM3, 50 GB/s a card of collective bandwidth (one 400 Gb/s
    NDR link a GPU)."""
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.ICI_BW == 50e9


@pytest.mark.parametrize("type_str", ["f32[8,8]{1,0}", "bf16[2,3]",
                                      "(f32[4], s32[2])", "pred[]",
                                      "f8e4m3fn[3,5]", "token[]"])
def test_shape_bytes(type_str):
    assert roofline.shape_bytes(type_str) == jroof.shape_bytes(type_str)
    assert roofline.shape_bytes("f32[8,8]{1,0}") == 256


def test_collective_bytes_operands():
    c = roofline.collective_bytes(HLO)
    assert c == jroof.collective_bytes(HLO)
    assert c["per_kind"]["all-reduce"] == 256
    assert c["per_kind"]["all-gather"] == 256
    assert c["counts"]["all-reduce"] == 1


def test_scan_aware_trip_scaling():
    sa = roofline.scan_aware_metrics(HLO, default_trips=1)
    assert sa == jroof.scan_aware_metrics(HLO, default_trips=1)
    assert sa["flops"] == pytest.approx(5 * 1024)
    assert sa["coll_bytes"] == pytest.approx(5 * 256 + 256)


def test_known_trip_count_precedence():
    hlo = HLO.replace(
        "while(%tup.2), condition=%wcond, body=%wbody",
        'while(%tup.2), condition=%wcond, body=%wbody, '
        'backend_config={"known_trip_count":{"n":"7"}}')
    sa = roofline.scan_aware_metrics(hlo, default_trips=1)
    assert sa == jroof.scan_aware_metrics(hlo, default_trips=1)
    assert sa["flops"] == pytest.approx(7 * 1024)


@pytest.mark.parametrize("args", [(197e12, 100e9, 1e9), (1e12, 819e9 * 2, 0),
                                  (989e12, 100e9, 1e9),
                                  (1e12, 3.35e12 * 2, 0), (1e9, 1e9, 5e9),
                                  (0.0, 0.0, 0.0)])
def test_roofline_terms(args, monkeypatch):
    """The reference's formula: equal to its result under its own
    constants; on the H100's, each term the count over its constant."""
    flops, nbytes, coll = args
    t = roofline.roofline_terms(*args)
    assert t["compute_s"] == flops / 989e12
    assert t["memory_s"] == nbytes / 3.35e12
    assert t["collective_s"] == coll / 50e9
    with monkeypatch.context() as m:
        for k in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
            m.setattr(roofline, k, getattr(jroof, k))
        assert roofline.roofline_terms(*args) == jroof.roofline_terms(*args)


def test_roofline_terms_dominance():
    t = roofline.roofline_terms(989e12, 100e9, 1e9)
    assert t["dominant"] == "compute"
    assert t["compute_s"] == pytest.approx(1.0)
    t2 = roofline.roofline_terms(1e12, 3.35e12 * 2, 0)
    assert t2["dominant"] == "memory"
    t3 = roofline.roofline_terms(1e12, 1e9, 50e9 * 3)
    assert t3["dominant"] == "collective"


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_model_flops_match_reference(arch, shape):
    assert roofline.model_flops(get_config(arch), SHAPES[shape]) == \
        jroof.model_flops(j_get_config(arch), J_SHAPES[shape])


def test_model_flops_monotonic():
    cfg = get_config("smollm-360m")
    f_train = roofline.model_flops(cfg, SHAPES["train_4k"])
    f_prefill = roofline.model_flops(cfg, SHAPES["prefill_32k"])
    f_decode = roofline.model_flops(cfg, SHAPES["decode_32k"])
    assert f_train > f_decode
    assert f_prefill > f_decode
    moe = get_config("mixtral-8x7b")
    f_moe = roofline.model_flops(moe, SHAPES["train_4k"])
    dense_equiv = 6 * 47e9 * SHAPES["train_4k"].seq_len * \
        SHAPES["train_4k"].global_batch
    assert f_moe < dense_equiv
