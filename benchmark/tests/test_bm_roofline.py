"""The benchmark's kernel counts at known shapes give the bounds of the
kernel table in PERF.md (chip_smoke.py's formulas)."""

import pytest

from benchmark import roofline


def test_k4_forward_bound_at_the_table_shape():
    # planes (4, 3, 32, 256, 256), 196,608 points an image: 0.1230 ms
    ms = 1e3 * roofline.k4_forward_s(N=4, H=256, W=256, C=32, M=196608)
    assert ms == pytest.approx(0.1230, abs=5e-5)


def test_k4_backward_bound_at_the_table_shape():
    ms = 1e3 * roofline.k4_backward_s(N=4, H=256, W=256, C=32, M=196608)
    assert ms == pytest.approx(0.1230, abs=5e-5)


def test_k1_and_k2_bounds_at_the_table_shape():
    # 16 images of 256^2, the head's 5023 verts and 10,042 faces
    assert 1e3 * roofline.k1_s(B=16, V=5023, F=10042, R=256) == \
        pytest.approx(0.0042, abs=5e-5)
    assert 1e3 * roofline.k2_s(B=16, V=5023, F=10042, R=256) == \
        pytest.approx(0.0029, abs=5e-5)


def test_share_is_none_without_device_time():
    assert roofline.share_pct(1e-3, 0) is None
    assert roofline.share_pct(1e-3, 2e-3) == pytest.approx(50.0)
