"""The attention's bound terms and the peaks the shares are taken against."""

import pytest

from benchmark import counts


def test_f32_peak_is_three_bf16_parts():
    assert counts.PEAK_F32_FLOPS == pytest.approx(989e12 / 3)
    assert counts.PEAK_FP32_PIPES_FLOPS == 67e12


@pytest.mark.parametrize("n,cb,c,ms", [(1, 8, 64, 0.0361), (16, 8, 64, 0.5769),
                                       (16, 12, 96, 0.8654)])
def test_resident_forward_terms_of_the_kernel_table(n, cb, c, ms):
    """PERF.md's kernel table, row 2 (the resident forward at T 4096):
    f32 operations at the FP32 pipes' 67 TFLOP/s, with no dtype switch
    and no SFU floor, and the bytes term below it."""
    got, by = counts.bound_ms(counts.attention_flops("fwd", n, 4096, cb, c),
                              counts.attention_bytes("fwd", n, 4096, cb, c),
                              counts.PEAK_FP32_PIPES_FLOPS)
    assert (round(got, 4), by) == (ms, "operations")
    nbytes = n * 4096 * ((2 * cb + c) * 4 + c * 4 + 8)
    assert counts.attention_bytes("fwd", n, 4096, cb, c) == nbytes


def test_bounds_at_the_f32_tensor_core_peak():
    """msau_funsd's attention calls at 512 x 512, bs 16 (N 16, T 4096, Cb 8,
    C 64): forward 0.117 ms, backward 0.248 ms; at 1024 x 1024, bs 4 (N 4,
    T 16384)."""
    assert counts.attention_bound_ms("fwd", 16, 4096, 8, 64)[0] == pytest.approx(0.11725, abs=1e-5)
    assert counts.attention_bound_ms("bwd", 16, 4096, 8, 64)[0] == pytest.approx(0.24754, abs=1e-5)
    assert counts.attention_bound_ms("fwd", 4, 16384, 8, 64)[0] == pytest.approx(0.46902, abs=1e-5)
    assert counts.attention_bytes("bwd", 4, 16384, 8, 64) == 4 * 16384 * (4 * 8 + 3 * 64) * 4 + 4 * 16384 * 8


def test_attention_shape_of_the_cells():
    funsd = {"scale_space_num": 4, "featRoot": 8}
    default = {"scale_space_num": 6, "featRoot": 8}
    assert counts.attention_shape(funsd, 16, 512, 512) == (16, 4096, 8, 64)
    assert counts.attention_shape(funsd, 4, 1024, 1024) == (4, 16384, 8, 64)
    assert counts.attention_shape(default, 16, 512, 512) == (16, 256, 32, 256)
