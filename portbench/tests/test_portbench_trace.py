"""The trace's reading on a synthetic trace: busy time, each kernel's
device time, glue, idle gaps by host activity, and the completeness check
against the launch counters."""
import json

import pytest

from portbench import trace

from ._small import ROOT

KERNELS = json.loads((ROOT / "portbench" / "kernels.json").read_text())


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def _trace():
    return {"traceEvents": [
        _x("user_annotation", trace.WINDOW, 0.0, 1000.0),
        _x("cpu_op", "aten::empty", 0.0, 100.0),
        _x("kernel", "void spectra_pow2_kernel<float, 8>(float const*, Views)", 100.0, 100.0),
        _x("kernel", "void movemean_partials_kernel<float>(...)", 150.0, 100.0),  # overlaps A
        _x("cuda_runtime", "cudaStreamSynchronize", 240.0, 60.0),
        _x("kernel", "void movemean_final_kernel<false>(...)", 300.0, 100.0),
        _x("kernel", "void at::native::elementwise_kernel<128, 4>(...)", 450.0, 50.0),
        _x("gpu_memset", "Memset (Device)", 500.0, 10.0),
        _x("cpu_op", "aten::zeros", 520.0, 400.0),
        _x("kernel", "void istft_fft_kernel<float>(...)", 950.0, 100.0),  # runs past the window
        _x("kernel", "void freq_smooth_blend_kernel(...)", 1200.0, 10.0),  # after the window
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 10.0},
    ]}


def test_summary_of_a_synthetic_trace():
    s = trace.summarize(_trace(), KERNELS)
    assert s.window_s == pytest.approx(1e-3)
    # union within the window: [100, 250] + [300, 400] + [450, 510] + [950, 1000]
    assert s.busy_s == pytest.approx((150 + 100 + 60 + 50) * 1e-6)
    assert s.family_n["A_spectra"] == 1 and s.family_n["F_mask"] == 2
    assert s.family_n["D_istft"] == 1 and s.family_n["C_smooth"] == 0
    assert s.family_s["F_mask"] == pytest.approx(200e-6)
    assert s.glue_s == pytest.approx(60e-6)
    assert s.device_s == pytest.approx(460e-6)
    assert sum(v for _, v in s.ops) == pytest.approx(s.device_s)
    gaps = dict(s.gaps)
    assert gaps["aten::empty"] == pytest.approx(100e-6)           # [0, 100]
    assert gaps["cudaStreamSynchronize"] == pytest.approx(50e-6)  # [250, 300]
    assert gaps["aten::zeros"] == pytest.approx(440e-6)           # [510, 950]
    assert gaps[trace.WINDOW] == pytest.approx(50e-6)             # [400, 450]: Python
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)


def test_missing_launches():
    s = trace.summarize(_trace(), KERNELS)
    assert trace.missing_launches(s, {"A_spectra": 1, "F_mask": 1, "D_istft": 1}, 4) == {}
    assert trace.missing_launches(s, {"F_mask": 3, "C_smooth": 1}, 4) == {
        "F_mask": (2, 3), "C_smooth": (0, 1)}
    assert trace.missing_launches(s, {"F_mask": 1}, 5) == {"all kernels": (4, 5)}


def test_a_trace_without_its_window_is_refused():
    t = _trace()
    t["traceEvents"] = t["traceEvents"][1:]
    with pytest.raises(ValueError):
        trace.summarize(t, KERNELS)


def test_short_names():
    assert trace.short_name("void spectra_fft_kernel<float, 8>(float const*)") == "spectra_fft_kernel"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
