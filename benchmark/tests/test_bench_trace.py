"""The reduction of a profiler trace to what the per-layer metrics read,
on a hand-made trace."""
import pytest

import harness
import traced


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    _x("user_annotation", traced.WINDOW_SPAN, 1000.0, 1000.0),
    _x("kernel", "gemm", 900.0, 200.0, tid=7),          # 100 us inside
    _x("kernel", "attention_bwd_wgmma_kernel<208>", 1200.0, 100.0, tid=7),
    _x("kernel", "attention_bwd_wgmma_kernel<208>", 1250.0, 100.0, tid=7),
    _x("gpu_memcpy", "Memcpy HtoD", 1500.0, 50.0, tid=7),
    _x("kernel", "late", 1950.0, 100.0, tid=7),         # 50 us inside
    _x("cuda_runtime", "cudaLaunchKernel", 1190.0, 5.0),
    _x("cuda_runtime", "cuLaunchKernelEx", 1240.0, 5.0),
    _x("cuda_runtime", "cudaLaunchKernel", 2500.0, 5.0),  # outside
    _x("cpu_op", "aten::mm", 1100.0, 100.0),
    _x("cpu_op", "aten::copy_", 1360.0, 200.0, tid=2),
    _x("cpu_op", "aten::add", 1380.0, 10.0, tid=2),
]


def test_busy_launches_and_kernels():
    s = traced.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    # 1000-1100, 1200-1350, 1500-1550, 1950-2000
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["launches"] == 2
    assert traced.kernel_seconds(s, "attention_bwd_wgmma_kernel") == (
        2, pytest.approx(200e-6))


def test_idle_gaps_are_named_by_the_innermost_host_op():
    s = traced.summarize(EVENTS)
    gaps = dict(s["idle_gaps"])
    # 1100-1200 (midpoint 1150, aten::mm), 1350-1500 (1425, aten::copy_),
    # 1550-1950 (1750, nothing)
    assert gaps["aten::mm"] == pytest.approx(100e-6)
    assert gaps["aten::copy_"] == pytest.approx(150e-6)
    assert gaps[traced.IDLE_LABEL] == pytest.approx(400e-6)


def test_no_window_span_gives_nothing():
    assert traced.summarize(EVENTS[1:]) == {}


@pytest.mark.parametrize("metric", ["train.device_idle", "judge.device_idle",
                                    "serve.device_idle"])
def test_idle_share_reader(metric):
    s = traced.summarize(EVENTS)
    assert harness.metric_reader(metric).read({"trace": s}) == \
        pytest.approx(65.0)


def test_k2_roofline_reader():
    import roofline
    s = traced.summarize(EVENTS)
    shape = {"n": 197, "hidden": 1024}
    got = harness.metric_reader("train.k2_roofline").read(
        {"trace": s, "calls": {"k2": 2}, "batch": 8, "shape": shape})
    assert got == pytest.approx(100 * roofline.k2_bound_s(8, 197, 1024)
                                / 100e-6)
