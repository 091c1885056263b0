"""The trace arithmetic on a hand-made Chrome trace: the union of device
intervals, launch counts, kernel sums and idle gaps by host operation."""

import pytest

from portbench.trace import SPAN, Trace


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


@pytest.fixture
def trace():
    return Trace([
        _x("user_annotation", SPAN, 0, 100),
        _x("kernel", "void take_wsum_kernel<4>", 10, 10),
        _x("kernel", "void rows_kernel<Run>", 15, 15),
        _x("kernel", "DeviceRadixSortOnesweepKernel", 50, 10),
        _x("gpu_memcpy", "Memcpy HtoD", 70, 5),
        _x("kernel", "late", 95, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 9, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 49, 1),
        _x("cuda_driver", "cuLaunchKernel", 94, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 101, 1),
        _x("cuda_runtime", "cudaMemcpyAsync", 69, 1),
        _x("cpu_op", "outer", 0, 100),
        _x("cpu_op", "aten::mul", 35, 10),
        _x("cpu_op", "aten::add", 60, 20, tid=2),
    ])


def test_busy_is_the_union_inside_the_span(trace):
    assert trace.window_s == pytest.approx(100e-6)
    # [10, 30] + [50, 60] + [70, 75] + [95, 100] (clipped).
    assert trace.busy_s() == pytest.approx(40e-6)
    assert trace.launches == 3


def test_kernel_sums_by_pattern(trace):
    assert trace.seconds(("take_wsum_kernel",)) == pytest.approx(10e-6)
    assert trace.seconds(("rows_kernel", "RadixSort")) == pytest.approx(
        25e-6)
    assert trace.seconds(("kernel",), exclude=("rows",)) == pytest.approx(
        10e-6)
    assert trace.top_ops(1)[0][0] == "late"


def test_idle_gaps_by_innermost_host_operation(trace):
    gaps = dict(trace.idle_gaps())
    # Gaps [0, 10], [30, 50], [60, 70], [75, 95]; midpoints 5, 40, 65, 85.
    assert gaps["aten::mul"] == pytest.approx(20e-6)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    assert gaps["outer"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_the_window_traces_its_units_and_runs_its_time():
    from portbench.kinds.common import run_window

    class Cell:
        seconds, trace = 0.05, True
        events = []

        def profile(self):
            cell = self

            class P:
                def start(self):
                    cell.events.append("start")

                def stop(self):
                    cell.events.append("stop")
                    return "trace"
            return P()

        def sync(self):
            self.events.append("sync")

    cell, seen = Cell(), []
    win = run_window(cell, lambda i, traced: seen.append((i, traced)), 2, 3)
    assert [t for _, t in seen[:6]] == [False, False, True, True, True,
                                        False]
    assert win.trace == "trace" and win.units == len(seen) >= 6
    assert win.seconds >= 0.05 and cell.events[-1] == "sync"
    assert len(win.stamps) == win.units + 1
