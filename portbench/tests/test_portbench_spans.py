"""The readers of the program's spans on hand-made Chrome traces: device
idle time charged to the spans that cover it, nested spans, gaps that
straddle a span's edge, the render's exclusion of the forward, a span on a
second thread, and nothing read from a trace without the program's spans.
"""

import json
import os
from types import SimpleNamespace

import pytest

from conftest import ROOT
from portbench.run import read_metric
from portbench.trace import SPAN, Trace


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _span(name, ts, end, tid=1):
    return _x("user_annotation", name, ts, end - ts, tid)


def _run(kind, events, units):
    return SimpleNamespace(kind=kind, trace=Trace(events), units=units)


def _ms(us, units):
    return us * 1e-3 / units


@pytest.fixture
def train_run():
    # Idle gaps [0, 10], [30, 50], [60, 70], [75, 95]: 60 us.
    return _run("train", [
        _x("user_annotation", SPAN, 0, 100),
        _x("kernel", "a", 10, 20), _x("kernel", "b", 50, 10),
        _x("gpu_memcpy", "Memcpy HtoD", 70, 5), _x("kernel", "c", 95, 20),
        _x("cpu_op", "aten::mul", 35, 5),
        _span("ucnerf.data.sample", 0, 5),
        # Straddles the gap's end at 10: idle [5, 10] only.
        _span("ucnerf.data.to_device", 5, 12),
        _span("ucnerf.forward", 20, 65),
        _span("ucnerf.encode", 35, 45),        # nested in the forward
        _span("ucnerf.losses", 65, 67),
        _span("ucnerf.backward", 69, 100),
        # Another thread, as autograd's engine thread; clipped at 100.
        _span("ucnerf.optimizer", 85, 120, tid=7),
    ], units=2)


@pytest.mark.parametrize("name,us", [
    ("idle_forward_ms.train", 20 + 5),
    ("idle_encode_ms.train", 10),
    ("idle_losses_ms.train", 2),
    ("idle_backward_ms.train", 1 + 20),
    ("idle_optimizer_ms.train", 10),
])
def test_train_idle_is_the_gaps_inside_each_span(train_run, name, us):
    assert read_metric(name, train_run) == pytest.approx(_ms(us, 2))


def test_train_data_host_time_and_covered_share(train_run):
    # Host time: the union [0, 12] of the two data spans.
    assert read_metric("data_host_ms.train", train_run) == pytest.approx(
        _ms(12, 2))
    # Uncovered: the gap's stretch [67, 69] between losses and backward.
    assert read_metric("idle_covered.train", train_run) == pytest.approx(
        100.0 * 58 / 60)
    # A reader of the other kind reads nothing.
    assert read_metric("idle_forward_ms.render", train_run) is None
    assert read_metric("idle_forward_ms.train", SimpleNamespace(
        kind="render", trace=train_run.trace, units=2)) is None


@pytest.fixture
def render_run():
    # Idle gaps [0, 20], [40, 60], [80, 100]: 60 us.
    return _run("render", [
        _x("user_annotation", SPAN, 0, 100),
        _x("kernel", "a", 20, 20), _x("kernel", "b", 60, 20),
        _span("ucnerf.render", 10, 95),
        _span("ucnerf.forward", 15, 45),
        _span("ucnerf.encode", 42, 45),
        _span("ucnerf.forward", 55, 85),
        _span("ucnerf.data.to_device", 46, 50),
    ], units=1)


@pytest.mark.parametrize("name,value", [
    ("idle_forward_ms.render", _ms(5 + 5 + 5 + 5, 1)),
    ("idle_encode_ms.render", _ms(3, 1)),
    # [10, 15], [45, 55] and [85, 95] of the render lie outside a forward.
    ("idle_between_chunks_ms.render", _ms(5 + 10 + 10, 1)),
    ("idle_covered.render", 100.0 * (10 + 20 + 15) / 60),
])
def test_render_readers(render_run, name, value):
    assert read_metric(name, render_run) == pytest.approx(value)


def _new_readers():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [m["name"] for m in bench["per_layer"]
            if m["source"] == "program_span"]


def test_the_span_readers_are_the_program_span_metrics():
    assert sorted(_new_readers()) == sorted([
        "data_host_ms.train", "idle_forward_ms.train",
        "idle_encode_ms.train", "idle_losses_ms.train",
        "idle_backward_ms.train", "idle_optimizer_ms.train",
        "idle_covered.train", "idle_forward_ms.render",
        "idle_encode_ms.render", "idle_between_chunks_ms.render",
        "idle_covered.render"])


@pytest.mark.parametrize("name", _new_readers())
def test_a_trace_without_the_programs_spans_reads_nothing(name):
    """A program without the spans: every reader returns None, and none
    raises."""
    events = [_x("user_annotation", SPAN, 0, 100),
              _x("kernel", "a", 10, 20), _x("cpu_op", "aten::mul", 35, 10),
              _x("user_annotation", "other.forward", 20, 40)]
    for kind in ("train", "render"):
        assert read_metric(name, _run(kind, events, 2)) is None
        assert read_metric(name, SimpleNamespace(
            kind=kind, trace=None, units=2)) is None
