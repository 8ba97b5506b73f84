"""``bench/spans.py`` on a small chrome trace and span list with known
answers: device work by the span open at its launch call (the runtime
event of the same correlation), idle gaps by the span open at their
midpoint, "outside any span", the readers' numbers, and a reader falling
silent when the slice's span counts do not match the traffic.

    python -m pytest portbench/test_portbench_spans.py -q
"""

from __future__ import annotations

import json
import types

import pytest

from portbench.bench import manifest, spans

BASE = 1_790_000_000_000_000_000   # ns, the trace's baseTimeNanoseconds


def _span(sid, name, start_us, end_us, parent=None, **attrs):
    return {"name": name, "start_ns": BASE + int(start_us * 1e3),
            "end_ns": BASE + int(end_us * 1e3), "id": sid, "parent": parent,
            "root": 1, "thread": 7, "attrs": attrs}


# sampler.run [50, 950] > two steps, each > one unet.forward
SAMPLING = [
    _span(1, "sampler.run", 50, 950),
    _span(2, "sampler.step", 100, 500, 1, step=0),
    _span(3, "unet.forward", 150, 400, 2, rows=4),
    _span(4, "sampler.step", 500, 900, 1, step=1),
    _span(5, "unet.forward", 550, 800, 4, rows=4),
]
# (correlation, launch call at, device start, device end): the device runs
# behind the host, so a kernel may run after its span has closed
LAUNCHES = [
    (1, 160, 200, 300),     # unet 3
    (2, 450, 310, 320),     # step 2, outside its forward
    (3, 560, 600, 700),     # unet 5
    (4, 810, 720, 730),     # step 4
    (5, 980, 990, 1000),    # outside any span
    (6, 1200, 1300, 1400),  # outside any span
]


def _trace_doc(launches=LAUNCHES):
    events = []
    for corr, at, s, e in launches:
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": at, "dur": 3, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": s,
                       "dur": e - s, "args": {"correlation": corr}})
    events.append({"ph": "f", "cat": "ac2g", "ts": 5, "id": 1})
    return {"baseTimeNanoseconds": BASE, "traceEvents": events}


def _load(tmp_path, doc):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    return spans.load_trace(path)


def test_work_by_launch_call_and_idle_by_midpoint(tmp_path):
    att = spans.attribute(_load(tmp_path, _trace_doc()), SAMPLING)
    us = {k: round(v * 1e6, 6) for k, v in att.device_s.items()}
    assert us == {3: 100, 2: 10, 5: 100, 4: 10, None: 110}
    # gaps: [300, 310] mid 305 in unet 3; [320, 600] mid 460 in step 2;
    # [700, 720] mid 710 in unet 5; [730, 990] mid 860 in step 4;
    # [1000, 1300] mid 1150 outside any span
    idle = {k: round(v * 1e6, 6) for k, v in att.idle_s.items()}
    assert idle == {3: 10, 2: 280, 5: 20, 4: 260, None: 300}
    assert round(att.busy_s * 1e6, 6) == 330
    run = att.named("sampler.run")
    assert round(att.device(run) * 1e6, 6) == 220
    assert round(att.idle(run) * 1e6, 6) == 570
    assert round(att.interval_s(run) * 1e6, 6) == 530      # 200 .. 730
    assert [s["id"] for s in att.named("unet.forward", under="sampler.step")] == [3, 5]
    names = {n: round(s * 1e6, 6) for n, s, _ in att.idle_by_name()}
    assert names == {"sampler.step": 540, spans.OUTSIDE: 300, "unet.forward": 30}


def test_innermost_span_across_threads_and_unmatched_work(tmp_path):
    """A span opened later on another thread is the innermost while it is
    open (autograd's backward thread); work with no launch event is outside."""
    spans_ = [_span(1, "trainer.backward", 0, 100), _span(2, "other", 40, 60)]
    spans_[1]["thread"] = 8
    doc = _trace_doc([(1, 10, 20, 30), (2, 50, 55, 58), (3, 70, 80, 90)])
    doc["traceEvents"].append({"ph": "X", "cat": "gpu_memcpy", "ts": 95, "dur": 2,
                               "args": {"correlation": 99}})
    att = spans.attribute(_load(tmp_path, doc), spans_)
    us = {k: round(v * 1e6, 6) for k, v in att.device_s.items()}
    assert us == {1: 20, 2: 3, None: 2}
    idle = {k: round(v * 1e6, 6) for k, v in att.idle_s.items()}
    assert idle == {2: 25, 1: 27}          # [30, 55] mid 42.5; [58, 80]; [90, 95]


class _Taken:
    def __init__(self, d):
        self.d = d

    def as_dict(self):
        return self.d


def _record(tmp_path, monkeypatch, span_list, cell="x.gen", units=1, steps=2):
    from v3d_tpu_torch.utils import trace as port_trace

    (tmp_path / f"{cell}.trace.json").write_text(json.dumps(_trace_doc()))
    monkeypatch.setattr(port_trace, "take", lambda: [_Taken(s) for s in span_list])
    rec = types.SimpleNamespace(cell=cell, profile=types.SimpleNamespace(units=units),
                                traffic={"params": {"num_steps": steps}})
    return rec


def test_generation_readers(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, SAMPLING)
    assert spans.for_record(rec, tmp_path) is spans.for_record(rec, tmp_path)
    got = spans.sampling(rec)
    assert got["steps"] == 2
    assert got["unet_ms"] == pytest.approx(0.100)
    assert got["glue_ms"] == pytest.approx(0.010)
    assert got["idle_ms"] == pytest.approx(0.285)
    assert got["interval_ms"] == pytest.approx(0.530)
    written = json.loads((tmp_path / "x.gen.spans.json").read_text())
    assert written["baseTimeNanoseconds"] == BASE and len(written["traceEvents"]) == 5
    first = written["traceEvents"][0]
    assert (first["ts"], first["dur"], first["args"]["id"]) == (50, 900, 1)
    lines = spans.lines(rec)
    assert any("outside any span 0.300 ms" in line for line in lines)
    assert spans.lines(rec) == []          # said once a run


@pytest.mark.parametrize("name,value", [("unet_device_ms.gen", 0.100),
                                        ("step_glue_ms.gen", 0.010),
                                        ("step_idle_ms.gen", 0.285)])
def test_a_reader_falls_silent_on_a_wrong_span_count(tmp_path, monkeypatch, name, value):
    reader = manifest.metric_reader(name)
    rec = _record(tmp_path, monkeypatch, SAMPLING)
    spans.for_record(rec, tmp_path)
    assert reader.read(rec) == pytest.approx(value)
    rec3 = _record(tmp_path, monkeypatch, SAMPLING, steps=3)    # the traffic says 3
    spans.for_record(rec3, tmp_path)
    assert reader.read(rec3) is None
    rec_fewer = _record(tmp_path, monkeypatch, SAMPLING[:-1])   # a step without its forward
    spans.for_record(rec_fewer, tmp_path)
    assert reader.read(rec_fewer) is None


TRAINING = [
    _span(1, "trainer.step", 100, 1000, step=0),
    _span(2, "trainer.forward", 110, 300, 1),
    _span(3, "unet.forward", 120, 290, 2, rows=8),
    _span(4, "trainer.backward", 300, 600, 1),
    _span(5, "trainer.update", 600, 940, 1),
    _span(6, "trainer.sync", 940, 1000, 1),
]


def test_training_readers(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, TRAINING, cell="x.train")
    spans.for_record(rec, tmp_path)
    got = spans.training(rec)
    # launch calls at 160 (forward's unet) 100 us; 450 and 560 (backward)
    # 10 + 100; 810 (update) 10; 980 (sync) 10; 1200 (outside) 100
    assert got["forward_ms"] == pytest.approx(0.100)
    assert got["backward_ms"] == pytest.approx(0.110)
    assert got["update_ms"] == pytest.approx(0.010)
    # idle 870 us in all, 10 + 280 of it in backward ([300, 310], [320, 600])
    assert got["edge_idle_ms"] == pytest.approx(0.580)
    assert got["busy_ms"] == pytest.approx(0.330)
    for name in ("forward_ms.train", "backward_ms.train", "update_ms.train",
                 "edge_idle_ms.train"):
        assert manifest.metric_reader(name).read(rec) == pytest.approx(got[name[:-6]])
    two = _record(tmp_path, monkeypatch, TRAINING, cell="x.train", units=2)
    spans.for_record(two, tmp_path)
    assert spans.training(two) is None


def test_silent_without_a_slice_or_spans(tmp_path, monkeypatch):
    rec = types.SimpleNamespace(cell="x.gen", profile=None, traffic={"params": {}})
    assert spans.for_record(rec) is None and spans.sampling(rec) is None
    rec = _record(tmp_path, monkeypatch, [])
    assert spans.for_record(rec, tmp_path) is None
    assert spans.training(rec) is None and spans.lines(rec) == []
