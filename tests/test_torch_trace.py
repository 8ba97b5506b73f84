"""The port's spans and its UNet counter (``v3d_tpu_torch/utils/trace.py``).

On the CPU: nesting, parent and unit ids; nothing kept while recording is
off; recording under a ``torch.profiler`` session and inside
``trace.recording()``; the bounded buffer; a span on the exported trace's
clock; the spans of ``sample_one`` on the tiny engine, of the image engine
and of a tiny fine-tune step; the counter.  On the card (``gpu``): a span
around K6 and K1 launches holds their launch calls and gets their device
time, under a profiler that records CUDA activity only:

    python -m pytest tests/test_torch_trace.py --noconftest -o addopts= -q -s -m gpu
"""

import json
import threading
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from v3d_tpu_torch.utils import trace
from v3d_tpu_torch.utils.trace import UNET_FORWARD, span


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.take()
    yield
    trace.take()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_spans_nest_with_parent_and_unit_ids():
    with trace.recording() as got:
        with span("a") as a:
            with span("b", rows=3) as b:
                with span("c") as c:
                    pass
            with span("d") as d:
                pass
        with span("e") as e:
            pass
    assert [s.name for s in got] == ["c", "b", "d", "a", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (None, a.id, b.id, a.id, None)
    assert a.root == b.root == c.root == d.root == a.id and e.root == e.id
    assert len({a.id, b.id, c.id, d.id, e.id}) == 5
    assert b.attrs == {"rows": 3} and a.thread == threading.get_ident()
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns
    assert b.as_dict()["attrs"] == {"rows": 3} and b.as_dict()["parent"] == a.id


def test_nothing_kept_while_off():
    with span("off") as s:
        time.sleep(0.002)
    assert s.id is None and s.seconds >= 0.002
    assert trace.take() == []


def test_recording_under_a_profiler_and_a_recording_block():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("profiled") as p:
            pass
    assert [s.name for s in trace.take()] == ["profiled"] and p.id is not None
    with trace.recording() as got:
        with span("recorded"):
            pass
    assert [s.name for s in got] == ["recorded"]
    assert trace.take() == []        # a recording block's spans leave the buffer


def test_bounded_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    before = trace.dropped()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with span("s", i=i):
                pass
    assert [s.attrs["i"] for s in trace.take()] == [0, 1, 2]
    assert trace.dropped() == before + 2


def test_span_on_the_profiler_clock(tmp_path):
    """The ``record_function`` event taken inside a span lies inside it on
    the exported trace's base (``ts`` us after ``baseTimeNanoseconds``),
    within 2 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer") as s:
            time.sleep(0.003)
            with record_function("mark"):
                torch.ones(64).sum()
            time.sleep(0.003)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    mark = next(e for e in doc["traceEvents"] if e.get("name") == "mark")
    start = doc["baseTimeNanoseconds"] + mark["ts"] * 1e3
    end = start + mark["dur"] * 1e3
    assert s.start_ns - 2e6 <= start <= end <= s.end_ns + 2e6
    assert start - s.start_ns >= 1e6 and s.end_ns - end >= 1e6    # the sleeps


def _tiny_generation(decoding_t=2):
    import chip_smoke
    from v3d_tpu_torch.apps.generate import sample_one
    from v3d_tpu_torch.engines.builder import build_tiny_engine

    engine = build_tiny_engine(num_frames=4, num_steps=2, device="cpu")
    return lambda: sample_one(chip_smoke.synthetic_image(96), engine=engine, num_frames=4,
                              num_steps=2, resolution=64, decoding_t=decoding_t,
                              device="cpu")


def test_sample_one_timings_and_spans():
    run = _tiny_generation()
    _, _, timings = run()
    assert list(timings) == ["cond_s", "sample_s", "decode_s"]
    assert all(v > 0 for v in timings.values())
    assert trace.take() == []
    before = dict(UNET_FORWARD)
    with trace.recording() as got:
        frames, _, timings = run()
    assert frames.shape == (4, 64, 64, 3)
    assert UNET_FORWARD["forwards"] - before["forwards"] == 2
    assert UNET_FORWARD["rows"] - before["rows"] == 2 * 8     # CFG doubles the 4 frames
    (req,) = _named(got, "generate.request")
    (cond,), (sample,), (decode,) = (_named(got, f"generate.{k}")
                                     for k in ("cond", "sample", "decode"))
    assert req.parent is None and all(s.root == req.id for s in got)
    assert cond.parent == sample.parent == decode.parent == req.id
    assert timings == {"cond_s": cond.seconds, "sample_s": sample.seconds,
                       "decode_s": decode.seconds}
    assert [s.parent for s in _named(got, "clip.forward") + _named(got, "vae.encode")] == \
        [cond.id, cond.id]
    (run_,) = _named(got, "sampler.run")
    steps = _named(got, "sampler.step")
    assert run_.parent == sample.id and [s.parent for s in steps] == [run_.id] * 2
    assert [s.attrs["step"] for s in steps] == [0, 1]
    unets = _named(got, "unet.forward")
    assert [u.parent for u in unets] == [s.id for s in steps]
    assert [u.attrs["rows"] for u in unets] == [8, 8]
    decodes = _named(got, "vae.decode")
    assert [d.attrs["frames"] for d in decodes] == [2, 2]
    assert all(d.parent == decode.id for d in decodes)
    for s in got:
        parent = next((p for p in got if p.id == s.parent), None)
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


class _Echo(torch.nn.Module):
    """A UNet that hands x back: (n, c, h, w) in, the same out."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x, c_noise, context=None, y=None, **kw):
        return x * self.w


def test_image_engine_spans_and_the_counter():
    from v3d_tpu_torch.diffusion.denoise import Denoiser
    from v3d_tpu_torch.diffusion.discretize import EDMDiscretization
    from v3d_tpu_torch.diffusion.sampling import EulerEDMSampler
    from v3d_tpu_torch.diffusion.scaling import EDMScaling
    from v3d_tpu_torch.engines.image_diffusion import ImageDiffusionEngine

    eng = ImageDiffusionEngine(unet=_Echo(), denoiser=Denoiser(scaling=EDMScaling()),
                               sampler=EulerEDMSampler(discretization=EDMDiscretization(),
                                                       num_steps=3),
                               vae_decoder=lambda z: z[:, :3])
    before = dict(UNET_FORWARD)
    with trace.recording() as got:
        z = eng.sample({}, {}, batch=2, height=16, width=16)
        images = eng.decode(z)
    assert images.shape == (2, 2, 2, 3)
    assert UNET_FORWARD == {"forwards": before["forwards"] + 3, "rows": before["rows"] + 6}
    assert Counter(s.name for s in got) == {"sampler.run": 1, "sampler.step": 3,
                                            "unet.forward": 3, "vae.decode": 1}
    steps = _named(got, "sampler.step")
    assert [u.parent for u in _named(got, "unet.forward")] == [s.id for s in steps]
    assert _named(got, "vae.decode")[0].attrs == {"frames": 2}


def test_make_unet_network_fn_counts():
    from v3d_tpu_torch.engines.wrappers import make_unet_network_fn

    net = make_unet_network_fn(_Echo(), 2)
    before = dict(UNET_FORWARD)
    out = net(torch.zeros(6, 4, 4, 3), torch.zeros(6), {})
    assert out.shape == (6, 4, 4, 3)
    assert UNET_FORWARD == {"forwards": before["forwards"] + 1, "rows": before["rows"] + 6}
    assert trace.take() == []


def test_train_step_spans():
    from v3d_tpu_torch.apps.train_diffusion import batches
    from v3d_tpu_torch.data.objaverse import SyntheticOrbitDataset
    from v3d_tpu_torch.engines.builder import build_tiny_engine
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer

    eng = build_tiny_engine(num_frames=4, device="cpu",
                            unet_overrides=dict(use_checkpoint=True))
    trainer = DiffusionTrainer(eng, num_frames=4)
    data = batches(eng, SyntheticOrbitDataset(2, 4, 8, clip_dim=64), 1, 4)
    try:
        with trace.recording() as got:
            batch = next(data)
            stats = trainer.train_step(batch["latents"], batch["cond"])
    finally:
        data.close()
    assert stats["step"] == 1
    (prep,) = _named(got, "train.prepare_batch")
    (step,) = _named(got, "trainer.step")
    assert prep.parent is None and step.parent is None and step.attrs == {"step": 0}
    parts = {k: _named(got, f"trainer.{k}") for k in
             ("forward", "backward", "update", "sync", "optimizer", "ema", "all_reduce")}
    assert {k: len(v) for k, v in parts.items()} == {
        "forward": 1, "backward": 1, "update": 1, "sync": 1, "optimizer": 1, "ema": 1,
        "all_reduce": 0}
    assert all(parts[k][0].parent == step.id for k in ("forward", "backward", "update", "sync"))
    assert parts["optimizer"][0].parent == parts["ema"][0].parent == parts["update"][0].id
    (unet,) = _named(got, "unet.forward")
    assert unet.parent == parts["forward"][0].id and unet.attrs == {"rows": 4}
    order = [parts[k][0] for k in ("forward", "backward", "update", "sync")]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))


MARGIN_S = 0.002


@pytest.mark.gpu
def test_span_holds_its_kernel_launches_on_the_card(tmp_path):
    """K6 and K1 at the generation's shapes, launched three times each
    inside a span under a CUDA-only profiler, ``MARGIN_S`` of host time
    before the first and after the last: every launch call lies in the span
    on the trace's base (the clocks agree to within the margin), and the
    span gets the kernels' device time (``portbench/bench/spans.py``).
    Prints the clocks' offset: how long after the host clock's reading each
    launch call began."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see module docstring)")
    from portbench.bench import spans as bench_spans
    from v3d_tpu_torch.ops.attention import flash_attn_fwd
    from v3d_tpu_torch.ops.group_norm import group_norm_fwd

    dev = torch.device("cuda")
    x = torch.randn(36, 320, 64, 64, device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    scale, bias = torch.ones(320, device=dev), torch.zeros(320, device=dev)
    q, k, v = (torch.randn(36, 5, 4096, 64, device=dev).to(torch.bfloat16) for _ in range(3))

    def k6():
        return group_norm_fwd(x, scale, bias, 32, 1e-5, True)

    def k1():
        return flash_attn_fwd(q, k, v)

    k6(), k1()
    torch.cuda.synchronize()
    reads = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with span("probe") as probe:
            time.sleep(MARGIN_S)
            for _ in range(3):
                for fn in (k6, k1):
                    reads.append(time.time_ns())
                    fn()
            time.sleep(MARGIN_S)
        torch.cuda.synchronize()
    taken = [s.as_dict() for s in trace.take()]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ours = {e["args"].get("correlation"): e["name"] for e in events
            if e.get("cat") == "kernel" and ("gn_" in e["name"] or "flash_fwd" in e["name"])}
    launches = sorted(base + e["ts"] * 1e3 for e in events
                      if e.get("cat") in bench_spans.LAUNCH_CATS
                      and e.get("args", {}).get("correlation") in ours)
    assert len(launches) >= 6, (len(launches), sorted(set(ours.values())))
    assert all(probe.start_ns <= t <= probe.end_ns for t in launches), (
        [(t - probe.start_ns) / 1e3 for t in launches], probe.seconds * 1e6)
    tr = bench_spans.load_trace(path)
    att = bench_spans.attribute(tr, taken)
    kernels = sum(e["dur"] for e in events if e.get("cat") == "kernel"
                  and e["args"].get("correlation") in ours) / 1e6
    # the trace's ts are ~1e12 us: a duration read back as end - start is
    # exact to ~1e-4 us
    assert att.device_s[probe.id] >= kernels * (1 - 1e-6) and kernels > 0
    offsets = [t - max((r for r in reads if r <= t), default=reads[0]) for t in launches]
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}: launch calls "
          f"{min(offsets) / 1e3:.1f}-{max(offsets) / 1e3:.1f} us after the host clock read "
          f"before each call; the first {(launches[0] - probe.start_ns) / 1e3 - 1e6 * MARGIN_S:.1f}"
          f" us after the span's margin, the last "
          f"{(probe.end_ns - launches[-1]) / 1e3 - 1e6 * MARGIN_S:.1f} us before its closing "
          f"margin; span device {1e3 * att.device_s[probe.id]:.3f} ms, K6 + K1 "
          f"{1e3 * kernels:.3f} ms")
