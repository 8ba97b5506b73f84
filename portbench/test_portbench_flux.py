"""The cells of FLUX.1-dev and of the four-rank fine-tune at toy size on the
CPU, and their per-layer readers on a small trace with known answers.

- ``flux1-dev.txt2img`` (``configs/flux1-dev.py`` ``tiny_cell``: hidden
  128, 2 heads of 64, 2 + 2 blocks, a 64^2 image, 4 steps) through
  ``session.run`` in float32: ``correct``, every compared gap at rounding
  level; in bf16 the control fails a limit where the program passes.
- the published ``transformer`` and ``vae`` sections build the models the
  cell runs: their widths, depth and the parameter counts the
  configuration states.
- ``v3d512.finetune.dp4`` (``tiny.py``) over 4 gloo ranks on the CPU:
  ``correct``; the control, and rank 0 stepping on its own slice (its
  gradients left out of the exchange), each fail a limit where the
  program passes; ``work`` is one rank's step.
- ``bench/blocks.py`` and the readers of ``k9_roofline.flux``,
  ``double_ms.flux``, ``single_ms.flux``, ``joint_attn_ms.flux`` and
  ``allreduce_ms.dp``.

    python -m pytest portbench/test_portbench_flux.py -q
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from portbench.bench import control, faults, manifest, session, spans
from portbench.bench.seeded import seed_for
from portbench.tiny import tiny_cell

torch.set_num_threads(2)
SEED = 2**31 + 33


def _flux_cell(dtype="float32"):
    mod = manifest.load_module(manifest.PKG / "configs" / "flux1-dev.py", "flux1-dev")
    return mod.tiny_cell(dtype=dtype)


def test_flux_models_are_built_from_the_published_sections():
    """``transformer/config.json``'s and ``vae/config.json``'s keys make the
    models the cell runs, whose parameters number what the configuration
    states."""
    from v3d_tpu_torch.models.flux import Flux
    from v3d_tpu_torch.models.vae import Decoder

    mod = manifest.load_module(manifest.PKG / "configs" / "flux1-dev.py", "flux1-dev")
    cfg = manifest.load_cell("flux1-dev.txt2img").config
    net, dec = mod.net_kwargs(cfg), mod.decoder_kwargs(cfg)
    assert net == dict(in_channels=64, vec_in_dim=768, context_in_dim=4096, hidden_size=3072,
                       num_heads=24, depth=19, depth_single_blocks=38, axes_dim=(16, 56, 56))
    assert dec == dict(ch=128, out_ch=3, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=16)
    with torch.device("meta"):
        built = {"transformer": Flux(**net), "vae_decoder": Decoder(**dec)}
    assert built["transformer"].single_blocks[0].mlp_hidden_dim == 12288
    assert {k: sum(p.numel() for p in m.parameters()) for k, m in built.items()} \
        == cfg["parameters"]
    ref = mod.build_reference(cfg, "serve", "meta", SEED)
    assert sum(p.numel() for p in ref.transformer.parameters()) \
        == cfg["parameters"]["transformer"]


def test_tiny_flux_cell_is_correct_at_rounding_level():
    result = session.run(_flux_cell(), SEED, 0.0, False, device="cpu")
    assert result["correct"], result["checks"]
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert checks["denoise"] <= 1e-5 and checks["step"] <= 1e-5
    assert checks["decode"] <= 1e-2          # the images' uint8 rounding
    assert set(result["metrics"]) == {"gen_s", "peak_gib", "setup_s"}


def test_tiny_flux_control_fails_where_the_program_passes():
    cell = _flux_cell("bfloat16")
    (_, program), (_, ctl) = control.readings(cell, SEED, True, device="cpu")
    assert all(program[k] <= v for k, v in cell.limits.items()), (program, cell.limits)
    assert any(ctl[k] > v for k, v in cell.limits.items()), (ctl, cell.limits)


def test_tiny_flux_work_counts_the_joint_attention_sites():
    cell = _flux_cell()
    entry = cell.entry.Entry(cell, SEED, "cpu")
    work = entry.work()
    assert work["joint_attention"] == [(1, 2, 23, 23, 64)] * 4
    assert work["flops"] > 0


def test_tiny_dp4_over_four_gloo_ranks_is_correct():
    cell = tiny_cell("v3d512.finetune.dp4", "float32")
    result = session.run(cell, SEED, 0.0, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4
    assert all(c["value"] < 1e-3 for c in result["checks"].values()), result["checks"]


def test_tiny_dp4_control_fails_where_the_program_passes():
    cell = tiny_cell("v3d512.finetune.dp4", "float32")
    (_, program), (_, ctl) = control.readings(cell, SEED, True, device="cpu")
    assert all(program[k] <= v for k, v in cell.limits.items()), (program, cell.limits)
    assert any(ctl[k] > v for k, v in cell.limits.items()), (ctl, cell.limits)


def _exchange_left_out(mp):
    """Rank 0 keeps its own gradients and loss: it still joins each
    all_reduce (on copies), so the other ranks do not wait, but steps on
    its own slice of the global batch."""
    from v3d_tpu_torch.engines import trainer

    real = trainer.all_reduce_mean_
    mp.setattr(trainer, "all_reduce_mean_",
               lambda tensors, mesh: real([t.clone() for t in tensors], mesh))


def test_tiny_dp4_exchange_left_out_fails_a_limit():
    cell = tiny_cell("v3d512.finetune.dp4", "float32")
    with faults.planted(_exchange_left_out):
        entry = control.program_run(cell, SEED, "cpu")
    got = entry.check(np.random.default_rng(seed_for(SEED, "check")))
    assert got["grad"] > cell.limits["grad"], (got, cell.limits)


def test_dp4_work_is_one_ranks_step():
    """The dp4 entry's work is the single cell's at one rank's videos: its
    attention sites are what rank 0's kernels run."""
    dp4 = tiny_cell("v3d512.finetune.dp4", "float32")
    one = tiny_cell("v3d512.finetune", "float32")
    one.traffic["params"]["videos"] = dp4.traffic["params"]["videos"]
    ranks = dp4.traffic["params"]["ranks"]
    entry = dp4.entry.Entry.__new__(dp4.entry.Entry)
    entry.cfg, entry.seed, entry.mod, entry.ranks = dp4.config, SEED, dp4.config_module, ranks
    entry.p = dict(dp4.traffic["params"], videos=dp4.traffic["params"]["videos"] * ranks)
    single = one.entry.Entry.__new__(one.entry.Entry)
    single.cfg, single.seed, single.mod, single.p = one.config, SEED, one.config_module, \
        one.traffic["params"]
    got, want = entry.work(), single.work()
    assert got["attention"] == want["attention"] and got["flops"] == want["flops"]
    assert entry.p["videos"] == dp4.traffic["params"]["videos"] * ranks


# -- the readers on a known trace ----------------------------------------------------

BASE = 1_790_000_000_000_000_000


def _span(sid, name, start_us, end_us, parent=None, **attrs):
    return {"name": name, "start_ns": BASE + int(start_us * 1e3),
            "end_ns": BASE + int(end_us * 1e3), "id": sid, "parent": parent,
            "root": 1, "thread": 7, "attrs": attrs}


# one step, one forward: a double block (its attention), a single block (its
# attention), the final layer
FLUX = [
    _span(1, "sampler.run", 0, 1000),
    _span(2, "sampler.step", 10, 990, 1, step=0),
    _span(3, "unet.forward", 20, 980, 2, rows=1),
    _span(4, "flux.double", 100, 400, 3, block=0),
    _span(5, "flux.attention", 200, 300, 4, tokens=23),
    _span(6, "flux.single", 400, 700, 3, block=0),
    _span(7, "flux.attention", 500, 600, 6, tokens=23),
    _span(8, "flux.final", 700, 800, 3),
]
# (correlation, launch call at, device start, device end)
FLUX_LAUNCHES = [(1, 150, 160, 170), (2, 250, 260, 290), (3, 450, 460, 465),
                 (4, 550, 560, 600), (5, 750, 760, 770)]
TRAINING = [
    _span(1, "trainer.step", 100, 1000, step=0),
    _span(2, "trainer.forward", 110, 300, 1),
    _span(3, "trainer.backward", 300, 600, 1),
    _span(4, "trainer.update", 600, 940, 1),
    _span(5, "trainer.all_reduce", 610, 700, 4),
]
TRAINING_LAUNCHES = [(1, 150, 160, 200), (2, 650, 660, 700), (3, 680, 705, 725),
                     (4, 800, 810, 820)]


class _Taken:
    def __init__(self, d):
        self.d = d

    def as_dict(self):
        return self.d


def _record(tmp_path, monkeypatch, span_list, launches, cell, steps=1, **extra):
    from v3d_tpu_torch.utils import trace as port_trace

    events = []
    for corr, at, s, e in launches:
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": at, "dur": 1, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": s,
                       "dur": e - s, "args": {"correlation": corr}})
    (tmp_path / f"{cell}.trace.json").write_text(json.dumps(
        {"baseTimeNanoseconds": BASE, "traceEvents": events}))
    monkeypatch.setattr(port_trace, "take", lambda: [_Taken(s) for s in span_list])
    rec = types.SimpleNamespace(cell=cell, profile=types.SimpleNamespace(units=1),
                                traffic={"params": {"num_steps": steps}}, **extra)
    spans.for_record(rec, tmp_path)
    return rec


@pytest.mark.parametrize("name,ms", [("double_ms.flux", 0.040), ("single_ms.flux", 0.045),
                                     ("joint_attn_ms.flux", 0.070)])
def test_flux_block_readers(tmp_path, monkeypatch, name, ms):
    rec = _record(tmp_path, monkeypatch, FLUX, FLUX_LAUNCHES, "f.gen")
    assert manifest.metric_reader(name).read(rec) == pytest.approx(ms)
    two = _record(tmp_path, monkeypatch, FLUX, FLUX_LAUNCHES, "f.gen", steps=2)
    assert manifest.metric_reader(name).read(two) is None     # the traffic says 2 steps
    bare = _record(tmp_path, monkeypatch, FLUX[:3], FLUX_LAUNCHES, "f.gen")
    assert manifest.metric_reader(name).read(bare) is None    # no block spans


def test_allreduce_reader(tmp_path, monkeypatch):
    rec = _record(tmp_path, monkeypatch, TRAINING, TRAINING_LAUNCHES, "t.train")
    # launches at 650 and 680 lie in trainer.all_reduce: 40 + 20 us
    assert manifest.metric_reader("allreduce_ms.dp").read(rec) == pytest.approx(0.060)
    alone = _record(tmp_path, monkeypatch, TRAINING[:4], TRAINING_LAUNCHES, "t.train")
    assert manifest.metric_reader("allreduce_ms.dp").read(alone) is None


def test_k9_roofline_reader():
    from portbench.bench.work import attention_work, bound_ms

    reader = manifest.metric_reader("k9_roofline.flux")
    site = (1, 24, 4608, 4608, 128)
    bound_s = bound_ms(*attention_work(*site, 2))[0] / 1e3
    prof = types.SimpleNamespace(
        units=1, kernel_s=lambda keys: 28 * 57 * 2 * bound_s if keys == ("flash_wide",) else 0)
    rec = types.SimpleNamespace(profile=prof, work={"joint_attention": [site] * 57},
                                traffic={"params": {"num_steps": 28}},
                                launches={"flash_attn_fwd_wide": 57 * 28})
    assert reader.read(rec) == pytest.approx(50.0)
    rec.launches = {"flash_attn_fwd_wide": 57 * 28 + 1}     # the routing moved
    assert reader.read(rec) is None
