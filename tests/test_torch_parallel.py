"""The port's mesh layer (v3d_tpu_torch/parallel) against the JAX package's
(v3d_tpu/parallel/mesh.py, on the 8-device CPU mesh that conftest.py sets
up), with the port's ranks spawned on the CPU over gloo
(tests/torch_dist_helpers.py: no rank loads jax).

- ``make_mesh``: shapes and axis names as test_parallel.py's
  test_make_mesh_shapes (4 ranks: the default (4, 1) and (2, 2); a mesh
  that does not cover the world fails with JAX's message); ``shard_batch``
  and ``replicate`` on 2 ranks, exact (slices and copies); an indivisible
  leading axis raises ValueError on both sides.
- ``param_specs`` over every parameter of the tiny engine's UNet and CLIP,
  mapped through the JAX key maps, equals the JAX ``param_specs`` of the
  converted tree: ``Shard(0)`` <-> P(None, "model"), ``Shard(1)`` <->
  P("model", None), ``Replicate()`` <-> P().  ``shard_params``' local
  shard on each rank of a (2, 2) mesh equals, exactly, the JAX sharded
  array's shard at that rank's model index.
- ``train_diffusion.train`` at --model-axis 2 on 4 ranks equals --model-axis
  1 on 2 ranks bit for bit: the batch is split over "data" only, so both
  runs do the same sums in the same order (gloo's sum of two ranks is
  exact to commute), and every rank ends with the same parameters.
- ``DiffusionTrainer(mesh=)`` refuses parameters that are not on its
  rank's mesh device (the broadcast is in place).
- No fallback: ``make_mesh`` without CUDA raises unless device="cpu";
  without a process group it raises; NCCL is not taken on the CPU, nor
  gloo quietly on the card; a collective that one rank never joins fails
  the other within its timeout (3 s here).
- The dry run: ``python -m v3d_tpu_torch.parallel.dryrun --nproc 2 --device
  cpu --rung small`` exits 0 with every stage's OK line.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from torch_dist_helpers import parallel_four, parallel_two, run_ranks
from torch_port_helpers import MAP_CLIP, MAP_UNET, to_flax
from v3d_tpu.parallel import mesh as jmesh
from v3d_tpu_torch.apps import train_diffusion
from v3d_tpu_torch.engines.builder import build_tiny_engine
from v3d_tpu_torch.parallel import mesh

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_ranks(parallel_two, 2, tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_ranks(parallel_four, 4, tmp_path_factory.mktemp("four"))


@pytest.fixture(scope="module")
def tiny():
    return build_tiny_engine(num_frames=4, device="cpu")


def test_make_mesh_shapes(two, four):
    jm = jmesh.make_mesh(model=1)
    assert jm.devices.shape == (len(jax.devices()), 1)
    assert jmesh.make_mesh(data=4, model=2).devices.shape == (4, 2)
    for r in four:
        assert r["shape_default"] == (4, 1)
        assert r["shape"] == (2, 2)
        assert r["names"] == tuple(jm.axis_names) == ("data", "model")
        assert r["bad_mesh"] == "mesh 3x2 != 4 devices"
    with pytest.raises(AssertionError, match="mesh 3x2 != 8 devices"):
        jmesh.make_mesh(data=3, model=2)
    assert [r["coord"] for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["data_index"] for r in two] == [0, 1]
    assert all(r["shape"] == (2, 1) and r["data_ranks"] == [0, 1] for r in two)
    assert all(r["shape_model2"] == (1, 2) for r in two)
    assert [r["model_index"] for r in two] == [0, 1]


def test_shard_batch_and_replicate(two):
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    for rank, r in enumerate(two):
        got = r["sharded"]
        np.testing.assert_array_equal(got["x"], x[8 * rank:8 * rank + 8])
        assert got["s"] == 3.0 and got["s"].ndim == 0
        assert torch.equal(got["t"], torch.arange(6)[3 * rank:3 * rank + 3])
        assert got["n"] == 4 and got["name"] == "orbit"
        np.testing.assert_array_equal(got["nested"][0], np.ones((2, 2)))
        np.testing.assert_array_equal(r["sharded_model2"]["x"], x)  # data = 1
        assert "leading axis 3" in r["indivisible"]
        rep = r["replicated"]
        assert torch.equal(rep["w"], torch.zeros(3, 3))
        assert rep["h"].dtype == torch.bfloat16 and torch.equal(
            rep["h"], torch.ones(2, dtype=torch.bfloat16))
        assert torch.equal(rep["a"], torch.zeros(2))
    # JAX: the leading dim on "data", scalars replicated; 3 rows on 8
    # devices is refused
    jm = jmesh.make_mesh(model=1)
    out = jmesh.shard_batch({"x": np.zeros((16, 4)), "s": np.asarray(3.0)}, jm)
    assert out["x"].sharding.spec == P("data", None) and out["s"].sharding.spec == P()
    with pytest.raises(ValueError):
        jmesh.shard_batch({"x": np.zeros((3, 2))}, jm)


def _jax_spec_to_port(spec):
    return {P(None, "model"): Shard(0), P("model", None): Shard(1),
            P(): Replicate()}[spec]


@pytest.mark.parametrize("part, key_map", [("unet", MAP_UNET), ("clip", MAP_CLIP)])
def test_param_specs_match_jax(tiny, part, key_map):
    module = getattr(tiny, part)
    specs = mesh.param_specs(module)
    jspecs = jmesh.param_specs(to_flax(module, key_map))
    sharded = 0
    for name, spec in specs.items():
        tree = jspecs["params"]
        for k in key_map(name)[0]:
            tree = tree[k]
        assert spec == _jax_spec_to_port(tree), name
        sharded += spec != Replicate()
    assert sharded > 0


def test_shard_params_local_shards_match_jax(four, tiny):
    jm = jmesh.make_mesh(data=4, model=2)
    jsharded = jmesh.shard_params(to_flax(tiny.unet, MAP_UNET), jm)
    position = {d: tuple(int(i) for i in np.argwhere(jm.devices == d)[0])
                for d in jm.devices.flat}
    state = tiny.unet.state_dict()
    for r in four:
        model_index = r["coord"][1]
        for name, local in r["local"].items():
            path, fn = MAP_UNET(name)
            arr = jsharded["params"]
            for k in path:
                arr = arr[k]
            want = next(np.asarray(s.data) for s in arr.addressable_shards
                        if position[s.device][1] == model_index)
            np.testing.assert_array_equal(np.asarray(fn(local)), want, err_msg=name)
            assert r["global_shape"][name] == tuple(state[name].shape)
            if "Shard" not in r["placements"][name]:
                assert torch.equal(local, state[name]), name


def test_model_axis_two_equals_model_axis_one(two, four):
    ref = two[0]["train"]
    assert len(ref["stats"]) == 3 and all(np.isfinite(s["loss"]) for s in ref["stats"])
    got = four[0]["train"]
    assert [(s["loss"], s["grad_norm"]) for s in got["stats"]] == [
        (s["loss"], s["grad_norm"]) for s in ref["stats"]]
    assert all(r["train"]["stats"] == [] for r in two[1:] + four[1:])   # rank 0 logs
    for r in two + four:
        for key in ("params", "ema"):
            for name, x in ref[key].items():
                assert torch.equal(r["train"][key][name], x), (key, name)


def test_a_collective_that_hangs_fails_within_its_timeout(two):
    name, seconds = two[0]["hang"]
    assert seconds < 3 + 20, (name, seconds)


def test_ranks_load_no_jax(two, four):
    assert all(r["foreign"] == [] for r in two + four)


def test_trainer_refuses_parameters_off_its_mesh_device(tiny):
    # the trainer replicates its parameters in place: one on another device
    # than its rank's would be broadcast into a copy and left as it was
    from v3d_tpu_torch.engines.trainer import DiffusionTrainer

    with pytest.raises(ValueError, match="mesh device is meta"):
        DiffusionTrainer(tiny, mesh=mesh.single_device_mesh("meta"))


def test_no_fallback(monkeypatch):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_distributed(rank=0, world_size=1)
    with pytest.raises(ValueError, match="nccl"):
        mesh.init_distributed("cpu", backend="nccl", rank=0, world_size=1)
    local = mesh.single_device_mesh("cpu")
    assert local.shape == (1, 1) and local.mesh_dim_names == ("data", "model")
    batch = {"x": torch.arange(4)}
    assert torch.equal(mesh.shard_batch(batch, local)["x"], batch["x"])
    assert torch.equal(mesh.replicate({"w": torch.ones(2)}, local)["w"], torch.ones(2))
    # the CLI outside torchrun stays one process: a model axis there is refused
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit):
        train_diffusion.main(["--data", "synthetic", "--device", "cpu",
                              "--model-axis", "2"])


def test_dryrun_small_rung_on_two_cpu_ranks(tmp_path):
    # a thread a rank: the suite's other workers share the cores
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = tmp_path / "dryrun.json"
    proc = subprocess.run(
        [sys.executable, "-m", "v3d_tpu_torch.parallel.dryrun", "--nproc", "2",
         "--device", "cpu", "--rung", "small", "--timeout", "120",
         "--join-timeout", "420", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=480)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for stage in ("dryrun DP fine-tune", "dryrun sampling parity", "dryrun recon DP",
                  "dryrun GS refpoint [small]", "dryrun NeuS refpoint [small]"):
        line = next(ln for ln in proc.stdout.splitlines() if ln.startswith(stage))
        assert line.endswith(" OK"), line
    assert "ALL STAGES DONE" in proc.stdout
    report = json.loads(out.read_text())
    assert report["backend"] == "gloo" and len(report["ranks"]) == 2
    assert report["ranks"][0]["refpoint"]["gs"]["render_max_abs"] <= 2e-5
    assert all(r["train"]["min_cos"] >= 0.999 for r in report["ranks"])
    assert all(r["sampling"]["max_abs"] <= 1e-2 for r in report["ranks"])
