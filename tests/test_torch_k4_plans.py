"""K4 (the 3DGS compositor forward, T10) on the CPU: the plain version of
its checkpoints (``ops/gs_composite.py composite_checkpoints_plain``: ts,
last, k_stop, which K5 reads) against the JAX package's Pallas kernel
``composite_tiles_fwd`` in interpret mode on the cases of
tests/test_torch_gs_composite.py, the cull's invariance, K4's table of
the cull's boxes in whole pixels (``reach_boxes``) against ``tile_reach``
and the alpha test, and what the wrapper hands its kernel (recorded by a
stand-in launch).

Tolerances:
- k_stop equal to the JAX kernel's out row 6 (exact);
- ts[:k_stop] and the final T (out row 5) within rtol 1e-5 where the pixel
  is live (JAX's T >= 1e-4; its T is a product in another order, a
  Hillis-Steele scan over 128 lanes).  Where it is not, the two
  definitions part: JAX keeps multiplying a dead pixel's T (weights 0),
  the port's T stays where it fell below 1e-4, so there the port's T must
  be below 1e-4 and at least JAX's (within rtol 1e-5);
- ``last`` by its definition (JAX has no such output): the last gaussian
  that passes the alpha test while the exclusive product of (1 - alpha)
  before it, in float64, is >= 1e-4; a pixel whose product at the stop
  lies within 1e-5 relative of 1e-4 may differ (counted, at most 1%);
- acc + T_final = 1 within 2e-5 (float32 sums in another order);
- the cull: checkpoints of a slab whose rows the cull rejects for a tile
  are zeroed equal those of the whole slab, bit for bit;
- the table: on whole tiles exactly ``tile_reach``; on bands of 4 pixel
  rows no pair that passes the alpha test is rejected (no tolerance).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_gs_composite import CASES, _attr_major, _port_inputs, _slab_case
from tests.test_torch_k9_k5_plans import _passes, _slab
from v3d_tpu.gs.pallas_raster import composite_tiles_fwd
from v3d_tpu_torch.ops import LAUNCHES, reset_launch_counts
from v3d_tpu_torch.ops import gs_composite as gc

torch.set_num_threads(1)


def _jax_fwd(name):
    slab, live, cell, xy = _slab_case(name)
    out, ts = composite_tiles_fwd(_attr_major(slab), cell, xy,
                                  live_count=jnp.asarray(live), interpret=True)
    return (slab, live, cell, xy), np.asarray(out), np.asarray(ts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoints_plain_match_pallas_kernel(name):
    case, out, ts_jax = _jax_fwd(name)
    ts, last, k_stop = gc.composite_checkpoints_plain(*_port_inputs(*case))
    ts, k_stop = ts.numpy(), k_stop.numpy()
    np.testing.assert_array_equal(k_stop, out[:, 6, 0].astype(np.int32))
    n_tiles = len(k_stop)
    rows = [(ts[t, :k_stop[t]], ts_jax[t, :k_stop[t]]) for t in range(n_tiles)]
    rows.append((ts[np.arange(n_tiles), k_stop], out[:, 5]))   # final T
    got = np.concatenate([g.reshape(-1) for g, _ in rows])
    want = np.concatenate([w.reshape(-1) for _, w in rows])
    live = want >= gc.T_EPS
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5)
    assert (got[~live] < gc.T_EPS).all()
    assert (got[~live] >= want[~live] * (1 - 1e-5)).all()
    assert np.isnan(ts[np.arange(ts.shape[1])[None] > k_stop[:, None]]).all()
    if name == "early_exit":   # pixels die
        assert (~live).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoints_plain_last_by_definition(name):
    slab, live, cell, xy = _slab_case(name)
    inputs = _port_inputs(slab, live, cell, xy)
    ts, last, k_stop = gc.composite_checkpoints_plain(*inputs)
    rows = inputs[0][inputs[2].long()]                        # (n, K, 10)
    pix = gc.tile_pixels(inputs[3])
    dx = pix[:, :, None, 0] - rows[:, None, :, 0]
    dy = pix[:, :, None, 1] - rows[:, None, :, 1]
    con = rows[:, None, :, 2:5]
    power = (-0.5 * (con[..., 0] * dx * dx + con[..., 2] * dy * dy)
             - con[..., 1] * dx * dy)
    alpha = torch.clamp(rows[:, None, :, 8] * torch.exp(power), max=gc.ALPHA_MAX)
    alpha = torch.where((power <= 0) & (alpha >= gc.ALPHA_MIN), alpha, 0.0)
    alpha = alpha.double().numpy()       # the test in float32, the products in float64
    t_excl = np.concatenate([np.ones_like(alpha[..., :1]),
                             np.cumprod(1 - alpha, -1)[..., :-1]], -1)
    comp = (alpha > 0) & (t_excl >= gc.T_EPS)
    want = np.where(comp, np.arange(alpha.shape[-1]), -1).max(-1)
    # pixels with a passing gaussian whose product before it sits at the stop
    near = ((alpha > 0) & (np.abs(t_excl / gc.T_EPS - 1) <= 1e-5)).any(-1)
    diff = last.numpy() != want
    assert not (diff & ~near).any(), int((diff & ~near).sum())
    assert diff.sum() <= 0.01 * diff.size
    assert (want >= 0).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoints_plain_final_t_is_one_minus_acc(name):
    inputs = _port_inputs(*_slab_case(name))
    ts, _, k_stop = gc.composite_checkpoints_plain(*inputs)
    _, acc, _ = gc.composite_plain(*inputs)
    t_final = ts[torch.arange(len(k_stop)), k_stop.long()]
    torch.testing.assert_close(acc + t_final, torch.ones_like(acc), rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["coarse", "early_exit"])
def test_cull_leaves_checkpoints_unchanged(name):
    """What K4 walks: per tile only the rows tile_reach admits.  Zeroing
    the others (opacity 0: alpha 0) in a per-tile copy of the slab changes
    no bit of ts, last or k_stop."""
    slab, live_count, cell, xy = _port_inputs(*_slab_case(name))
    rows = slab[cell.long()].clone()                             # (n_tiles, K, 10)
    reach = gc.tile_reach(rows, xy)
    assert (~reach & (rows[..., 8] > 0)).any()                   # the cull rejects some
    rows[~reach] = 0.0
    tiles = torch.arange(len(cell), dtype=torch.int32)
    got = gc.composite_checkpoints_plain(rows, live_count[cell.long()], tiles, xy)
    want = gc.composite_checkpoints_plain(slab, live_count, cell, xy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_checkpoints_plain_ragged_kc():
    """Kc not a multiple of 128 (the card tests use 1000): the last batch
    is short; k_stop counts the batches of the live rows."""
    slab, live, cell, xy = _port_inputs(*_slab_case("coarse"))
    cut = slab[:, :200].contiguous()
    live = live.clamp(max=200)
    ts, last, k_stop = gc.composite_checkpoints_plain(cut, live, cell, xy)
    assert ts.shape == (len(cell), 3, gc.P)
    assert int(last.max()) < 200
    assert (k_stop <= (live[cell.long()] + 127) // 128).all()
    padded = slab[:, :256].clone()
    padded[:, 200:] = 0.0                                     # dead rows
    full = gc.composite_checkpoints_plain(padded, live, cell, xy)
    for g, w in zip((ts, last, k_stop), full):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.fixture
def fake_launch(monkeypatch):
    """Drive the wrapper's CUDA branch on CPU tensors with a launch that
    records its arguments."""
    calls = []

    def record(name, fn_name, device, *args):
        calls.append((fn_name, args))
        LAUNCHES[name] += 1

    monkeypatch.setattr(gc, "launch", record)
    reset_launch_counts()
    return calls


@pytest.mark.parametrize("with_prof", [False, True], ids=["no_prof", "prof"])
def test_composite_fwd_hands_its_kernel(fake_launch, with_prof):
    """K4's wrapper passes the inputs, (n_cells, n_tiles, Kc, n_chunks), an
    int16 scratch of 4 a slab row for the boxes, the six outputs it
    allocates (ts with a row past the last batch) and the clock64 buffer
    where one is given, None otherwise; one launch is counted (the call:
    the library function makes two)."""
    kc, n_tiles = 300, 3
    slab = torch.zeros(2, kc, gc.ATTR)
    live = torch.tensor([300, 7], dtype=torch.int32)
    cell = torch.tensor([0, 1, 1], dtype=torch.int32)
    xy = torch.zeros(n_tiles, 2, dtype=torch.int32)
    prof = torch.zeros(n_tiles, gc.FWD_PROF_SLOTS, dtype=torch.int64) if with_prof else None
    (rgb, acc, dep), (ts, last, k_stop) = gc.composite_fwd(slab, live, cell, xy, prof=prof)
    ((fn, args),) = fake_launch
    assert fn == "v3d_gs_composite_fwd"
    assert args[:4] == tuple(x.data_ptr() for x in (slab, live, cell, xy))
    assert args[4:8] == (2, n_tiles, kc, 3)
    assert isinstance(args[8], int) and args[8] not in (0, slab.data_ptr())
    assert args[9:15] == tuple(x.data_ptr() for x in (rgb, acc, dep, ts, last, k_stop))
    assert args[15] == (prof.data_ptr() if with_prof else None)
    assert rgb.shape == (n_tiles, gc.P, 3) and ts.shape == (n_tiles, 4, gc.P)
    assert last.dtype == k_stop.dtype == torch.int32 and k_stop.shape == (n_tiles,)
    assert LAUNCHES["gs_composite_fwd"] == 1 and LAUNCHES["gs_composite_bwd"] == 0


# -- K4's table of the cull's boxes in whole pixels --

@pytest.mark.parametrize("kind", ["random", "threshold", "near_degenerate", "zero_rows",
                                  "not_positive_definite"])
def test_reach_boxes_on_a_tile_are_tile_reach(kind):
    """On whole 16 x 16 tiles the table's integer test admits exactly what
    tile_reach admits (the same boxes: an integer tile edge meets a box
    exactly where it meets its ceil / floor), also for the exact boxes."""
    rng = np.random.RandomState(2)
    tile_xy = torch.tensor([[0, 0], [16, 0], [0, 16], [16, 16]], dtype=torch.int32)
    slab = _slab(rng, 4, 512, kind)
    for exact in (False, True):
        boxes = gc.reach_boxes(slab, exact=exact)
        assert boxes.dtype == torch.int16 and boxes.shape == (4, 512, 4)
        x0, y0 = tile_xy[:, 0, None], tile_xy[:, 1, None]
        meet = gc.pixel_boxes_meet(boxes, x0, x0 + gc.TILE - 1, y0, y0 + gc.TILE - 1)
        assert torch.equal(meet, gc.tile_reach(slab, tile_xy, exact=exact))


@pytest.mark.parametrize("kind", ["random", "threshold", "near_degenerate",
                                  "not_positive_definite"])
def test_reach_boxes_are_conservative_on_bands(kind):
    """No (pixel, gaussian) pair that passes composite_plain's alpha test
    lies in a band of FWD_SPLIT pixel rows whose test rejects the gaussian;
    the bands reject more than the whole tile does."""
    rng = np.random.RandomState(3)
    tile_xy = torch.tensor([[0, 0], [16, 0], [0, 16], [16, 16]], dtype=torch.int32)
    slab = _slab(rng, 4, 512, kind)
    boxes = gc.reach_boxes(slab)
    passing = _passes(slab, tile_xy).reshape(4, gc.FWD_SPLIT, -1, slab.shape[1])
    rows = gc.TILE // gc.FWD_SPLIT
    x0, y0 = tile_xy[:, 0, None], tile_xy[:, 1, None]
    band_total = 0
    for s in range(gc.FWD_SPLIT):
        meet = gc.pixel_boxes_meet(boxes, x0, x0 + gc.TILE - 1, y0 + s * rows,
                                   y0 + s * rows + rows - 1)
        assert not (passing[:, s].any(1) & ~meet).any()
        band_total += int(meet.sum())
    if kind == "random":
        assert band_total < gc.FWD_SPLIT * int(gc.tile_reach(slab, tile_xy).sum())


def test_reach_boxes_clamp_and_flags():
    rows = torch.zeros(1, 4, gc.ATTR)
    rows[..., 2] = rows[..., 4] = 1.0
    rows[..., 8] = 0.5
    rows[0, 0, 0] = 1e6                        # far right: clamped to int16
    rows[0, 1, 3] = float("nan")               # admitted everywhere
    rows[0, 2, 8] = 0.0                        # a dead slot: reaches nothing
    rows[0, 3, 0:2] = 100.0
    boxes = gc.reach_boxes(rows)[0].tolist()
    assert boxes[0][0] == 32767 and boxes[0][1] == 32767
    assert boxes[1] == [-32768, 32767, -32768, 32767]
    assert boxes[2] == [32767, -32768, 32767, -32768]
    assert boxes[3][0] < 100 < boxes[3][1] and boxes[3][2] < 100 < boxes[3][3]
    meet = gc.pixel_boxes_meet(gc.reach_boxes(rows), 0, 15, 0, 15)[0].tolist()
    assert meet == [False, True, False, False]


def test_checkpoint_mismatch_counts():
    """chip_smoke.gs_checkpoints_mismatch (phase 3 and the card tests):
    nothing on equal checkpoints (rows past k_stop are not read); a changed
    ``last`` or ``k_stop`` counts outside the pixels at the 1e-4 stop and not
    inside them; ts's relative difference is reported."""
    import chip_smoke

    plain = gc.composite_checkpoints_plain(*_port_inputs(*_slab_case("early_exit")))
    ts, last, k_stop = (x.clone() for x in plain)
    ts[torch.isnan(ts)] = 7.0                        # unwritten rows
    assert chip_smoke.gs_checkpoints_mismatch((ts, last, k_stop), plain) == {
        "near": 0, "last": 0, "k_stop": 0, "ts_rel": 0.0}
    last[0, 0] += 1
    k_stop[1] -= 1
    ts[2, 0, 3] *= 1 + 1e-6
    got = chip_smoke.gs_checkpoints_mismatch((ts, last, k_stop), plain)
    assert (got["last"], got["k_stop"]) == (1, 1) and 5e-7 < got["ts_rel"] < 2e-6
    ts[0, k_stop[0].long(), 0] = gc.T_EPS * (1 - 1e-6)   # pixel (0, 0) at the stop
    ts[1, k_stop[1].long(), 5] = gc.T_EPS                # a pixel of tile 1 at the stop
    got = chip_smoke.gs_checkpoints_mismatch((ts, last, k_stop), plain)
    assert (got["near"], got["last"], got["k_stop"]) == (2, 0, 0)


def test_time_script_compares_trees(tmp_path):
    """kernels/time_gs_composite.py --compare: the first tree writes K4's
    six outputs, a later one gets each output's max abs difference (ts over
    the rows both wrote, and the final row)."""
    from v3d_tpu_torch.kernels.time_gs_composite import compare_outputs

    inputs = _port_inputs(*_slab_case("coarse"))
    out = gc.composite_plain(*inputs)
    saved = gc.composite_checkpoints_plain(*inputs)
    path = tmp_path / "k4.pt"
    assert compare_outputs(str(path), out, saved) is None and path.exists()
    diffs = compare_outputs(str(path), out, saved)
    assert diffs == dict.fromkeys(["rgb", "acc", "depth", "ts", "last", "k_stop"], 0.0)
    ts = saved[0].clone()
    ts[0, 0, 0] += 0.25
    diffs = compare_outputs(str(path), out, (ts,) + saved[1:])
    assert diffs["ts"] == pytest.approx(0.25) and diffs["rgb"] == 0.0
