"""The port's NeusTrainer (v3d_tpu_torch/nerf/system.py) against the JAX
package's, on the CPU in float32: both trainers start from one state (the
JAX trainer's, carried by ``core.convert.trainer_state_from_jax``) and
take the same steps on the same draws (the JAX keys' draws, split as
system.py:287-314, :384-391 and _sample_batch :261-283 split them, handed
to the port as ``NeusDraws``; tests/torch_neus_helpers.py).  Two recipes
at tiny size: the card's (frequency encoding, exact gradient,
coarse-to-fine, ray chunks, normal supervision) and the reference's (hash
grid, finite differences, the occupancy lookup and its update, on a 16^3
grid updated with jittered cells every step in both trainers).

Tolerances: each loss component rel 1e-4 (a forward of a few hundred
float32 ops); gradients and Adam moments per parameter tensor max |port -
JAX| <= rel max |JAX| (JAX's gradient is (mu - 0.9 mu_before) / 0.1) with
rel 1e-4, but 1e-3 for the finite-difference recipe's geometry and 1e-2
for its hash table: the central difference divides the SDF's float32
rounding by 2 eps, and a table entry sums contributions of the +eps and
-eps points that cancel (at the third step both float32 sums differ from a
float64 evaluation by up to 3e-4 of the largest network gradient, and XLA's
scatter-add leaves ~8e-3 of the table's largest on an entry whose float64
value is ~3e-8, where the port's sum is within 2e-8); parameters after
AdamW |port - JAX| <= 1e-6 + 2 lr min(1, 1.5 r), r the larger relative
difference of the entry's two moments (the update lr m / (sqrt(v) + eps)
moves by at most 1.5 r of itself, and by at most 2 lr where a moment of
rounding size takes its sign from rounding); the occupancy grid's mask,
the ray counts and the live-sample counts exactly, its EMA atol 1e-6 (an
alpha in [0, 1]).  The reference recipe's steps are in
test_torch_neus_train_ref.py, the export path in test_torch_neus_export.py;
a capture / restore round trip here is exact."""

import torch

from torch_neus_helpers import GRID, RECIPES, check_train_steps, scene
from v3d_tpu_torch.nerf.occupancy import OccupancyGrid
from v3d_tpu_torch.nerf.system import NeusConfig, NeusTrainer


def test_train_steps_match_jax_card_recipe():
    check_train_steps("card")


def test_capture_restore_round_trip():
    images, fg, dirs, poses, _ = scene(False)

    def trainer(seed):
        tr = NeusTrainer(images, fg, dirs, poses, config=NeusConfig(
            **RECIPES["reference"]), seed=seed, device="cpu")
        tr.occ = OccupancyGrid(occ_threshold=tr.cfg.grid_prune_occ_thre,
                               device="cpu", **GRID)
        return tr

    pt, other = trainer(0), trainer(7)
    pt.train_iter()
    other.restore(pt.capture())
    a, b = pt.train_iter(), other.train_iter()
    assert float(a["loss"]) == float(b["loss"])
    for (n, p), q in zip(pt.geometry.named_parameters(), other.geometry.parameters()):
        assert torch.equal(p, q), n
