"""Three NeusTrainer steps of the reference recipe (hash grid, finite
differences, the occupancy lookup and its update) against the JAX
package's, from one state on the JAX keys' draws; the tolerances are
those stated in tests/test_torch_neus_train.py."""

from torch_neus_helpers import check_train_steps


def test_train_steps_match_jax_reference_recipe():
    check_train_steps("reference")
