"""Port parity of the nuScenes variant (`diffusiondrive_nuscenes_agent`:
ResNet-50 encoders, 6 poses, k-means anchors) against the JAX package, on
the CPU: the tests of `test_torch_port_variants_model.py` on this
variant, in a file of their own so that `--dist loadfile` gives its
~60 s to another worker.
"""

import pytest

from test_torch_port_variants_model import (  # noqa: F401  (collected here with this file's fixture)
    test_variant_eval_forward_matches_jax,
    test_variant_train_step_gradients_and_bn_match_jax,
    test_variant_train_step_losses_and_assignment_match_jax,
    variant_results,
)


@pytest.fixture(scope="module")
def variant():
    return variant_results("diffusiondrive_nuscenes_agent")
