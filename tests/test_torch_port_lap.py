"""Port parity of the plain linear assignment (kernel B4's plain version),
on the CPU, against the JAX package's solver, its Pallas kernel in interpret
mode and scipy; and the wrapper's dispatch.

Both versions do the same float32 subtractions and comparisons in the same
order and take the first index on ties, so the assignments must be equal
exactly, ties included; the total cost must equal scipy's optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from diffusiondrive_tpu.ops import hungarian as jhung

from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment, linear_sum_assignment_plain


def _costs(kind, B_, n, rng):
    if kind == "normal":
        return rng.normal(size=(B_, n, n)).astype(np.float32)
    if kind == "ties":  # integer costs: many equal optima, the tie-break decides
        return rng.integers(0, 4, size=(B_, n, n)).astype(np.float32)
    if kind == "ones":
        return np.ones((B_, n, n), np.float32)
    if kind == "huge":  # large finite costs must not collide with the 1e18 sentinel
        return (rng.uniform(size=(B_, n, n)) * 1e9).astype(np.float32)
    if kind == "signed_zero":  # -0.0 and +0.0 compare equal: the tie-break must not see the sign
        return rng.choice(np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0], np.float32), size=(B_, n, n))
    # "mixed": tiny diagonal in a sea of huge costs
    c = np.full((B_, n, n), 1e8, np.float32)
    c[:, np.arange(n), np.arange(n)] = 1e-6
    return c


@pytest.mark.parametrize("n,B_", [(1, 3), (2, 5), (7, 16), (30, 16), (31, 4)])
@pytest.mark.parametrize("kind", ["normal", "ties", "ones", "huge", "mixed", "signed_zero"])
def test_plain_assignment_equals_jax_and_pallas_interpret(n, B_, kind):
    """Equal assignments, exactly, to JAX's solver and its Pallas kernel in
    interpret mode; optimal total cost against scipy."""
    costs = _costs(kind, B_, n, np.random.default_rng(n * 100 + B_))
    got = linear_sum_assignment_plain(torch.from_numpy(costs)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(jhung.linear_sum_assignment)(jnp.asarray(costs))))
    np.testing.assert_array_equal(got, np.asarray(jhung._lsa_pallas(jnp.asarray(costs), interpret=True)))
    for c, col in zip(costs, got):
        assert sorted(col.tolist()) == list(range(n))
        r, cs = scipy_lsa(c)
        np.testing.assert_allclose(c[np.arange(n), col].sum(dtype=np.float64),
                                   c[r, cs].sum(dtype=np.float64), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 30])
def test_plain_step_counter_counts_the_chain_and_changes_nothing(n):
    """The optional step counter adds each problem's search steps and augment
    hops and leaves the assignment as it is. A zero diagonal with positive
    costs elsewhere takes one search step and one augment hop a row: 2n."""
    rng = np.random.default_rng(n)
    diag = rng.uniform(0.5, 2.0, size=(3, n, n)).astype(np.float32)
    diag[:, np.arange(n), np.arange(n)] = 0.0
    steps = torch.zeros(3, dtype=torch.long)
    col = linear_sum_assignment_plain(torch.from_numpy(diag), steps)
    np.testing.assert_array_equal(col.numpy(), np.tile(np.arange(n, dtype=np.int32), (3, 1)))
    assert steps.tolist() == [2 * n] * 3
    costs = torch.from_numpy(np.concatenate([_costs("normal", 2, n, rng), _costs("ties", 2, n, rng)]))
    steps = torch.full((4,), 7, dtype=torch.long)
    torch.testing.assert_close(linear_sum_assignment_plain(costs, steps), linear_sum_assignment_plain(costs),
                               rtol=0, atol=0)
    assert (steps >= 7 + 2 * n).all() and (steps <= 7 + n * (2 * n + 2)).all()


def test_assignment_wrapper_takes_the_plain_version_on_cpu_and_launches_nothing():
    costs = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 30, 30)).astype(np.float32))
    before = batched_linear_sum_assignment.launches
    torch.testing.assert_close(batched_linear_sum_assignment(costs), linear_sum_assignment_plain(costs),
                               rtol=0, atol=0)
    assert batched_linear_sum_assignment.launches == before


def test_assignment_off_the_cpu_reaches_the_kernel_or_raises():
    """A meta tensor is no CPU tensor: it must not take the plain version."""
    with pytest.raises(RuntimeError, match="no kernel"):
        batched_linear_sum_assignment(torch.empty(2, 30, 30, device="meta"))
    with pytest.raises(ValueError, match="outside the kernel"):
        batched_linear_sum_assignment(torch.empty(2, 32, 32, device="meta"))
    with pytest.raises(TypeError, match="float32"):
        batched_linear_sum_assignment(torch.empty(2, 30, 30, device="meta", dtype=torch.float64))


@pytest.mark.parametrize("n", [30, 40])
def test_detection_loss_takes_the_kernel_only_where_jax_does(n, monkeypatch):
    """JAX's `_lsa_local` takes its kernel for 1 <= n <= 31 and the XLA
    solver above (`num_bounding_boxes=40` trains in JAX); the port's loss
    calls the kernel's wrapper only for those n and the plain solver above,
    and equals the JAX loss at both n. Each prediction is a ground-truth
    box of a permutation plus noise, its logit +-4 by that box's label: one
    optimum up to swaps among invalid boxes, which leave the loss as it is."""
    from diffusiondrive_tpu.models.config import TransfuserConfig as JConfig
    from diffusiondrive_tpu.training import losses as jlosses

    from diffusiondrive_torch.models.config import TransfuserConfig
    from diffusiondrive_torch.training import losses as plosses

    rng = np.random.default_rng(n)
    B = 2
    gt = rng.normal(0, 10, (B, n, 5)).astype(np.float32)
    perm = np.stack([rng.permutation(n) for _ in range(B)])
    pred = (np.take_along_axis(gt, perm[..., None], 1) + rng.normal(0, 0.5, (B, n, 5))).astype(np.float32)
    labels = rng.uniform(size=(B, n)) > 0.4
    logits = (np.where(np.take_along_axis(labels, perm, 1), 4.0, -4.0)
              + rng.normal(0, 0.5, (B, n))).astype(np.float32)
    calls = []

    def spy(cost):
        calls.append(cost.shape)
        return batched_linear_sum_assignment(cost)

    monkeypatch.setattr(plosses, "batched_linear_sum_assignment", spy)
    got = plosses.agent_detection_loss(
        {"agent_states": torch.from_numpy(gt), "agent_labels": torch.from_numpy(labels)},
        {"agent_states": torch.from_numpy(pred), "agent_labels": torch.from_numpy(logits)},
        TransfuserConfig(num_bounding_boxes=n))
    want = jlosses.agent_detection_loss(
        {"agent_states": jnp.asarray(gt), "agent_labels": jnp.asarray(labels)},
        {"agent_states": jnp.asarray(pred), "agent_labels": jnp.asarray(logits)},
        JConfig(num_bounding_boxes=n))
    assert calls == ([(B, n, n)] if n <= 31 else [])
    np.testing.assert_allclose(torch.stack(got).numpy(), np.asarray(jnp.stack(want)), rtol=1e-6, atol=1e-6)
