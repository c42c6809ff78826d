"""The port's dihedral augmentation against the reference's.

All 8 group elements, in the reference's numbering, on NHWC planes and
on flat actions (pass included): bit-identical to
``rocalphago_tpu.training.symmetries``; the inverse undoes each
element; ``random_transform_batch`` with the reference's own ``t``
draws gives the reference's batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.training import symmetries as ref
from rocalphago_tpu_torch.training import symmetries


@pytest.mark.parametrize("size", [5, 9])
def test_every_element_on_planes_and_actions(size):
    n = size * size
    rng = np.random.default_rng(size)
    x = rng.integers(0, 256, (8, size, size, 3)).astype(np.uint8)
    t = np.arange(8)
    got = symmetries.transform_planes(torch.from_numpy(x),
                                      torch.from_numpy(t)).numpy()
    for i in range(8):
        want = np.asarray(ref.transform_planes(jnp.asarray(x[i]), i))
        np.testing.assert_array_equal(got[i], want)
        back = symmetries.inverse_transform_planes(
            torch.from_numpy(got[i:i + 1]), torch.tensor([i])).numpy()
        np.testing.assert_array_equal(back[0], x[i])
        want_inv = np.asarray(ref.inverse_transform_planes(
            jnp.asarray(x[i]), i))
        np.testing.assert_array_equal(
            symmetries.inverse_transform_planes(
                torch.from_numpy(x[i:i + 1]), torch.tensor([i])).numpy()[0],
            want_inv)
    # every action, pass included, under every element
    acts = np.arange(n + 1, dtype=np.int32)
    for i in range(8):
        want = np.asarray(jax.vmap(
            lambda a: ref.transform_action(a, jnp.int32(i), size))(
                jnp.asarray(acts)))
        got_a = symmetries.transform_action(
            torch.from_numpy(acts), torch.full((n + 1,), i), size).numpy()
        np.testing.assert_array_equal(got_a, want)
        assert got_a.dtype == np.int32


def test_a_move_follows_its_stone():
    """The transformed action points at the transformed one-hot."""
    size = 7
    for i in range(8):
        for a in (0, 3, 10, 48):
            plane = np.zeros((1, size, size), np.uint8)
            plane[0, a // size, a % size] = 1
            moved = symmetries.transform_planes(
                torch.from_numpy(plane), torch.tensor([i])).numpy()
            dst = int(symmetries.transform_action(
                torch.tensor([a]), torch.tensor([i]), size))
            assert moved.reshape(-1)[dst] == 1


def test_batch_with_the_reference_draws():
    size, b = 9, 32
    rng = np.random.default_rng(0)
    planes = rng.random((b, size, size, 4)).astype(np.float32)
    actions = rng.integers(0, size * size + 1, b).astype(np.int32)
    key = jax.random.key(3)
    want_p, want_a = ref.random_transform_batch(
        key, jnp.asarray(planes), jnp.asarray(actions), size)
    t = np.array(jax.random.randint(key, (b,), 0, 8))
    got_p, got_a = symmetries.random_transform_batch(
        None, torch.from_numpy(planes), torch.from_numpy(actions), size,
        t=torch.from_numpy(t))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    # the generator's draws are uniform on the 8 elements and repeat
    # from a seed
    draws = [symmetries.draw_elements(
        torch.Generator().manual_seed(5), 4096, "cpu") for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    counts = torch.bincount(draws[0], minlength=8)
    assert counts.min() > 400 and counts.max() < 630
