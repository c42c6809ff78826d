"""The port's kernel modules against the reference's.

``rocalphago_tpu_torch/ops/labels.py`` and ``ops/chase.py``: the plain
PyTorch versions (what the wrappers run on CPU tensors) against the
reference's XLA functions (vmapped ``jaxgo.compute_labels`` and
``ladders._chase``) and its Pallas kernels in interpret mode, as
``tests/test_ops.py`` runs them. Tolerance: exact -- every output is
integer or boolean. The CUDA kernels themselves are checked against
the plain versions on the card by ``tests/test_torch_gpu.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocalphago_tpu.engine.jaxgo import (
    GoConfig,
    compute_labels,
    lib_counts_from_labels,
)
from rocalphago_tpu.features.ladders import _chase
from rocalphago_tpu.ops import pallas_chase, pallas_labels
from rocalphago_tpu_torch.ops import chase as tchase
from rocalphago_tpu_torch.ops import labels as tlabels
from torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    random_games,
    serpentine,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 9
N = SIZE * SIZE


def boards_of(states) -> np.ndarray:
    return np.stack([np.asarray(s.board, np.int8).reshape(-1)
                     for s in states])


@functools.lru_cache(maxsize=None)
def ref_labels_fn(size: int):
    cfg = GoConfig(size=size)
    return jax.jit(jax.vmap(lambda b: compute_labels(cfg, b)))


@pytest.mark.parametrize("moves", [0, 10, 30, 60])
def test_labels_plain_matches_reference(moves):
    boards = boards_of(random_games(SIZE, 6, moves, moves, seed=moves))
    want = np.asarray(ref_labels_fn(SIZE)(boards))
    t = torch.as_tensor(boards)
    np.testing.assert_array_equal(tlabels.labels_plain(t, SIZE).numpy(),
                                  want)
    np.testing.assert_array_equal(
        np.asarray(pallas_labels(boards, SIZE, interpret=True)), want)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(tlabels.labels(t, SIZE).numpy(), want)
    assert tlabels.labels(t, SIZE).dtype == torch.int32


@pytest.mark.parametrize("size", [5, 9, 19])
def test_labels_serpentine_worst_case(size):
    snake = serpentine(size)
    boards = np.stack([snake, -snake, np.ones_like(snake)])
    want = np.asarray(ref_labels_fn(size)(boards))
    got = tlabels.labels_plain(torch.as_tensor(boards), size).numpy()
    np.testing.assert_array_equal(got, want)
    if size < 19:   # the 19×19 snake is the reference suite's own case
        np.testing.assert_array_equal(
            np.asarray(pallas_labels(boards, size, interpret=True)), want)
    stones = boards[0] != 0
    assert (got[0][stones] == got[0][stones].min()).all()


def test_labels_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        tlabels.labels(torch.zeros((2, N), dtype=torch.int32), SIZE)
    with pytest.raises(ValueError):
        tlabels.labels(torch.zeros((2, N + 1), dtype=torch.int8), SIZE)


@functools.lru_cache(maxsize=None)
def chase_entries(seed: int, positions: int):
    """Every 2-liberty group of seeded random 9×9 positions as a chase
    entry: ``(boards int8 [L,N], labels int32 [L,N], prey int32 [L])``
    -- the entry contract ``benchmarks/_harness.py`` harvests."""
    cfg = GoConfig(size=SIZE)
    boards = boards_of(random_games(SIZE, positions, 8, 40, seed))
    labels = np.asarray(ref_labels_fn(SIZE)(boards))
    libs = np.asarray(jax.jit(jax.vmap(lambda b, l: lib_counts_from_labels(
        cfg, b, l)))(jnp.asarray(boards), jnp.asarray(labels)))
    out_b, out_l, out_p = [], [], []
    for b, lab, lib in zip(boards, labels, libs):
        for root in np.unique(lab[b != 0]):
            if lib[root] == 2:
                out_b.append(b)
                out_l.append(lab)
                out_p.append(root)
    return (np.stack(out_b), np.stack(out_l).astype(np.int32),
            np.asarray(out_p, np.int32))


def plain(boards, labels, prey, collect_core=True):
    return tchase.chase_plain(torch.as_tensor(boards),
                              torch.as_tensor(labels),
                              torch.as_tensor(prey), SIZE, 40,
                              collect_core=collect_core)


def test_chase_plain_matches_xla_chase():
    boards, labels, prey = chase_entries(3, 24)
    assert len(prey) >= 40
    xla = jax.jit(jax.vmap(functools.partial(
        _chase, GoConfig(size=SIZE), depth=40, enabled=True,
        collect_core=True)))
    want_cap, want_core = xla(jnp.asarray(boards), jnp.asarray(labels),
                              jnp.asarray(prey))
    got_cap, got_core = plain(boards, labels, prey)
    np.testing.assert_array_equal(got_cap.numpy(), np.asarray(want_cap))
    np.testing.assert_array_equal(got_core.numpy(), np.asarray(want_core))
    # both outcomes, or the comparison proves little
    assert got_cap.any() and not got_cap.all()


def test_chase_plain_matches_pallas_chase():
    boards, labels, prey = chase_entries(7, 8)
    boards, labels, prey = boards[:16], labels[:16], prey[:16]
    onehot = np.arange(N)[None, :] == prey[:, None]
    want_cap, want_core = pallas_chase(
        jnp.asarray(boards), jnp.asarray(labels), jnp.asarray(onehot),
        SIZE, depth=40, interpret=True, collect_core=True)
    got_cap, got_core = plain(boards, labels, prey)
    np.testing.assert_array_equal(got_cap.numpy(), np.asarray(want_cap))
    np.testing.assert_array_equal(got_core.numpy(), np.asarray(want_core))
    assert np.asarray(want_core).any()


def test_chase_disabled_lanes_read_false():
    boards, labels, prey = chase_entries(5, 6)
    off = np.full_like(prey, -1)
    cap, core = plain(boards, labels, off)
    assert not cap.any() and not core.any()
    zeros = np.zeros((len(prey), N), bool)
    assert not np.asarray(pallas_chase(
        jnp.asarray(boards), jnp.asarray(labels), jnp.asarray(zeros),
        SIZE, interpret=True)).any()
    # mixed: disabling half the lanes leaves the others' verdicts alone
    mixed = np.where(np.arange(len(prey)) % 2 == 0, prey, -1)
    mcap, _ = plain(boards, labels, mixed)
    full, _ = plain(boards, labels, prey)
    np.testing.assert_array_equal(mcap.numpy()[::2], full.numpy()[::2])
    assert not mcap.numpy()[1::2].any()


def test_chase_wrapper_on_cpu_is_the_plain_version():
    boards, labels, prey = chase_entries(3, 24)
    args = (torch.as_tensor(boards), torch.as_tensor(labels),
            torch.as_tensor(prey))
    cap, core = tchase.chase(*args, SIZE, 40, collect_core=True)
    pcap, pcore = tchase.chase_plain(*args, SIZE, 40, collect_core=True)
    assert torch.equal(cap, pcap) and torch.equal(core, pcore)
    assert torch.equal(tchase.chase(*args, SIZE), pcap)
    with pytest.raises(TypeError):
        tchase.chase(args[0], args[1].long(), args[2], SIZE)
    with pytest.raises(ValueError):
        tchase.chase(*args, SIZE, depth=0)
