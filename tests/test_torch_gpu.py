"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA card; the
card is looked for when a test runs (a fixture), never at import, so
every pytest-xdist worker collects the same tests. The card machine
has no JAX, and ``tests/conftest.py`` imports it, so run this file
there without the conftest::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gpu.py -m gpu

This file imports only torch, numpy and the port. Tolerance: exact for
the kernels and the encode (integer and boolean outputs), and for the
convolution epilogue's outputs; its bias gradient, a float32 sum in the
kernel's own order, within float32 reordering of the float64 sum.
"""

import io
import time

import numpy as np
import pytest
import torch

from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.features import Preprocess
from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
from rocalphago_tpu_torch.models import CNNPolicy
from rocalphago_tpu_torch.ops import chase, conv_epilogue, labels, tree
from rocalphago_tpu_torch.search.players import GreedyPolicyPlayer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_positions(size, count, lo, hi, seed):
    """Seeded random play on the port's rules oracle."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        st = pygo.GameState(size=size)
        target = int(rng.integers(lo, hi + 1))
        tries = 0
        while st.turns_played < target and tries < 4 * target + 4:
            tries += 1
            empty = np.flatnonzero(st.board.reshape(-1) == 0)
            mv = divmod(int(empty[rng.integers(len(empty))]), size)
            if st.is_eye(mv, st.current_player):
                continue
            try:
                st.do_move(mv)
            except pygo.IllegalMove:
                continue
        out.append(st)
    return out


def snake(size):
    b = np.zeros((size, size), np.int8)
    for x in range(size):
        if x % 2 == 0:
            b[x, :] = 1
        else:
            b[x, size - 1 if (x // 2) % 2 == 0 else 0] = 1
    return b.reshape(-1)


@pytest.mark.parametrize("size", [9, 13, 19, 25])
def test_labels_kernel_matches_plain(cuda_device, size):
    boards = np.stack([np.asarray(s.board, np.int8).reshape(-1) for s in
                       random_positions(size, 64, 0, size * size // 2, 1)]
                      + [snake(size), -snake(size)])
    t = torch.as_tensor(boards, device=cuda_device)
    before = labels.launches
    got = labels.labels(t, size)
    assert labels.launches == before + 1
    assert torch.equal(got, labels.labels_plain(t, size))


def encode_lanes(device, size, states):
    """The chase lanes one encode of ``states`` sends to the wrapper."""
    seen = []
    inner = chase.chase

    def record(b, lab, p, sz, depth=40, collect_core=False):
        seen.append((b, lab, p))
        return inner(b, lab, p, sz, depth, collect_core)

    cfg = torchgo.GoConfig(size=size)
    chase.chase = record
    try:
        Preprocess(cfg=cfg, device=device).states_to_tensor(
            torchgo.from_pygo(cfg, states, device=device))
    finally:
        chase.chase = inner
    return [torch.cat(x) for x in zip(*seen)]


@pytest.mark.parametrize("size", [9, 13, 19, 25])
def test_chase_kernel_matches_plain(cuda_device, size):
    boards, labs, prey = encode_lanes(
        cuda_device, size, random_positions(size, 48, 10, size * 8, 2))
    prey = torch.cat([prey, torch.full_like(prey[:8], -1)])
    boards = torch.cat([boards, boards[:8]])
    labs = torch.cat([labs, labs[:8]])
    before = chase.launches
    cap, core = chase.chase(boards, labs, prey, size, 40,
                            collect_core=True)
    assert chase.launches == before + 1
    pcap, pcore = chase.chase_plain(boards, labs, prey, size, 40,
                                    collect_core=True)
    assert torch.equal(cap, pcap) and torch.equal(core, pcore)
    assert not cap[-8:].any() and not core[-8:].any()
    assert cap.any()


@pytest.mark.parametrize("lanes", [1, 6, 7])
def test_chase_kernel_odd_lane_counts(cuda_device, lanes):
    """Lane counts that are no multiple of the kernel's lanes per
    block, with disabled lanes between live ones of one block."""
    boards, labs, prey = encode_lanes(
        cuda_device, 19, random_positions(19, 48, 10, 152, 2))
    live = torch.nonzero(prey >= 0)[:, 0]
    pick = live[torch.arange(lanes, device=cuda_device) * 7 % len(live)]
    prey = prey[pick].clone()
    prey[1::3] = -1
    boards, labs = boards[pick].contiguous(), labs[pick].contiguous()
    cap, core = chase.chase(boards, labs, prey, 19, 40, collect_core=True)
    pcap, pcore = chase.chase_plain(boards, labs, prey, 19, 40,
                                    collect_core=True)
    assert torch.equal(cap, pcap) and torch.equal(core, pcore)
    assert not cap[prey < 0].any() and not core[prey < 0].any()


def test_card_encode_equals_cpu_encode(cuda_device):
    cfg = torchgo.GoConfig(size=19)
    states = random_positions(19, 32, 20, 220, 3)
    gpu = Preprocess(cfg=cfg, device=cuda_device).states_to_tensor(
        torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, states, device=cuda_device, with_labels=False)))
    cpu = Preprocess(cfg=cfg, device="cpu").states_to_tensor(
        torchgo.from_pygo(cfg, states, device="cpu"))
    assert torch.equal(gpu.cpu(), cpu)


def test_tracked_encode_counts_the_launches_the_process_made(cuda_device):
    from rocalphago_tpu_torch.obs import registry, torchobs

    cfg = torchgo.GoConfig(size=19)
    states = torchgo.from_pygo(cfg, random_positions(19, 32, 20, 220, 3),
                               device=cuda_device)
    pre = Preprocess(cfg=cfg, device=cuda_device)
    key = 'kernel_launches_total{{entry="encode.batch",kernel="{}"}}'

    def counts():
        snap = registry.snapshot()["counters"]
        return ({k: snap.get(key.format(k), 0) for k in torchobs.KERNELS},
                torchobs.process_launches())

    (reg0, proc0) = counts()
    for _ in range(3):
        pre.states_to_tensor(states)
    reg1, proc1 = counts()
    grown = {k: proc1[k] - proc0[k] for k in torchobs.KERNELS}
    assert grown["chase"] > 0
    assert {k: reg1[k] - reg0[k] for k in torchobs.KERNELS} == grown


def test_genmove_launches_both_kernels(cuda_device):
    net = CNNPolicy(board=19, layers=3, filters_per_layer=16, seed=0,
                    device=cuda_device)
    out = io.StringIO()
    before = (labels.launches, chase.launches)
    engine = run_gtp(GreedyPolicyPlayer(net), io.StringIO(
        "boardsize 19\ngenmove b\ngenmove w\nquit\n"), out)
    assert labels.launches > before[0] and chase.launches > before[1]
    moves = [r[2:] for r in out.getvalue().split("\n\n")
             if r.startswith("= ")]
    assert len(moves) == 2 and engine.illegal_from_player == 0
    assert all(vertex_to_move(v, 19) is not None for v in moves)


@pytest.mark.parametrize("size", [9, 19, 32])
def test_labels_kernel_region_boards(cuda_device, size):
    """Boards as area scoring labels them: 9 where empty, 0 elsewhere."""
    boards = np.stack([np.asarray(s.board, np.int8).reshape(-1) for s in
                       random_positions(size, 33, 0, size * size * 3 // 4,
                                        4)])
    t = torch.as_tensor(np.where(boards == 0, 9, 0).astype(np.int8),
                        device=cuda_device)
    assert torch.equal(labels.labels(t, size), labels.labels_plain(t, size))


def fake_search(size, feats, gumbel=False):
    """A device search (PUCT, or Gumbel with 24 simulations and 16
    candidates: a plan of 34) with the reference's fakes (uniform
    logits, a stone-count value): exact on any device, so the card's
    search, with every kernel, must equal the CPU's."""
    from rocalphago_tpu_torch.search.device_mcts import (
        make_device_mcts,
        make_gumbel_mcts,
    )

    n = size * size

    def policy(planes):
        return torch.zeros((planes.shape[0], n), device=planes.device)

    def value(planes):
        return (planes[..., 0].sum(dim=(1, 2))
                - planes[..., 1].sum(dim=(1, 2))) / n

    if gumbel:
        return make_gumbel_mcts(torchgo.GoConfig(size=size), feats,
                                feats + ("color",), policy, value, n_sim=24)
    return make_device_mcts(torchgo.GoConfig(size=size), feats,
                            feats + ("color",), policy, value, n_sim=24,
                            max_nodes=20)


def test_device_search_on_the_card_equals_the_cpu(cuda_device):
    """The full 48-plane encode (chase kernel), terminal scoring (labels
    kernel) and the tree walks (tree kernel) on the card give the CPU's
    tree, slab full and terminal leaves included."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES

    cfg = torchgo.GoConfig(size=9)
    states = random_positions(9, 5, 0, 60, 5)
    played_out = pygo.GameState(size=9)
    for mv in [None, None]:
        played_out.do_move(mv)
    before = {m: m.launches for m in (labels, chase, tree)}
    trees = []
    for device in (cuda_device, torch.device("cpu")):
        search = fake_search(9, DEFAULT_FEATURES)
        roots = torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, states + [played_out], device=device, with_labels=False))
        t = search.init(roots)
        t = search.run_sims(t, 24)
        trees.append(t)
    for name in ("prior", "visits", "value_sum", "child", "parent",
                 "paction", "n_nodes"):
        assert torch.equal(getattr(trees[0], name).cpu(),
                           getattr(trees[1], name)), name
    assert all(m.launches > before[m] for m in before)
    assert int(trees[1].n_nodes.max()) == 20
    assert int(trees[1].visits[-1].sum()) == 0       # the finished game


def test_gumbel_search_on_the_card_equals_the_cpu(cuda_device):
    """The Gumbel search with the fakes and one noise draw: on the card
    (every descent through the tree kernel, its root edge forced) the
    CPU's visits, q and ``best`` (the plain walks), chunked and whole;
    every kernel launched. π′ within 1e-6: the card's exp and log round
    differently from the CPU's in the last place."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES

    cfg = torchgo.GoConfig(size=9)
    states = random_positions(9, 5, 0, 60, 7)
    noise = fake_search(9, DEFAULT_FEATURES, gumbel=True).draw_noise(
        5, torch.Generator().manual_seed(1))
    before = {m: m.launches for m in (labels, chase, tree)}
    results = []
    for device in (cuda_device, torch.device("cpu")):
        search = fake_search(9, DEFAULT_FEATURES, gumbel=True)
        roots = torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, states, device=device, with_labels=False))
        whole = search(roots, noise=noise.to(device))
        chunked = search.run_chunked(roots, 5, noise=noise.to(device))
        for x, y in zip(whole, chunked):
            assert torch.equal(x, y)
        results.append(whole)
    assert all(m.launches > before[m] for m in before)
    for x, y in zip(results[0][:3], results[1][:3]):
        assert torch.equal(x.cpu(), y)
    assert float((results[0][3].cpu() - results[1][3]).abs().max()) <= 1e-6
    assert bool((results[1][0].sum(1) == 34).all())


def test_gumbel_chunk_makes_no_host_sync(cuda_device):
    """One Gumbel chunk (every simulation forcing its root edge) and the
    rerank after it queue without a device->host sync."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES

    cfg = torchgo.GoConfig(size=9)
    search = fake_search(9, DEFAULT_FEATURES, gumbel=True)
    roots = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, random_positions(9, 4, 10, 40, 8), device=cuda_device,
        with_labels=False))
    tree, g, cand, _ = search.init(
        roots, generator=torch.Generator(device=cuda_device).manual_seed(0))
    k = search.schedule[0][0]
    search.run_phase(tree, g, cand, 0, 1, k)       # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        search.run_phase(tree, g, cand, 1, 8, k)
        cand = search.rerank(tree, g, cand, k)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(search.root_stats(tree)[0].sum()) == 4 * 9


def test_gumbel_player_answers_a_genmove(cuda_device):
    """``build_player("gumbel-mcts")`` on the committed 9×9 nets, by
    default on the card: a legal genmove from a whole plan."""
    import os

    from rocalphago_tpu_torch.search.players import build_player

    nets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "zero_r5",
        "target_compare", "gumbel")
    player = build_player("gumbel-mcts", os.path.join(nets, "policy.json"),
                          os.path.join(nets, "value.json"), playouts=16)
    assert player.device.type == "cuda"
    out = io.StringIO()
    engine = run_gtp(player, io.StringIO(
        "boardsize 9\ngenmove b\ngenmove w\nquit\n"), out)
    moves = [r[2:] for r in out.getvalue().split("\n\n")
             if r.startswith("= ")]
    assert len(moves) == 2 and engine.illegal_from_player == 0
    assert all(vertex_to_move(v, 9) is not None for v in moves)
    assert player.last_n_sim == 32 and player.reuses == 0   # the plan


def random_slab(batch, seed):
    """A random tree slab of 19×19 edge rows with terminal nodes: node
    i > 0 hangs under a random earlier node's random edge. Returns
    ``(prior, visits, value_sum, child, done, root, parent, paction,
    forced first edges, rng)``."""
    rng = np.random.default_rng(seed)
    m, a = 24, 362
    prior = rng.random((batch, m, a)) ** 8 * (rng.random((batch, m, a))
                                              < 0.3)
    prior = torch.as_tensor(prior / prior.sum(-1, keepdims=True) + 0.0,
                            dtype=torch.float32)
    visits = torch.as_tensor(rng.integers(0, 4, (batch, m, a)) * (
        prior.numpy() > 0), dtype=torch.int32)
    value_sum = torch.as_tensor(rng.uniform(-1, 1, (batch, m, a)),
                                dtype=torch.float32) * (visits > 0)
    parent = torch.full((batch, m), -1, dtype=torch.int32)
    paction = torch.zeros((batch, m), dtype=torch.int32)
    child = torch.full((batch, m, a), -1, dtype=torch.int32)
    for b in range(batch):
        for i in range(1, m):
            p = int(rng.integers(0, i))
            e = int(rng.choice(np.flatnonzero(prior[b, p].numpy() > 0)))
            if child[b, p, e] < 0:
                parent[b, i], paction[b, i], child[b, p, e] = p, e, i
    done = torch.as_tensor(rng.random((batch, m)) < 0.15)
    root = torch.as_tensor(rng.integers(0, 3, batch), dtype=torch.int32)
    forced = torch.as_tensor(np.where(rng.random(batch) < 0.5,
                                      rng.integers(0, a, batch), -1),
                             dtype=torch.int32)
    return (prior, visits, value_sum, child, done, root, parent, paction,
            forced, rng)


@pytest.mark.parametrize("batch", [1, 7, 64])
def test_tree_kernel_matches_plain(cuda_device, batch):
    """Descents (free and with a forced first edge) and backups on a
    random tree slab with terminal nodes, kernel against plain."""
    (prior, visits, value_sum, child, done, root, parent, paction, forced,
     rng) = random_slab(batch, batch)
    cpu = (prior, visits, value_sum, child, done, root)
    gpu = tuple(x.to(cuda_device) for x in cpu)
    for ra in (torch.full((batch,), -1, dtype=torch.int32), forced):
        before = tree.launches
        got = tree.descend(*gpu, ra.to(cuda_device), 5.0)
        assert tree.launches == before + 1
        want = tree.descend_plain(*cpu, ra, 5.0)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    node, action = want
    start = torch.where(action >= 0, node, parent[torch.arange(batch),
                                                  node.long()])
    start_a = torch.where(action >= 0, action,
                          paction[torch.arange(batch), node.long()])
    values = torch.as_tensor(rng.uniform(-1, 1, batch), dtype=torch.float32)
    gv, gs = tree.backup(visits.clone().to(cuda_device),
                         value_sum.clone().to(cuda_device),
                         parent.to(cuda_device), paction.to(cuda_device),
                         start.to(cuda_device), start_a.to(cuda_device),
                         values.to(cuda_device))
    pv, ps = tree.backup_plain(visits.clone(), value_sum.clone(), parent,
                               paction, start, start_a, values)
    assert torch.equal(gv.cpu(), pv) and torch.equal(gs.cpu(), ps)


@pytest.mark.parametrize("batch", [1, 8, 256])
def test_tree_kernel_forced_root_matches_plain(cuda_device, batch):
    """Forced playouts at the root (forced_k 2, and a large k that
    makes every root short of its floor): kernel against plain, free
    descents and forced first edges; the floors decide some descents."""
    (prior, visits, value_sum, child, done, root, *_, forced,
     _) = random_slab(batch, 1000 + batch)
    done[torch.arange(batch), root.long()] = False
    cpu = (prior, visits, value_sum, child, done, root)
    gpu = tuple(x.to(cuda_device) for x in cpu)
    free = torch.full((batch,), -1, dtype=torch.int32)
    decided = 0
    for k in (2.0, 50.0):
        for ra in (free, forced):
            got = tree.descend(*gpu, ra.to(cuda_device), 0.5, k)
            want = tree.descend_plain(*cpu, ra, 0.5, k)
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
        floors = tree.descend_plain(*cpu, free, 0.5, k)
        puct = tree.descend_plain(*cpu, free, 0.5)
        decided += int(((floors[0] != puct[0])
                        | (floors[1] != puct[1])).sum())
    assert decided > 0


def test_selfplay_segment_on_the_card_replays_on_the_cpu(cuda_device):
    """A 10-ply segment of 9×9 self-play on the card (every kernel on
    the path), its actions replayed on the CPU: every action sensible
    there, the same final states, live flags and winners."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.search import selfplay

    cfg = torchgo.GoConfig(size=9)
    nets = [CNNPolicy(board=9, layers=2, filters_per_layer=8, seed=s,
                      device=cuda_device, dtype=torch.float32)
            for s in (1, 2)]
    run = selfplay.make_selfplay_chunked(
        cfg, DEFAULT_FEATURES, nets[0].module, nets[1].module, batch=8,
        max_moves=10, chunk=10, device=cuda_device)
    before = {m: m.launches for m in (labels, chase)}
    res = run(torch.Generator(device=cuda_device).manual_seed(0))
    assert all(m.launches > before[m] for m in before)
    ply = selfplay.Ply(cfg, DEFAULT_FEATURES, None, None, 8, 1.0)
    st = torchgo.new_states(cfg, 8, device="cpu")
    for t in range(10):
        gd = torchgo.group_data(cfg, st.board, labels=st.labels)
        sens = selfplay.sensible_mask(cfg, st, gd)
        a = res.actions[t].cpu()
        at = sens.gather(1, a.clamp(max=80).long()[:, None])[:, 0]
        ok = torch.where(a < 81, at, ~sens.any(dim=1))
        assert bool(ok.all()), t
        st, live = ply.advance(st, a, gd)
        assert torch.equal(live, res.live[t].cpu())
    for name, x in zip(torchgo.GoState._fields, st):
        assert torch.equal(getattr(res.final, name).cpu(), x), name
    assert torch.equal(res.winners.cpu(), torchgo.winner(cfg, st))
    assert np.array_equal(selfplay.host_winners(cfg, st.board),
                          res.winners.cpu().numpy())


@pytest.mark.parametrize("size", [9, 19])
def test_terminal_labels_on_the_card_equal_the_cpu(cuda_device, size):
    cfg = torchgo.GoConfig(size=size)
    sts = random_positions(size, 16, 0, size * size, size)
    before = labels.launches
    got = labels.terminal_labels(cfg, torchgo.from_pygo(
        cfg, sts, device=cuda_device))
    assert labels.launches == before + 1
    want = labels.terminal_labels(cfg, torchgo.from_pygo(cfg, sts,
                                                         device="cpu"))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


# ------------------------------------------------------------ training


def sl_step_run(device, steps, seed=0, dtype=torch.float32):
    """``steps`` SL train steps (symmetries on, momentum, decay) from
    the same seeded 19×19 12 × 32 policy on ``device``; the losses and
    the final params on the CPU."""
    from rocalphago_tpu_torch.training import sl

    net = CNNPolicy(board=19, layers=12, filters_per_layer=32, seed=seed,
                    device=device, dtype=dtype)
    cfg = sl.SLConfig(learning_rate=0.01, momentum=0.9, decay=0.1)
    opt, lr_at = sl.make_optimizer(cfg, net.module.parameters())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = sl.TrainState(net.module, opt, gen)
    step = sl.make_train_step(net.module, opt, lr_at, 19, True)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        planes = torch.as_tensor(
            rng.random((16, 19, 19, 48)) < 0.2, dtype=torch.uint8)
        actions = torch.as_tensor(rng.integers(0, 362, 16), dtype=torch.int32)
        state, m = step(state, planes.to(device), actions.to(device),
                        t=torch.arange(16, device=device) % 8)
        losses.append(float(m["loss"]))
    return losses, {k: v.cpu() for k, v in net.module.state_dict().items()}


def test_sl_step_on_the_card_equals_the_cpu(cuda_device):
    """Float32 with TF32 off: summation order only, the forward
    tolerance of chip_smoke.py's phase 6 (1e-3 absolute + 1e-4
    relative) on the loss and on every parameter after 2 steps."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = sl_step_run(cuda_device, 2)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    cpu = sl_step_run("cpu", 2)
    np.testing.assert_allclose(card[0], cpu[0], atol=1e-3, rtol=1e-4)
    for k in cpu[1]:
        np.testing.assert_allclose(card[1][k].numpy(), cpu[1][k].numpy(),
                                   atol=1e-3, rtol=1e-4, err_msg=k)


def test_sl_steps_on_the_card_repeat_bit_for_bit(cuda_device):
    """Deterministic cuDNN (as the trainer sets it): two runs of 5 bf16
    steps with generator draws end on the same bits."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        a = sl_step_run(cuda_device, 5, dtype=torch.bfloat16)
        b = sl_step_run(cuda_device, 5, dtype=torch.bfloat16)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    assert a[0] == b[0]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


def epilogue_inputs(device, batch, channels, size, layout, dtype, seed):
    """A convolution's output ``z`` in ``dtype`` and ``layout``, a float32
    bias, and an upstream gradient with a nonzero mean (so each
    channel's sum is far from 0), seeded."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shape = (batch, channels, size, size)
    z = torch.randn(shape, generator=g, device=device).to(dtype)
    b = torch.randn(channels, generator=g, device=device) * 0.5
    gy = (torch.randn(shape, generator=g, device=device) + 0.5).to(dtype)
    return (z.contiguous(memory_format=layout), b,
            gy.contiguous(memory_format=layout))


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_epilogue(device, batch, channels, size, layout, dtype, seed):
    """The kernel against the plain versions on one shape, or, for a
    layout that is not channels_last, both wrappers' refusal."""
    z, b, gy = epilogue_inputs(device, batch, channels, size, layout, dtype,
                               seed)
    before = conv_epilogue.launches
    if not z.is_contiguous(memory_format=torch.channels_last):
        with pytest.raises(ValueError, match="channels_last"):
            conv_epilogue.bias_relu_(z.clone(), b)
        with pytest.raises(ValueError, match="channels_last"):
            conv_epilogue.bias_relu_backward(gy, z)
        assert conv_epilogue.launches == before
        return
    for bias in (b, b.to(dtype)):
        y = conv_epilogue.bias_relu_(z.clone(), bias)
        assert torch.equal(bits(y), bits(conv_epilogue.bias_relu_plain(
            z.clone(), bias))), bias.dtype
    assert y.stride() == z.stride()
    gz, gb = conv_epilogue.bias_relu_backward(gy, y)
    assert conv_epilogue.launches == before + 2 + 2
    pgz, pgb = conv_epilogue.bias_relu_backward_plain(gy, y)
    assert gz.stride() == y.stride()
    assert torch.equal(bits(gz), bits(pgz))
    # the float32 sum in the kernel's order against the float64 sum:
    # reordering only, and never further off than PyTorch's own
    # reduction in the working type
    exact = pgz.double().sum(dim=(0, 2, 3))
    tol = 1e-5 * pgz.double().abs().sum(dim=(0, 2, 3))
    assert gb.dtype == torch.float32
    assert ((gb.double() - exact).abs() <= tol).all()
    plain = pgz.sum(dim=(0, 2, 3)).double()
    assert ((gb.double() - exact).abs()
            <= (plain - exact).abs() + tol).all()
    # the same shape gives the same bits
    gz2, gb2 = conv_epilogue.bias_relu_backward(gy, y)
    assert torch.equal(bits(gz2), bits(gz)) and torch.equal(bits(gb2),
                                                            bits(gb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [torch.channels_last,
                                    torch.contiguous_format])
@pytest.mark.parametrize("size", [9, 19])
@pytest.mark.parametrize("channels", [48, 192])
@pytest.mark.parametrize("batch", [1, 7])
def test_conv_epilogue_kernel_matches_plain(cuda_device, batch, channels,
                                            size, layout, dtype):
    check_epilogue(cuda_device, batch, channels, size, layout, dtype,
                   seed=batch * 1000 + channels + size)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_epilogue_kernel_at_the_benchmark_shape(cuda_device, dtype):
    """2,048 x 192 x 19 x 19 channels_last, the SL cell's activations."""
    check_epilogue(cuda_device, 2048, 192, 19, torch.channels_last, dtype,
                   seed=20)


def test_conv_epilogue_odd_shapes_and_views(cuda_device):
    """Channel counts that are no multiple of the vector (scalar path),
    one channel, one point (where contiguous NCHW is channels_last too),
    a misaligned view, and a ``gy`` in the other layout (copied into
    ``y``'s)."""
    for batch, channels, size in ((3, 5, 7), (2, 1, 9), (5, 24, 1)):
        for layout in (torch.channels_last, torch.contiguous_format):
            check_epilogue(cuda_device, batch, channels, size, layout,
                           torch.bfloat16, seed=channels)
    z, b, gy = epilogue_inputs(cuda_device, 9, 16, 5, torch.channels_last,
                               torch.bfloat16, 3)
    # channels_last, starting one value (2 bytes) into its storage
    store = torch.empty(z.numel() + 1, dtype=z.dtype, device=cuda_device)
    view = store[1:].view(9, 5, 5, 16).permute(0, 3, 1, 2)
    view.copy_(z)
    assert view.is_contiguous(memory_format=torch.channels_last)
    want = conv_epilogue.bias_relu_plain(z.clone(), b)
    assert torch.equal(bits(conv_epilogue.bias_relu_(view, b)), bits(want))
    # gy contiguous NCHW against a channels_last y
    gz, gb = conv_epilogue.bias_relu_backward(gy.contiguous(), view)
    pgz, _ = conv_epilogue.bias_relu_backward_plain(gy, want)
    assert torch.equal(bits(gz), bits(pgz))
    assert gz.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        conv_epilogue.bias_relu_(z.transpose(2, 3).contiguous().transpose(
            1, 2), b[:5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bias_relu_on_the_card_is_the_plain_twin(cuda_device, dtype):
    """The seam against ``relu(conv2d(x, w, b))`` on the card: the output
    and the gradients of ``x`` and ``w`` bit for bit (the same cuDNN
    calls, the same epilogue values), the bias gradient within float32
    reordering; under ``no_grad`` the same output, nothing saved."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        g = torch.Generator(device=cuda_device)
        g.manual_seed(5)
        x = torch.randn(64, 48, 19, 19, generator=g, device=cuda_device).to(
            dtype).contiguous(memory_format=torch.channels_last)
        w = torch.randn(192, 48, 5, 5, generator=g, device=cuda_device) * 0.05
        b = torch.randn(192, generator=g, device=cuda_device) * 0.1
        gy = torch.randn(64, 192, 19, 19, generator=g,
                         device=cuda_device).to(dtype).contiguous(
                             memory_format=torch.channels_last)
        for x_grad in (True, False):
            xs = x.clone().requires_grad_(x_grad)
            ws, bs = w.clone().requires_grad_(), b.clone().requires_grad_()
            before = conv_epilogue.launches
            y = conv_epilogue.conv_bias_relu(xs, ws, bs, (2, 2), dtype)
            y.backward(gy)
            assert conv_epilogue.launches == before + 3
            xt = x.clone().requires_grad_(x_grad)
            wt, bt = w.clone().requires_grad_(), b.clone().requires_grad_()
            yt = torch.relu(torch.nn.functional.conv2d(
                xt, wt.to(dtype), bt.to(dtype), padding=(2, 2)))
            yt.backward(gy)
            assert torch.equal(bits(y.detach()), bits(yt.detach()))
            assert torch.equal(bits(ws.grad), bits(wt.grad))
            if x_grad:
                assert torch.equal(bits(xs.grad), bits(xt.grad))
            else:
                assert xs.grad is None
            gz = torch.ops.aten.threshold_backward(gy, yt.detach(), 0)
            exact = gz.double().sum(dim=(0, 2, 3))
            tol = 1e-5 * gz.double().abs().sum(dim=(0, 2, 3))
            assert ((bs.grad.double() - exact).abs() <= tol).all()
        with torch.no_grad():
            before = conv_epilogue.launches
            y = conv_epilogue.conv_bias_relu(x, w, b, (2, 2), dtype)
            assert conv_epilogue.launches == before + 1
            assert y.grad_fn is None
            assert torch.equal(bits(y), bits(yt.detach()))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def test_sl_step_launches_the_epilogue_for_each_convolution(cuda_device):
    """Each SL step sends every trunk convolution through the kernel:
    11 forward launches and 22 backward ones for a 12-layer net, and
    its registry series counts them all."""
    from rocalphago_tpu_torch.obs import torchobs

    before = conv_epilogue.launches
    before_thread = _build_counts()
    sl_step_run(cuda_device, 3, dtype=torch.bfloat16)
    assert conv_epilogue.launches - before == 3 * (11 + 22)
    assert _build_counts() - before_thread == 3 * (11 + 22)
    assert torchobs.process_launches()["conv_epilogue"] == \
        conv_epilogue.launches


def _build_counts():
    from rocalphago_tpu_torch.ops import _build

    return _build.THREAD.counts[conv_epilogue.KERNEL]


def test_device_prefetch_on_the_card_stages_every_batch(cuda_device):
    """50 batches through the side-stream stager, each consumed by a
    kernel queued right after it is handed out: every one equal to its
    host copy."""
    from rocalphago_tpu_torch.data.pipeline import device_prefetch

    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 2, (256, 19, 19, 48)).astype(np.uint8),
             rng.integers(0, 361, 256).astype(np.int32)) for _ in range(50)]
    sums = []
    for planes, actions in device_prefetch(iter(host), cuda_device):
        assert planes.device.type == "cuda"
        # read on the consumer stream before any host sync
        sums.append((planes.sum(dtype=torch.int64),
                     actions.sum(dtype=torch.int64), planes.clone()))
    assert len(sums) == 50
    for (p, a, copy), (hp, ha) in zip(sums, host):
        assert int(p) == int(hp.sum(dtype=np.int64))
        assert int(a) == int(ha.sum(dtype=np.int64))
        assert np.array_equal(copy.cpu().numpy(), hp)


# ------------------------------------------------------- reinforcement


def rl_iteration(device, dtype, seed=0):
    """One REINFORCE iteration on ``device`` (9×9, 2 × 8 policies,
    game batch 8, 24 plies) from seeded nets: ``(the iteration, the
    game result it played, updates per lr, metrics)``."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.training import rl

    learner, opp = (CNNPolicy(board=9, layers=2, filters_per_layer=8, seed=s,
                              device=device, dtype=dtype) for s in (1, 2))
    cfg = torchgo.GoConfig(size=9, komi=torchgo.default_komi(9))
    opt = torch.optim.SGD(learner.module.parameters(), lr=0.1)
    it = rl.RLIteration(cfg, DEFAULT_FEATURES, learner.module, opt, 8, 24,
                        0.67, device=device)
    state = rl.RLState(learner.module, opt,
                       torch.Generator(device=device).manual_seed(seed))
    old = {k: v.clone() for k, v in learner.module.state_dict().items()}
    held = []
    play = it.play
    it.play = lambda *a: held.append(play(*a)) or held[-1]
    metrics = {k: float(v) for k, v in it(state, opp.module).items()}
    del it.play
    new = learner.module.state_dict()
    return it, held[0], {k: ((old[k] - new[k]) / 0.1).cpu() for k in old}, \
        metrics


def test_rl_gradient_on_the_card_equals_the_cpu_replay(cuda_device):
    """Float32 with TF32 off: the card's iteration against the CPU's
    replay of the card's games, within 1e-3 + 1e-4·|x|; the chase and
    labels kernels launched on the card."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.search.selfplay import SelfplayResult
    from rocalphago_tpu_torch.training import rl

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = {m: m.launches for m in (labels, chase)}
    try:
        _, res, card, card_m = rl_iteration(cuda_device, torch.float32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert all(m.launches > before[m] for m in before)
    learner = CNNPolicy(board=9, layers=2, filters_per_layer=8, seed=1,
                        device="cpu", dtype=torch.float32)
    opt = torch.optim.SGD(learner.module.parameters(), lr=0.1)
    it_cpu = rl.RLIteration(torchgo.GoConfig(size=9, komi=7.0),
                            DEFAULT_FEATURES, learner.module, opt, 8, 24,
                            0.67, device="cpu")
    old = {k: v.clone() for k, v in learner.module.state_dict().items()}
    res = SelfplayResult(*(x.cpu() if isinstance(x, torch.Tensor)
                           else torchgo.GoState(*(y.cpu() for y in x))
                           for x in res))
    z = it_cpu.replay(res)
    it_cpu.update()
    cpu_m = {k: float(v) for k, v in rl._metrics(z, res.num_moves).items()}
    assert cpu_m == card_m
    new = learner.module.state_dict()
    moved = 0.0
    for k in old:
        want = ((old[k] - new[k]) / 0.1).numpy()
        np.testing.assert_allclose(card[k].numpy(), want, atol=1e-3,
                                   rtol=1e-4, err_msg=k)
        moved = max(moved, float(np.abs(want).max()))
    assert moved > 1e-3


def test_rl_iterations_on_the_card_repeat_bit_for_bit(cuda_device):
    """bf16, deterministic cuDNN (as the trainer sets it): two
    iterations from one generator state end on the same bits."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        a = rl_iteration(cuda_device, torch.bfloat16, seed=3)
        b = rl_iteration(cuda_device, torch.bfloat16, seed=3)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    assert torch.equal(a[1].actions, b[1].actions)
    assert a[3] == b[3]
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def test_value_games_on_the_card_replay_on_the_cpu(cuda_device):
    """A batch of value games on the card (every kernel on the path),
    its U and actions replayed on the CPU: the same snapshots (every
    field), z, valid and u."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.training import selfplay_data as sd

    cfg = torchgo.GoConfig(size=9, komi=torchgo.default_komi(9))

    def runner(device):
        sl_net, rl_net = (CNNPolicy(board=9, layers=2, filters_per_layer=8,
                                    seed=s, device=device,
                                    dtype=torch.float32) for s in (4, 5))
        return sd.make_value_games_chunked(
            cfg, DEFAULT_FEATURES, sl_net.module, rl_net.module, 8, 40,
            chunk=40, device=device)

    card = runner(cuda_device)
    actions = []
    sample = card.ply.sample
    card.ply.sample = lambda *a: actions.append(sample(*a)) or actions[-1]
    before = {m: m.launches for m in (labels, chase)}
    got = card(torch.Generator(device=cuda_device).manual_seed(6))
    assert all(m.launches > before[m] for m in before)
    assert len(actions) == 40
    cpu = runner("cpu")
    stream = iter(actions)
    cpu.ply.sample = lambda *a: next(stream).cpu()
    want = cpu(torch.Generator(), U=got.u.cpu())
    for name, x, y in zip(torchgo.GoState._fields, got.recorded,
                          want.recorded):
        assert torch.equal(x.cpu(), y), name
    for name in ("z", "valid", "u"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    assert bool(got.valid.any())


def mcts_nets(device, dtype=torch.float32):
    """Small seeded nets of this slice at 9×9: a 2-pool policy, a value
    net and a rollout net."""
    from rocalphago_tpu_torch.models import CNNRollout, CNNValue

    feats = ("board", "ones", "turns_since", "liberties", "sensibleness")
    return (CNNPolicy(feats, board=9, layers=4, filters_per_layer=16,
                      trunk_pool=2, seed=7, device=device, dtype=dtype),
            CNNValue(feats + ("color",), board=9, layers=3,
                     filters_per_layer=16, seed=8, device=device,
                     dtype=dtype),
            CNNRollout(board=9, seed=9, device=device, dtype=dtype))


def test_device_rollout_on_the_card_equals_the_cpu(cuda_device):
    """A wave of 8 leaves (2 of them done padding) rolled out on the card
    and on the CPU under the same draws: the same actions, executed
    plies and winners (float32, TF32 off)."""
    from rocalphago_tpu_torch.search import selfplay

    torch.backends.cudnn.allow_tf32 = False
    cfg = torchgo.GoConfig(size=9, komi=7.0)
    states = random_positions(9, 8, 4, 30, 10)
    for st in states[6:]:
        st.do_move(None)
        st.do_move(None)
    noise = selfplay.gumbel_noise((500, 8, 81),
                                  torch.Generator().manual_seed(2))
    out = []
    for device in (cuda_device, torch.device("cpu")):
        net = mcts_nets(device)[2]
        run = selfplay.make_device_rollout(cfg, net.feature_list,
                                           net.forward, with_steps=True)
        batched = torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, states, device=device, with_history=False,
            with_labels=False))
        record = []
        before = labels.launches
        winners, plies = run(batched, noise=noise.to(device), record=record)
        if device.type == "cuda":
            assert labels.launches > before      # area scoring
        out.append((winners.tolist(), plies,
                    torch.stack(record).cpu().tolist()))
    assert out[0] == out[1] and 0 < out[0][1] < 500


def test_symmetric_and_pooled_forwards_on_the_card_equal_the_cpu(
        cuda_device):
    """The 8-symmetry policy distributions and values, and a pooled
    trunk, card against CPU within 1e-3 + 1e-4·|x| (float32, TF32 off:
    summation order only)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    states = random_positions(9, 8, 4, 40, 11)
    sens = [s.get_legal_moves(include_eyes=False) for s in states]
    got = []
    for device in (cuda_device, torch.device("cpu")):
        pol, val, _ = mcts_nets(device)
        got.append((pol.batch_eval_state(states, sens, symmetric=True),
                    val.batch_eval_state(states, symmetric=True),
                    pol.forward(pol._states_to_planes(states)).cpu()))
    (cd, cv, cl), (hd, hv, hl) = got
    for a, b in zip(cd, hd):
        assert [m for m, _ in a] == [m for m, _ in b]
        np.testing.assert_allclose([p for _, p in a], [p for _, p in b],
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(cv, hv, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(cl.numpy(), hl.numpy(), rtol=1e-4, atol=1e-3)


def test_mcts_player_plays_on_the_card_and_needs_one(cuda_device,
                                                      monkeypatch, tmp_path):
    """``build_player("mcts")`` over spec-CLI nets answers legal genmoves
    on the card with device rollouts (both kernels launched), and raises
    when no card is there and no device is named."""
    import os

    from rocalphago_tpu_torch.models import specs
    from rocalphago_tpu_torch.search.players import build_player

    paths = []
    for kind, extra in (("policy", ["--layers", "3", "--filters", "16"]),
                        ("value", ["--layers", "3", "--filters", "16"]),
                        ("rollout", [])):
        paths.append(os.path.join(tmp_path, f"{kind}.json"))
        specs.main([kind, "--out", paths[-1], "--board", "9", *extra])
    player = build_player("mcts", *paths, playouts=16, device_rollout=True)
    out = io.StringIO()
    before = (labels.launches, chase.launches)
    engine = run_gtp(player, io.StringIO(
        "boardsize 9\ngenmove b\ngenmove w\nquit\n"), out)
    assert labels.launches > before[0] and chase.launches > before[1]
    moves = [r[2:] for r in out.getvalue().split("\n\n")
             if r.startswith("= ")]
    assert len(moves) == 2 and engine.illegal_from_player == 0
    assert all(vertex_to_move(v, 9) is not None for v in moves)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_player("mcts", *paths)


def test_budget_masked_search_on_the_card_equals_the_cpu(cuda_device):
    """Mixed per-row simulation budgets (the playout caps): the card's
    slab equals the CPU's, every retired row bit for bit."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES

    cfg = torchgo.GoConfig(size=9)
    states = random_positions(9, 4, 0, 60, 8)
    budget = torch.tensor([3, 24, 11, 1], dtype=torch.int32)
    before = tree.launches
    trees = []
    for device in (cuda_device, torch.device("cpu")):
        search = fake_search(9, DEFAULT_FEATURES)
        roots = torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, states, device=device, with_labels=False))
        t, ran = search.run_sims_chunked(search.init(roots), 5, n=24,
                                         owned=True,
                                         budget=budget.to(device))
        assert ran == 24
        trees.append(t)
    for name in ("prior", "visits", "value_sum", "child", "parent",
                 "paction", "n_nodes"):
        assert torch.equal(getattr(trees[0], name).cpu(),
                           getattr(trees[1], name)), name
    assert trees[1].visits[:, 0].sum(1).tolist() == budget.tolist()
    assert tree.launches > before


def zero_setup(device, dtype, aux=True):
    """A 9×9 zero iteration over 2 × 8 nets (48 planes, so the chase
    kernel runs), caps and the auxiliary heads on."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES, VALUE_FEATURES
    from rocalphago_tpu_torch.models import CNNValue
    from rocalphago_tpu_torch.training import zero

    pol = CNNPolicy(board=9, layers=2, filters_per_layer=8, seed=1,
                    device=device, dtype=dtype)
    val = CNNValue(board=9, layers=2, filters_per_layer=8, seed=2,
                   device=device, dtype=dtype,
                   aux_heads=("ownership", "score") if aux else ())
    it = zero.ZeroIteration(torchgo.GoConfig(size=9, komi=7.0),
                            DEFAULT_FEATURES, VALUE_FEATURES, 4, 20, 8,
                            sim_chunk=4, replay_chunk=7, cap_p=0.5,
                            cap_cheap=2, aux_weight=1.0 if aux else 0.0,
                            device=device)
    state = zero.init_zero_state(pol.module, val.module, 0.1, seed=4)
    return it, state


def zero_updates(state, old):
    out = {}
    for name, module in (("policy", state.policy), ("value", state.value)):
        new = module.state_dict()
        out.update({f"{name}.{k}": ((old[name][k] - new[k]) / 0.1).cpu()
                    for k in new})
    return out


def test_zero_learn_on_the_card_equals_the_cpu(cuda_device):
    """Float32 with TF32 off: the card plays a batch (all three kernels
    launched), then the card's ``learn`` and the CPU's, on the same
    record, agree within 1e-3 + 1e-4·|x|; the metrics within 1e-5."""
    from rocalphago_tpu_torch.training import zero
    from rocalphago_tpu_torch.training.actor import games_to_host

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = {m: m.launches for m in (labels, chase, tree)}
    try:
        it, state = zero_setup(cuda_device, torch.float32)
        games = it.play(state.policy, state.value, 5)
        assert all(m.launches > before[m] for m in before)
        host = games_to_host(games)
        runs = []
        for device in (cuda_device, torch.device("cpu")):
            it, state = zero_setup(device, torch.float32)
            old = {"policy": {k: v.clone() for k, v in
                              state.policy.state_dict().items()},
                   "value": {k: v.clone() for k, v in
                             state.value.state_dict().items()}}
            state, m = it.learn(state, host)
            runs.append((zero_updates(state, old), zero.metrics_to_host(m)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (card, card_m), (cpu, cpu_m) = runs
    assert card_m.keys() == cpu_m.keys()
    for k in cpu_m:
        np.testing.assert_allclose(card_m[k], cpu_m[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    moved = 0.0
    for k in cpu:
        np.testing.assert_allclose(card[k].numpy(), cpu[k].numpy(),
                                   atol=1e-3, rtol=1e-4, err_msg=k)
        moved = max(moved, float(cpu[k].abs().max()))
    assert moved > 1e-3


def test_zero_iterations_on_the_card_repeat_bit_for_bit(cuda_device):
    """bf16, deterministic cuDNN (as the trainer sets it): two
    iterations from one state end on the same bits."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ends = []
        for _ in range(2):
            it, state = zero_setup(cuda_device, torch.bfloat16)
            for _ in range(2):
                state, m = it(state)
            ends.append((state, {k: float(v) for k, v in m.items()}))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    (a, ma), (b, mb) = ends
    assert ma == mb and torch.equal(a.rng, b.rng)
    for x, y in ((a.policy, b.policy), (a.value, b.value)):
        sx, sy = x.state_dict(), y.state_dict()
        assert all(torch.equal(sx[k], sy[k]) for k in sx)


def test_zero_cli_profile_dir_traces_the_kernels(cuda_device, tmp_path):
    """``--profile-dir`` on a 5×5 zero CLI run on the card (48- and
    49-plane nets, so every encode reads ladders): the Chrome trace it
    writes holds chase, labels and tree launches beside the zero loop's
    spans as ranges, and the run's stream the profiler's start and stop
    records."""
    import json

    from rocalphago_tpu_torch.models import CNNValue
    from rocalphago_tpu_torch.training import zero

    pj, vj = str(tmp_path / "p.json"), str(tmp_path / "v.json")
    CNNPolicy(board=5, layers=1, filters_per_layer=2,
              device=cuda_device).save_model(pj)
    CNNValue(board=5, layers=1, filters_per_layer=2,
             device=cuda_device).save_model(vj)
    out, prof = tmp_path / "out", tmp_path / "prof"
    zero.run_training([pj, vj, str(out), "--game-batch", "2",
                       "--iterations", "1", "--move-limit", "6", "--sims",
                       "2", "--sim-chunk", "2", "--save-every", "1",
                       "--gate-games", "2", "--profile-dir", str(prof)])
    with open(prof / zero.PROFILE_TRACE) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    for name in ("chase_kernel", "labels_kernel", "descend_kernel"):
        assert any(name in k for k in kernels), name
    assert {"zero.iteration", "zero.selfplay", "zero.replay"} <= {
        e["name"] for e in events if e.get("cat") == "user_annotation"}
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["action"] for r in records if r["event"] == "profiler"] == [
        "start", "stop"]


# ------------------------------------------------------------- serving

def small_serve_nets(device, size=9, dtype=torch.bfloat16):
    from rocalphago_tpu_torch.models import CNNValue

    feats = ("board", "ones", "turns_since", "liberties")
    kw = dict(board=size, layers=3, filters_per_layer=16, device=device,
              dtype=dtype)
    return (CNNPolicy(feats, seed=5, **kw),
            CNNValue(feats + ("color",), seed=6, **kw))


def test_pooled_genmove_on_the_card_equals_the_standalone_player(
        cuda_device, monkeypatch):
    """Both evaluate at batch 1: root visits bit-equal on the card; the
    pool's fleet round and the ladder's rungs run there too."""
    from rocalphago_tpu_torch.search import device_mcts
    from rocalphago_tpu_torch.serve import ServePool

    pol, val = small_serve_nets(cuda_device)
    seen = []
    orig = device_mcts.DeviceMCTS.root_stats

    def rec(tree):
        out = orig(tree)
        seen.append(out[0].cpu().clone())
        return out

    monkeypatch.setattr(device_mcts.DeviceMCTS, "root_stats",
                        staticmethod(rec))
    with ServePool(val, pol, n_sim=32) as pool:
        pool.warm()
        sess = pool.open_session()
        for st in random_positions(9, 3, 0, 30, 11):
            want = device_mcts.DeviceMCTSPlayer(val, pol,
                                                n_sim=32).get_move(st)
            got = sess.get_move(st)
            assert got == want and torch.equal(seen[-1], seen[-2])
        sess.close()
        sessions = [pool.open_session(resilient=False) for _ in range(8)]
        moves = pool.driver(sessions).genmove_all(
            random_positions(9, 8, 0, 30, 12))
        assert len(moves) == 8
        assert pool.stats()["evaluator"]["batch_occupancy"] > 0.5


def test_komi_rescoring_and_cache_hits_on_the_card(cuda_device):
    from rocalphago_tpu_torch.search.device_mcts import make_device_mcts
    from rocalphago_tpu_torch.serve import BatchingEvaluator
    from rocalphago_tpu_torch.serve.evalcache import EvalCache

    pol, val = small_serve_nets(cuda_device)
    cfg = pol.cfg
    search = make_device_mcts(cfg, pol.feature_list, val.feature_list,
                              pol.module, val.module, n_sim=8)
    passed = pygo.GameState(size=9)
    passed.do_move(None)
    passed.do_move(None)
    sts = random_positions(9, 6, 0, 40, 13) + [passed]
    states = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, sts, device=cuda_device, with_labels=False))
    p0, v0 = search.eval_batch(states)
    p1, v1 = search.eval_batch_komi(
        states, torch.full((7,), cfg.komi, device=cuda_device))
    assert torch.equal(p0, p1) and torch.equal(v0, v1)
    komi = torch.full((7,), cfg.komi, device=cuda_device)
    komi[-1] = -25.0
    _, v2 = search.eval_batch_komi(states, komi)
    assert float(v2[-1]) == -float(v0[-1]) != 0.0
    assert torch.equal(v2[:-1], v0[:-1])
    ev = BatchingEvaluator(search.eval_with, pol.module, val.module,
                           batch_sizes=(1, 8), cache=EvalCache(capacity=64),
                           key_fn=search.eval_key, board=9, start=False)
    try:
        one = torchgo.GoState(*(x[:1] for x in states))
        want = ev.eval_direct(one)
        for _ in range(2):
            req = ev.submit(one)
            ev.drain_once()
            got = req.result(timeout=60)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        assert ev.cache.stats()["hits"] == 1
    finally:
        ev.close()


def test_cuda_errors_are_classified_as_the_card_raises_them(cuda_device):
    """The card's out-of-memory error is transient (the ladder's reduced
    rung); a sticky CUDA error, raised in a child process because it
    poisons the context, is not."""
    import json
    import os
    import subprocess
    import sys

    from rocalphago_tpu_torch.runtime.retries import is_transient

    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        torch.empty(1 << 46, dtype=torch.uint8, device=cuda_device)
    assert is_transient(err.value)
    code = ("import json, torch\n"
            "from rocalphago_tpu_torch.runtime.retries import is_transient\n"
            "x = torch.zeros(4, device='cuda')\n"
            "i = torch.tensor([1 << 20], device='cuda')\n"
            "try:\n"
            "    x[i] = 1.0\n"
            "    torch.cuda.synchronize()\n"
            "except BaseException as e:\n"
            "    print(json.dumps({'type': type(e).__qualname__,\n"
            "                      'message': str(e)[:80],\n"
            "                      'transient': is_transient(e)}))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=root))
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert rows, proc.stderr[-2000:]
    sticky = json.loads(rows[-1])
    assert sticky["message"].startswith("CUDA error:")
    assert sticky["transient"] is False


def incremental_trajectory(size, plies, seed):
    """A seeded game with passes and captures on the rules oracle: the
    host states of its plies."""
    rng = np.random.default_rng(seed)
    st = pygo.GameState(size=size)
    out = []
    for i in range(plies):
        if st.is_end_of_game:
            break
        moves = st.get_legal_moves(include_eyes=False)
        st.do_move(None if (i % 23 == 22 or not moves)
                   else moves[rng.integers(len(moves))])
        out.append(st.copy())
    return out


@pytest.mark.parametrize("size,plies", [(9, 60), (19, 90)])
def test_incremental_encode_on_the_card_equals_the_cpu(cuda_device, size,
                                                       plies):
    """A trajectory encoded through the incremental cache on the card
    and on the CPU: at every ply the card's planes equal its scratch
    encode and the CPU's planes, and every cache field equals the
    CPU's carry; the chase kernel runs once an encode."""
    from rocalphago_tpu_torch.features import incremental as incr
    from rocalphago_tpu_torch.features.planes import encode

    cfg = torchgo.GoConfig(size=size)
    card = incr.init_cache(cfg, device=cuda_device)
    cpu = incr.init_cache(cfg)
    before = chase.launches
    sts = incremental_trajectory(size, plies, size)
    for i, st in enumerate(sts):
        ts = torchgo.from_pygo(cfg, [st], device="cpu")
        tg = torchgo.from_pygo(cfg, [st], device=cuda_device)
        got, card = incr.encode_step(cfg, tg, card)
        want, cpu = incr.encode_step(cfg, ts, cpu)
        assert torch.equal(got, encode(cfg, tg)), i
        assert torch.equal(got.cpu(), want), i
        for name, a, b in zip(incr.EncodeCache._fields, card, cpu):
            assert torch.equal(a.cpu(), b), (i, name)
    assert chase.launches - before >= len(sts)
    assert int(cpu.stats[0, incr.STAT_REUSED]) > 0


def test_chase_kernel_cores_on_incremental_lanes_match_plain(cuda_device):
    """Every lane the incremental encode sends to the chase on a 19×19
    trajectory, disabled lanes included: the kernel's verdicts and read
    cores equal the plain version's."""
    from rocalphago_tpu_torch.features import incremental as incr

    cfg = torchgo.GoConfig(size=19)
    lanes, inner = [], chase.chase

    def record(boards, labels_, prey, size, depth=40, collect_core=False):
        lanes.append((boards.clone(), labels_.clone(), prey.clone()))
        return inner(boards, labels_, prey, size, depth, collect_core)

    cache = incr.init_cache(cfg, device=cuda_device)
    chase.chase = record
    try:
        for st in incremental_trajectory(19, 90, 19):
            _, cache = incr.encode_step(cfg, torchgo.from_pygo(
                cfg, [st], device=cuda_device), cache)
    finally:
        chase.chase = inner
    boards = torch.cat([b for b, _, _ in lanes])
    labs = torch.cat([lab for _, lab, _ in lanes])
    prey = torch.cat([p for _, _, p in lanes])
    assert bool((prey < 0).any()) and bool((prey >= 0).any())
    got = chase.chase(boards, labs, prey, 19, collect_core=True)
    want = chase.chase_plain(boards, labs, prey, 19, collect_core=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_incremental_selfplay_segment_makes_no_host_sync(cuda_device):
    """Policy self-play with the encode cache: after a warm segment,
    a segment's plies queue without a device->host sync, and the games
    equal those played without the cache."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.search import selfplay

    cfg = torchgo.GoConfig(size=9)
    net = CNNPolicy(board=9, layers=2, filters_per_layer=8, seed=1,
                    device=cuda_device, dtype=torch.float32)
    ply = selfplay.Ply(cfg, DEFAULT_FEATURES, net.module, net.module, 8, 1.0,
                       incremental=True)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    st = torchgo.new_states(cfg, 8, device=cuda_device)
    for t in range(4):                              # warm
        st, _, _ = ply(st, gen, t)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(4, 12):
            st, _, _ = ply(st, gen, t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    runs = [selfplay.make_selfplay_chunked(
        cfg, DEFAULT_FEATURES, net.module, net.module, 8, 16, chunk=8,
        device=cuda_device, incremental=inc)(
            torch.Generator(device=cuda_device).manual_seed(1))
        for inc in (True, False)]
    assert torch.equal(runs[0].actions, runs[1].actions)


def test_gateway_conversation_over_a_card_pool(cuda_device):
    """One gateway conversation over a small card pool (the 48 and 49
    planes, so the ladder planes read with the chase kernel): every
    move legal, the three kernels launched, nothing unhandled."""
    from rocalphago_tpu_torch.gateway.client import GatewayClient
    from rocalphago_tpu_torch.gateway.server import GatewayServer
    from rocalphago_tpu_torch.models import CNNValue
    from rocalphago_tpu_torch.serve import ServePool

    kw = dict(board=9, layers=2, filters_per_layer=16, device=cuda_device)
    pol, val = CNNPolicy(seed=7, **kw), CNNValue(seed=8, **kw)
    with ServePool(val, pol, n_sim=32) as pool:
        pool.warm()
        with GatewayServer(pool, max_conns=2).start() as srv:
            counters = (labels, chase, tree)
            for c in counters:
                c.launches = 0
            st = pygo.GameState(size=9)
            c = GatewayClient("127.0.0.1", srv.port)
            try:
                c.new_game(komi=6.5)
                for color in "bwbw":
                    reply = c.genmove(color)
                    assert reply["rung"] == "search"
                    mv = vertex_to_move(reply["move"], 9)
                    assert mv is None or st.is_legal(mv)
                    st.do_move(mv)
                c.close_game()
            finally:
                c.close()
            launches = {k.__name__: k.launches for k in counters}
            assert all(n > 0 for n in launches.values()), launches
            deadline = time.monotonic() + 10
            while srv.stats()["conns"]["live"] and time.monotonic() < deadline:
                time.sleep(0.02)
            stats = srv.stats()
            assert stats["requests"]["unhandled"] == 0
            assert stats["requests"]["genmoves"] == 4
            assert pool.stats()["sessions"]["live"] == 0


def swap_pool(device):
    from rocalphago_tpu_torch.models import CNNValue
    from rocalphago_tpu_torch.serve import ServePool

    kw = dict(board=9, layers=2, filters_per_layer=16, device=device)
    pol, val = CNNPolicy(seed=11, **kw), CNNValue(seed=12, **kw)
    pool = ServePool(val, pol, n_sim=32)
    pool.warm()
    return pool, pol, val


def scaled(module, s):
    return {k: v * s for k, v in module.state_dict().items()}


def test_hot_swap_under_an_in_flight_genmove_on_the_card(cuda_device):
    """A swap while a session's genmove is searching: that genmove ends
    on the version it pinned, with a legal move; the next one runs on
    the new version."""
    import threading

    pool, pol, val = swap_pool(cuda_device)
    try:
        pinned = threading.Event()
        plain = pool.evaluator.acquire

        def acquire(version=None):
            v = plain(version)
            pinned.set()
            return v

        pool.evaluator.acquire = acquire
        st = pygo.GameState(size=9)
        out = {}
        with pool.open_session() as sess:
            def genmove():
                out["move"] = sess.get_move(st)
                out["version"] = sess.params_version

            t = threading.Thread(target=genmove)
            t.start()
            assert pinned.wait(60)
            v0 = pool.params_version
            v1 = pool.set_params(scaled(pol.module, 0.5),
                                 val.module.state_dict())
            t.join(120)
            assert not t.is_alive() and out["version"] == v0 != v1
            assert out["move"] is None or st.is_legal(out["move"])
            st.do_move(out["move"])
            mv = sess.get_move(st)
            assert sess.params_version == v1
            assert mv is None or st.is_legal(mv)
    finally:
        pool.close()


def test_card_memory_stays_flat_across_swaps(cuda_device):
    """Retired versions free their working copies and the facade nets'
    old modules: five swaps (each with a genmove) leave the allocated
    card memory where the first left it."""
    import gc

    pool, pol, val = swap_pool(cuda_device)
    try:
        st = pygo.GameState(size=9)

        def swap_and_play(i):
            pool.set_params(scaled(pol.module, 1.0 + 0.01 * i),
                            val.module.state_dict())
            with pool.open_session(resilient=False) as sess:
                sess.get_move(st)
            torch.cuda.synchronize()
            gc.collect()
            return torch.cuda.memory_allocated(cuda_device)

        base = swap_and_play(0)
        after = [swap_and_play(i) for i in range(1, 6)]
        assert max(after) <= base, (base, after)
        assert pool.stats()["params"]["swaps"] == 6
    finally:
        pool.close()


def test_selfplay_actor_ships_card_games(cuda_device, tmp_path):
    """The actor CLI's self-play mode plays on the card (the labels
    kernel scores its games, the tree kernel walks its searches) and
    ships the record over the wire."""
    from rocalphago_tpu_torch.replaynet import actor
    from rocalphago_tpu_torch.replaynet.client import ReplayClient
    from rocalphago_tpu_torch.replaynet.server import ReplayService

    svc = ReplayService(capacity=4).start()
    try:
        for k in (labels, tree):
            k.launches = 0
        assert actor.main(["--connect", f"127.0.0.1:{svc.port}",
                           "--spool-dir", str(tmp_path / "a"), "--games",
                           "1", "--mode", "selfplay", "--board", "9",
                           "--device", "cuda"]) == 0
        assert labels.launches > 0 and tree.launches > 0
        with ReplayClient("127.0.0.1", svc.port, attempts=2) as c:
            rec = c.next_batch()["record"]
        assert rec["visits_dtype"] == "int32"
        assert np.asarray(rec["visits"]).shape == (16, 2, 82)
        assert svc.stats()["requests"]["unhandled"] == 0
    finally:
        svc.close()


# ---------------------------------------------------------- data parallel
# Ranks are child processes (parallel.launch.spawn_ranks) that import
# this module; the card machine has one card, so two ranks share it
# (gloo on CUDA tensors) and NCCL runs as a one-rank group.


def _card_sl_step(params, planes, actions, t, mesh=None) -> dict:
    """One float32 SL step (TF32 off) of a 19×19 3 × 32 policy on the
    mesh's rows of the global batch; its loss and params."""
    from rocalphago_tpu_torch.parallel import mesh as meshlib
    from rocalphago_tpu_torch.training import sl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = mesh.device if mesh is not None else torch.device("cuda")
    net = CNNPolicy(board=19, layers=3, filters_per_layer=32,
                    init_weights=False, device=dev, dtype=torch.float32)
    net.module.load_state_dict(params)
    opt, lr_at = sl.make_optimizer(sl.SLConfig(learning_rate=0.05),
                                   net.module.parameters())
    state = sl.TrainState(net.module, opt, torch.Generator(device=dev))
    step = sl.make_train_step(net.module, opt, lr_at, 19, True, mesh=mesh)
    planes, actions, t = meshlib.shard_batch(mesh, (planes, actions, t))
    state, m = step(state, *(torch.from_numpy(x).to(dev)
                             for x in (planes, actions)),
                    t=torch.from_numpy(t).to(dev))
    return {"loss": float(m["loss"]),
            "backend": None if mesh is None else mesh.backend,
            "params": {k: v.cpu() for k, v in
                       net.module.state_dict().items()}}


def _rank_card_sl_step(params, planes, actions, t) -> dict:
    from rocalphago_tpu_torch.parallel import mesh as meshlib

    return _card_sl_step(params, planes, actions, t,
                         meshlib.make_mesh(device="cuda"))


def _rank_nccl(params, planes, actions, t) -> dict:
    """A one-rank NCCL group: an all_reduce, a broadcast and one SL
    step with its gradients all-reduced through the group."""
    import torch.distributed as dist

    from rocalphago_tpu_torch.parallel import mesh as meshlib

    dev = torch.device("cuda", 0)
    mesh = meshlib.Mesh(1, 0, dev, group=dist.group.WORLD)
    x = torch.arange(6, dtype=torch.float32, device=dev)
    y = mesh.all_reduce(x.clone())
    z = mesh.broadcast(torch.arange(3, dtype=torch.int32, device=dev))
    out = _card_sl_step(params, planes, actions, t, mesh)
    out.update(all_reduce=torch.equal(x, y),
               broadcast=z.cpu().tolist())
    return out


def card_step_inputs(seed: int = 7):
    net = CNNPolicy(board=19, layers=3, filters_per_layer=32, seed=seed,
                    device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 2, (16, 19, 19, 48)).astype(np.uint8)
    actions = rng.integers(0, 361, 16).astype(np.int32)
    actions[:3] = 361                      # pass rows, all on rank 0
    t = rng.integers(0, 8, 16).astype(np.int64)
    return dict(params=net.module.state_dict(), planes=planes,
                actions=actions, t=t)


def test_sl_step_over_two_ranks_sharing_the_card(cuda_device, tmp_path):
    """Two ranks on the one card (gloo on CUDA tensors) take the
    one-rank float32 step within ``1e-4 + 1e-4·|x|`` (summation order),
    and agree with each other bit for bit."""
    import os

    from rocalphago_tpu_torch.parallel.launch import spawn_ranks

    inputs = card_step_inputs()
    outs = spawn_ranks(f"{__name__}:_rank_card_sl_step", 2,
                       str(tmp_path / "ranks"), inputs, device="cuda",
                       paths=(os.path.dirname(os.path.abspath(__file__)),))
    one = _card_sl_step(**inputs)
    assert [o["backend"] for o in outs] == ["gloo", "gloo"]
    assert outs[0]["loss"] == outs[1]["loss"]
    assert outs[0]["loss"] == pytest.approx(one["loss"], rel=1e-5)
    for k, v in one["params"].items():
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k]), k
        np.testing.assert_allclose(outs[0]["params"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_one_rank_nccl_group_on_the_card(cuda_device, tmp_path):
    """``init_process_group("nccl")`` with one rank: an all_reduce, a
    broadcast, and an SL step through the group equal to the step
    without one, bit for bit."""
    import os

    from rocalphago_tpu_torch.parallel.launch import spawn_ranks

    inputs = card_step_inputs()
    out, = spawn_ranks(f"{__name__}:_rank_nccl", 1, str(tmp_path / "ranks"),
                       inputs, device="cuda",
                       paths=(os.path.dirname(os.path.abspath(__file__)),))
    one = _card_sl_step(**inputs)
    assert out["backend"] == "nccl"
    assert out["all_reduce"] and out["broadcast"] == [0, 1, 2]
    assert out["loss"] == one["loss"]
    for k, v in one["params"].items():
        assert torch.equal(out["params"][k], v), k
