"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA card; the
card is looked for when a test runs (a fixture), never at import, so
every pytest-xdist worker collects the same tests. The card machine
has no JAX, and ``tests/conftest.py`` imports it, so run this file
there without the conftest::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gpu.py -m gpu

This file imports only torch, numpy and the port. Tolerance: exact for
the kernels and the encode (integer and boolean outputs).
"""

import io

import numpy as np
import pytest
import torch

from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.features import Preprocess
from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
from rocalphago_tpu_torch.models import CNNPolicy
from rocalphago_tpu_torch.ops import chase, labels, tree
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


def fake_search(size, feats):
    """A device search with the reference's fakes (uniform logits, a
    stone-count value): exact on any device, so the card's search, with
    every kernel, must equal the CPU's."""
    from rocalphago_tpu_torch.search.device_mcts import make_device_mcts

    n = size * size

    def policy(planes):
        return torch.zeros((planes.shape[0], n), device=planes.device)

    def value(planes):
        return (planes[..., 0].sum(dim=(1, 2))
                - planes[..., 1].sum(dim=(1, 2))) / n

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
