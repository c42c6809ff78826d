#!/usr/bin/env python3
"""Drive the PyTorch port (``rocalphago_tpu_torch``) on one CUDA card
and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --host-reads DIR   # the port found in DIR:
    #   one zero iteration's host reads (phase 18's count), as JSON
    python3 chip_smoke.py --conv-epilogue    # phases 1 and 24 alone

Phases, in order; any failure exits non-zero before the result line:

1. card: name and power limit (``nvidia-smi``), kernel build time (the
   four sources, one ``nvcc`` each, in parallel);
2. tree kernel vs its plain version: search trees grown at 9×9 and
   19×19, batch 1, 7 and 64, with terminal nodes, forced first edges, a
   slab that fills, the main path's slab (batch 1, 200 nodes, 100
   simulations) and roots moved down the tree -- every descent's node
   and action and every backup's slabs bit-exact;
3. labels kernel vs its plain version: 19×19 boards from seeded random
   play (0, 60 and 200 moves), serpentine snakes at 9, 13, 19 and 25,
   random boards at 7, 9, 13, 25 and 32, and region boards (9 where
   empty, 0 elsewhere, as area scoring sends them) at 9, 19 and 32 --
   bit-exact;
4. chase kernel vs its plain version: lanes harvested from real encodes
   of ladder-heavy and random 19×19 positions, seeded random entries
   and disabled lanes; 1, 6 and 7 lanes with disabled lanes among live
   ones; lanes at 7, 9, 13, 25 and 32 with ladders to every edge --
   verdicts and read cores bit-exact;
5. encode: 19×19 positions encoded on the card equal the CPU encode
   (plain versions) bit for bit;
6. forward: the full-width policy and value nets (19×19, 48 and 49
   planes, 12 layers × 128 filters, the value net's FCN head, fresh
   seeded weights), float32 with TF32 off, card vs CPU within
   ``FORWARD_ATOL``/``FORWARD_RTOL``, at batch 8 and 256;
7. greedy GTP, slice 1's path: the policy saved as a spec, loaded by the
   GTP player factory (``build_player``: the card, bfloat16), and a
   scripted session through ``run_gtp`` with a ladder on the board and
   ``GENMOVES`` genmoves for both colours; every reply a legal vertex,
   no illegal move from the player, and the labels and chase kernels
   launched during it (launch counts reset just before, read just
   after);
8. device search: 8 roots searched together at full width (float32)
   give the visits each gets alone; a chunk of simulations at batch 1
   and 8 (bfloat16) runs under ``torch.cuda.set_sync_debug_mode
   ("error")``, so makes no device→host sync;
9. device-search GTP, this slice's main path: both nets saved as specs
   and loaded by ``build_player("device-mcts", ...)``, a scripted
   session of ``SEARCH_GENMOVES`` genmoves at 100 simulations, then
   ``TIMED_GENMOVES`` under ``time_settings 0 1 1`` (the deadline
   armed); every reply a legal vertex, and the labels, chase and tree
   kernels launched during it (counts reset just before, read just
   after);
10. timings with CUDA events at the main path's shapes (one state per
    genmove or simulation) and at batch 8 and 256, beside each plain
    version and each kernel's roofline bound; the greedy genmove p50;
    the device-search genmove p50 and simulations per second, the
    stages of a simulation, and a profile of one chunk; the tree kernel
    held against its plain version once more on the tree the GTP
    session's last search left and on each tree it is timed on;
11. policy self-play, this slice's headline path: 19×19, two fresh
    12 × 128 bf16 policies, batch 256, up to 300 plies in segments of
    10, stopping when every game is over. An untimed segment; a segment
    under ``set_sync_debug_mode("error")``; the timed run (games per
    minute under the reference's metric name, board-plies/s, mean game
    length, the pipeline's ``host_gap_frac``; chase and labels launched,
    counts reset just before and read just after); its first 8 games
    replayed on the CPU port (every action sensible there, the same
    live rows, boards, done flags and winners); ``winner`` on the card
    against ``host_winners``; the chase kernel on the lanes of one of
    its batch-256 encodes and the labels kernel on its final region
    boards, bit-exact and timed; the stages of a ply and a profile of a
    segment;
12. search self-play: the device-search player's nets, batch 8, 32
    simulations a move, Dirichlet noise (α 0.03, ε 0.25), forced
    playouts (k 2), recorded targets, 8 plies (plies/s, simulations/s;
    every target sums to 1; all three kernels launched); the tree kernel
    with forced playouts bit-exact against its plain version and timed
    on a grown batch-8 slab and on a batch-256 slab grown from phase
    11's positions (that one also with ``forced_k`` 0, the PUCT walk);
13. the CLIs on the committed 9×9 nets and GTP serving, all seven
    child processes at once (their checks are timing-free): the self-play CLI (``python -m
    rocalphago_tpu_torch.interface.selfplay_cli``) in policy mode,
    search mode and Gumbel search mode (``--gumbel --m-root 4``), into
    ``build/smoke_selfplay``, every SGF parsing with the port's reader
    and replaying legally; the tournament CLI, ``gumbel-mcts`` against
    ``device-mcts`` on the committed 9×9 gumbel nets (``TOURNEY_GAMES``
    2, 8 playouts, move limit ``TOURNEY_MOVES`` 12, no forfeit, a log
    line a game), and the Elo CLI over its log (finite ratings); the
    tournament CLI, ``mcts`` with a seeded 9×9 rollout spec and
    ``--device-rollout`` against ``greedy`` on the committed 9×9 nets
    (2 games, 8 playouts, move limit ``TOURNEY_MOVES`` 12, no forfeit);
    and two GTP subprocesses, ``--serve`` on the committed 9×9 nets
    (genmove, komi, both probes) and ``--serve-sizes 9,13,19`` on fresh
    seeded 19×19 12 × 128 FCN specs (phase 19's) re-routed by
    ``boardsize 13``, both exiting 0 with no genmove degraded;
14. the supervised training path at full width, in ``build/smoke_sl``:
    the converter's CLI entry (``rocalphago_tpu_torch.data.convert``)
    on the committed 19×19 games of ``results/sl19_r5/sgf`` (48 planes;
    the manifest counts every game and one position per non-pass move;
    labels and chase launched, counts reset just before and read just
    after, and ``kernel_launches_total`` grown by the same counts, every
    chase launch in ``encode.batch``; positions/s with the native
    replayer, built by ``g++`` just before and timed apart), the native
    replay of every game equal to pygo's on the host (boards, turns,
    kos, steps, ages, actions) and the first game's shard rows equal to
    the card encode of pygo's replay, both replays' host rates; its
    first 2 games converted again by the converter's CLI on the CPU
    (``--device cpu``, a child process beside the resume runs), bit for
    bit; the SL trainer's CLI entry on a fresh seeded 12 × 128 bf16
    policy saved as a spec (minibatch 16, symmetries on,
    2 epochs of 50 steps: finite losses, every artifact, the ``sl.*``
    span paths, the data-wait histogram and ``sl.train_step``'s
    ``kernel_launches_total`` at 0 for every kernel in its
    ``metrics.jsonl``, the exported ``model.json`` answering GTP
    genmoves legally); exact
    resume (killed
    after epoch 0, and after step 25 with a checkpoint every 10, both
    resumed through the CLI to the straight run's params bit for bit);
    the evaluator's ``top1`` equal to the trainer's ``test_accuracy``;
    the value trainer on a seeded 512-position outcome corpus (12 ×
    128 FCN bf16; finite MSEs, the export, the evaluator's MSE); the
    train step at minibatch 16 and 256 with CUDA events (parts, the
    MFU share, a profile of 20 steps) and the cost of deterministic
    cuDNN at 256;
15. the reinforcement stage at full width, in ``build/smoke_rl``, from
    phase 14's SL export: the RL trainer's CLI (``rocalphago_tpu_torch.
    training.rl``) at game batch 8 and move limit 60, 3 iterations (its
    ``rl.*`` span paths in ``metrics.jsonl``), and a run killed after 2
    and resumed through the CLI to the straight run's params and
    generator bit for bit; a replay segment (10 plies
    of the learner's half-batch encode, forward and backward) under
    ``set_sync_debug_mode("error")``; one iteration at the reference's
    shape (game batch 256, move limit 500, 12 × 128 bf16), its play,
    replay and update timed with a sync after each (games per minute
    under the reference's metric, ms per replay ply, the replay's MFU
    share), chase and labels launched (counts reset just before, read
    just after), the params moved and finite, its first 8 games
    replayed on the CPU, the chase kernel on a mid-game replay ply's
    lanes and the labels kernel on its final region boards bit-exact and
    timed, a profile of 10 mid-game replay plies; the value-corpus
    generator's CLI (``....training.selfplay_data``) with the SL export
    before the
    random ply and the RL export after, batch 256, at least
    ``GEN_POSITIONS`` 128 positions (49 planes, z ±1; both kernels launched; valid
    positions/s and yield); the value trainer on that corpus; and two
    device-search GTP genmoves at 100 simulations over the RL export
    and that value net -- the whole pipeline on one card;
16. the Gumbel root search and the evaluation tools: phase 8's 8 roots
    searched together by the Gumbel searcher (float32, 16 simulations,
    m_root 16, one noise draw) give each root's visits and ``best``
    alone, π′ within ``PI_ATOL``; a Gumbel chunk and its rerank at
    batch 1 and 8 (bf16) under ``set_sync_debug_mode("error")``; the
    tree kernel bit-exact against its plain version on the Gumbel-grown
    batch-8 slab with every candidate's root edge forced, and timed;
    the Gumbel GTP session, this slice's main path: both nets loaded
    by ``build_player("gumbel-mcts", ...)``, ``SEARCH_GENMOVES``
    genmoves at 100 simulations, then 4 under ``time_settings 0 1 1``,
    every reply a
    legal vertex, the three kernels launched (counts reset just before,
    read just after), no tree reused, its p50 beside phase 9's; a PUCT
    and a Gumbel search of 100 simulations from one root timed in turns,
    and a profile of a Gumbel chunk; Gumbel search self-play (batch 8, 32 simulations, 4 plies playing the
    halving winner, then 2 sampling π′; every π′ row finite and summing
    to 1; simulations/s; the three kernels launched) (its CLIs run in
    phase 13);
17. the reference's own AlphaGo player, host APV-MCTS, in
    ``build/smoke_mcts``: fresh seeded specs written by the port's spec
    CLI (the 19×19 12 × 128 policy and FCN value nets, a 32-filter
    rollout net, a 12 × 128 policy with two global-pooling blocks); the
    main path, ``build_player("mcts", ...,
    device_rollout=True)`` at ``MCTS_PLAYOUTS`` 16 playouts (the
    reference's default 100, cut), leaf batch 8, λ 0.5,
    rollouts to 500 plies, in a GTP session of ``MCTS_GENMOVES``
    genmoves and ``MCTS_TIMED_GENMOVES`` under ``time_settings 0 1 1``
    (one wave each), every reply a legal vertex, labels and chase
    launched (counts reset just before, read just after), the genmove
    p50, playouts/s and the host stages of a wave; one wave of the
    session's leaves rolled out on the card with its actions recorded
    and replayed through pygo on the CPU (the same winners; the host
    reads of the run counted under ``set_sync_debug_mode("warn")``:
    one per ``ROLLOUT_CHECK_PLIES`` plies and one for the winners), the
    launches of one wave, a profile of 10 rollout plies; a genmove of
    one wave with host rollouts; symmetric policy distributions and
    values at batch 8 and the pooled policy's forward, card vs CPU at
    float32 within ``FORWARD_ATOL``/``FORWARD_RTOL``; a ``ValuePlayer``
    move with a top-16 policy pre-filter (its tournament CLI runs in
    phase 13);
18. the AlphaZero loop, in ``build/smoke_zero``: fresh seeded 19×19
    specs from the spec CLI (the 12 × 128 policy, 48 planes, and the
    12 × 128 FCN value net, 49 planes, with the auxiliary heads grafted
    on); the zero CLI (``rocalphago_tpu_torch.training.zero``) at game
    batch 8, 16 simulations, move limit ``ZERO_MOVES``,
    ``ZERO_ITERATIONS`` 2 iterations, a checkpoint every iteration, the
    gate every 2 and after the last (8 games), Dir(0.03): straight and
    with ``--actor-learner --actors 1`` as child processes, and killed
    after iteration 1 and resumed with the same command in this process
    meanwhile (its first play's record kept for phase 23; the runs'
    checks are timing-free) -- the last two
    end on the straight run's checkpoint, exports, pool and metric rows
    (wall times aside) bit for bit; the straight run's ``metrics.jsonl``
    holds every ``zero.*`` span path of the reference with ``ok`` true
    and a registry record with the search's simulations,
    ``device_occupancy{runner="zero.replay"}`` and the
    ``kernel_launches_total`` series of the ``zero.*`` and
    ``device_mcts.*`` entries and ``untracked`` (the killed and resumed
    runs in process: the series grown by the process's launches, the
    tracked entries' share within them), the actor/learner run's
    the ``learner_*``, ``replay_*`` and ``actor_*`` metrics; a cut run
    (1 iteration, 2 simulations, move limit 4, a 2-game gate) with
    ``--profile-dir``, whose Chrome trace holds chase, labels and tree
    launches by name; one iteration in process with the
    playout caps (p 0.25, cheap 4) and the auxiliary heads (weight 1),
    timed by phase (play, replay, update, a gate match; a sync after
    each) with games/min, simulations/s, the full-search fraction, ms a
    replay ply and the replay's MFU share, the labels, chase and tree
    launches of the iteration (counts reset just before, read just
    after); a replay segment under ``set_sync_debug_mode("error")``, in
    its span and pushed to the replay's pipeline with the runner
    metrics on; a profile of 10 replay plies (kernels a ply, idle
    share); one more iteration's host reads under
    ``set_sync_debug_mode("warn")`` (a fresh process beside the CLI
    runs), equal to the count of the commit
    before the instrumentation (``ZERO_PARENT_HOST_READS``, counted by
    ``python3 chip_smoke.py --host-reads DIR`` on a checkout of it),
    and the instrumentation's cost (span records and registry writes
    of that iteration, each at its cost on this host) under 2% of the
    timed iteration's wall; its first 2
    games learned in float32 (TF32 off) on the card and on the CPU,
    both nets' updates within ``FORWARD_ATOL``/``FORWARD_RTOL``; and the
    committed 9×9 pool of ``results/zero_r5/run`` loaded through
    ``ZeroGate.load``, its last incumbent against its first in an
    8-game raw match (move limit 60);
19. serving, in ``build/smoke_serve``: fresh seeded 19×19 12 × 128 bf16
    specs from the spec CLI (the policy, 48 planes, and the FCN value
    net, 49 planes) loaded into a ``ServePool`` at 100 simulations and
    warmed; ``FleetDriver.genmove_all`` at 1, 8 and 64 sessions,
    ``SERVE_GENMOVES`` 1 round each (moves/s, game-simulations/s against the 1,000 limit,
    evaluator batches, mean occupancy, the three kernels' launches,
    counts reset just before and read just after), a round at 8
    sessions under ``set_sync_debug_mode("error")``, a profiled round
    at 64 sessions and 10 simulations (kernels and host ms a convoy,
    idle share); 4 threaded sessions through the ladder,
    ``SERVE_THREAD_GENMOVES`` 1 genmove each (p50, p99 against the 5 s
    limit, launches a genmove); a
    session under ``slo_s=2.0`` with more simulations than fit,
    answering before the SLO plus about one simulation; a one-session
    pooled genmove and a standalone ``DeviceMCTSPlayer``'s with
    bit-equal root visits; ``eval_batch_komi`` at the default komi
    equal to ``eval_batch`` and a custom komi flipping a passed-out
    row; an ``EvalCache`` hit and an in-batch dedup equal to the
    uncached rows; every rung of the ladder through a GTP engine on a
    pooled session (a fault plan, a real out-of-memory error, a hang
    abandoned by the watchdog, the fallback), every answer legal and
    counted by ``rocalphago-stats``, and a sticky CUDA error raised in
    a child process, classified not transient (its GTP subprocesses
    run in phase 13);
20. the incremental encode: three seeded 19×19 games of ``INCR_PLIES``
    plies (one from a ladder board, two from the empty board, with
    passes and captures), encoded one after another through one carried
    cache (so the second and third start with a jump), on the card
    through the cache and from scratch, bit for bit at every ply, and
    through the cache on the CPU, planes and every cache field equal to
    the card's; the reuse statistics; the chase kernel on every lane
    those encodes launched, disabled lanes included, verdicts and cores
    bit-exact; µs a warm root encode, scratch and incremental, in turns
    (CUDA events and wall), and kernels an encode (the profiler); the
    main path, a GTP session of ``INCR_GENMOVES`` genmoves at 100
    simulations on a ladder board then ``clear_board``, a genmove,
    ``boardsize 19`` and a genmove, by a ``DeviceMCTSPlayer`` over the
    nets ``build_player("device-mcts", ...)`` loaded from phase 9's
    specs with the incremental root encode (the labels, chase and tree
    kernels launched, counts reset just before and read just after;
    every reply legal; the registry's ``encode_delta_total``,
    ``encode_incr_*_total`` and both reset reasons), the same session
    without the cache giving the same replies, each session's genmove
    p50, and a Gumbel genmove with its caches; policy self-play at
    phase 11's shape with the cache and without it, ``INCR_SP_RUNS``
    timed runs each in turns from one seed (the same actions every
    time; games/min), and a segment with the cache under
    ``set_sync_debug_mode("error")``;
21. the network gateway, in ``build/smoke_serve``: phase 19's specs in
    a warmed ``ServePool`` at 100 simulations behind a ``GatewayServer``
    (``GATEWAY_CONNS`` 4 connections) and its ``GatewayHTTP``, both on
    ephemeral ports. The main path: ``run_load`` with 4 connections of
    ``GATEWAY_GENMOVES`` 1 genmove from the empty board, every move
    replayed legally on ``pygo``, the three kernels launched (counts
    reset just before, read just after) as phase 19's threaded sessions
    launch them (a labels and a chase launch an evaluator batch, a
    labels launch a root, two tree launches a simulation), the wire
    p50 and p99 against the 5 s limit beside phase 19's threaded ones,
    ``requests.unhandled`` 0; a fifth connection shed with ``overload``
    and ``retry_after_s`` 1.0, ``connect_with_retry`` admitted once a
    slot frees, and a pool's session cap refusing ``new_game`` the
    same way; an SLO server (``slo_ms`` 2000) over a pool with more
    simulations than fit, answering with ``slo_hit`` within the SLO
    plus about one simulation; the fault wall (an injected kill gets
    ``internal`` and drops its connection, a transient fails one
    request, the server serves on with nothing unhandled and every
    slot back); ``/healthz`` and ``/metrics`` (the shed count equal to
    the servers'); the drain (an in-flight genmove answered, then
    ``goodbye``; ``/healthz`` 503, TCP refused, sessions back to 0,
    the three drain events in order); and the CLIs as a user runs
    them: ``python -m rocalphago_tpu_torch.gateway.server`` on the
    same specs, driven by ``python -m rocalphago_tpu_torch.interface.
    gtp --connect`` (``boardsize 19``, ``clear_board``, ``komi 7.5``,
    two genmoves around a ``play``; every reply ``=``, every vertex
    legal), then SIGTERM: exit 0 within the drain, the drain timeline
    in its metrics file.

22. the network fleet, part 2, in ``build/smoke_fleet`` (phase 19's
    specs and a second seeded pair of the same shape, phase 18's zero
    specs): (a) a ``ParamsPublisher(spill_dir=)`` publishes the second
    pair while a session's genmove is in flight, a ``SpillWatcher``
    swaps it into a warmed 100-simulation pool: that genmove ends on
    its pinned version, the next on the new one; the new version
    evaluates within ``SIZE_ULPS`` of a fresh pool on the second specs
    at batch 8; card memory stays flat across ``FLEET_SWAPS`` more
    swaps; ``rollout_swap_seconds``; (b) a ``CanaryController`` behind
    ``GatewayServer(canary=)``: the candidate arm searches on the staged
    version, scripted outcomes promote one candidate and roll back
    another, whose live session falls back to current; (c) the main
    path: ``run_load`` (``GATEWAY_CONNS`` connections of
    ``ROUTER_GENMOVES`` genmove) through a ``RolloutRouter`` over two
    in-process gateways (a 1-session pool sharing the searcher, and the
    pool), sticky with a spillover, every move legal, the three kernels
    launched as phase 21's load launches them (counts reset just before,
    read just after), the routed p50 beside phase 21's wire p50 and
    beside the same load through a router over the pool's replica alone
    (the hop apart from the replica split); a
    fleet-wide swap and ``await_convergence``; a game failed over
    mid-drain; (d) the CLIs: ``gateway.server --spill``,
    ``rollout.router --replica``, ``gtp --connect`` through the router,
    a spill showing on ``/healthz``, SIGTERM and exit 0 for each; (e)
    replay over the wire: the ``replaynet.server`` CLI, a
    ``--mode selfplay --board 19`` actor on the card, the zero CLI
    learning one iteration with ``--replay-connect``, a synthetic actor
    SIGKILLed mid-run and restarted, produced ids equal to ingested ids,
    and the service drained and restarted, recovering its buffer and
    dedup window.

23. data parallelism, in ``build/smoke_parallel``: two ranks sharing
    the one card (gloo on CUDA tensors), each run started by ``python
    -m torch.distributed.run``, the three CLI runs and the probe's
    kernel checks at once: (a) the SL trainer's CLI on phase 14's spec
    and corpus, ``PAR_STEPS`` steps at global minibatch
    ``PAR_MINIBATCH`` (16 a rank) against one rank's run of the same,
    one epoch record and the artifacts from rank 0 alone, each rank's
    backend; the first step's update within ``PAR_SPLIT_L2`` of the
    same two halves in this process, the updates within
    ``PAR_UPDATE_L2`` and the train loss within ``PAR_LOSS_RTOL`` of
    one rank's; (b) the zero CLI's entry at ``--num-devices 2`` on
    phase 18's specs (``--zero-ranks``: ``zero.run_training`` with its
    first play's record gathered and kept), one iteration against
    phase 18's one-rank run of the same command: the first play's
    actions, live rows, visits and winners bit for bit, the game
    statistics equal, the updates within ``PAR_ZERO_L2``, the labels,
    chase and tree launches of each rank, read from its registry's
    ``kernel_launches_total`` and equal to its process totals; (c) the
    self-play CLI with
    ``--shard``, 8 19×19 games, every SGF byte-equal to one rank's; (d)
    a probe (``--ranks-probe``) in two ranks: the three kernels against
    their plain versions in each rank, then, once the CLI runs have
    ended, the SL step timed with its gradient all-reduce and each
    rank's card memory, and on rank 0 a one-rank NCCL group (an
    all_reduce, a broadcast, an SL step through it equal to one without
    it, the step and the all-reduce timed). Two ranks on one card
    measure overhead, not scaling;
24. the trunk convolutions' epilogue (``ops/conv_epilogue.py``) at the
    SL benchmark cell's shape, 2,048 x 192 x 19 x 19 bfloat16
    channels_last: the forward and the ReLU's gradient bit for bit the
    plain versions', the float32 bias gradient within ``EPI_SUM_RTOL``
    of the float64 sum (of each channel's absolute sum); card ms of each
    direction beside its bytes bound, the plain version's ms and, for
    the backward, PyTorch's bfloat16 reduction in its place (the path
    before the kernel); the same checks and times, with a random
    nonzero bias, at the smoke's own shapes, batch 1, 8 and 256 x 128
    filters x 19 x 19 in bfloat16 and float32 (fresh nets have zero
    biases, so their forwards alone would not see a bias dropped); the
    launches of one SL step of the cell's net
    (13 layers x 192, minibatch 2,048), one a convolution forward and
    two backward.

Every phase's wall time is logged. To keep the whole run well inside
its 1,200 s clock with phase 23 in, timing-free child processes run at
once: phase 13's seven CLIs (phase 16's Gumbel self-play CLI and
tournament, phase 17's tournament and phase 19's two GTP runs until
phase 23 came in), phase
14's CPU conversion beside the SL resume runs, phase 18's straight,
actor/learner and profiled zero CLI runs and its host-reads count
beside the killed run, and phase 23's runs; and depth is cut: phase
9's and 16's GTP sessions 3 genmoves before the timed ones (4), phase
23's probe 10 timed SL steps (20), phase 21's load 1 genmove a
connection (2); phase
16's Gumbel self-play 4 + 2 plies (8 + 4), both tournaments' move
limit 12 (20), phase 17's mcts session at 16 playouts (32), phase 20's
games 80 plies (120) and its timed self-play 1 run a mode (2), phase
23's SL runs a 1% validation and test split; with
phase 21 in: phase 9's and
16's GTP sessions 4 genmoves before the timed ones (6), both
tournaments move limit 20 (40), phase 17's mcts session 2 + 1 genmoves
(2 + 2; its first genmove only warms the move clock) at 32 playouts
(the reference's default 100), phase 19's
fleets 1 round a size (2) and threaded sessions 1 genmove each (2),
phase 20's GTP sessions 2 genmoves before their resets (4), the
generator ≥128 positions, one batch (≥256); earlier: phase 18's CLI
runs 2 iterations (3), phase 20's timed self-play 2 runs a mode (3),
the tournaments 2 games.

Every child process is started so that it dies with this script,
however the script ends; a SIGTERM unwinds the phase under way through
its clean-up. Before the result lines the script checks that no child
process and no non-daemon thread is left (it kills a stray child and
fails).

The kernel line's launches are phases 11, 12, 14's conversion, 15's RL
iteration and generator, 16's GTP session and self-play, 17's GTP
session, 18's zero iteration, 19's fleets and threaded sessions, 20's
GTP session and self-play runs with the cache, 21's gateway load and
22's routed load, and 23's zero CLI's ranks and one-rank self-play
here together,
its times those at self-play's shapes (chase at 1,536 lanes, labels at
256 region boards, the tree at batch 8). The last three lines are the
card (as ``nvidia-smi`` prints it), the kernel table as JSON, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SIZE = 19
SEED = 20261017
GENMOVES = 12            # per colour
SEARCH_GENMOVES = 3      # device-search genmoves at 100 simulations (6
                         # until the gateway phase came in, then 4 until
                         # phase 23)
TIMED_GENMOVES = 4       # then under time_settings 0 1 1
SEARCH_CHECK_SIMS = 16   # simulations of the batched-vs-alone check
CHUNK = 8                # simulations per chunk (the player's default)
SP_BATCH = 256           # policy self-play: games in lockstep
SP_MAX_MOVES = 300       # the reference's headline game length
SP_CHUNK = 10            # plies per segment
SP_REPLAY = 8            # games of the card run replayed on the CPU
SS_BATCH, SS_SIMS, SS_PLIES = 8, 32, 8     # search self-play
SS_ALPHA, SS_EPS, SS_FORCED_K = 0.03, 0.25, 2.0
SS_TREE256_SIMS = 16     # simulations of the batch-256 tree timed
CLI_TIMEOUT_S = 300
PUCT_DIR = os.path.join("results", "zero_r5", "target_compare", "puct")
GUMBEL_DIR = os.path.join("results", "zero_r5", "target_compare", "gumbel")
M_ROOT = 16              # Gumbel root candidates (the player's default)
GS_PLIES, GS_SAMPLE_PLIES = 4, 2   # Gumbel self-play (batch 8, 32 sims;
#                                    8 and 4 until phase 23 came in)
PI_ATOL = 1e-5           # π′ batched vs alone; a π′ row's sum vs 1
# both tournaments' depth, cut from 4 games at move limit 60 to keep the
# smoke inside its clock on a slower host
TOURNEY_GAMES, TOURNEY_PLAYOUTS, TOURNEY_MOVES = 2, 8, 12  # (move limit
#   20 until phase 23 came in,
#   40, then 30, until the gateway phase came in)
FORWARD_ATOL = 1e-3      # float32 card vs CPU, TF32 off: summation
FORWARD_RTOL = 1e-4      # order only, over 12 layers of 1,152-term dots
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# phase 24: the SL benchmark cell's activations and net
EPI_SHAPE = (2048, 192, 19, 19)
EPI_LAYERS = 13
# ... and the smoke's own paths: batch 1 (GTP), 8 (search), 256
# (self-play) on its 12 x 128 nets
EPI_PATH_BATCHES = (1, 8, 256)
EPI_PATH_FILTERS = 128
# the bias gradient's float32 sum against the float64 one, relative to
# each channel's absolute sum (float32 reordering: ~1e-6 observed scale)
EPI_SUM_RTOL = 1e-5
SCALAR_OPS_PER_S = 67e12           # float32 outside the tensor cores
# The bounds' work is the reference's, whatever kernel implements it.
# Chase: integer operations per board point per rung of the reference's
# read (rocalphago_tpu/features/ladders.py::_chase): the liberty table
# (4 neighbour reads, the dedup of 4 roots, the empty test, ~20), the
# prey mask and its liberty points (~10), and per chaser option, two a
# rung: _place (~10), _escaper_response_full's own masks (five
# dilations, the merged chaser group, the gained roots, the atari and
# target masks, ~60) and its two try_moves (two root masks, empty2,
# comp, two dilations, two reductions, ~60); _relabel_place's ~10 for
# each ply is inside the rounding. Counted over the rungs chase_plain
# reports for the run's lanes.
CHASE_OPS_PER_POINT_RUNG = 300
# Labels: per point per hook-and-jump sweep of the reference's fill
# (4 hooks, a jump, the change test), over the sweeps labels_sweeps
# counts for the run's boards.
LABELS_OPS_PER_POINT_SWEEP = 6
BF16_FLOPS_PER_S = 989e12          # H100 SXM data sheet, dense bf16
SL_DIR = os.path.join("build", "smoke_sl")
SL_GAMES = os.path.join("results", "sl19_r5", "sgf")
SL_CPU_GAMES = 2         # games the CPU port converts again
SL_EPOCH_LENGTH = 50     # steps per epoch of the SL runs (2 epochs)
SL_KILL_AFTER = 25       # steps before the mid-epoch kill
SL_TIMED_BATCHES = (16, 256)
VALUE_POSITIONS = 512    # the value trainer's seeded outcome corpus
VALUE_STEPS = 10
QUEUED_STEPS = 3         # ~750 launches at minibatch 256 (see sl_timings)
RL_DIR = os.path.join("build", "smoke_rl")
RL_BATCH = 256           # the RL iteration and the generator: games
RL_MOVES = 500           # the reference's move limit
RL_MID = 250             # the replay ply whose lanes and followers are
#                          checked and profiled (mid-game)
RL_SMALL_BATCH = 8       # the RL CLI's kill/resume runs
RL_SMALL_MOVES = 60
GEN_POSITIONS = 128      # the generator's corpus, at least: one batch
                         # (cut from 512, then 256 for the gateway phase)
MCTS_DIR = os.path.join("build", "smoke_mcts")
MCTS_GENMOVES = 2        # host APV-MCTS genmoves at MCTS_PLAYOUTS (the
                         # first only warms the move clock's rate)
MCTS_TIMED_GENMOVES = 1  # then under time_settings 0 1 1 (cut from 2)
MCTS_PLAYOUTS = 16       # 2 waves a genmove (the reference's default
                         # 100, cut for the clock: 32 until phase 23)
MCTS_LEAF_BATCH = 8      # the reference's default
MCTS_HOST_PLAYOUTS = 8   # one wave with host rollouts
VALUE_TOP_K = 16         # the value player's policy pre-filter
MCTS_TOURNEY_GAMES = 2   # mcts vs greedy, 8 playouts, TOURNEY_MOVES
ROLLOUT_PROFILE_PLIES = 10
ZERO_DIR = os.path.join("build", "smoke_zero")
ZERO_BATCH, ZERO_SIMS = 8, 16     # the zero CLI's game batch and search
ZERO_MOVES = 24          # the cut game length (depth, not width)
ZERO_GATE_GAMES = 8
ZERO_ITERATIONS = 2      # the zero CLI runs (cut from 3 for the clock)
ZERO_ALPHA = 0.03
ZERO_CAP_P, ZERO_CAP_CHEAP, ZERO_AUX = 0.25, 4, 1.0   # the timed iteration
ZERO_CPU_GAMES = 2       # games of the timed iteration learned on the CPU
# card vs CPU learn, per tensor of either net's float32 update summed
# over 48 position-plies of 12-layer forward and backward passes: the
# relative L2 error, and the largest error over the tensor's largest
# entry (each with an absolute floor of FORWARD_ATOL an entry); the
# ReLU gates that float32 rounding flips leave ~1e-3 on the value
# trunk's biases
ZERO_GRAD_L2, ZERO_GRAD_MAX = 5e-3, 1e-2
ZERO_PROFILE_PLIES = 10
ZERO_POOL = os.path.join("results", "zero_r5", "run")
ZERO_POOL_GAMES, ZERO_POOL_MOVES = 8, 60
# the --profile-dir run: one iteration, its game and search cut (depth)
# so the Chrome trace of every launch stays tens of MB
ZERO_PROFILE_ARGS = ("--iterations", "1", "--sims", "2", "--move-limit",
                     "4", "--gate-games", "2")
#: the reference's span paths of a zero iteration (tests/test_obs.py)
ZERO_SPAN_PATHS = ("zero.iteration", "zero.iteration/zero.selfplay",
                   "zero.iteration/zero.replay", "zero.iteration/zero.update",
                   "zero.iteration/zero.gate", "zero.iteration/zero.export",
                   "zero.iteration/zero.save")
#: host reads of one zero iteration (caps and aux, as zero_timed) under
#: set_sync_debug_mode("warn"), counted by ``--host-reads`` in a fresh
#: process on a git archive of the commit before the instrumentation
#: (37df546), "NVIDIA H100 80GB HBM3, 700.00 W"
ZERO_PARENT_HOST_READS = 74
OVERHEAD_LIMIT = 0.02    # the instrumentation's share of an iteration
#: the kernels' names in a profiler trace
KERNEL_SYMBOLS = {"chase": ("chase_kernel",), "labels": ("labels_kernel",),
                  "tree": ("descend_kernel", "backup_kernel")}
SERVE_DIR = os.path.join("build", "smoke_serve")
SERVE_SIMS = 100         # simulations a genmove (the GTP default)
SERVE_FLEETS = (1, 8, 64)  # sessions driven in lockstep
SERVE_GENMOVES = 1       # fleet rounds per fleet size (cut from 2)
SERVE_THREADS = 4        # threaded sessions through the ladder
SERVE_THREAD_GENMOVES = 1  # (cut from 2 for the gateway phase)
SERVE_SLO_S = 2.0        # the SLO run's per-genmove deadline
SERVE_SLO_SIMS = 2000    # more than fit the SLO: the answer is anytime
SERVE_GENMOVE_LIMIT_S = 5.0        # PERF.md section 2: genmove p50
SERVE_SIMS_LIMIT = 1000.0          # PERF.md section 2: game-sims/s
SERVE_HANG_S = 3.0       # the ladder's hang timeout in the hang check
SERVE_PROFILE_SIMS = 10  # the profiled fleet round (64 sessions)
SIZE_ULPS = 4            # bf16 ulps a row may move between padded sizes
INCR_GAMES = 3           # phase 20: seeded 19×19 games through one cache
INCR_PLIES = 80          # (120 until phase 23 came in)
INCR_PASS_EVERY = 23     # a pass every this many plies
INCR_TIMED_PLIES = 60    # warm plies of game 2 timed in turns
INCR_GENMOVES = 2        # per GTP session before its resets, both (4
                         # until the gateway phase came in)
#                          colours (6 in all with the two after them)
INCR_SP_RUNS = 1         # timed self-play runs per mode (cut from 3, then
#                          2 until phase 23 came in)
GATEWAY_CONNS = 4        # phase 21: connections of the load
GATEWAY_GENMOVES = 1     # genmoves a connection (2 until phase 23 came
#                          in)
GATEWAY_SLO_MS = 2000.0  # the SLO server's per-genmove deadline
GATEWAY_DRAIN_S = 30.0   # the CLI's SIGTERM: drain and exit within this
FLEET_DIR = os.path.join("build", "smoke_fleet")
FLEET_SWAPS = 5          # phase 22: swaps the card-memory check spans
CANARY_GAMES = 4         # the canary's budget (4 straight wins: lb 0.51)
ROUTER_GENMOVES = 1      # genmoves a connection of the routed load (cut
#                          from phase 21's 2 for the clock)
CLI_PLAYOUTS = 32        # the gateway CLI's simulations (depth cut)
REPLAY_GAMES = 12        # the synthetic actor's game batches
REPLAY_KILL_AFTER = 3    # its ingested batches before the SIGKILL
WIRE_MOVES = 16          # the self-play actor's move limit (its default)
PAR_DIR = os.path.join("build", "smoke_parallel")
PAR_RANKS = 2            # phase 23: ranks sharing the one card (gloo)
PAR_MINIBATCH = 32       # the SL runs' global minibatch (16 a rank)
PAR_STEPS = 4            # SL steps of the two-rank and one-rank runs
PAR_TIMED_STEPS = 10     # SL steps timed in each rank of the probe
# two ranks against one, the relative L2 distance of a net's update
# (every parameter). In bf16 cuDNN computes 16 rows and 32 with other
# algorithms, so one process's gradient of the 12 x 128 policy from two
# half-minibatches lies ~0.1 from the whole minibatch's (phase 23 logs
# it), and the SL runs' updates drift further apart over their 4 steps
PAR_UPDATE_L2 = 0.5
# the zero CLI's learn over two ranks against one rank's, the same
# relative L2 per net: the policy read 2.446e-03 (NVIDIA H100 80GB HBM3,
# 700.00 W); plain SGD, so a gradient averaged where it is summed over
# the ranks (off by the width) reads 0.5. No game of ZERO_MOVES plies
# ends, so the value net moves in neither run and is held to that alone
PAR_ZERO_L2 = 1e-2
# the two ranks' first SL step against the same two halves in one
# process: the same kernels on the same rows, float32 sums of two terms
PAR_SPLIT_L2 = 1e-5
PAR_LOSS_RTOL = 1e-2     # the SL epoch's mean train loss, two ranks vs one
PAR_SP_GAMES, PAR_SP_MOVES, PAR_SP_CHUNK = 8, 60, 20   # self-play --shard
PAR_TIMEOUT_S = 600      # one torch.distributed.run


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


#: prctl(2), resolved before any fork so the child only calls it
_PRCTL = ctypes.CDLL(None, use_errno=True).prctl
_PR_SET_PDEATHSIG = 1


def die_with_parent(parent: int) -> None:
    """In a child between fork and exec: have the kernel send it SIGKILL
    when this script's process ends, however it ends (a SIGKILL at the
    clock included), and end at once if that already happened."""
    _PRCTL(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


def child_run(*args, **kw):
    """``subprocess.run`` for a child that dies with this script (every
    child is started from the main thread, whose exit the death signal
    follows)."""
    parent = os.getpid()
    return subprocess.run(*args, preexec_fn=lambda: die_with_parent(parent),
                          **kw)


def child_popen(*args, **kw):
    """``subprocess.Popen`` for a child that dies with this script."""
    parent = os.getpid()
    return subprocess.Popen(*args, preexec_fn=lambda: die_with_parent(parent),
                            **kw)


def descendants(pid: int) -> list:
    """``(pid, state, command)`` of every process below ``pid``, read
    from ``/proc``."""
    kids = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        kids.setdefault(int(fields[1]), []).append(
            (int(d), fields[0], cmd.strip()))
    out, todo = [], [pid]
    while todo:
        for kid in kids.get(todo.pop(), []):
            out.append(kid)
            todo.append(kid[0])
    return out


def nothing_left() -> str:
    """The script stops every process it started and leaves no thread
    that would keep its own process alive after ``main`` returns: a
    live child is killed and fails the run, and so does a non-daemon
    thread still alive 30 s after it was found. Returns what is left
    (daemon threads end with the process)."""
    strays = [p for p in descendants(os.getpid()) if p[1] != "Z"]
    for pid, _state, _cmd in strays:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    check(not strays, f"child processes still running: {strays}")
    main = threading.main_thread()
    held = [t for t in threading.enumerate() if t is not main
            and not t.daemon]
    for t in held:
        t.join(timeout=30)
    held = [t.name for t in held if t.is_alive()]
    check(not held, f"non-daemon threads still running: {held}")
    left = sorted(t.name for t in threading.enumerate() if t is not main)
    return f"no child process; daemon threads {left}"


def undegraded(engine) -> None:
    """The GTP engine wraps its player in the degradation ladder: a
    session of an earlier phase must have served every genmove from the
    search rung, so that a player error cannot pass as a move."""
    stats = engine._serve.stats()
    check(stats["degraded_total"] == 0 and not stats["rung_failures"][
        "search"], f"a genmove degraded: {stats}")


# ----------------------------------------------------------------- inputs


def random_positions(pygo, count: int, moves, seed: int, size: int = SIZE):
    """Seeded random play: uniform random empty points, own eyes
    skipped, illegal tries dropped; ``moves[i % len(moves)]`` plies."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        st = pygo.GameState(size=size, komi=7.5)
        target = moves[i % len(moves)]
        tries = 0
        while st.turns_played < target and tries < 4 * target:
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


def ladder_positions(pygo, count: int, seed: int, size: int = SIZE,
                     turn: bool = False):
    """Ladder-heavy boards: standard ladder seeds along the
    anti-diagonal (each white stone flanked on three sides, black to
    move; six of them at 19x19), plus a few seeded random stones that
    break some paths. The ladders run down and right, to the last row
    and column; ``turn=True`` mirrors board ``i`` by ``i % 4`` so that
    they run to every edge."""
    rng = np.random.default_rng(seed)
    seeds = [(r, size - 2 - r) for r in range(1, size - 1, 3)
             if size - 2 - r >= 1]
    out = []
    for i in range(count):
        flip_r, flip_c = turn and i % 2 == 1, turn and i % 4 >= 2

        def at(r, c):
            return (size - 1 - r if flip_r else r,
                    size - 1 - c if flip_c else c)

        st = pygo.GameState(size=size, komi=7.5)
        for r, c in seeds:
            st.do_move(at(r - 1, c), pygo.BLACK)
            st.do_move(at(r, c), pygo.WHITE)
            st.do_move(at(r, c - 1), pygo.BLACK)
            st.do_move(at(r + 1, c - 1), pygo.BLACK)
        for _ in range(i % 5):
            mv = tuple(int(v) for v in rng.integers(0, size, 2))
            if st.board[mv] == 0 and st.is_legal(mv):
                st.do_move(mv, pygo.WHITE if rng.random() < 0.5
                           else pygo.BLACK)
        st.current_player = pygo.BLACK if i % 2 == 0 else pygo.WHITE
        out.append(st)
    return out


def serpentine(size: int) -> np.ndarray:
    """A one-wide boustrophedon snake: one group whose label has to
    travel the longest path a board allows."""
    b = np.zeros((size, size), np.int8)
    for x in range(size):
        if x % 2 == 0:
            b[x, :] = 1
        else:
            b[x, size - 1 if (x // 2) % 2 == 0 else 0] = 1
    return b.reshape(-1)


# ----------------------------------------------------------------- timing


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls
    after a warm-up call. ``queued=True`` first parks the card on a
    spin kernel long enough for the host to queue every call, so the
    events time the kernels back to back on the device and not the
    host's launch overhead (for kernels that are shorter than their
    launch); the plain versions sync with the host inside and are
    timed as they run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:     # ~2 GHz: at least twice the time it takes to queue
        torch.cuda._sleep(int(min(4e9, 4e9 * host_s * reps + 1e6)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call, synchronised: what a caller
    waits, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def bound(bytes_moved: float, ops: float):
    """(least milliseconds, what bounds it) on an H100 SXM."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------------------------------ phases


def phase_card():
    from rocalphago_tpu_torch.ops import _build

    smi = child_run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    _build.KERNELS.build_all()
    log(f"kernel build: {_build.KERNELS.seconds:.1f} s")
    for name, out in _build.KERNELS.log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  nvcc {name}: {line.strip()}")
    for name, counts in sass_sizes(_build).items():
        log(f"  sass {name}: " + ", ".join(
            f"{fn} {k} instructions" for fn, k in counts.items()))
    return card


def sass_sizes(build) -> dict:
    """Instructions per kernel instance in each built library (the code a
    launch fetches), from ``cuobjdump -sass``; empty without it."""
    tool = os.path.join(os.path.dirname(build.KernelLibraries.nvcc()),
                        "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = {}
    for name in build.SOURCES:
        sass = child_run([tool, "-sass", build.KERNELS._target(name)[1]],
                              capture_output=True, text=True,
                              timeout=120).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(r"ILi(\d+)E", line)
                fn = ("generic" if not m or m.group(1) == "0"
                      else f"size {m.group(1)}")
                counts[fn] = 0
            elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S.*;", line):
                counts[fn] += 1
        out[name] = counts
    return out


def phase_labels(pygo, dev):
    from rocalphago_tpu_torch.ops import labels as L

    sts = random_positions(pygo, 1026, (0, 60, 200), SEED)
    boards = np.stack([np.asarray(s.board, np.int8).reshape(-1)
                       for s in sts])
    cases = [(SIZE, boards)]
    for size in (9, 13, 19, 25):
        snake = serpentine(size)
        cases.append((size, np.stack([snake, -snake,
                                      np.ones_like(snake)])))
    # random boards at the other sizes; 7 and 32 take the kernel's
    # generic instance, and 33 boards are no multiple of the boards per
    # block
    for i, size in enumerate((7, 9, 13, 25, 32)):
        sts = random_positions(pygo, 30, (0, size * size // 3,
                                          size * size // 2), SEED + 40 + i,
                               size)
        snake = serpentine(size)
        cases.append((size, np.stack(
            [np.asarray(s.board, np.int8).reshape(-1) for s in sts]
            + [snake, -snake, np.ones_like(snake)])))
    # region boards, as area scoring labels them: 9 where the point is
    # empty, 0 elsewhere (so the empty regions are the groups)
    regions = []
    for i, size in enumerate((9, 19, 32)):
        sts = random_positions(pygo, 33, (0, size * size // 4,
                                          size * size // 2,
                                          size * size * 3 // 4),
                               SEED + 50 + i, size)
        b = np.stack([np.asarray(s.board, np.int8).reshape(-1)
                      for s in sts])
        cases.append((size, np.where(b == 0, 9, 0).astype(np.int8)))
        regions.append(size)
    worst = 0
    for size, b in cases:
        t = torch.as_tensor(b, device=dev)
        got = L.labels(t, size)
        want = L.labels_plain(t, size)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(torch.equal(got, want),
              f"labels kernel differs from plain at size {size}: "
              f"{int((got != want).sum())} points")
        worst = max(worst, err)
    log(f"labels: {len(boards)} 19x19 boards, serpentines at 9/13/19/25, "
        "33 boards each at 7/9/13/25/32, and 33 region boards (9 and 0) "
        f"each at {regions} bit-exact vs plain")
    return worst


class LaneRecorder:
    """Wraps ``ops.chase.chase`` to keep every lane an encode sends."""

    def __init__(self, chase_mod):
        self.mod = chase_mod
        self.inner = chase_mod.chase
        self.lanes = []

    def __enter__(self):
        def record(boards, labels, prey, size, depth=40,
                   collect_core=False):
            self.lanes.append((boards.clone(), labels.clone(), prey.clone()))
            return self.inner(boards, labels, prey, size, depth,
                              collect_core)

        self.mod.chase = record
        return self

    def __exit__(self, *exc):
        self.mod.chase = self.inner


def entry_lanes(pygo, torchgo, dev, count: int, seed: int,
                size: int = SIZE, moves=(40, 90, 140)):
    """Every 2-liberty group of random positions as a chase entry
    (board, carried labels, a prey point of the group)."""
    cfg = torchgo.GoConfig(size=size)
    sts = random_positions(pygo, count, moves, seed, size)
    st = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, sts, device=dev, with_labels=False))
    libs = torchgo.lib_counts_from_labels(cfg, st.board, st.labels)
    lab = st.labels.long()
    two = (libs.gather(1, lab) == 2) & (st.board != 0) & (
        lab == torch.arange(cfg.num_points, device=dev))
    g, p = torch.nonzero(two, as_tuple=True)
    return (st.board[g].contiguous(), st.labels[g].contiguous(),
            p.int().contiguous())


def encode_lanes(pygo, torchgo, dev, sts, size: int = SIZE):
    """The lanes one encode of ``sts`` sends to the chase."""
    from rocalphago_tpu_torch.features.api import Preprocess
    from rocalphago_tpu_torch.ops import chase as C

    cfg = torchgo.GoConfig(size=size)
    with LaneRecorder(C) as rec:
        Preprocess(cfg=cfg, device=dev).states_to_tensor(
            torchgo.seed_labels(cfg, torchgo.from_pygo(
                cfg, sts, device=dev, with_labels=False)))
    return tuple(torch.cat(x) for x in zip(*rec.lanes))


def check_chase(C, boards, labels, prey, size: int, what: str):
    """Kernel against plain on one lane set: verdicts and read cores
    bit-exact, disabled lanes False. Returns the plain verdicts."""
    got_c, got_core = C.chase(boards, labels, prey, size, 40,
                              collect_core=True)
    want_c, want_core = C.chase_plain(boards, labels, prey, size, 40,
                                      collect_core=True)
    torch.cuda.synchronize()
    check(torch.equal(got_c, want_c),
          f"chase {what}: verdicts differ on "
          f"{int((got_c != want_c).sum())} lanes")
    check(torch.equal(got_core, want_core),
          f"chase {what}: cores differ on "
          f"{int((got_core != want_core).any(1).sum())} lanes")
    check(not got_c[prey < 0].any(), f"chase {what}: a disabled lane "
          "read True")
    return want_c


def phase_chase(pygo, torchgo, dev):
    from rocalphago_tpu_torch.ops import chase as C

    sts = (ladder_positions(pygo, 24, SEED + 1)
           + random_positions(pygo, 40, (60, 120, 200), SEED + 2))
    eb, el, ep = encode_lanes(pygo, torchgo, dev, sts)
    rb, rl, rp = entry_lanes(pygo, torchgo, dev, 48, SEED + 3)
    boards = torch.cat([eb, rb, rb[:64]])
    labels = torch.cat([el, rl, rl[:64]])
    prey = torch.cat([ep, rp, torch.full((64,), -1, dtype=torch.int32,
                                         device=dev)])   # disabled lanes
    want_c = check_chase(C, boards, labels, prey, SIZE, "19x19")
    enc_live = int((ep >= 0).sum())
    check(enc_live > 0 and bool(want_c.any()) and not bool(want_c.all()),
          "the chase inputs lack live encode lanes or an outcome")
    log(f"chase: {len(prey)} lanes ({enc_live} live from encodes, "
        f"{len(rp)} random entries, 64 disabled), "
        f"{int(want_c.sum())} captured; verdicts and cores bit-exact")

    # lane counts that are no multiple of the lanes per block, with
    # disabled lanes among the live ones of a block
    live = torch.nonzero(prey >= 0)[:, 0]
    odd = []
    for k in (1, 6, 7):
        pick = live[torch.arange(k, device=dev) * 5 % len(live)]
        p = prey[pick].clone()
        p[1::3] = -1
        odd.append(int(check_chase(C, boards[pick].contiguous(),
                                   labels[pick].contiguous(), p, SIZE,
                                   f"{k} lanes").sum()))
    log(f"chase: 1, 6 and 7 lanes (lanes 1 and 4 disabled), "
        f"{odd} captured; bit-exact")

    # other board sizes (7 and 32 take the kernel's generic instance),
    # ladders to every edge, every third lane disabled
    seen = []
    for i, size in enumerate((7, 9, 13, 25, 32)):
        scale = size * size / (SIZE * SIZE)
        moves = tuple(max(4, int(m * scale)) for m in (40, 90, 140))
        sts = (ladder_positions(pygo, 8, SEED + 10 + i, size, turn=True)
               + random_positions(pygo, 16, moves, SEED + 20 + i, size))
        eb, el, ep = encode_lanes(pygo, torchgo, dev, sts, size)
        rb, rl, rp = entry_lanes(pygo, torchgo, dev, 16, SEED + 30 + i,
                                 size, moves)
        boards = torch.cat([eb, rb])
        labels = torch.cat([el, rl])
        prey = torch.cat([ep, rp])
        prey[1::3] = -1
        want_c = check_chase(C, boards, labels, prey, size,
                             f"{size}x{size}")
        check(bool((prey >= 0).any()), f"no live chase lane at {size}")
        seen.append(f"{size}x{size} {len(prey)} lanes "
                    f"{int(want_c.sum())} captured")
    log("chase: " + ", ".join(seen) + "; verdicts and cores bit-exact")
    return 0


def tree_levels(parent, root, node) -> np.ndarray:
    """Levels from each game's root down to ``node`` (a descent's
    reads), counted on the host from the ``parent`` slab."""
    parent, root = parent.cpu().numpy(), root.cpu().numpy()
    out = []
    for b, x in enumerate(node.cpu().numpy()):
        depth = 1
        while x != root[b] and parent[b, x] >= 0:
            x = parent[b, x]
            depth += 1
        out.append(depth)
    return np.asarray(out)


def grow_trees(T, dev, size: int, batch: int, max_nodes: int, sims: int,
               seed: int, forced: bool = False, c_puct: float = 5.0):
    """Grow ``batch`` search trees of ``(size² + 1)`` actions for ``sims``
    simulations, on the card through the tree kernel and on the CPU
    through its plain versions, from the same seeded priors, terminal
    flags and values; check every descent's node and action and every
    backup's slabs bit-exact. In a batch of more than one, game 0's
    root is terminal (it backs up nothing); a slab of ``max_nodes``
    smaller than ``sims`` fills. ``forced`` forces a random first edge
    on every other game; a small ``c_puct`` follows the values more and
    grows deeper trees. Returns
    the CPU slabs and the levels walked by each simulation's descent."""
    a_n = size * size + 1
    rng = np.random.default_rng(seed)
    shape = (batch, max_nodes, a_n)
    cpu = dict(prior=torch.zeros(shape), visits=torch.zeros(
        shape, dtype=torch.int32), value_sum=torch.zeros(shape),
        child=torch.full(shape, -1, dtype=torch.int32),
        done=torch.zeros((batch, max_nodes), dtype=torch.bool),
        parent=torch.full((batch, max_nodes), -1, dtype=torch.int32),
        paction=torch.zeros((batch, max_nodes), dtype=torch.int32))

    def prior_rows(k):
        # peaked priors, so that the descents go deep
        p = rng.random((k, a_n)) ** 16 * (rng.random((k, a_n)) < 0.3)
        p[:, -1] += 1e-3
        return torch.as_tensor(p / p.sum(1, keepdims=True),
                               dtype=torch.float32)

    cpu["prior"][:, 0] = prior_rows(batch)
    cpu["done"][0, 0] = batch > 1
    gpu = {k: v.to(dev) for k, v in cpu.items()}
    n_nodes = np.ones(batch, np.int64)
    root = torch.zeros(batch, dtype=torch.int32)
    levels = []
    for _ in range(sims):
        ra = torch.full((batch,), -1, dtype=torch.int32)
        if forced:
            ra[1::2] = torch.as_tensor(rng.integers(0, a_n, batch // 2),
                                       dtype=torch.int32)
        args = [cpu[k] for k in ("prior", "visits", "value_sum", "child",
                                 "done")]
        want = T.descend_plain(*args, root, ra, c_puct)
        got = T.descend(*[gpu[k] for k in ("prior", "visits", "value_sum",
                                           "child", "done")],
                        root.to(dev), ra.to(dev), c_puct)
        check(torch.equal(got[0].cpu(), want[0])
              and torch.equal(got[1].cpu(), want[1]),
              f"tree descend differs at {size}x{size}, batch {batch}")
        node, action = want
        levels.append(tree_levels(cpu["parent"], root, node))
        rows = prior_rows(batch)
        term = torch.as_tensor(rng.random(batch) < 0.1)
        start_n, start_a = node.clone(), action.clone()
        for b in range(batch):
            nd, a = int(node[b]), int(action[b])
            if a < 0:
                start_n[b] = cpu["parent"][b, nd]
                start_a[b] = cpu["paction"][b, nd]
                continue
            if n_nodes[b] >= max_nodes:
                continue
            i = int(n_nodes[b])
            n_nodes[b] += 1
            for d in (cpu, gpu):
                d["prior"][b, i] = rows[b].to(d["prior"].device)
                d["done"][b, i] = bool(term[b])
                d["parent"][b, i] = nd
                d["paction"][b, i] = a
                d["child"][b, nd, a] = i
        values = torch.as_tensor(rng.uniform(-1, 1, batch),
                                 dtype=torch.float32)
        T.backup_plain(cpu["visits"], cpu["value_sum"], cpu["parent"],
                       cpu["paction"], start_n, start_a, values)
        T.backup(gpu["visits"], gpu["value_sum"], gpu["parent"],
                 gpu["paction"], start_n.to(dev), start_a.to(dev),
                 values.to(dev))
        for k in ("visits", "value_sum"):
            check(torch.equal(gpu[k].cpu(), cpu[k]),
                  f"tree backup: {k} differs at {size}x{size}, batch "
                  f"{batch}")
    check(batch == 1 or int(cpu["visits"][0].sum()) == 0,
          "a terminal root backed up")
    return cpu, np.stack(levels)


def phase_tree(dev):
    """Tree kernel against its plain version on grown trees: 9×9 and
    19×19, batch 1, 7 and 64, terminal nodes, a forced first edge, a
    slab that fills, the main path's slab (batch 1, 200 nodes, 100
    simulations), and descents from roots moved down the tree."""
    from rocalphago_tpu_torch.ops import tree as T

    seen = []
    for size in (9, 19):
        for batch, m, sims in ((1, 64, 48), (1, 200, 100), (7, 48, 64),
                               (64, 24, 40)):
            for forced, c_puct in ((False, 5.0), (True, 0.5)):
                cpu, levels = grow_trees(T, dev, size, batch, m, sims,
                                         SEED + size + batch + forced,
                                         forced, c_puct)
            # roots moved to a random expanded node of each game
            root = torch.as_tensor(
                [int(np.random.default_rng(b).integers(
                    0, max(1, int((cpu["parent"][b] >= 0).sum()) + 1)))
                 for b in range(batch)], dtype=torch.int32)
            free = torch.full((batch,), -1, dtype=torch.int32)
            args = [cpu[k] for k in ("prior", "visits", "value_sum",
                                     "child", "done")]
            want = T.descend_plain(*args, root, free, 5.0)
            got = T.descend(*[x.to(dev) for x in args], root.to(dev),
                            free.to(dev), 5.0)
            check(torch.equal(got[0].cpu(), want[0])
                  and torch.equal(got[1].cpu(), want[1]),
                  f"tree descend from moved roots differs at {size}")
            seen.append(f"{size}x{size} batch {batch} slab {m} "
                        f"({int((cpu['parent'] >= 0).sum())} nodes, "
                        f"deepest {int(levels.max())} levels)")
    log("tree: descend and backup bit-exact vs plain at every simulation: "
        + ", ".join(seen))
    return 0


def phase_encode(pygo, torchgo, dev):
    from rocalphago_tpu_torch.features.api import Preprocess

    cfg = torchgo.GoConfig(size=SIZE)
    sts = (random_positions(pygo, 240, (10, 50, 100, 160, 220), SEED + 4)
           + ladder_positions(pygo, 16, SEED + 5))
    gpu = Preprocess(cfg=cfg, device=dev)
    cpu = Preprocess(cfg=cfg, device="cpu")
    for i in range(0, len(sts), 64):
        chunk = sts[i:i + 64]
        g = gpu.states_to_tensor(torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, chunk, device=dev, with_labels=False)))
        c = cpu.states_to_tensor(torchgo.seed_labels(cfg, torchgo.from_pygo(
            cfg, chunk, device="cpu", with_labels=False)))
        check(g.shape == (len(chunk), SIZE, SIZE, 48), f"shape {g.shape}")
        check(torch.equal(g.cpu(), c),
              f"card encode differs from CPU encode in chunk {i // 64}")
    log(f"encode: {len(sts)} 19x19 positions, card == CPU bit for bit")


def phase_forward(torchgo, dev):
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    for cls, planes_n, what in ((CNNPolicy, 48, "policy logit"),
                                (CNNValue, 49, "value")):
        gpu = cls(board=SIZE, layers=12, filters_per_layer=128,
                  seed=SEED, device=dev, dtype=torch.float32)
        cpu = cls(board=SIZE, layers=12, filters_per_layer=128,
                  seed=SEED, device="cpu", dtype=torch.float32)
        for batch in (8, 256):
            planes = torch.as_tensor((rng.random(
                (batch, SIZE, SIZE, planes_n)) < 0.3).astype(np.float32))
            g = gpu.forward(planes.to(dev)).cpu()
            c = cpu.forward(planes)
            check(bool(torch.isfinite(g).all()), f"non-finite {what}s")
            err = float((g - c).abs().max())
            check(torch.allclose(g, c, atol=FORWARD_ATOL,
                                 rtol=FORWARD_RTOL),
                  f"{what} forward batch {batch}: max abs err {err}")
            log(f"forward: {what}s, batch {batch}, 12x128 fp32 (TF32 off), "
                f"card vs CPU max abs err {err:.3g} (max |{what}| "
                f"{float(c.abs().max()):.3g})")


class Timed(io.StringIO):
    """Input stream that stamps when each line is handed out."""

    def __init__(self, text):
        super().__init__(text)
        self.stamps = []

    def __iter__(self):
        while line := self.readline():
            self.stamps.append(time.monotonic())
            yield line


def model_specs(dev):
    """The full-width nets saved as specs (fresh weights from the seed):
    the 19×19 ``CNNPolicy`` and the ``CNNValue`` with its FCN head."""
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue

    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "smoke_model")
    os.makedirs(model_dir, exist_ok=True)
    specs = (os.path.join(model_dir, "policy19.json"),
             os.path.join(model_dir, "value19.json"))
    CNNPolicy(board=SIZE, layers=12, filters_per_layer=128, seed=SEED,
              device=dev).save_model(specs[0])
    CNNValue(board=SIZE, layers=12, filters_per_layer=128, seed=SEED + 1,
             device=dev).save_model(specs[1])
    return specs


def phase_gtp(dev, counters):
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
    from rocalphago_tpu_torch.search.players import build_player

    # the user's route: a saved spec, loaded by the GTP entry's player
    # factory on its default device (the card) and working type (bf16)
    player = build_player("greedy", model_specs(dev)[0])
    net = player.policy
    check(net.device.type == "cuda" and net.module.dtype == torch.bfloat16,
          f"the GTP player runs on {net.device} in {net.module.dtype}")
    # a ladder: white (D4) flanked on three sides, black to move
    setup = ["boardsize 19", "clear_board", "komi 7.5", "play b C4",
             "play w D4", "play b D3", "play w Q16", "play b E3"]
    moves = [f"genmove {c}" for _ in range(GENMOVES) for c in "bw"]
    script = "\n".join(setup + moves + ["final_score", "quit"]) + "\n"

    instream, out = Timed(script), io.StringIO()
    for c in counters:
        c.launches = 0
    engine = run_gtp(player, instream, out)
    torch.cuda.synchronize()
    undegraded(engine)
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    replies = [r for r in out.getvalue().split("\n\n") if r.strip()]
    check(len(replies) == len(setup) + len(moves) + 2,
          f"{len(replies)} replies to {len(setup) + len(moves) + 2} "
          "commands")
    for cmd, reply in zip(setup + moves, replies):
        check(reply.startswith("="), f"{cmd!r} -> {reply!r}")
    for reply in replies[len(setup):len(setup) + len(moves)]:
        move = vertex_to_move(reply[1:].strip(), SIZE)
        check(move is not None, f"genmove passed: {reply!r}")
    check(engine.illegal_from_player == 0,
          f"illegal_from_player = {engine.illegal_from_player}")
    for name, n in launches.items():
        check(n > 0, f"the {name} kernel was not launched by the genmoves")
    stamps = instream.stamps
    g0 = len(setup)
    lat = sorted(stamps[i + 1] - stamps[i] for i in range(g0, g0 + len(moves)))
    p50 = lat[len(lat) // 2] * 1e3
    log(f"gtp: {len(moves)} genmoves on the 19x19 12x128 bf16 net, all "
        f"legal vertices, illegal_from_player 0; launches {launches}; "
        f"genmove p50 {p50:.1f} ms (max {lat[-1] * 1e3:.1f} ms)")

    # where a genmove's time goes, stage by stage on the final position
    from rocalphago_tpu_torch.engine import torchgo

    st, cfg = engine.state, net.cfg
    parts = {"host sensible moves": lambda: st.get_legal_moves(
        include_eyes=False)}
    state = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, [st], device=dev, with_labels=False))
    planes = net.preprocess.states_to_tensor(state)
    parts["from_pygo + labels"] = lambda: torchgo.seed_labels(
        cfg, torchgo.from_pygo(cfg, [st], device=dev, with_labels=False))
    parts["encode (48 planes)"] = lambda: net.preprocess.states_to_tensor(
        state)
    parts["forward (bucket 8)"] = lambda: net.forward(
        net._pad_bucket(planes)[0])
    log("genmove stages [" + ", ".join(
        f"{k} {wall_ms(f, 10):.2f} ms" for k, f in parts.items()) + "]")
    return launches, p50


def phase_timings(pygo, torchgo, dev, card):
    """Kernel, plain and bound times at the main path's shapes (batch
    1 per genmove: one board for labels, ``chase_slots`` lanes for the
    chase) and at batch 8 and 256."""
    from rocalphago_tpu_torch.features.api import Preprocess
    from rocalphago_tpu_torch.ops import chase as C
    from rocalphago_tpu_torch.ops import labels as L

    cfg = torchgo.GoConfig(size=SIZE)
    n = cfg.num_points
    pre = Preprocess(cfg=cfg, device=dev)
    rows = {}
    for batch in (1, 8, 256):
        sts = (ladder_positions(pygo, max(1, batch // 8), SEED + 6)
               + random_positions(pygo, batch - max(1, batch // 8),
                                  (60, 120, 180), SEED + 7 + batch))
        st = torchgo.from_pygo(cfg, sts, device=dev, with_labels=False)
        boards = st.board
        with LaneRecorder(C) as rec:
            pre.states_to_tensor(torchgo.seed_labels(cfg, st))
        cb, cl, cp = rec.lanes[0]

        lab_ms = cuda_ms(lambda: L.labels(boards, SIZE), 200, queued=True)
        lab_wall = wall_ms(lambda: L.labels(boards, SIZE), 200)
        lab_plain = cuda_ms(lambda: L.labels_plain(boards, SIZE), 5)
        sweeps = labels_sweeps(boards)
        lab_bound = bound(boards.numel() * 5,
                          sweeps * boards.numel()
                          * LABELS_OPS_PER_POINT_SWEEP)
        ch_ms = cuda_ms(lambda: C.chase(cb, cl, cp, SIZE), 200, queued=True)
        ch_wall = wall_ms(lambda: C.chase(cb, cl, cp, SIZE), 200)
        ch_plain = cuda_ms(lambda: C.chase_plain(cb, cl, cp, SIZE), 3)
        _, rungs = C.chase_plain(cb, cl, cp, SIZE, return_rungs=True)
        ch_bound = bound(cb.numel() * 5 + cp.numel() * 5,
                         int(rungs.sum()) * n * CHASE_OPS_PER_POINT_RUNG)
        d = int(torch.argmax(rungs))
        deep_ms = cuda_ms(lambda: C.chase(cb[d:d + 1], cl[d:d + 1],
                                          cp[d:d + 1], SIZE), 100,
                          queued=True)
        rows[batch] = dict(labels=(lab_ms, lab_plain, lab_bound),
                           chase=(ch_ms, ch_plain, ch_bound),
                           lanes=len(cp), live=int((cp >= 0).sum()),
                           rungs=int(rungs.sum()))
        log(f"timing batch {batch} [{card}]: labels [{batch},{n}] kernel "
            f"{lab_ms:.4f} ms (host wall per call {lab_wall:.4f} ms), "
            f"plain {lab_plain:.3f} ms, bound "
            f"{lab_bound[0]:.6f} ms ({lab_bound[1]}, {sweeps} sweeps); "
            f"chase {len(cp)} lanes ({rows[batch]['live']} live, "
            f"{rows[batch]['rungs']} rungs) kernel {ch_ms:.4f} ms (host "
            f"wall per call {ch_wall:.4f} ms), plain "
            f"{ch_plain:.3f} ms, bound {ch_bound[0]:.6f} ms "
            f"({ch_bound[1]}); deepest lane {int(rungs[d])} rungs, "
            f"{deep_ms:.4f} ms alone")
    return rows


def searcher(pol, val, n_sim: int, max_nodes=None):
    from rocalphago_tpu_torch.search.device_mcts import make_device_mcts

    return make_device_mcts(pol.cfg, pol.feature_list, val.feature_list,
                            pol.module, val.module, n_sim=n_sim,
                            max_nodes=max_nodes)


def bridged(torchgo, cfg, sts, dev):
    return torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, sts, device=dev, with_labels=False))


def phase_batched_search(pygo, torchgo, dev):
    """8 roots searched together give the visits each gets alone: the
    full-width nets in float32 (TF32 off; bfloat16 rounds differently at
    batch 1 and 8, and its ties would be broken by that), 16
    simulations."""
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue

    pol = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                    seed=SEED, device=dev, dtype=torch.float32)
    val = CNNValue(board=SIZE, layers=12, filters_per_layer=128,
                   seed=SEED + 1, device=dev, dtype=torch.float32)
    search = searcher(pol, val, SEARCH_CHECK_SIMS)
    sts = (random_positions(pygo, 6, (0, 30, 80, 130, 180, 230), SEED + 8)
           + ladder_positions(pygo, 2, SEED + 9))
    together, _ = search(bridged(torchgo, pol.cfg, sts, dev))
    alone = torch.cat([search(bridged(torchgo, pol.cfg, [st], dev))[0]
                       for st in sts])
    torch.cuda.synchronize()
    check(bool((together.sum(1) == SEARCH_CHECK_SIMS).all()),
          f"batched search ran {together.sum(1).tolist()} simulations")
    check(torch.equal(together, alone),
          "a batch of 8 roots searched together differs from each root "
          f"alone in {int((together != alone).any(1).sum())} roots")
    log(f"search: 8 roots at 19x19 full width (fp32), {SEARCH_CHECK_SIMS} "
        "simulations, visits batched == alone on every root "
        f"({int((together > 0).sum())} visited root edges)")
    return pol, val, sts


def phase_sync_free(pygo, torchgo, dev, pol, val):
    """One chunk of simulations makes no device→host sync: run under
    ``torch.cuda.set_sync_debug_mode("error")`` at batch 1 and 8, full
    width, bfloat16. Returns the batch-8 tree."""
    search = searcher(pol, val, CHUNK)
    tree = None
    for batch in (1, 8):
        sts = random_positions(pygo, batch, (20, 90, 160, 230),
                               SEED + 10 + batch)
        tree = search.init(bridged(torchgo, pol.cfg, sts, dev))
        search.simulate(tree)        # warm: cached tables, cuDNN
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(CHUNK):
                search.simulate(tree)
        except RuntimeError as e:
            raise SmokeFailure(f"a host sync inside a chunk (batch "
                               f"{batch}): {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        visits, _ = search.root_stats(tree)
        check(bool((visits.sum(1) == CHUNK + 1).all()),
              f"sync-free chunk: visits {visits.sum(1).tolist()}")
    log(f"search: a chunk of {CHUNK} simulations at batch 1 and 8 "
        "(19x19, full width, bf16) ran with no device->host sync")
    return tree


def phase_search_gtp(player, counters, what: str = "device-search"):
    """The main path: the device-search player (``what``) that the GTP
    player factory built from the saved specs, a scripted session at 100
    simulations a move, then moves under ``time_settings 0 1 1`` (the
    deadline armed)."""
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move

    for net in (player.policy, player.value):
        check(net.device.type == "cuda" and net.module.dtype == torch.bfloat16,
              f"the device-search nets run on {net.device} in "
              f"{net.module.dtype}")
    check(player.value.module.head == "fcn" and player.n_sim == 100,
          "the device-search player is not the FCN / 100-playout default")
    setup = ["boardsize 19", "clear_board", "komi 7.5", "play b C4",
             "play w D4", "play b D3", "play w Q16", "play b E3"]
    searched = [f"genmove {'wb'[i % 2]}" for i in range(SEARCH_GENMOVES)]
    timed = [f"genmove {'wb'[i % 2]}" for i in range(TIMED_GENMOVES)]
    script = "\n".join(setup + searched + ["time_settings 0 1 1"] + timed
                       + ["final_score", "quit"]) + "\n"
    runs = []
    inner = player.get_move

    def recorded(state):
        move = inner(state)
        runs.append((player.last_n_sim, player.last_deadline_hit,
                     player.reuses))
        return move

    player.get_move = recorded
    instream, out = Timed(script), io.StringIO()
    for c in counters:
        c.launches = 0
    engine = run_gtp(player, instream, out)
    torch.cuda.synchronize()
    undegraded(engine)
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    player.get_move = inner
    replies = [r for r in out.getvalue().split("\n\n") if r.strip()]
    cmds = setup + searched + ["time_settings 0 1 1"] + timed
    check(len(replies) == len(cmds) + 2,
          f"{len(replies)} replies to {len(cmds) + 2} commands")
    for cmd, reply in zip(cmds, replies):
        check(reply.startswith("="), f"{cmd!r} -> {reply!r}")
        if cmd.startswith("genmove"):
            check(vertex_to_move(reply[1:].strip(), SIZE) is not None,
                  f"genmove passed: {reply!r}")
    check(engine.illegal_from_player == 0,
          f"illegal_from_player = {engine.illegal_from_player}")
    for name, n in launches.items():
        check(n > 0, f"the {name} kernel was not launched by the "
              f"{what} genmoves")
    check([r[0] for r in runs[:SEARCH_GENMOVES]] == [100] * SEARCH_GENMOVES,
          f"simulations per searched move: {[r[0] for r in runs]}")
    stamps = instream.stamps
    g0 = len(setup)
    lat = [stamps[i + 1] - stamps[i] for i in range(g0, g0 + SEARCH_GENMOVES)]
    p50 = sorted(lat)[len(lat) // 2] * 1e3
    # the first search pays the value net's first launches; the rate
    # is over the others
    sims_per_s = (sum(r[0] for r in runs[1:SEARCH_GENMOVES])
                  / sum(lat[1:]))
    t0 = g0 + SEARCH_GENMOVES + 1
    tlat = [stamps[i + 1] - stamps[i] for i in range(t0, t0 + TIMED_GENMOVES)]
    log(f"{what} gtp: {SEARCH_GENMOVES} genmoves at 100 simulations "
        f"on the 19x19 12x128 bf16 policy and FCN value nets, all legal "
        f"vertices; launches {launches}; genmove p50 {p50:.1f} ms (each "
        f"{[round(x * 1e3, 1) for x in lat]} ms), {sims_per_s:.1f} "
        f"simulations/s; reuses {runs[SEARCH_GENMOVES - 1][2]}")
    log(f"{what} gtp under time_settings 0 1 1: simulations "
        f"{[r[0] for r in runs[SEARCH_GENMOVES:]]}, deadline hit "
        f"{[r[1] for r in runs[SEARCH_GENMOVES:]]}, genmove ms "
        f"{[round(x * 1e3, 1) for x in tlat]}")
    return dict(launches=launches, p50=p50, sims_per_s=sims_per_s,
                player=player, state=engine.state, reuses=runs[-1][2])


def sim_stages(torchgo, search, tree, reps: int):
    """Host milliseconds of each stage of a simulation, synchronised
    after every stage (the stages of ``DeviceMCTS.simulate``)."""
    from rocalphago_tpu_torch.ops import tree as T
    from rocalphago_tpu_torch.search import device_mcts as D
    from rocalphago_tpu_torch.features.planes import encode
    from rocalphago_tpu_torch.search.selfplay import sensible_mask

    cfg = search.cfg
    free = torch.full_like(tree.n_nodes, -1)
    sums: dict = {}

    def lap(name, t):
        torch.cuda.synchronize()
        now = time.perf_counter()
        sums[name] = sums.get(name, 0.0) + (now - t) * 1e3
        return now

    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            node, action = T.descend(tree.prior, tree.visits,
                                     tree.value_sum, tree.child,
                                     tree.states.done, tree.root, free,
                                     search.c_puct)
            t = lap("descend (tree kernel)", t)
            parent = D._state_at(tree.states, node)
            safe = torch.where(action >= 0, action, cfg.num_points)
            stepped = torchgo.step(cfg, parent, safe)
            expanding = action >= 0
            leaf = torchgo.where_rows(expanding, stepped, parent)
            t = lap("step", t)
            gd = torchgo.group_data(cfg, leaf.board, labels=leaf.labels)
            planes = encode(cfg, leaf, search.value_features, gd=gd)
            sens = sensible_mask(cfg, leaf, gd)
            t = lap("analysis + encode (chase kernel)", t)
            logits = search.policy_fn(planes[..., :search.n_policy_planes])
            masked = torch.where(sens, logits,
                                 torch.finfo(logits.dtype).min)
            board_p = torch.softmax(masked, dim=-1)
            t = lap("policy forward + softmax", t)
            values = search.value_fn(planes).float()
            t = lap("value forward", t)
            term = D._terminal_value(cfg, leaf)
            t = lap("terminal scoring (labels kernel)", t)
            any_sens = sens.any(dim=-1, keepdim=True)
            priors = torch.cat([torch.where(any_sens, board_p, 0.0),
                                torch.where(any_sens, 0.0, 1.0)], -1)
            values = torch.where(leaf.done, term, values)
            search.apply_sim(tree, D.SimStep(node, safe.int(), expanding,
                                             leaf), priors, values)
            lap("apply + backup (tree kernel)", t)
    return {k: v / reps for k, v in sums.items()}


def check_tree_walks(tree, c_puct: float, what: str, forced_k: float = 0.0,
                     root_actions=None):
    """One descent of ``tree`` (free, or forced down ``root_actions``)
    and one backup of the path it found, through the tree kernel and
    through its plain versions on the same card tensors: node, action
    and both backed-up slabs bit-exact. Returns the descent's arguments,
    the backup's (on copies of the slabs) and the node reached."""
    from rocalphago_tpu_torch.ops import tree as T

    b = tree.prior.shape[0]
    if root_actions is None:
        root_actions = torch.full_like(tree.n_nodes, -1)
    args = (tree.prior, tree.visits, tree.value_sum, tree.child,
            tree.states.done, tree.root, root_actions, c_puct, forced_k)
    node, action = T.descend(*args)
    want = T.descend_plain(*args)
    check(torch.equal(node, want[0]) and torch.equal(action, want[1]),
          f"tree descend differs from plain on {what}")
    ar = torch.arange(b, device=node.device)
    start = torch.where(action >= 0, node,
                        tree.parent[ar, node.long()]).contiguous()
    start_a = torch.where(action >= 0, action,
                          tree.paction[ar, node.long()]).contiguous()
    values = torch.linspace(-1, 1, b, dtype=torch.float32,
                            device=node.device)
    back = (tree.visits.clone(), tree.value_sum.clone(), tree.parent,
            tree.paction, start, start_a, values)
    plain = (tree.visits.clone(), tree.value_sum.clone()) + back[2:]
    T.backup(*back)
    T.backup_plain(*plain)
    check(torch.equal(back[0], plain[0]) and torch.equal(back[1], plain[1]),
          f"tree backup differs from plain on {what}")
    return args, back, node


def tree_timing(tree, c_puct: float, what: str, forced_k: float = 0.0,
                root_actions=None):
    """(kernel ms, plain ms, (bound ms, by), levels) of one descent and
    one backup of the path it found, on the card, for a tree (checked
    against the plain versions first)."""
    from rocalphago_tpu_torch.ops import tree as T

    b, _, a = tree.prior.shape
    args, back, node = check_tree_walks(tree, c_puct, what, forced_k,
                                        root_actions)
    ms = (cuda_ms(lambda: T.descend(*args), 200, queued=True)
          + cuda_ms(lambda: T.backup(*back), 200, queued=True))
    plain = (cuda_ms(lambda: T.descend_plain(*args), 5)
             + cuda_ms(lambda: T.backup_plain(*back), 5))
    levels = tree_levels(tree.parent, tree.root, node)
    # descend: each level reads one node's prior, visits and value_sum
    # rows, its child pointer and done flag; backup: each level reads
    # and writes one visit count and value sum and reads parent/paction
    bytes_moved = int(levels.sum()) * (a * 12 + 5 + 16 + 8) + b * 24
    return ms, plain, bound(bytes_moved, int(levels.sum()) * a * 12), levels


def phase_search_timings(torchgo, dev, card, main, tree8):
    """Where a device-search move's time goes: the stages of a
    simulation at the main path's shape (one game), the kernel count and
    device time of a chunk (profiler), and the tree kernel's time beside
    its bound at batch 1 and 8."""
    player, state = main["player"], main["state"]
    cfg, search = player._searcher_for(float(state.komi))
    tree = search.init(bridged(torchgo, cfg, [state], dev))
    for _ in range(24):
        search.simulate(tree)
    stages = sim_stages(torchgo, search, tree, 16)
    log(f"simulation stages at batch 1 [{card}], host ms with a sync after "
        "each: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.2f} ms")
    prof = profile_device(lambda: search.simulate(tree), CHUNK,
                          f"one chunk of {CHUNK} simulations at batch 1",
                          "simulation")
    # the tree the GTP session's last search left (subtree reuse
    # carries it), at the shape the session launched the kernel on
    carried = player._carry[3]
    check_tree_walks(carried, search.c_puct, "the GTP session's tree")
    tree_ms, tree_plain, tree_bound, levels = tree_timing(
        tree, search.c_puct, "the main path's slab")
    t8 = tree_timing(tree8, search.c_puct, "the batch-8 chunk's tree")
    log(f"tree kernel: descend and backup bit-exact vs plain on the GTP "
        f"session's tree ({int(carried.n_nodes.sum())} of "
        f"{carried.prior.shape[1]} nodes) and the trees timed below")
    log(f"tree kernel [{card}]: batch 1 ({int(tree.n_nodes.sum())} nodes, "
        f"{int(levels.sum())} levels) descend + backup {tree_ms:.4f} ms, "
        f"plain {tree_plain:.3f} ms, bound {tree_bound[0]:.6f} ms "
        f"({tree_bound[1]}); batch 8 ({int(t8[3].sum())} levels) "
        f"{t8[0]:.4f} ms, plain {t8[1]:.3f} ms, bound {t8[2][0]:.6f} ms")
    return dict(stages=stages, profile=prof,
                tree=(tree_ms, tree_plain, tree_bound))


def profile_device(step_fn, units: int, what: str, unit: str):
    """Kernel launches and device busy time per ``unit`` over ``units``
    calls of ``step_fn``, from ``torch.profiler``; None where the trace
    shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    if not kernels or busy <= 0:
        log("profiler: no device time in the trace; launches not measured")
        return None
    out = dict(launches=len(kernels) / units, busy_ms=busy / units,
               wall_ms=wall / units)
    out["idle"] = 1 - out["busy_ms"] / out["wall_ms"]
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    log(f"profiler, {what}: {out['launches']:.0f} kernels per {unit}, "
        f"device busy {out['busy_ms']:.3f} of {out['wall_ms']:.2f} ms "
        f"(idle share {out['idle']:.3f}, the profiler on); top: "
        + ", ".join(f"{e.key[:40]} x{e.count // units} "
                    f"{e.device_time_total / 1e3 / units:.3f} ms"
                    for e in top[:6]))
    return out


# ------------------------------------------------------------ self-play


def ply_stages(torchgo, ply, states, t: int, generator, reps: int):
    """Host milliseconds of each stage of one self-play ply (the stages
    of ``Ply.__call__``), synchronised after every stage."""
    from rocalphago_tpu_torch.features.planes import encode
    from rocalphago_tpu_torch.search import selfplay as S

    cfg = ply.cfg
    sums: dict = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        now = time.perf_counter()
        sums[name] = sums.get(name, 0.0) + (now - t0) * 1e3
        return now

    swap = t % 2 == 1
    half = ply.batch // 2
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gd = torchgo.group_data(cfg, states.board, labels=states.labels)
            t0 = lap("analysis", t0)
            planes = encode(cfg, states, ply.features, gd=gd)
            t0 = lap("encode (chase kernel)", t0)
            rolled = S._half_swap(planes, swap)
            logits = S._half_swap(torch.cat(
                [ply.policy_a(rolled[:half]), ply.policy_b(rolled[half:])]),
                swap)
            t0 = lap("two forwards", t0)
            sens = S.sensible_mask(cfg, states, gd)
            masked = torch.where(sens, logits / ply.temperature,
                                 torch.finfo(logits.dtype).min)
            action = ply.sample(masked, sens, generator)
            t0 = lap("mask + sample", t0)
            ply.advance(states, action, gd)
            lap("step", t0)
    return {k: v / reps for k, v in sums.items()}


def replay_on_cpu(torchgo, cfg, features, actions, live, played):
    """Replay a card run's actions ``[T, B]`` on the CPU port (plain
    versions): every action of a ply the card played (``played[t]``;
    the rest are the zero padding after every game ended) sensible
    there, the same ``live`` rows. Returns the CPU's final states."""
    from rocalphago_tpu_torch.search import selfplay as S

    n = cfg.num_points
    b = actions.shape[1]
    ply = S.Ply(cfg, features, None, None, b, 1.0)
    st = torchgo.new_states(cfg, b, device="cpu")
    for t in range(actions.shape[0]):
        gd = torchgo.group_data(cfg, st.board, labels=st.labels)
        sens = S.sensible_mask(cfg, st, gd)
        a = actions[t]
        at = sens.gather(1, a.clamp(max=n - 1).long()[:, None])[:, 0]
        ok = torch.where(a < n, at, ~sens.any(dim=1))
        check(not played[t] or bool(ok.all()),
              f"replay ply {t}: a card action is not sensible on the CPU")
        st, lv = ply.advance(st, a, gd)
        check(torch.equal(lv, live[t]), f"replay ply {t}: live differs")
    return st


def kernel_row(fn, plain_fn, bytes_moved, ops, reps: int = 100):
    """(kernel ms, plain ms, (bound ms, by)) of one kernel call on the
    card, CUDA events around back-to-back launches."""
    return (cuda_ms(fn, reps, queued=True), cuda_ms(plain_fn, 3),
            bound(bytes_moved, ops))


def phase_policy_selfplay(torchgo, dev, card, counters):
    """Policy self-play at full width, this slice's headline: 19×19,
    two fresh 12 × 128 bf16 policies, batch 256, up to 300 plies in
    segments of 10, stopping when every game is over. One untimed run of
    a segment, one segment with no device→host sync, then the timed
    run, its first games replayed on the CPU, its winners scored on the
    host, the chase and labels kernels held against their plain
    versions on its lanes and region boards, a stage breakdown and a
    profile of a ply."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.ops import chase as C
    from rocalphago_tpu_torch.ops import labels as L
    from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
    from rocalphago_tpu_torch.search import selfplay as S

    cfg = torchgo.GoConfig(size=SIZE)
    n = cfg.num_points
    nets = [CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                      seed=SEED + 20 + i, device=dev) for i in range(2)]
    for net in nets:
        check(net.device.type == "cuda"
              and net.module.dtype == torch.bfloat16,
              f"a self-play net runs on {net.device} in {net.module.dtype}")
    args = (cfg, DEFAULT_FEATURES, nets[0].module, nets[1].module, SP_BATCH)
    gen = torch.Generator(device=dev)
    warm = S.make_selfplay_chunked(*args, max_moves=SP_CHUNK,
                                   chunk=SP_CHUNK, device=dev)(
        gen.manual_seed(SEED))
    torch.cuda.synchronize()
    run = S.make_selfplay_chunked(*args, max_moves=SP_MAX_MOVES,
                                  chunk=SP_CHUNK, device=dev)

    # one segment with no device->host sync, on the warm run's games
    states = warm.final
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(SP_CHUNK, 2 * SP_CHUNK):
            states, _, _ = run.ply(states, gen, t)
    except RuntimeError as e:
        raise SmokeFailure(f"a host sync inside a self-play segment: "
                           f"{e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"policy self-play: a segment of {SP_CHUNK} plies at batch "
        f"{SP_BATCH} ran with no device->host sync")

    # the timed run: the path's launches counted from zero
    pipe = ChunkPipeline(dev)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = run(gen.manual_seed(SEED + 1), stop_when_done=True, pipeline=pipe)
    winners = res.winners.cpu()
    wall = time.perf_counter() - t0
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    num_moves = res.num_moves.cpu()
    check(res.actions.shape == (SP_MAX_MOVES, SP_BATCH),
          f"self-play actions {tuple(res.actions.shape)}")
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by self-play")
    games_per_min = SP_BATCH * 60.0 / wall
    board_plies = int(num_moves.sum())
    plies_run = int(res.live.any(dim=1).sum())
    log(f"policy self-play [{card}]: {SP_BATCH} games, 19x19 12x128 bf16, "
        f"{plies_run} plies in {wall:.2f} s: selfplay_19x19_games_per_min "
        f"(the port's) {games_per_min:.2f}, {board_plies / wall:.1f} "
        f"board-plies/s, {plies_run / wall:.2f} plies/s, mean game "
        f"{float(num_moves.float().mean()):.1f} plies "
        f"({int(res.final.done.sum())} of {SP_BATCH} games over), "
        f"host_gap_frac {pipe.host_gap_frac:.4f}; launches {launches}")

    # the card's result, replayed on the CPU and scored on the host
    cpu = replay_on_cpu(torchgo, cfg, DEFAULT_FEATURES,
                        res.actions[:, :SP_REPLAY].cpu(),
                        res.live[:, :SP_REPLAY].cpu(),
                        res.live.any(dim=1).tolist())
    for name in ("board", "done", "turn", "labels"):
        check(torch.equal(getattr(res.final, name)[:SP_REPLAY].cpu(),
                          getattr(cpu, name)),
              f"replayed games: {name} differs from the card's")
    check(torch.equal(winners[:SP_REPLAY], torchgo.winner(cfg, cpu)),
          "replayed games: winners differ")
    host = S.host_winners(cfg, res.final.board)
    check(np.array_equal(host, winners.numpy()),
          f"winner on the card differs from host_winners in "
          f"{int((host != winners.numpy()).sum())} games")
    log(f"policy self-play: the first {SP_REPLAY} games replayed on the CPU "
        "(every action sensible there; the live rows, so num_moves, and "
        f"boards, done flags and winners equal); winners of all {SP_BATCH} "
        "== host_winners")

    # the kernels at this path's shapes: lanes of a real batch-256 encode
    # and the final boards' empty regions
    final = res.final
    with LaneRecorder(C) as rec:
        run.ply.logits(final, plies_run)
    cb, cl, cp = rec.lanes[0]
    want_c = check_chase(C, cb, cl, cp, SIZE, f"self-play {len(cp)} lanes")
    _, rungs = C.chase_plain(cb, cl, cp, SIZE, return_rungs=True)
    chase_row = kernel_row(
        lambda: C.chase(cb, cl, cp, SIZE), lambda: C.chase_plain(
            cb, cl, cp, SIZE), cb.numel() * 5 + cp.numel() * 5,
        int(rungs.sum()) * n * CHASE_OPS_PER_POINT_RUNG)
    regions = torch.where(final.board == 0, 9, 0).to(torch.int8)
    check(torch.equal(L.labels(regions, SIZE), L.labels_plain(regions, SIZE)),
          "labels kernel differs from plain on the self-play regions")
    labels_row = kernel_row(
        lambda: L.labels(regions, SIZE), lambda: L.labels_plain(
            regions, SIZE), regions.numel() * 5,
        labels_sweeps(regions) * regions.numel()
        * LABELS_OPS_PER_POINT_SWEEP)
    log(f"self-play kernels [{card}]: chase {len(cp)} lanes "
        f"({int((cp >= 0).sum())} live, {int(want_c.sum())} captured, "
        f"{int(rungs.sum())} rungs) bit-exact, {chase_row[0]:.4f} ms, plain "
        f"{chase_row[1]:.3f} ms, bound {chase_row[2][0]:.6f} ms "
        f"({chase_row[2][1]}); labels on {SP_BATCH} region boards "
        f"bit-exact, {labels_row[0]:.4f} ms, plain {labels_row[1]:.3f} ms, "
        f"bound {labels_row[2][0]:.6f} ms ({labels_row[2][1]})")

    stages = ply_stages(torchgo, run.ply, final, plies_run, gen, 3)
    log(f"self-play ply stages at batch {SP_BATCH} [{card}], host ms with a "
        "sync after each: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in stages.items())
        + f"; sum {sum(stages.values()):.2f} ms")
    holder = [final, plies_run]

    def one_ply():
        holder[0], _, _ = run.ply(holder[0], gen, holder[1])
        holder[1] += 1

    prof = profile_device(one_ply, SP_CHUNK,
                          f"a segment of {SP_CHUNK} plies at batch "
                          f"{SP_BATCH}", "ply")
    return dict(launches=launches, games_per_min=games_per_min,
                wall=wall, final=final, stages=stages, profile=prof,
                chase=chase_row, labels=labels_row)


def phase_search_selfplay(torchgo, dev, card, counters, player, states256):
    """Search self-play: the full-width policy and FCN value nets the
    device-search player loaded, batch 8, 32 simulations a move in
    chunks of 8, Dirichlet root noise, forced playouts, recorded
    targets, 8 plies. Then the tree kernel with forced playouts against
    its plain version on a grown batch-8 slab and on a batch-256 slab
    grown from the policy self-play's positions, both timed."""
    from rocalphago_tpu_torch.search.device_mcts import (
        make_device_mcts,
        make_mcts_selfplay,
    )

    pol, val = player.policy, player.value
    cfg = pol.cfg
    run = make_mcts_selfplay(
        cfg, pol.feature_list, val.feature_list, pol.module, val.module,
        batch=SS_BATCH, max_moves=SS_PLIES, n_sim=SS_SIMS, sim_chunk=CHUNK,
        record_visits=True, dirichlet_alpha=SS_ALPHA, noise_frac=SS_EPS,
        forced_k=SS_FORCED_K, device=dev)
    # untimed: the searcher's first launches
    run.search_ply(torchgo.new_states(cfg, SS_BATCH, device=dev))
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    t0 = time.perf_counter()
    final, actions, live, targets = run(gen, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by search "
              "self-play")
    plies = actions.shape[0]
    check(plies == SS_PLIES and targets.shape == (
        SS_PLIES, SS_BATCH, cfg.num_points + 1)
        and targets.dtype == torch.float32,
        f"search self-play: {plies} plies, targets "
        f"{tuple(targets.shape)} {targets.dtype}")
    sums = targets.sum(-1)[live]
    check(bool(((sums - 1).abs() < 1e-5).all()),
          f"a recorded target does not sum to 1: {sums.tolist()}")
    log(f"search self-play [{card}]: batch {SS_BATCH}, {SS_SIMS} "
        f"simulations a move, forced_k {SS_FORCED_K}, Dir({SS_ALPHA}) "
        f"eps {SS_EPS}, {plies} plies in {wall:.2f} s: "
        f"{plies / wall:.3f} plies/s, {plies * SS_SIMS / wall:.1f} "
        f"simulations/s ({plies * SS_SIMS * SS_BATCH / wall:.1f} game "
        f"simulations/s); every target sums to 1; launches {launches}")

    # the tree kernel with forced playouts on grown slabs
    gamma = torch.as_tensor(np.random.default_rng(SEED + 3).gamma(
        SS_ALPHA, size=(SS_BATCH, cfg.num_points + 1)),
        dtype=torch.float32).to(dev)
    tree8 = run.add_root_noise(run.search.init(final), gamma)
    tree8, _ = run.search.run_sims_chunked(tree8, CHUNK, owned=True)
    t8 = tree_timing(tree8, run.search.c_puct, "a batch-8 self-play slab",
                     SS_FORCED_K)
    search256 = make_device_mcts(
        cfg, pol.feature_list, val.feature_list, pol.module, val.module,
        n_sim=SS_TREE256_SIMS, forced_k=SS_FORCED_K)
    tree256 = search256.init(states256)
    tree256, _ = search256.run_sims_chunked(tree256, CHUNK, owned=True)
    t256 = tree_timing(tree256, search256.c_puct,
                       "a batch-256 self-play slab", SS_FORCED_K)
    p256 = tree_timing(tree256, search256.c_puct,
                       "a batch-256 self-play slab, plain PUCT")
    log(f"tree kernel, forced_k {SS_FORCED_K} [{card}]: bit-exact vs plain; "
        f"batch 8 ({int(tree8.n_nodes.sum())} nodes, {int(t8[3].sum())} "
        f"levels) descend + backup {t8[0]:.4f} ms, plain {t8[1]:.3f} ms, "
        f"bound {t8[2][0]:.6f} ms; batch 256 ({int(tree256.n_nodes.sum())} "
        f"nodes, {int(t256[3].sum())} levels) {t256[0]:.4f} ms, plain "
        f"{t256[1]:.3f} ms, bound {t256[2][0]:.6f} ms ({t256[2][1]}); "
        f"the same slab with forced_k 0 ({int(p256[3].sum())} levels) "
        f"{p256[0]:.4f} ms, plain {p256[1]:.3f} ms, bound "
        f"{p256[2][0]:.6f} ms")
    return dict(launches=launches, wall=wall, plies=plies,
                tree8=t8[:3], tree256=t256[:3])


def selfplay_cli_start(mode: str):
    """Start the self-play CLI as a user runs it, on the committed 9×9
    nets, in ``mode`` (``policy``, ``search`` or Gumbel ``search``),
    into ``build/``; ``(mode, games, out dir, the started child)``."""
    root = os.path.dirname(os.path.abspath(__file__))
    policy = os.path.join(root, PUCT_DIR, "policy.json")
    value = os.path.join(root, PUCT_DIR, "value.json")
    games, extra = {
        "policy": (16, ["--chunk", "20"]),
        "search": (4, ["--search-sims", "16", "--value", value,
                       "--max-moves", "20", "--dirichlet-alpha", "0.03"]),
        "gumbel": (4, ["--search-sims", "8", "--gumbel", "--m-root", "4",
                       "--value", value, "--max-moves", "20"])}[mode]
    out = os.path.join(root, "build", "smoke_selfplay", mode)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [sys.executable, "-m",
           "rocalphago_tpu_torch.interface.selfplay_cli", "--policy",
           policy, "--games", str(games), "--out", out, "--seed",
           str(SEED)] + extra
    return mode, games, out, bg_start(cmd, out + "_run")


def selfplay_cli_check(pygo, mode: str, games: int, out: str, started):
    """Wait for a :func:`selfplay_cli_start`ed run: every SGF parses
    back with the port's reader and replays legally on the rules
    oracle."""
    from rocalphago_tpu_torch.data import sgf

    rc, stdout, stderr, wall = bg_wait(started)
    check(rc == 0, f"selfplay_cli ({mode}) exited {rc}: {stderr[-2000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    check(summary["sgf_files"] == games,
          f"selfplay_cli ({mode}) wrote {summary.get('sgf_files')} SGFs")
    lengths = []
    for g in range(games):
        with open(os.path.join(out, f"selfplay-{g:05d}.sgf")) as f:
            game = sgf.parse(f.read())
        st = pygo.GameState(size=game.size, komi=game.komi)
        for color, move in game.moves:
            check(st.is_legal(move), f"selfplay_cli ({mode}) game {g}: "
                  f"illegal {move}")
            st.do_move(move, color)
        lengths.append(len(game.moves))
    check(float(np.mean(lengths)) == summary["mean_moves"],
          f"selfplay_cli ({mode}): SGF lengths {lengths} against "
          f"mean_moves {summary['mean_moves']}")
    log(f"selfplay_cli {mode}: {summary} ({wall:.1f} s with start-up, "
        f"beside phase 13's other CLI runs); every SGF parses and replays "
        f"legally")


def phase_clis_9x9(pygo, card):
    """The CLIs on the committed 9×9 nets, and GTP serving, all at once
    (their checks are timing-free): self-play in policy, search and
    Gumbel search mode, the tournament of ``gumbel-mcts`` against
    ``device-mcts`` and its Elo table, the tournament of ``mcts`` with
    device rollouts against ``greedy``, and GTP ``--serve`` and
    ``--serve-sizes`` (:func:`serve_gtp_start`)."""
    root = os.path.dirname(os.path.abspath(__file__))
    gtp_work = os.path.join(root, "build", "smoke_gtp")
    shutil.rmtree(gtp_work, ignore_errors=True)
    os.makedirs(gtp_work)
    runs = [selfplay_cli_start(mode)
            for mode in ("policy", "search", "gumbel")]
    tourneys = [gumbel_tournament_start(), mcts_tournament_start()]
    gtps = serve_gtp_start(gtp_work)
    try:
        for run in runs:
            selfplay_cli_check(pygo, *run)
        gumbel_tournament(card, *tourneys[0])
        mcts_tournament(card, *tourneys[1])
        for run, started in gtps:
            serve_gtp_check(card, *run, started)
    finally:
        bg_stop([run[3] for run in runs] + [t[1] for t in tourneys]
                + [started for _, started in gtps])


# ------------------------------------------------------ supervised path


def sl_argv(spec, corpus, out, epochs=2, *extra):
    """The SL trainer's command line for this phase's runs (minibatch
    16, symmetries on: the reference's defaults)."""
    return [spec, corpus, out, "--epoch-length", str(SL_EPOCH_LENGTH),
            "--epochs", str(epochs), "--seed", str(SEED), *extra]


def final_params(out: str, step: int) -> dict:
    """The params of ``out``'s checkpoint at ``step``."""
    path = os.path.join(out, "checkpoints", str(step), "state.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def same_params(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def sl_convert(root: str, work: str, counters):
    """The converter CLI on the committed 19×19 games, the launches of
    both kernels counted from zero."""
    from rocalphago_tpu_torch.data import convert, sgf

    games = os.path.join(root, SL_GAMES)
    files = sorted(f for f in os.listdir(games) if f.endswith(".sgf"))
    moves = non_pass = 0
    for f in files:
        with open(os.path.join(games, f)) as fh:
            g = sgf.parse(fh.read())
        moves += len(g.moves)
        non_pass += sum(m is not None for _, m in g.moves)
    corpus = os.path.join(work, "corpus")
    from rocalphago_tpu_torch.data import native
    from rocalphago_tpu_torch.obs import torchobs

    # the native replayer's build at its first use, timed apart
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    torchobs.flush_untracked()
    before = launch_series()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = convert.run_game_converter(["--directory", games, "--outfile",
                                      corpus])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    # the registry's series over the conversion: every launch counted
    # once, every chase launch inside the encoder's tracked batch
    series = launches_since(before)
    check(by_kernel(series) == {"tree": 0, "conv_epilogue": 0, **launches}
          and series.get(("encode.batch", "chase")) == launches["chase"],
          f"convert: kernel_launches_total grew by {series}, the process "
          f"by {launches}")
    with open(f"{corpus}-manifest.json") as f:
        manifest = json.load(f)
    check(manifest["num_games"] == len(files) and not manifest["errors"],
          f"converted {manifest['num_games']} of {len(files)} games: "
          f"{manifest['errors']}")
    check(manifest["num_positions"] == non_pass == out["num_positions"],
          f"{manifest['num_positions']} positions from {non_pass} non-pass "
          "moves")
    check(manifest["planes"] == 48 and manifest["board_size"] == SIZE,
          f"manifest {manifest['planes']} planes at {manifest['board_size']}")
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by the converter")
    log(f"convert: {len(files)} games, {moves} moves ({moves - non_pass} "
        f"passes), {manifest['num_positions']} positions in "
        f"{manifest['num_shards']} shards, {wall:.2f} s with the shard "
        f"writes, {manifest['num_positions'] / wall:.1f} positions/s (the "
        f"native replayer built by g++ before it in {build_s:.2f} s); "
        f"launches "
        f"{launches}, kernel_launches_total "
        + ", ".join(f"{e}/{k} {v}" for (e, k), v in sorted(series.items())))
    replay = sl_replays(games, files, corpus)
    sl_kernels(games, files[0])
    return corpus, launches, manifest["num_positions"] / wall, replay


def sl_replays(games: str, files: list, corpus: str) -> dict:
    """The conversion's native replay against the pygo replay of the
    same games on the host: every game's encoder inputs (boards, turn,
    ko, step, ages) and actions bit for bit, and the first game's shard
    rows equal to the card encode of pygo's replay; the host rates of
    both replays (positions/s)."""
    from rocalphago_tpu_torch.data import convert, sgf
    from rocalphago_tpu_torch.data.pipeline import ShardedDataset

    parsed = []
    for f in files:
        with open(os.path.join(games, f)) as fh:
            parsed.append(sgf.parse(fh.read()))
    conv = convert.GameConverter()
    t0 = time.perf_counter()
    native = [conv._replay_native(g, False) for g in parsed]
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = [conv._replay_pygo(g, False) for g in parsed]
    t_pygo = time.perf_counter() - t0
    for f, (nf, na), (pf, pa) in zip(files, native, plain):
        check(na == pa and len(nf) == len(pf) and all(
            np.array_equal(x, y) and np.asarray(x).dtype ==
            np.asarray(y).dtype for a, b in zip(nf, pf)
            for x, y in zip(a, b)),
            f"convert: the native replay of {f} differs from pygo's")
    rows = len(plain[0][1])
    got = ShardedDataset(corpus).gather(np.arange(rows))
    check(np.array_equal(got[0], conv._encode_fields(plain[0][0]))
          and np.array_equal(got[1], np.asarray(plain[0][1], np.int32)),
          "convert: the first game's shard rows differ from the card "
          "encode of pygo's replay")
    n = sum(len(a) for _, a in native)
    rates = {"native": n / t_native, "pygo": n / t_pygo}
    log(f"convert: the native replay of the {len(files)} games ({n} "
        f"positions) equals pygo's, field for field; the first game's "
        f"{rows} shard rows equal the card encode of pygo's replay bit "
        f"for bit; host replay alone {rates['native']:.1f} positions/s "
        f"native, {rates['pygo']:.1f} pygo ({t_native:.3f} s, "
        f"{t_pygo:.3f} s)")
    return rates


def cpu_convert_start(root: str, work: str):
    """Start the converter CLI on the CPU (``--device cpu``) over the
    first ``SL_CPU_GAMES`` committed games; ``(out corpus, the started
    child)``."""
    games = os.path.join(root, SL_GAMES)
    files = sorted(f for f in os.listdir(games) if f.endswith(".sgf"))
    first = os.path.join(work, "cpu_games")
    os.makedirs(first)
    for f in files[:SL_CPU_GAMES]:
        shutil.copy(os.path.join(games, f), first)
    corpus = os.path.join(work, "cpu_corpus")
    return corpus, bg_start(
        [sys.executable, "-m", "rocalphago_tpu_torch.data.convert",
         "--directory", first, "--outfile", corpus, "--device", "cpu"],
        corpus + "_run")


def cpu_convert_check(corpus: str, cpu_corpus: str, started):
    """Wait for the :func:`cpu_convert_start`ed CLI: the CPU port's
    planes and actions of the first games equal the card's bit for
    bit."""
    from rocalphago_tpu_torch.data.pipeline import ShardedDataset

    rc, _, stderr, wall = bg_wait(started)
    check(rc == 0, f"convert --device cpu: rc {rc}\n{stderr[-2000:]}")
    cpu = ShardedDataset(cpu_corpus)
    rows = np.arange(len(cpu))
    got, want = ShardedDataset(corpus).gather(rows), cpu.gather(rows)
    check(len(rows) > 0 and np.array_equal(got[0], want[0])
          and np.array_equal(got[1], want[1]),
          "the card's planes or actions differ from the CPU's")
    log(f"convert: the first {SL_CPU_GAMES} games ({len(rows)} positions) "
        f"converted by the CLI on the CPU equal the card's bit for bit "
        f"({wall:.1f} s with the process start, beside the SL resume runs)")


def sl_kernels(games: str, first: str):
    """Both kernels at the converter's shapes: the boards and the lanes
    of the first encode batch of the first game (256 positions, 4 chase
    slots each), against their plain versions and timed."""
    from rocalphago_tpu_torch.data import convert
    from rocalphago_tpu_torch.ops import chase as C
    from rocalphago_tpu_torch.ops import labels as L

    boards, inner = [], L.labels

    def record(b, size):
        boards.append(b.clone())
        return inner(b, size)

    L.labels = record
    try:
        with LaneRecorder(C) as rec, open(os.path.join(games, first)) as f:
            convert.GameConverter().convert_game(f.read())
    finally:
        L.labels = inner
    b = boards[0]
    n = b.shape[1]
    check(torch.equal(L.labels(b, SIZE), L.labels_plain(b, SIZE)),
          "labels kernel differs from plain on the converter's boards")
    lab = kernel_row(lambda: L.labels(b, SIZE),
                     lambda: L.labels_plain(b, SIZE), b.numel() * 5,
                     labels_sweeps(b) * b.numel()
                     * LABELS_OPS_PER_POINT_SWEEP)
    cb, cl, cp = rec.lanes[0]
    want = check_chase(C, cb, cl, cp, SIZE, f"converter {len(cp)} lanes")
    _, rungs = C.chase_plain(cb, cl, cp, SIZE, return_rungs=True)
    ch = kernel_row(lambda: C.chase(cb, cl, cp, SIZE),
                    lambda: C.chase_plain(cb, cl, cp, SIZE),
                    cb.numel() * 5 + cp.numel() * 5,
                    int(rungs.sum()) * n * CHASE_OPS_PER_POINT_RUNG)
    log(f"converter kernels: labels on {b.shape[0]} boards bit-exact, "
        f"{lab[0]:.4f} ms, plain {lab[1]:.3f} ms, bound {lab[2][0]:.6f} ms "
        f"({lab[2][1]}); chase {len(cp)} lanes ({int((cp >= 0).sum())} "
        f"live, {int(want.sum())} captured, {int(rungs.sum())} rungs) "
        f"bit-exact, {ch[0]:.4f} ms, plain {ch[1]:.3f} ms, bound "
        f"{ch[2][0]:.6f} ms ({ch[2][1]})")


def sl_train(dev, work: str, corpus: str):
    """The SL trainer's CLI at full width, then its export answering a
    GTP genmove; returns the spec and the straight run's directory."""
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.search.players import build_player
    from rocalphago_tpu_torch.training import sl

    spec = os.path.join(work, "policy.json")
    CNNPolicy(board=SIZE, layers=12, filters_per_layer=128, seed=SEED + 40,
              device=dev).save_model(spec)
    out = os.path.join(work, "straight")
    t0 = time.perf_counter()
    sl.run_training(sl_argv(spec, corpus, out))
    wall = time.perf_counter() - t0
    check(torch.backends.cudnn.deterministic
          and not torch.backends.cudnn.benchmark,
          "the trainer left cuDNN non-deterministic")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    check(len(epochs) == 2, f"{len(epochs)} epoch records")
    spans = check_span_paths(events, ("sl.epoch", "sl.epoch/sl.train",
                                      "sl.epoch/sl.eval", "sl.epoch/sl.export",
                                      "sl.epoch/sl.save"), "sl straight run")
    snap = last_registry(events, "sl straight run")
    waits = snap["histograms"]['train_data_wait_seconds{trainer="sl"}']
    steps = {k: v for (e, k), v in launch_series(snap).items()
             if e == "sl.train_step"}
    epilogue = steps.pop("conv_epilogue", 0)
    check(steps == {"labels": 0, "chase": 0, "tree": 0}
          and epilogue > 0 and epilogue % (3 * 11) == 0,
          f"sl: kernel_launches_total of sl.train_step {steps}, "
          f"conv_epilogue {epilogue} (training reads stored planes; each "
          "step 11 convolutions, one forward and two backward launches "
          "each)")
    check(len(spans["sl.epoch"]) == 2
          and waits["count"] >= 2 * SL_EPOCH_LENGTH,
          f"sl: {len(spans['sl.epoch'])} epoch spans, {waits['count']} "
          "data waits")
    for e in epochs:
        for k in ("train_loss", "val_loss", "train_accuracy"):
            check(e.get(k) is not None and np.isfinite(e[k]),
                  f"epoch {e['epoch']}: {k} = {e.get(k)}")
    for name in ("metadata.json", "metrics.jsonl", "shuffle.npz",
                 "model.json", "weights.00000.flax.msgpack",
                 "weights.00001.flax.msgpack"):
        check(os.path.exists(os.path.join(out, name)), f"no {name}")
    with open(os.path.join(out, "metadata.json")) as f:
        meta = json.load(f)
    check(np.isfinite(meta["test_accuracy"]), "no test accuracy")
    log(f"sl: {2 * SL_EPOCH_LENGTH} steps at minibatch 16 on the 19x19 "
        f"12x128 bf16 policy, symmetries on, {wall:.1f} s with two "
        f"validations; train loss {epochs[0]['train_loss']:.4f} -> "
        f"{epochs[1]['train_loss']:.4f}, val accuracy "
        f"{epochs[1]['val_accuracy']:.4f}, test accuracy "
        f"{meta['test_accuracy']:.4f}, {epochs[1]['positions_per_s']:.1f} "
        f"positions/s in the loop")

    player = build_player("greedy", os.path.join(out, "model.json"))
    check(player.policy.device.type == "cuda", "the export loads off the card")
    replies = io.StringIO()
    engine = run_gtp(player, io.StringIO(
        "boardsize 19\nclear_board\nplay b D4\ngenmove w\ngenmove b\nquit\n"),
        replies)
    undegraded(engine)
    answers = [r for r in replies.getvalue().split("\n\n") if r.strip()]
    for reply in answers[3:5]:
        check(reply.startswith("=") and vertex_to_move(
            reply[1:].strip(), SIZE) is not None, f"genmove -> {reply!r}")
    check(engine.illegal_from_player == 0, "the export played illegally")
    log(f"sl: the exported model.json answers genmove over GTP: "
        f"{answers[3][1:].strip()}, {answers[4][1:].strip()}")
    return spec, out, meta


def sl_resume(work: str, spec: str, corpus: str, straight: str):
    """Exact resume on the card: killed after epoch 0, and killed after
    step 25 with a checkpoint every 10, both resumed through the CLI and
    ending on the straight run's bits."""
    from rocalphago_tpu_torch.training import sl

    end = 2 * SL_EPOCH_LENGTH
    want = final_params(straight, end)
    out = os.path.join(work, "killed_epoch")
    sl.run_training(sl_argv(spec, corpus, out, 1))
    sl.run_training(sl_argv(spec, corpus, out))
    check(same_params(want, final_params(out, end)),
          "killed after epoch 0 and resumed: params differ from the "
          "straight run's")

    out = os.path.join(work, "killed_step")
    cfg = sl.SLConfig(model_json=spec, train_data=corpus, out_dir=out,
                      epochs=2, epoch_length=SL_EPOCH_LENGTH, seed=SEED,
                      save_every=10)
    trainer = sl.SLTrainer(cfg)
    step, calls = trainer._train_step, [0]

    def killing_step(state, planes, actions):
        if calls[0] == SL_KILL_AFTER:
            raise KeyboardInterrupt("killed")
        calls[0] += 1
        return step(state, planes, actions)

    trainer._train_step = killing_step
    try:
        trainer.run()
        check(False, "the killed run did not stop")
    except KeyboardInterrupt:
        pass
    check(trainer.ckpt.latest_step() == 20,
          f"latest checkpoint {trainer.ckpt.latest_step()} after the kill")
    del trainer
    sl.run_training(sl_argv(spec, corpus, out, 2, "--save-every", "10"))
    check(same_params(want, final_params(out, end)),
          f"killed after step {SL_KILL_AFTER} and resumed: params differ "
          "from the straight run's")
    log(f"sl resume: killed after epoch 0, and after step {SL_KILL_AFTER} "
        "with a checkpoint every 10 steps; both resumed runs end on the "
        "straight run's params bit for bit")


def sl_evaluate(corpus: str, straight: str, meta: dict):
    """The evaluator's CLI on the straight run's export and test split;
    at the trainer's minibatch, so both forwards see the same batch
    shapes (cuDNN picks its algorithm per shape; in bf16 another
    summation order can flip a near-tied argmax)."""
    from rocalphago_tpu_torch.training import evaluate

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluate.main([os.path.join(straight, "model.json"), corpus,
                       "--split", "test", "--shuffle-npz",
                       os.path.join(straight, "shuffle.npz"),
                       "--minibatch", "16"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    err = abs(res["top1"] - meta["test_accuracy"])
    check(err <= 1e-6, f"evaluate top1 {res['top1']} against the trainer's "
          f"test_accuracy {meta['test_accuracy']}")
    log(f"evaluate: top1 {res['top1']:.6f} on {res['positions']} test "
        f"positions, the trainer's test_accuracy to {err:.1e}")


def sl_value(dev, work: str):
    """The value trainer's CLI at full width on a seeded outcome corpus
    in the converter's layout, its export, and the evaluator's MSE."""
    from rocalphago_tpu_torch.features import VALUE_FEATURES
    from rocalphago_tpu_torch.models import CNNValue, NeuralNetBase
    from rocalphago_tpu_torch.training import evaluate, value

    rng = np.random.default_rng(SEED + 50)
    prefix = os.path.join(work, "outcomes")
    states = (rng.random((VALUE_POSITIONS, SIZE, SIZE, 49)) < 0.2).astype(
        np.uint8)
    z = rng.choice([-1, 1], VALUE_POSITIONS).astype(np.int32)
    np.savez_compressed(f"{prefix}-00000.npz", states=states, actions=z)
    with open(f"{prefix}-manifest.json", "w") as f:
        json.dump({"board_size": SIZE, "komi": 7.5, "planes": 49,
                   "feature_list": list(VALUE_FEATURES),
                   "targets": "outcome", "shard_counts": [VALUE_POSITIONS],
                   "num_positions": VALUE_POSITIONS}, f)
    spec = os.path.join(work, "value.json")
    CNNValue(board=SIZE, layers=12, filters_per_layer=128, seed=SEED + 41,
             device=dev).save_model(spec)
    out = os.path.join(work, "value")
    t0 = time.perf_counter()
    res = value.run_training([spec, prefix, out, "--epochs", "1",
                              "--epoch-length", str(VALUE_STEPS),
                              "--seed", str(SEED)])
    wall = time.perf_counter() - t0
    for k in ("train_mse", "val_mse", "test_mse"):
        check(np.isfinite(res[k]), f"value {k} = {res[k]}")
    net = NeuralNetBase.load_model(os.path.join(out, "model.json"))
    v = net.forward(torch.as_tensor(states[:8], device=dev).float())
    check(v.shape == (8,) and bool(torch.isfinite(v).all()),
          "the value export's forward")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = evaluate.main([os.path.join(out, "model.json"), prefix,
                            "--split", "test", "--shuffle-npz",
                            os.path.join(out, "shuffle.npz")])
    check(np.isfinite(ev["mse"]), f"evaluate mse {ev['mse']}")
    log(f"value: {VALUE_STEPS} steps at minibatch 32 on the 19x19 12x128 "
        f"bf16 FCN value net ({wall:.1f} s), train mse "
        f"{res['train_mse']:.4f}, test mse {res['test_mse']:.4f}; "
        f"evaluate mse {ev['mse']:.4f} on {ev['positions']} positions")


def conv_flops(module) -> tuple[float, float]:
    """(forward, forward + backward) FLOPs per position of the net's
    convolutions: 2·k²·Cin·Cout per point forward; backward twice that,
    less the first layer's input gradient, which no one needs."""
    convs = [m for m in module.modules() if isinstance(m, torch.nn.Conv2d)]
    fwd = [2.0 * m.weight.numel() * SIZE * SIZE for m in convs]
    return sum(fwd), 3 * sum(fwd) - fwd[0]


def spread_ms(fn, queued: bool = False, repeats: int = 5, reps: int = 30):
    """(median, min, max) of ``repeats`` :func:`cuda_ms` readings."""
    xs = sorted(cuda_ms(fn, reps, queued) for _ in range(repeats))
    return xs[len(xs) // 2], xs[0], xs[-1]


def sl_timings(dev, card):
    """The SL train step at minibatch 16 and 256: CUDA events around the
    step as it runs (median of 5 readings of 30 steps) and with the
    card parked until the host has queued every step (the card's time
    alone), around its parts, positions/s, the MFU share against the
    dense bf16 peak, a profile of 20 steps, and the cost of
    deterministic cuDNN at 256 on the card's time alone (deterministic,
    not, not, deterministic, three times over). The card's time alone
    queues only ``QUEUED_STEPS`` steps behind the spin: a deeper queue
    can fill the driver's launch queue, and then the host's pace comes
    back into the reading."""
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.training import sl
    from rocalphago_tpu_torch.training.symmetries import (
        random_transform_batch,
    )

    net = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                    seed=SEED + 42, device=dev)
    module = net.module
    fwd_flops, step_flops = conv_flops(module)
    cfg = sl.SLConfig()
    opt, lr_at = sl.make_optimizer(cfg, module.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = sl.TrainState(module, opt, gen)
    step = sl.make_train_step(module, opt, lr_at, SIZE, True)
    rng = np.random.default_rng(SEED + 60)
    out = {}
    for b in SL_TIMED_BATCHES:
        host = torch.as_tensor(rng.random((b, SIZE, SIZE, 48)) < 0.2,
                               dtype=torch.uint8).pin_memory()
        host_a = torch.as_tensor(rng.integers(0, SIZE * SIZE, b),
                                 dtype=torch.int32).pin_memory()
        planes, actions = host.to(dev), host_a.to(dev)
        pf = planes.float()

        def fwd_bwd():
            opt.zero_grad(set_to_none=True)
            sl.policy_loss_fn(module, pf, actions)[0].backward()

        fwd_bwd()
        parts = {
            "h2d": lambda: (host.to(dev, non_blocking=True),
                            host_a.to(dev, non_blocking=True)),
            "symmetry": lambda: random_transform_batch(gen, pf, actions,
                                                       SIZE),
            "fwd+bwd": fwd_bwd,
            "optimizer": lambda: sl.apply_update(opt, 1e-9),
        }
        parts = {k: spread_ms(f)[0] for k, f in parts.items()}

        def run_step():
            step(state, planes, actions)

        ms, lo, hi = spread_ms(run_step)
        alone = spread_ms(run_step, queued=True, reps=QUEUED_STEPS)[0]
        wall = wall_ms(run_step, 30)
        prof = profile_device(run_step, 20,
                              f"SL train step at minibatch {b}", "step")
        mfu = b * step_flops / (ms * 1e-3) / BF16_FLOPS_PER_S
        out[b] = dict(ms=ms, wall=wall, parts=parts, prof=prof, mfu=mfu,
                      alone=alone)
        log(f"sl step, minibatch {b}: {ms:.3f} ms on the card (median; "
            f"{lo:.3f}-{hi:.3f}; {wall:.3f} ms host-synchronised; the "
            f"card's time alone {alone:.3f} ms), {b / ms * 1e3:.1f} "
            f"positions/s; parts (medians) [" + ", ".join(
                f"{k} {v:.3f} ms" for k, v in parts.items())
            + f"]; MFU share {mfu:.4f}, on the card's time alone "
            f"{mfu * ms / alone:.4f} ({step_flops / 1e9:.3f} GFLOP a "
            f"position forward + backward, {fwd_flops / 1e9:.3f} forward, "
            f"against {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s) on {card}")
    b = SL_TIMED_BATCHES[-1]
    host = torch.as_tensor(rng.random((b, SIZE, SIZE, 48)) < 0.2,
                           dtype=torch.uint8, device=dev)
    acts = torch.as_tensor(rng.integers(0, SIZE * SIZE, b), device=dev)
    det = {True: [], False: []}
    for flag in (True, False, False, True) * 3:
        torch.backends.cudnn.deterministic = flag
        det[flag].append(cuda_ms(lambda: step(state, host, acts),
                                 QUEUED_STEPS, queued=True))
    torch.backends.cudnn.deterministic = True
    on, off = (float(np.median(det[f])) for f in (True, False))
    log(f"sl step, minibatch {b}, the card's time alone: deterministic "
        f"cuDNN " + " / ".join(f"{x:.3f}" for x in det[True]) + " ms, not "
        + " / ".join(f"{x:.3f}" for x in det[False]) + " ms; cost of the "
        f"medians {on / off - 1:+.3f} on {card}")
    smi = child_run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card after the step timings (SM clock, power, temperature): "
        f"{smi.stdout.strip()}")
    check(all(np.isfinite(v["ms"]) for v in out.values()), "timings")
    return out


def phase_supervised(dev, card, counters):
    """The supervised training path at full width (phase 14)."""
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, SL_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    corpus, launches, rate, replay = sl_convert(root, work, counters)
    spec, straight, meta = sl_train(dev, work, corpus)
    # the CPU conversion (timing-free) beside the untimed runs
    cpu = cpu_convert_start(root, work)
    try:
        sl_resume(work, spec, corpus, straight)
        sl_evaluate(corpus, straight, meta)
        sl_value(dev, work)
        cpu_convert_check(corpus, *cpu)
    finally:
        bg_stop([cpu[1]])
    timings = sl_timings(dev, card)
    log(f"supervised phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "positions_per_s": rate,
            "replay_per_s": replay, "timings": timings, "export": os.path.join(straight, "model.json"),
            "spec": spec, "corpus": corpus}


# ------------------------------------------------------ reinforcement path


def rl_argv(spec, out, iterations, *extra):
    """The RL trainer's command line for the kill/resume runs: full
    width, a small batch and a cut game length."""
    return [spec, out, "--game-batch", str(RL_SMALL_BATCH), "--iterations",
            str(iterations), "--save-every", "2", "--move-limit",
            str(RL_SMALL_MOVES), "--seed", str(SEED)]


def rl_cli(work: str, sl_export: str):
    """The RL CLI from the SL export at a small batch: a straight run of
    3 iterations, and one killed after 2 and resumed, ending on the
    straight run's params and generator bit for bit. Returns the
    straight run's export."""
    from rocalphago_tpu_torch.training import rl

    straight = os.path.join(work, "straight")
    t0 = time.perf_counter()
    final = rl.run_training(rl_argv(sl_export, straight, 3))
    wall = time.perf_counter() - t0
    check(torch.backends.cudnn.deterministic
          and not torch.backends.cudnn.benchmark,
          "the RL trainer left cuDNN non-deterministic")
    check(np.isfinite(final["win_rate"]) and final["iteration"] == 2,
          f"rl final {final}")
    spans = check_span_paths(run_events(straight), (
        "rl.iteration", "rl.iteration/rl.data", "rl.iteration/rl.play",
        "rl.iteration/rl.replay", "rl.iteration/rl.update",
        "rl.iteration/rl.save"), "rl straight run")
    check(len(spans["rl.iteration"]) == 3 and all(
        r["plies"] == RL_SMALL_MOVES for r in spans["rl.iteration/rl.replay"]),
          "rl: not 3 iteration spans, or a replay span's plies tag off")
    for name in ("model.json", "weights.00002.flax.msgpack",
                 "weights.00003.flax.msgpack", "metadata.json",
                 "opponents/opponent.00002.flax.msgpack"):
        check(os.path.exists(os.path.join(straight, name)), f"rl: no {name}")
    want = torch.load(os.path.join(straight, "checkpoints", "3", "state.pt"),
                      map_location="cpu", weights_only=True)
    killed = os.path.join(work, "killed")
    rl.run_training(rl_argv(sl_export, killed, 2))
    rl.run_training(rl_argv(sl_export, killed, 3))
    got = torch.load(os.path.join(killed, "checkpoints", "3", "state.pt"),
                     map_location="cpu", weights_only=True)
    check(same_params(want["params"], got["params"])
          and torch.equal(want["rng"], got["rng"]),
          "rl killed after iteration 2 and resumed: params or generator "
          "differ from the straight run's")
    log(f"rl cli: 3 iterations at game batch {RL_SMALL_BATCH}, move limit "
        f"{RL_SMALL_MOVES}, from the SL export (19x19 12x128 bf16), "
        f"{wall:.1f} s; last win rate {final['win_rate']:.3f}, "
        f"{final['games_per_min']:.1f} games/min; killed after 2 and "
        "resumed through the CLI: params and generator bit-identical")
    return os.path.join(straight, "model.json")


def rl_iteration(torchgo, dev, card, counters, sl_export):
    """One RL iteration at the reference's shape: batch 256, move limit
    500, the SL export (19x19 12x128 bf16) as learner and opponent.
    First a replay segment with no device->host sync; then the timed
    iteration, its phases split by a sync after each, with the launches
    counted from zero; its first games replayed on the CPU; both
    kernels held against their plain versions on its lanes and region
    boards; a profile of replay plies."""
    import copy

    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.io.metrics import MetricsLogger
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.obs import trace
    from rocalphago_tpu_torch.ops import chase as C
    from rocalphago_tpu_torch.ops import labels as L
    from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
    from rocalphago_tpu_torch.search import selfplay as S
    from rocalphago_tpu_torch.training import rl

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    net = NeuralNetBase.load_model(sl_export)
    check(net.module.dtype == torch.bfloat16 and net.device.type == "cuda",
          f"the learner runs on {net.device} in {net.module.dtype}")
    opponent = copy.deepcopy(net.module).requires_grad_(False)
    cfg = torchgo.GoConfig(size=SIZE, komi=torchgo.default_komi(SIZE))
    opt = torch.optim.SGD(net.module.parameters(), lr=0.001)
    it = rl.RLIteration(cfg, net.feature_list, net.module, opt, RL_BATCH,
                        RL_MOVES, 0.67, device=dev)
    gen = torch.Generator(device=dev)
    state = rl.RLState(net.module, opt, gen.manual_seed(SEED + 70))

    # a replay segment with no device->host sync, on a short game
    warm = S.make_selfplay_chunked(cfg, net.feature_list, net.module,
                                   opponent, RL_BATCH, SP_CHUNK,
                                   chunk=SP_CHUNK, temperature=0.67,
                                   device=dev)(
        torch.Generator(device=dev).manual_seed(SEED + 71))
    z = rl._learner_z(warm.winners, RL_BATCH // 2)
    live = warm.live.float()
    states = torchgo.new_states(cfg, RL_BATCH, device=dev)
    opt.zero_grad(set_to_none=True)
    it.replay_ply(states, z, warm.actions[0], live[0], 0)
    torch.cuda.synchronize()
    # as the chunked replay runs it: in its span, pushed to the replay's
    # pipeline (the runner metrics on), a sink configured
    sink = MetricsLogger(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), RL_DIR, "segment.jsonl"), echo=False)
    trace.configure(sink)
    pipe = ChunkPipeline(dev, runner="rl.replay")
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.span("rl.replay", plies=SP_CHUNK):
            for t in range(SP_CHUNK):
                states = it.replay_ply(states, z, warm.actions[t], live[t],
                                       t)
            pipe.push()
            pipe.finish()
    except RuntimeError as e:
        raise SmokeFailure(f"a host sync inside a replay segment: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
        trace.configure(None)
        sink.close()
    torch.cuda.synchronize()
    log(f"rl: a replay segment of {SP_CHUNK} plies at game batch "
        f"{RL_BATCH} (learner half {RL_BATCH // 2}, forward + backward), in "
        "its span and pushed to the replay's pipeline with the runner "
        "metrics on, ran with no device->host sync")

    # the timed iteration, its phases split by a sync after each
    laps, held = {}, {}

    def timed(name, fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            laps[name] = time.perf_counter() - t0
            held[name] = out
            return out
        return run

    for name in ("play", "replay", "update"):
        setattr(it, name, timed(name, getattr(it, name)))
    before = {k: v.detach().clone()
              for k, v in net.module.state_dict().items()}
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    m = it(state, opponent)
    win = float(m["win_rate"])
    wall = time.perf_counter() - t0
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    for name in ("play", "replay", "update"):
        delattr(it, name)
    res, z, live = held["play"], held["replay"], held["play"].live.float()
    plies = res.actions.shape[0]
    check(plies == RL_MOVES, f"the iteration played {plies} plies")
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by the RL "
              "iteration")
    after = net.module.state_dict()
    check(all(bool(torch.isfinite(after[k]).all()) for k in after)
          and not all(torch.equal(before[k], after[k]) for k in after),
          "the RL update left the params unchanged or not finite")
    moves = res.num_moves.float()
    games_per_min = RL_BATCH * 60.0 / wall
    replay_ply_ms = laps["replay"] / plies * 1e3
    _, step_flops = conv_flops(net.module)
    replayed = RL_BATCH // 2 * plies
    mfu = replayed * step_flops / laps["replay"] / BF16_FLOPS_PER_S
    log(f"rl iteration [{card}]: game batch {RL_BATCH}, move limit "
        f"{RL_MOVES}, 19x19 12x128 bf16: wall {wall:.2f} s (play "
        f"{laps['play']:.2f} s, replay {laps['replay']:.2f} s, update "
        f"{laps['update'] * 1e3:.2f} ms); games_per_min {games_per_min:.2f};"
        f" {replay_ply_ms:.2f} ms a replay ply; replay MFU share {mfu:.5f} "
        f"({replayed} learner positions x {step_flops / 1e9:.3f} GFLOP); "
        f"mean game {float(moves.mean()):.1f} plies "
        f"({int(res.final.done.sum())} of {RL_BATCH} over), win rate "
        f"{win:.3f}, mean_moves {float(m['mean_moves']):.1f}; launches "
        f"{launches}")

    # the card's games replayed on the CPU
    cpu = replay_on_cpu(torchgo, cfg, DEFAULT_FEATURES,
                        res.actions[:, :SP_REPLAY].cpu(),
                        res.live[:, :SP_REPLAY].cpu(),
                        res.live.any(dim=1).tolist())
    for name in ("board", "done", "turn", "labels"):
        check(torch.equal(getattr(res.final, name)[:SP_REPLAY].cpu(),
                          getattr(cpu, name)),
              f"rl games replayed: {name} differs from the card's")
    check(torch.equal(res.winners[:SP_REPLAY].cpu(),
                      torchgo.winner(cfg, cpu)),
          "rl games replayed: winners differ")
    log(f"rl: the first {SP_REPLAY} games replayed on the CPU (every action "
        "sensible there; live rows, boards, done flags, winners equal)")

    # both kernels on this path's shapes: the lanes of a mid-game replay
    # ply's half-batch encode (the timed run's first RL_MID plies
    # replayed again, untimed), the final boards' empty regions
    final = res.final
    states = torchgo.new_states(cfg, RL_BATCH, device=dev)
    for t in range(RL_MID):
        states = it.replay_ply(states, z, res.actions[t], live[t], t)
    with LaneRecorder(C) as rec:
        states = it.replay_ply(states, z, res.actions[RL_MID], live[RL_MID],
                               RL_MID)
    cb, cl, cp = rec.lanes[0]
    n = cfg.num_points
    want_c = check_chase(C, cb, cl, cp, SIZE, f"replay {len(cp)} lanes")
    _, rungs = C.chase_plain(cb, cl, cp, SIZE, return_rungs=True)
    chase_row = kernel_row(
        lambda: C.chase(cb, cl, cp, SIZE), lambda: C.chase_plain(
            cb, cl, cp, SIZE), cb.numel() * 5 + cp.numel() * 5,
        int(rungs.sum()) * n * CHASE_OPS_PER_POINT_RUNG)
    regions = torch.where(final.board == 0, 9, 0).to(torch.int8)
    check(torch.equal(L.labels(regions, SIZE), L.labels_plain(regions, SIZE)),
          "labels kernel differs from plain on the RL regions")
    labels_row = kernel_row(
        lambda: L.labels(regions, SIZE), lambda: L.labels_plain(
            regions, SIZE), regions.numel() * 5,
        labels_sweeps(regions) * regions.numel()
        * LABELS_OPS_PER_POINT_SWEEP)
    log(f"rl kernels [{card}]: chase on replay ply {RL_MID}'s {len(cp)} lanes "
        f"({int((cp >= 0).sum())} live, {int(want_c.sum())} captured, "
        f"{int(rungs.sum())} rungs) bit-exact, {chase_row[0]:.4f} ms, plain "
        f"{chase_row[1]:.3f} ms, bound {chase_row[2][0]:.6f} ms "
        f"({chase_row[2][1]}); labels on {RL_BATCH} region boards bit-exact,"
        f" {labels_row[0]:.4f} ms, plain {labels_row[1]:.3f} ms, bound "
        f"{labels_row[2][0]:.6f} ms ({labels_row[2][1]})")

    holder = [states, RL_MID + 1]

    def one_ply():
        t = holder[1]
        holder[0] = it.replay_ply(holder[0], z, res.actions[t], live[t], t)
        holder[1] += 1

    opt.zero_grad(set_to_none=True)
    prof = profile_device(one_ply, SP_CHUNK,
                          f"{SP_CHUNK} replay plies from ply {RL_MID + 1} at "
                          f"game batch {RL_BATCH}", "replay ply")
    return dict(launches=launches, wall=wall, laps=laps, mfu=mfu,
                games_per_min=games_per_min, replay_ply_ms=replay_ply_ms,
                profile=prof, chase=chase_row, labels=labels_row)


def rl_generate(work: str, card: str, sl_export: str, rl_export: str,
                counters):
    """The value-corpus generator's CLI: the SL export before U, the RL
    export after, batch 256, at least ``GEN_POSITIONS`` positions; both
    kernels launched (counts reset just before, read just after)."""
    from rocalphago_tpu_torch.data.pipeline import ShardedDataset
    from rocalphago_tpu_torch.features import VALUE_FEATURES
    from rocalphago_tpu_torch.training import selfplay_data as SD

    prefix = os.path.join(work, "value_corpus", "v")
    batches = [0]
    inner = SD.play_value_games

    def counted(*a, **kw):
        batches[0] += 1
        return inner(*a, **kw)

    SD.play_value_games = counted
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    try:
        manifest = SD.run_generator([
            sl_export, rl_export, prefix, "--n-positions",
            str(GEN_POSITIONS), "--batch", str(RL_BATCH), "--seed",
            str(SEED)])
    finally:
        SD.play_value_games = inner
    wall = time.perf_counter() - t0
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by the generator")
    check(manifest["num_positions"] >= GEN_POSITIONS
          and manifest["planes"] == 49 and manifest["board_size"] == SIZE
          and manifest["feature_list"] == list(VALUE_FEATURES)
          and manifest["targets"] == "outcome",
          f"generator manifest {manifest}")
    ds = ShardedDataset(prefix)
    states, z = ds.gather(np.arange(len(ds)))
    check(states.dtype == np.uint8 and set(np.unique(z)) <= {-1, 1},
          "generator corpus: planes not uint8 or z not +-1")
    games = batches[0] * RL_BATCH
    rate = manifest["num_positions"] / wall
    log(f"generator cli [{card}]: {manifest['num_positions']} "
        f"positions from {games} games ({batches[0]} batches of {RL_BATCH}, "
        f"move limit 500), yield {manifest['num_positions'] / games:.4f}, "
        f"{wall:.2f} s: {rate:.2f} valid positions/s, "
        f"{int((z > 0).sum())} z=+1 and {int((z < 0).sum())} z=-1; "
        f"launches {launches}")
    return prefix, launches, rate, manifest["num_positions"] / games


def rl_value_and_search(dev, work: str, corpus: str, rl_export: str):
    """The value trainer on the generated corpus, then a device-search
    GTP session with the RL export and that value net."""
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move
    from rocalphago_tpu_torch.models import CNNValue
    from rocalphago_tpu_torch.search.players import build_player
    from rocalphago_tpu_torch.training import value

    spec = os.path.join(work, "value.json")
    CNNValue(board=SIZE, layers=12, filters_per_layer=128, seed=SEED + 72,
             device=dev).save_model(spec)
    out = os.path.join(work, "value")
    t0 = time.perf_counter()
    res = value.run_training([spec, corpus, out, "--epochs", "1",
                              "--epoch-length", str(VALUE_STEPS),
                              "--seed", str(SEED)])
    wall = time.perf_counter() - t0
    for k in ("train_mse", "val_mse", "test_mse"):
        check(np.isfinite(res[k]), f"value on the generated corpus: {k} = "
              f"{res[k]}")
    log(f"value on the generated corpus: {VALUE_STEPS} steps at minibatch "
        f"32, 19x19 12x128 bf16 FCN, {wall:.1f} s; train mse "
        f"{res['train_mse']:.4f}, val mse {res['val_mse']:.4f}, test mse "
        f"{res['test_mse']:.4f}")
    player = build_player("device-mcts", rl_export,
                          value_path=os.path.join(out, "model.json"))
    replies = io.StringIO()
    t0 = time.perf_counter()
    engine = run_gtp(player, io.StringIO(
        "boardsize 19\nclear_board\ngenmove b\ngenmove w\nquit\n"),
        replies)
    undegraded(engine)
    wall = time.perf_counter() - t0
    answers = [r for r in replies.getvalue().split("\n\n") if r.strip()]
    for reply in answers[2:4]:
        check(reply.startswith("=") and vertex_to_move(
            reply[1:].strip(), SIZE) is not None, f"genmove -> {reply!r}")
    check(engine.illegal_from_player == 0 and player.last_n_sim == 100,
          "the pipeline's device search played illegally or cut its search")
    log(f"the whole pipeline on one card: device-mcts over the RL export and "
        f"the value net trained on the generated corpus answered "
        f"{answers[2][1:].strip()}, {answers[3][1:].strip()} at 100 "
        f"simulations ({wall:.1f} s for the session)")


def phase_reinforcement(torchgo, dev, card, counters, sl_export):
    """The reinforcement stage at full width (phase 15)."""
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, RL_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    rl_export = rl_cli(work, sl_export)
    out = rl_iteration(torchgo, dev, card, counters, sl_export)
    corpus, gen_launches, rate, yield_ = rl_generate(
        work, card, sl_export, rl_export, counters)
    rl_value_and_search(dev, work, corpus, rl_export)
    log(f"reinforcement phase: {time.perf_counter() - t0:.1f} s")
    out.update(gen_launches=gen_launches, positions_per_s=rate,
               yield_=yield_)
    return out


# ------------------------------------------------------------ Gumbel path


def gumbel_searcher(pol, val, n_sim: int):
    from rocalphago_tpu_torch.search.device_mcts import make_gumbel_mcts

    return make_gumbel_mcts(pol.cfg, pol.feature_list, val.feature_list,
                            pol.module, val.module, n_sim=n_sim,
                            m_root=M_ROOT)


def gumbel_batched(torchgo, dev, pol, val, sts):
    """Phase 8's 8 roots searched together by the Gumbel searcher
    (float32, 16 simulations: a plan of 30), one noise draw: each root
    gets the visits and ``best`` it gets alone with its own noise row,
    and π′ within ``PI_ATOL``."""
    search = gumbel_searcher(pol, val, SEARCH_CHECK_SIMS)
    noise = search.draw_noise(len(sts), torch.Generator(
        device=dev).manual_seed(SEED + 16))
    together = search(bridged(torchgo, pol.cfg, sts, dev), noise=noise)
    alone = [search(bridged(torchgo, pol.cfg, [st], dev),
                    noise=noise[i:i + 1]) for i, st in enumerate(sts)]
    torch.cuda.synchronize()
    plan = search.plan_sims
    check(bool((together[0].sum(1) == plan).all()),
          f"batched Gumbel search ran {together[0].sum(1).tolist()} "
          f"simulations, not the plan's {plan}")
    for i, one in enumerate(alone):
        check(torch.equal(together[0][i:i + 1], one[0])
              and torch.equal(together[2][i:i + 1], one[2]),
              f"Gumbel root {i}: batched visits or best differ from alone")
        err = float((together[3][i:i + 1] - one[3]).abs().max())
        check(err <= PI_ATOL, f"Gumbel root {i}: pi' batched vs alone "
              f"{err:.3g}")
    log(f"gumbel: 8 roots at 19x19 full width (fp32), {SEARCH_CHECK_SIMS} "
        f"simulations (a plan of {plan}), m_root {M_ROOT}: visits and best "
        f"batched == alone on every root, pi' within {PI_ATOL}")


def gumbel_sync_free(pygo, torchgo, dev, pol, val):
    """One Gumbel chunk (every simulation forcing its root edge) and
    the rerank after it make no device→host sync, at batch 1 and 8, full
    width, bf16. Returns the batch-8 searcher, its tree grown on through
    the plan's later phases, its g and its candidates."""
    search = gumbel_searcher(pol, val, 100)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    for batch in (1, 8):
        sts = random_positions(pygo, batch, (20, 90, 160, 230),
                               SEED + 18 + batch)
        tree, g, cand, _ = search.init(bridged(torchgo, pol.cfg, sts, dev),
                                       generator=gen)
        k = search.schedule[0][0]
        search.run_phase(tree, g, cand, 0, 1, k)     # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            search.run_phase(tree, g, cand, 1, CHUNK, k)
            cand = search.rerank(tree, g, cand, k)
        except RuntimeError as e:
            raise SmokeFailure(f"a host sync inside a Gumbel chunk (batch "
                               f"{batch}): {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        visits, _ = search.root_stats(tree)
        check(bool((visits.sum(1) == CHUNK + 1).all()),
              f"sync-free Gumbel chunk: visits {visits.sum(1).tolist()}")
    # the later phases of the plan on the batch-8 tree
    for k, v in search.schedule[1:]:
        search.run_phase(tree, g, cand, 0, k * v, k)
        cand = search.rerank(tree, g, cand, k)
    log(f"gumbel: a chunk of {CHUNK} simulations and its rerank at batch 1 "
        "and 8 (19x19, full width, bf16) ran with no device->host sync")
    return search, tree, g, cand


def gumbel_tree_kernel(search, tree, g, cand, card):
    """The tree kernel against its plain version on the Gumbel-grown
    batch-8 slab, every descent forced down a candidate's root edge
    (each slot of the first phase), and timed on the first."""
    k = search.schedule[0][0]
    for slot in range(k):
        check_tree_walks(tree, search.base.c_puct, f"the Gumbel slab, slot "
                         f"{slot}", root_actions=search.forced_candidate(
                             g, cand, slot))
    ms, plain, (bnd, by), levels = tree_timing(
        tree, search.base.c_puct, "the Gumbel slab",
        root_actions=search.forced_candidate(g, cand, 0))
    log(f"tree kernel on the Gumbel batch-8 slab [{card}] "
        f"({int(tree.n_nodes.sum())} nodes): descend and backup bit-exact vs "
        f"plain with the root edge forced in each of {k} slots; "
        f"descend + backup {ms:.4f} ms ({int(levels.sum())} levels), plain "
        f"{plain:.3f} ms, bound {bnd:.6f} ms ({by})")


def gumbel_selfplay(torchgo, dev, card, counters, pol, val):
    """Gumbel search self-play at full width: batch 8, 32 simulations a
    move (a plan of 40), recorded π′ targets, ``GS_PLIES`` plies playing
    the halving winner, then ``GS_SAMPLE_PLIES`` sampling π′; every π′
    row finite and summing to
    1 within ``PI_ATOL``; the three kernels launched (counts reset just
    before, read just after). Returns the launches and simulations/s."""
    from rocalphago_tpu_torch.search.device_mcts import make_mcts_selfplay

    cfg = pol.cfg
    launches = {c.__name__.rsplit(".", 1)[-1]: 0 for c in counters}
    rates = []
    for sample, plies in ((False, GS_PLIES), (True, GS_SAMPLE_PLIES)):
        run = make_mcts_selfplay(
            cfg, pol.feature_list, val.feature_list, pol.module, val.module,
            batch=SS_BATCH, max_moves=plies, n_sim=SS_SIMS,
            sim_chunk=CHUNK, record_visits=True, gumbel=True, m_root=M_ROOT,
            gumbel_sample=sample, device=dev)
        plan = run.search.plan_sims
        gen = torch.Generator(device=dev).manual_seed(SEED + 19)
        # untimed: the searcher's first launches
        run.search_ply(torchgo.new_states(cfg, SS_BATCH, device=dev),
                       noise=run.search.draw_noise(SS_BATCH, gen))
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        final, actions, live, targets = run(gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for c in counters:
            launches[c.__name__.rsplit(".", 1)[-1]] += c.launches
        what = "sampling pi'" if sample else "playing the halving winner"
        check(actions.shape[0] == plies and targets.shape == (
            plies, SS_BATCH, cfg.num_points + 1)
            and targets.dtype == torch.float32,
            f"Gumbel self-play ({what}): {actions.shape[0]} plies, targets "
            f"{tuple(targets.shape)} {targets.dtype}")
        check(bool(torch.isfinite(targets).all())
              and bool(((targets.sum(-1) - 1).abs() <= PI_ATOL).all()),
              f"Gumbel self-play ({what}): a pi' row is not finite or does "
              f"not sum to 1: {targets.sum(-1).tolist()}")
        rate = plies * plan / wall
        rates.append(rate)
        log(f"gumbel self-play [{card}] ({what}): batch {SS_BATCH}, "
            f"{SS_SIMS} simulations (a plan of {plan}), m_root {M_ROOT}, "
            f"{plies} plies in {wall:.2f} s: {plies / wall:.3f} plies/s, "
            f"{rate:.1f} simulations/s ({rate * SS_BATCH:.1f} game "
            f"simulations/s); every pi' row finite and sums to 1")
    for name, n in launches.items():
        check(n > 0, f"the {name} kernel was not launched by Gumbel "
              "self-play")
    log(f"gumbel self-play launches {launches}")
    return launches, rates[0]


def gumbel_tournament_start():
    """Start the tournament CLI as a user runs it: ``gumbel-mcts``
    against ``device-mcts`` on the committed 9×9 gumbel nets, its log
    in ``build/``; ``(log path, the started child)``."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "smoke_tournament")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    log_path = os.path.join(out, "games.jsonl")
    spec = (os.path.join(root, GUMBEL_DIR, "policy.json") + ":"
            + os.path.join(root, GUMBEL_DIR, "value.json"))
    cmd = [sys.executable, "-m", "rocalphago_tpu_torch.interface.tournament",
           f"gumbel-mcts:{spec}", f"device-mcts:{spec}", "--games",
           str(TOURNEY_GAMES), "--board", "9", "--playouts",
           str(TOURNEY_PLAYOUTS), "--move-limit", str(TOURNEY_MOVES),
           "--log", log_path]
    return log_path, bg_start(cmd, os.path.join(out, "run"))


def gumbel_tournament(card, log_path: str, started):
    """Wait for the :func:`gumbel_tournament_start`ed tournament, then
    run the Elo CLI over its log."""
    root = os.path.dirname(os.path.abspath(__file__))
    rc, stdout, stderr, wall = bg_wait(started)
    check(rc == 0, f"tournament exited {rc}: {stderr[-2000:]}")
    tally = json.loads(stdout.strip().splitlines()[-1])
    with open(log_path) as f:
        games = [json.loads(line) for line in f]
    check(sum(tally["wins"].values()) == TOURNEY_GAMES
          and tally["forfeits"] == {"A": 0, "B": 0}
          and len(games) == TOURNEY_GAMES
          and not any("forfeit" in g for g in games),
          f"tournament: tally {tally}, {len(games)} log lines")
    proc = child_run([sys.executable, "-m",
                           "rocalphago_tpu_torch.interface.elo", log_path],
                          cwd=root, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    check(proc.returncode == 0, f"elo exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    table = json.loads(proc.stdout)["players"]
    check(set(table) == {"A", "B"} and all(
        row["elo"] is not None and np.isfinite(row["elo"])
        for row in table.values()), f"elo: {table}")
    log(f"tournament cli [{card}]: gumbel-mcts (A) vs device-mcts (B), "
        f"9x9 committed gumbel nets, {TOURNEY_PLAYOUTS} playouts, move "
        f"limit {TOURNEY_MOVES}: {tally['wins']}, gumbel win rate "
        f"{tally['win_rate_a']:.3f} (not a gate; not comparable with "
        f"results/gumbel_demo, another evaluator at 7x7), no forfeit, "
        f"{wall:.1f} s with start-up, beside phase 13's other CLI runs; elo "
        f"cli: A {table['A']['elo']}, B {table['B']['elo']}")


def gumbel_vs_puct(torchgo, dev, card, puct_player, player, state):
    """A PUCT and a Gumbel search of 100 simulations from the same root
    (the Gumbel session's last position), timed in turns (PUCT, Gumbel,
    Gumbel, PUCT; host ms, synchronised), then the kernels and device
    time of one Gumbel chunk (profiler)."""
    komi = float(state.komi)
    cfg, gumbel = player._searcher_for(komi, 100)
    _, puct = puct_player._searcher_for(komi)
    root = bridged(torchgo, cfg, [state], dev)
    noise = gumbel.draw_noise(1, torch.Generator(device=dev).manual_seed(
        SEED + 20))

    def run_puct():
        puct.run_sims_chunked(puct.init(root), CHUNK, owned=True)

    def run_gumbel():
        gumbel.run_chunked(root, CHUNK, noise=noise)

    laps = []
    for name, fn in (("puct", run_puct), ("gumbel", run_gumbel),
                     ("gumbel", run_gumbel), ("puct", run_puct)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        laps.append((name, (time.perf_counter() - t0) * 1e3))
    log(f"same root, 100 simulations each [{card}], host ms in turns: "
        + ", ".join(f"{n} {ms:.1f}" for n, ms in laps))
    tree, g, cand, _ = gumbel.init(root, noise=noise)
    k = gumbel.schedule[0][0]
    return laps, profile_device(
        lambda: gumbel.run_phase(tree, g, cand, 0, 1, k), CHUNK,
        f"one Gumbel chunk of {CHUNK} simulations at batch 1",
        "simulation")


def phase_gumbel(pygo, torchgo, dev, card, counters, phase8, specs, puct):
    """The Gumbel root search and the evaluation tools (phase 16);
    ``puct`` is phase 9's session (its player and p50)."""
    from rocalphago_tpu_torch.search.players import build_player

    t0 = time.perf_counter()
    gumbel_batched(torchgo, dev, *phase8)
    player = build_player("gumbel-mcts", specs[0], value_path=specs[1])
    grown = gumbel_sync_free(pygo, torchgo, dev, player.policy, player.value)
    gumbel_tree_kernel(*grown, card)
    main = phase_search_gtp(player, counters, what="gumbel-mcts")
    check(main["reuses"] == 0, f"the Gumbel player reused {main['reuses']} "
          "trees")
    log(f"gumbel-mcts genmove p50 {main['p50']:.2f} ms at 100 simulations "
        f"({main['p50'] / puct['p50']:.3f}x phase 9's device-mcts p50 "
        f"{puct['p50']:.2f} ms, the same run) on {card}")
    gumbel_vs_puct(torchgo, dev, card, puct["player"], player, main["state"])
    sp_launches, sp_rate = gumbel_selfplay(torchgo, dev, card, counters,
                                           player.policy, player.value)
    log(f"gumbel phase: {time.perf_counter() - t0:.1f} s")
    return dict(main=main, sp_launches=sp_launches, sp_rate=sp_rate)


# ------------------------------------------------------- host APV-MCTS


def mcts_specs():
    """The nets of phase 17, written by the port's spec CLI (its
    ``main``) with fresh seeded weights: the 19×19 12 × 128 policy (48
    planes) and FCN value net (49), a 32-filter 19×19 rollout net, a
    12 × 128 policy with two global-pooling blocks (phase 13 writes the
    tournament's 9×9 rollout net)."""
    from rocalphago_tpu_torch.models import specs

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, MCTS_DIR)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    paths = {}
    for name, argv in (
            ("policy", ["policy", "--seed", str(SEED + 30)]),
            ("value", ["value", "--seed", str(SEED + 31)]),
            ("rollout", ["rollout", "--seed", str(SEED + 32)]),
            ("pooled", ["policy", "--trunk-pool", "2", "--seed",
                        str(SEED + 33)])):
        paths[name] = os.path.join(out, f"{name}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            specs.main(argv + ["--out", paths[name]])
    return paths


class WaveClock:
    """Host seconds of each stage of a ``ParallelMCTS``'s leaf waves:
    descent (``_descend``, its state copies and moves included), encode
    and evaluation (the fused or separate net calls), rollout (the batch
    rollout) and backup (the rest of a wave: virtual loss, expansion,
    updates). Keeps the leaves of the last full wave and each device
    rollout's executed plies."""

    STAGES = ("descent", "evaluation", "rollout")

    def __init__(self, search):
        self.search = search
        self.secs = dict.fromkeys(("wave",) + self.STAGES, 0.0)
        self.waves = 0
        self.plies = []
        self.leaves = None
        self._wrap("_wave", "wave")
        self._wrap("_descend", "descent")
        for attr in ("_pv", "_policy", "_value"):
            if getattr(search, attr) is not None:
                self._wrap(attr, "evaluation")
        rollout = search._rollout

        def timed_rollout(states):
            if len(states) == MCTS_LEAF_BATCH:
                self.leaves = [st.copy() for st in states]
            t0 = time.perf_counter()
            out = rollout(states)
            self.secs["rollout"] += time.perf_counter() - t0
            if getattr(rollout, "last_plies", None) is not None:
                self.plies.append(rollout.last_plies)
            return out

        search._rollout = timed_rollout

    def _wrap(self, attr, stage):
        fn = getattr(self.search, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.secs[stage] += time.perf_counter() - t0
            self.waves += stage == "wave"
            return out

        setattr(self.search, attr, timed)

    def reset(self):
        self.secs = dict.fromkeys(self.secs, 0.0)
        self.waves = 0
        self.plies = []

    def per_wave_ms(self) -> dict:
        waves = max(self.waves, 1)
        out = {k: self.secs[k] / waves * 1e3 for k in self.STAGES}
        out["backup"] = (self.secs["wave"] - sum(
            self.secs[k] for k in self.STAGES)) / waves * 1e3
        return out


def mcts_session(player, counters, clock, card):
    """The main path of phase 17: the mcts player the GTP factory built
    from the specs (device rollouts), a scripted session of
    ``MCTS_GENMOVES`` genmoves at ``MCTS_PLAYOUTS`` playouts, then
    ``MCTS_TIMED_GENMOVES`` under ``time_settings 0 1 1``; every reply a
    legal vertex, labels and chase launched (counts reset just before,
    read just after)."""
    from rocalphago_tpu_torch.interface.gtp import run_gtp, vertex_to_move

    search = player.mcts
    check(search._n_playout == MCTS_PLAYOUTS
          and search._leaf_batch == MCTS_LEAF_BATCH
          and search._lmbda == 0.5 and search._rollout_limit == 500
          and search._c_puct == 5.0 and search._L == 20,
          "the mcts player is not at the smoke's playouts and the "
          "reference's other defaults")
    setup = ["boardsize 19", "clear_board", "komi 7.5", "play b C4",
             "play w D4", "play b D3", "play w Q16", "play b E3"]
    searched = [f"genmove {'wb'[i % 2]}" for i in range(MCTS_GENMOVES)]
    timed = [f"genmove {'wb'[(MCTS_GENMOVES + i) % 2]}"
             for i in range(MCTS_TIMED_GENMOVES)]
    cmds = setup + searched + ["time_settings 0 1 1"] + timed
    script = "\n".join(cmds + ["final_score", "quit"]) + "\n"
    runs, stages = [], []
    inner = player.get_move

    def recorded(state):
        clock.reset()
        move = inner(state)
        runs.append(player.last_n_playout)
        stages.append((clock.waves, clock.per_wave_ms(), list(clock.plies),
                       clock.secs["rollout"]))
        return move

    player.get_move = recorded
    instream, out = Timed(script), io.StringIO()
    for c in counters:
        c.launches = 0
    engine = run_gtp(player, instream, out)
    torch.cuda.synchronize()
    undegraded(engine)
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    player.get_move = inner
    replies = [r for r in out.getvalue().split("\n\n") if r.strip()]
    check(len(replies) == len(cmds) + 2,
          f"{len(replies)} replies to {len(cmds) + 2} commands")
    for cmd, reply in zip(cmds, replies):
        check(reply.startswith("="), f"{cmd!r} -> {reply!r}")
        if cmd.startswith("genmove"):
            check(vertex_to_move(reply[1:].strip(), SIZE) is not None,
                  f"genmove passed: {reply!r}")
    check(engine.illegal_from_player == 0,
          f"illegal_from_player = {engine.illegal_from_player}")
    for name, n in launches.items():
        check(n > 0, f"the {name} kernel was not launched by the mcts "
              "genmoves")
    check(runs[:MCTS_GENMOVES] == [MCTS_PLAYOUTS] * MCTS_GENMOVES
          and all(r < MCTS_PLAYOUTS and r % MCTS_LEAF_BATCH == 0
                  for r in runs[MCTS_GENMOVES:]),
          f"playouts per move: {runs}")
    stamps = instream.stamps
    g0 = len(setup)
    lat = [stamps[i + 1] - stamps[i] for i in range(g0, g0 + MCTS_GENMOVES)]
    p50 = sorted(lat)[len(lat) // 2] * 1e3
    # the first search builds the rollout runner and pays cuDNN's first
    # choices; the rate is over the others
    rate = MCTS_PLAYOUTS * (MCTS_GENMOVES - 1) / sum(lat[1:])
    t0 = g0 + MCTS_GENMOVES + 1
    tlat = [stamps[i + 1] - stamps[i]
            for i in range(t0, t0 + MCTS_TIMED_GENMOVES)]
    waves, wave_ms, plies, roll_s = stages[MCTS_GENMOVES - 1]
    plies_per_s = sum(plies) / roll_s
    log(f"mcts gtp [{card}]: {MCTS_GENMOVES} genmoves at {MCTS_PLAYOUTS} "
        f"playouts (leaf batch {MCTS_LEAF_BATCH}, lambda 0.5, device "
        f"rollouts to 500 plies) on the 19x19 12x128 bf16 policy, FCN "
        f"value and 32-filter rollout nets, all legal vertices; launches "
        f"{launches}; genmove p50 {p50:.1f} ms (each "
        f"{[round(x * 1e3, 1) for x in lat]} ms), {rate:.2f} playouts/s")
    log(f"mcts gtp under time_settings 0 1 1: playouts "
        f"{runs[MCTS_GENMOVES:]}, genmove ms "
        f"{[round(x * 1e3, 1) for x in tlat]}")
    log(f"mcts wave stages (genmove {MCTS_GENMOVES}, {waves} waves, host "
        "ms a wave): " + ", ".join(f"{k} {v:.2f}"
                                   for k, v in wave_ms.items())
        + f"; rollout plies a wave {plies}; {plies_per_s:.1f} rollout "
        f"plies/s at wave {MCTS_LEAF_BATCH}")
    return dict(launches=launches, p50=p50, rate=rate, wave_ms=wave_ms,
                plies_per_s=plies_per_s, state=engine.state)


def rollout_replay(torchgo, dev, rollout_fn, rollout_net, leaves,
                   counters, card):
    """One wave of 8 leaves from the session rolled out on the card with
    each ply's actions recorded, then replayed through pygo on the CPU:
    the same winners, every game over at the executed ply count. The
    host reads the run makes (``set_sync_debug_mode("warn")``), the
    launches of one wave through the player's own rollout callable, and
    a profile of 10 rollout plies."""
    import warnings

    from rocalphago_tpu_torch.search import selfplay

    check(leaves is not None and len(leaves) == MCTS_LEAF_BATCH,
          "no full wave of leaves was kept from the session")
    cfg = torchgo.GoConfig(size=SIZE, komi=float(leaves[0].komi))
    run = selfplay.make_device_rollout(cfg, rollout_net.feature_list,
                                       rollout_net.forward, with_steps=True)
    states = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, leaves, device=dev, with_history=False, with_labels=False))
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    record = []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            winners, plies = run(states, generator=gen, record=record)
            winners = winners.cpu().numpy()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # one "called a synchronizing CUDA operation" a read (the mode's own
    # "prototype feature" notice is not one)
    reads = sum("called a synchronizing" in str(w.message) for w in caught)
    want_reads = max(1, -(-plies // selfplay.ROLLOUT_CHECK_PLIES)) + 1
    check(reads == want_reads, f"a rollout wave of {plies} plies made "
          f"{reads} host reads, expected {want_reads}")
    actions = torch.stack(record).cpu().numpy()
    check(len(actions) == plies, "recorded plies != executed plies")
    replay = [st.copy() for st in leaves]
    n = SIZE * SIZE
    for t, row in enumerate(actions):
        for st, a in zip(replay, row):
            if st.is_end_of_game:
                continue
            move = None if a == n else divmod(int(a), SIZE)
            check(move is None or st.is_legal(move),
                  f"rollout ply {t}: illegal {move}")
            st.do_move(move)
    check(all(st.is_end_of_game for st in replay) or plies == 500,
          f"games not over after {plies} plies")
    host = np.asarray([st.get_winner() for st in replay])
    check(np.array_equal(host, winners),
          f"card winners {winners.tolist()} != CPU replay {host.tolist()}")
    for c in counters:
        c.launches = 0
    rollout_fn([st.copy() for st in leaves])
    torch.cuda.synchronize()
    wave_launches = {c.__name__.rsplit(".", 1)[-1]: c.launches
                     for c in counters}
    g = selfplay.gumbel_noise((MCTS_LEAF_BATCH, n), gen)
    prof = profile_device(lambda: run.ply(states, g), ROLLOUT_PROFILE_PLIES,
                          f"{ROLLOUT_PROFILE_PLIES} rollout plies at wave "
                          f"{MCTS_LEAF_BATCH} (19x19, 32-filter net)", "ply")
    log(f"device rollout [{card}]: a wave of {MCTS_LEAF_BATCH} leaves, "
        f"{plies} plies, winners {winners.tolist()} equal to the CPU "
        f"replay; {reads} host reads (one every "
        f"{selfplay.ROLLOUT_CHECK_PLIES} plies, one for the winners); "
        f"launches of one wave {wave_launches}")
    return dict(plies=plies, reads=reads, wave_launches=wave_launches,
                profile=prof)


def mcts_card_vs_cpu(pygo, dev, pooled_spec):
    """Symmetric policy distributions and values at batch 8, and a
    ``trunk_pool=2`` 12 × 128 policy forward, card against CPU (float32,
    TF32 off) within ``FORWARD_ATOL``/``FORWARD_RTOL``."""
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue, NeuralNetBase

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    states = random_positions(pygo, 8, (20, 160), SEED + 36, size=SIZE)
    sens = [st.get_legal_moves(include_eyes=False) for st in states]
    out = []
    for where in (dev, torch.device("cpu")):
        pol = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                        seed=SEED + 37, device=where, dtype=torch.float32)
        val = CNNValue(board=SIZE, layers=12, filters_per_layer=128,
                       seed=SEED + 38, device=where, dtype=torch.float32)
        pooled = NeuralNetBase.load_model(pooled_spec, device=where,
                                          dtype=torch.float32)
        out.append((
            pol.batch_eval_state(states, sens, symmetric=True),
            torch.as_tensor(val.batch_eval_state(states, symmetric=True)),
            pooled.forward(pooled._states_to_planes(states)).cpu()))
    (gd, gv, gl), (cd, cv, cl) = out
    errs = []
    for a, b in zip(gd, cd):
        check([m for m, _ in a] == [m for m, _ in b],
              "symmetric policy supports differ")
        pa, pb = (torch.tensor([p for _, p in x] + [0.0]) for x in (a, b))
        errs.append(float((pa - pb).abs().max()))
        check(torch.allclose(pa, pb, atol=FORWARD_ATOL, rtol=FORWARD_RTOL),
              f"symmetric policy: max abs err {errs[-1]}")
    verr, lerr = float((gv - cv).abs().max()), float((gl - cl).abs().max())
    check(torch.allclose(gv, cv, atol=FORWARD_ATOL, rtol=FORWARD_RTOL),
          f"symmetric value: max abs err {verr}")
    check(bool(torch.isfinite(gl).all()) and torch.allclose(
        gl, cl, atol=FORWARD_ATOL, rtol=FORWARD_RTOL),
        f"pooled policy forward: max abs err {lerr}")
    log(f"symmetric evaluation at batch 8 (8 x 8 transforms in one "
        f"forward), 12x128 fp32 (TF32 off), card vs CPU: policy max abs "
        f"err {max(errs):.3g}, value {verr:.3g}; trunk_pool=2 12x128 "
        f"policy logits {lerr:.3g}")


def mcts_tournament_start():
    """Start the tournament CLI with a rollout spec: ``mcts`` (device
    rollouts, a seeded 9×9 rollout net written by the port's spec CLI)
    against ``greedy`` on the committed 9×9 gumbel nets; ``(log path,
    the started child)``."""
    from rocalphago_tpu_torch.models import specs

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "smoke_tournament")
    rollout9 = os.path.join(out, "rollout9.json")
    with contextlib.redirect_stdout(io.StringIO()):
        specs.main(["rollout", "--board", "9", "--seed", str(SEED + 34),
                    "--out", rollout9])
    log_path = os.path.join(out, "mcts_games.jsonl")
    pol = os.path.join(root, GUMBEL_DIR, "policy.json")
    val = os.path.join(root, GUMBEL_DIR, "value.json")
    cmd = [sys.executable, "-m", "rocalphago_tpu_torch.interface.tournament",
           f"mcts:{pol}:{val}:{rollout9}", f"greedy:{pol}",
           "--games", str(MCTS_TOURNEY_GAMES), "--board", "9", "--playouts",
           str(TOURNEY_PLAYOUTS), "--move-limit", str(TOURNEY_MOVES),
           "--device-rollout", "--log", log_path]
    return log_path, bg_start(cmd, os.path.join(out, "mcts_run"))


def mcts_tournament(card, log_path: str, started):
    """Wait for the :func:`mcts_tournament_start`ed tournament: both
    games played, no forfeit."""
    rc, stdout, stderr, wall = bg_wait(started)
    check(rc == 0, f"tournament exited {rc}: {stderr[-2000:]}")
    tally = json.loads(stdout.strip().splitlines()[-1])
    with open(log_path) as f:
        games = [json.loads(line) for line in f]
    check(sum(tally["wins"].values()) == MCTS_TOURNEY_GAMES
          and tally["forfeits"] == {"A": 0, "B": 0}
          and len(games) == MCTS_TOURNEY_GAMES
          and not any("forfeit" in g for g in games),
          f"mcts tournament: tally {tally}, {len(games)} log lines")
    log(f"tournament cli [{card}]: mcts (A, device rollouts, seeded 9x9 "
        f"rollout spec) vs greedy (B), committed 9x9 gumbel nets, "
        f"{TOURNEY_PLAYOUTS} playouts, move limit {TOURNEY_MOVES}: "
        f"{tally['wins']}, no forfeit, {wall:.1f} s with start-up, beside "
        f"phase 13's other CLI runs")


def phase_mcts(pygo, torchgo, dev, card, counters):
    """The reference's own AlphaGo player (phase 17)."""
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.search.players import ValuePlayer, build_player

    t0 = time.perf_counter()
    paths = mcts_specs()
    player = build_player("mcts", paths["policy"], paths["value"],
                          paths["rollout"], playouts=MCTS_PLAYOUTS,
                          leaf_batch=MCTS_LEAF_BATCH, lmbda=0.5,
                          device_rollout=True)
    rollout_fn = player.mcts._rollout
    clock = WaveClock(player.mcts)
    main = mcts_session(player, counters, clock, card)
    main["replay"] = rollout_replay(
        torchgo, dev, rollout_fn, NeuralNetBase.load_model(paths["rollout"]),
        clock.leaves, counters, card)
    state = main["state"]
    host = build_player("mcts", paths["policy"], paths["value"],
                        paths["rollout"], playouts=MCTS_HOST_PLAYOUTS)
    t1 = time.perf_counter()
    move = host.get_move(state)
    check(move is not None and state.is_legal(move),
          f"host-rollout genmove gave {move}")
    log(f"mcts genmove with host rollouts [{card}]: {MCTS_HOST_PLAYOUTS} "
        f"playouts (one wave), legal, "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    mcts_card_vs_cpu(pygo, dev, paths["pooled"])
    vp = ValuePlayer(NeuralNetBase.load_model(paths["value"]),
                     NeuralNetBase.load_model(paths["policy"]),
                     top_k=VALUE_TOP_K)
    t1 = time.perf_counter()
    move = vp.get_move(state)
    check(move is not None and state.is_legal(move),
          f"value player gave {move}")
    log(f"value player [{card}]: top-{VALUE_TOP_K} policy pre-filter, one "
        f"batched value call, legal, "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    log(f"mcts phase: {time.perf_counter() - t0:.1f} s")
    return main


# ------------------------------------------------------- the zero loop


def zero_specs(work: str) -> tuple:
    """Fresh seeded 19×19 specs from the port's spec CLI: the 12 × 128
    policy (48 planes) and the 12 × 128 FCN value net (49 planes), the
    auxiliary heads grafted on (``with_aux_heads``)."""
    from rocalphago_tpu_torch.models import NeuralNetBase, specs
    from rocalphago_tpu_torch.models.value import with_aux_heads

    paths = [os.path.join(work, f"{n}.json") for n in ("policy", "value")]
    plain = os.path.join(work, "value_plain.json")
    with contextlib.redirect_stdout(io.StringIO()):
        specs.main(["policy", "--seed", str(SEED + 40), "--out", paths[0]])
        specs.main(["value", "--seed", str(SEED + 41), "--out", plain])
    with_aux_heads(NeuralNetBase.load_model(plain),
                   seed=SEED + 42).save_model(paths[1])
    pol, val = (NeuralNetBase.load_model(x) for x in paths)
    check(pol.preprocess.output_dim == 48 and val.preprocess.output_dim == 49
          and tuple(val.module.aux_heads) == ("ownership", "score")
          and pol.spec_kwargs["layers"] == val.spec_kwargs["layers"] == 12,
          "zero specs: not 12 x 128 nets of 48 / 49 planes with aux heads")
    return tuple(paths)


def zero_argv(paths, out: str, iterations: int = ZERO_ITERATIONS,
              *extra) -> list:
    """The zero CLI's command line: full width, depth cut."""
    return [*paths, out, "--game-batch", str(ZERO_BATCH), "--sims",
            str(ZERO_SIMS), "--move-limit", str(ZERO_MOVES), "--iterations",
            str(iterations), "--save-every", "1", "--gate-every", "2",
            "--gate-games", str(ZERO_GATE_GAMES), "--dirichlet-alpha",
            str(ZERO_ALPHA), "--seed", str(SEED), *extra]


def zero_artifacts(out: str, step: int = ZERO_ITERATIONS):
    """A run's final checkpoint, its metric rows without wall times, and
    the bytes of its exports, specs and pool."""
    state = torch.load(os.path.join(out, "checkpoints", str(step),
                                    "state.pt"), map_location="cpu",
                       weights_only=True)
    rows = []
    with open(os.path.join(out, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["event"] in ("iteration", "gate", "ladder"):
                rows.append({k: v for k, v in r.items() if k not in (
                    "time", "games_per_min", "replay_version",
                    "replay_staleness_s")})
    files = {}
    for sub in ("", "pool"):
        for name in sorted(os.listdir(os.path.join(out, sub))):
            if name.endswith((".msgpack", ".json")) and \
                    name != "metadata.json":
                with open(os.path.join(out, sub, name), "rb") as f:
                    files[os.path.join(sub, name)] = f.read()
    return state, rows, files


def run_events(out: str) -> list:
    """The records of a run's ``metrics.jsonl``."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_span_paths(events, paths, what: str) -> dict:
    """Every path in ``paths`` among the run's span records, each record
    of it ``ok``; returns the records by path."""
    spans: dict = {}
    for e in events:
        if e["event"] == "span":
            spans.setdefault(e["path"], []).append(e)
    for path in paths:
        check(path in spans and all(r["ok"] for r in spans[path]),
              f"{what}: no span {path} with ok true (spans {sorted(spans)})")
    return spans


def last_registry(events, what: str) -> dict:
    """The snapshot of the run's last ``registry`` record."""
    snaps = [e["snapshot"] for e in events if e["event"] == "registry"]
    check(bool(snaps), f"{what}: no registry record in metrics.jsonl")
    return snaps[-1]


def launch_series(snapshot: dict | None = None) -> dict:
    """``{(entry, kernel): launches}`` of the ``kernel_launches_total``
    series in a registry snapshot (default: this process's registry)."""
    from rocalphago_tpu_torch.obs import registry

    counters = (snapshot or registry.snapshot())["counters"]
    out = {}
    for key, v in counters.items():
        m = re.fullmatch(r'kernel_launches_total\{entry="([^"]*)",'
                         r'kernel="([^"]*)"\}', key)
        if m:
            out[m.groups()] = v
    return out


def launches_since(before: dict) -> dict:
    """The series that grew since ``before`` (:func:`launch_series`),
    by how much, the untracked remainder brought up to date first."""
    from rocalphago_tpu_torch.obs import torchobs

    torchobs.flush_untracked()
    return {k: v - before.get(k, 0) for k, v in launch_series().items()
            if v != before.get(k, 0)}


def by_kernel(series: dict, tracked_only: bool = False) -> dict:
    """Per-kernel sums of :func:`launch_series`-shaped ``series``, with or
    without the ``untracked`` entry."""
    from rocalphago_tpu_torch.obs import torchobs

    out = dict.fromkeys(torchobs.KERNELS, 0)
    for (entry, kernel), v in series.items():
        if not (tracked_only and entry == "untracked"):
            out[kernel] += v
    return out


def trace_kernel_counts(path: str) -> dict:
    """Kernel records per kernel of the port in a Chrome trace that
    ``torch.profiler`` exported, by the kernels' symbols."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(1 for n in names if any(
        re.search(rf"\b{sym}\b", n) for sym in syms))
        for k, syms in KERNEL_SYMBOLS.items()}


def same_tree(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y)
                                        for x, y in zip(a, b))
    return a == b


def zero_cli(work: str, paths, card: str):
    """The zero CLI four ways: straight, with one lockstep actor, and
    a ``--profile-dir`` capture of a cut run, each a child process, with
    the ``--host-reads`` count beside them (all timing-free); meanwhile
    in this process the run killed after its next-to-last iteration
    and resumed with the same command, its first play's record kept for
    phase 23. The killed and the actor runs end on the straight run's
    checkpoint, exports, pool and metric rows bit for bit. Returns the
    walls, the host-reads count and the record's path."""
    from rocalphago_tpu_torch.io.checkpoint import TrainCheckpointer
    from rocalphago_tpu_torch.obs import torchobs
    from rocalphago_tpu_torch.training import zero

    root = os.path.dirname(os.path.abspath(__file__))
    prof_dir = os.path.join(work, "profile")
    outs = {name: os.path.join(work, name) for name in (
        "straight", "actor_learner", "profiled", "killed")}
    cmds = {
        "straight": zero_argv(paths, outs["straight"]),
        "actor_learner": zero_argv(paths, outs["actor_learner"],
                                   ZERO_ITERATIONS, "--actor-learner",
                                   "--actors", "1"),
        "profiled": zero_argv(paths, outs["profiled"], 1,
                              *ZERO_PROFILE_ARGS, "--profile-dir", prof_dir)}
    record = os.path.join(work, "play0.pt")
    started, ran, walls = {}, {}, {}
    try:
        for name, argv in cmds.items():
            started[name] = bg_start(
                [sys.executable, "-m", "rocalphago_tpu_torch.training.zero",
                 *argv], outs[name] + "_run")
        started["host_reads"] = bg_start(
            [sys.executable, os.path.abspath(__file__), "--host-reads",
             root], os.path.join(work, "host_reads_run"))
        last = ZERO_ITERATIONS - 1
        real = TrainCheckpointer.save

        def killing_save(self, step, state):
            real(self, step, state)
            if step == last:
                raise KeyboardInterrupt(f"killed after iteration {last}")

        t0 = time.perf_counter()
        torchobs.flush_untracked()
        series0 = launch_series()
        process0 = torchobs.process_launches()
        undo = record_first_play(record)
        TrainCheckpointer.save = killing_save
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                zero.run_training(zero_argv(paths, outs["killed"]))
            raise SmokeFailure("the zero run was not killed")
        except KeyboardInterrupt:
            pass
        finally:
            TrainCheckpointer.save = real
            undo()
        check(torch.backends.cudnn.deterministic
              and not torch.backends.cudnn.benchmark,
              "the zero trainer left cuDNN non-deterministic")
        with contextlib.redirect_stdout(io.StringIO()):
            zero.run_training(zero_argv(paths, outs["killed"]))
        walls["killed"] = time.perf_counter() - t0
        # the killed and resumed runs' launches: each counted once in
        # the registry, the tracked entries' within the process's
        grown = launches_since(series0)
        process = {k: v - process0[k]
                   for k, v in torchobs.process_launches().items()}
        tracked = by_kernel(grown, tracked_only=True)
        check(by_kernel(grown) == process and all(
            0 < tracked[k] <= process[k] for k in process),
            f"zero killed and resumed: kernel_launches_total grew by "
            f"{grown}, the process by {process}")
        for name, run in started.items():
            rc, stdout, stderr, walls[name] = ran[name] = bg_wait(run)
            check(rc == 0, f"zero {name}: rc {rc}\n{stderr[-3000:]}")
    finally:
        bg_stop(started.values())
    final = json.loads(ran["straight"][1].strip().splitlines()[-1])
    check(final["iteration"] == last and all(
        np.isfinite(final[k]) for k in zero.METRICS),
        f"zero final row {final}")
    want = zero_artifacts(outs["straight"])
    for name in ("policy.json", "value.json",
                 f"policy.{ZERO_ITERATIONS:05d}.flax.msgpack",
                 f"value.{ZERO_ITERATIONS:05d}.flax.msgpack",
                 "pool/best.00000.policy.msgpack", "pool/rollout.json"):
        check(name in want[2], f"zero: no {name}")
    # a gate every 2 iterations and after the last
    n_gates = sum((it + 1) % 2 == 0 or it == last
                  for it in range(ZERO_ITERATIONS))
    gates = [r for r in want[1] if r["event"] == "gate"]
    check(len(gates) == n_gates,
          f"zero: {len(gates)} gate matches, not {n_gates}")
    # the reference's instrumentation in the run's metrics.jsonl
    events = run_events(outs["straight"])
    spans = check_span_paths(events, ZERO_SPAN_PATHS, "zero straight run")
    check(len(spans["zero.iteration"]) == ZERO_ITERATIONS
          and all(r["plies"] == ZERO_MOVES
                  for r in spans["zero.iteration/zero.selfplay"]),
          "zero: an iteration span missing, or a selfplay span's plies tag "
          "off")
    snap = last_registry(events, "zero straight run")
    series = launch_series(snap)
    entries = {e for e, _ in series}
    check({"zero.replay_segment", "zero.apply_updates", "device_mcts.init",
           "device_mcts.run_sims", "untracked"} <= entries
          and len(series) == len(torchobs.KERNELS) * len(entries)
          and series[("device_mcts.run_sims", "tree")] > 0
          and series[("zero.apply_updates", "chase")] == 0,
          f"zero straight run: kernel_launches_total {series}")
    occupancy = snap["gauges"].get('device_occupancy{runner="zero.replay"}')
    check(snap["counters"].get("device_mcts_sims_total", 0) > 0
          and occupancy is not None and 0.0 < occupancy <= 1.0,
          "zero straight run: the registry record lacks the search's "
          "simulations or the replay's occupancy")
    got = zero_artifacts(outs["killed"])
    check(same_tree(got[0], want[0]) and got[1] == want[1]
          and got[2] == want[2],
          f"zero killed after iteration {last} and resumed: the "
          "checkpoint, exports, pool or metric rows differ from the "
          "straight run's")
    got = zero_artifacts(outs["actor_learner"])
    check(same_tree(got[0], want[0]) and got[1] == want[1]
          and got[2] == want[2],
          "zero --actor-learner --actors 1: the checkpoint, exports, pool "
          "or metric rows differ from the synchronous run's")
    events = run_events(outs["actor_learner"])
    check_span_paths(events, ("zero.iteration/learner.step",
                              "zero.iteration/learner.step/zero.replay",
                              "actor.play", "actor.play/zero.selfplay"),
                     "zero --actor-learner")
    snap = last_registry(events, "zero --actor-learner")
    flat = {**snap["counters"], **snap["gauges"], **snap["histograms"]}
    split = ("learner_steps_total", "learner_wait_seconds",
             "learner_idle_frac", "replay_fill_games",
             "replay_ingest_games_total", "replay_ingest_per_min",
             "replay_spilled_total", "replay_sample_staleness_seconds",
             'actor_games_total{actor="a0"}', "actor_params_version")
    check(all(k in flat for k in split)
          and snap["counters"]["learner_steps_total"] >= ZERO_ITERATIONS,
          "zero --actor-learner: the registry lacks "
          f"{[k for k in split if k not in flat]}")

    # --profile-dir: a torch.profiler capture of a cut run
    trace_path = os.path.join(prof_dir, zero.PROFILE_TRACE)
    traced = trace_kernel_counts(trace_path)
    events = run_events(outs["profiled"])
    check([e["action"] for e in events if e["event"] == "profiler"]
          == ["start", "stop"], "zero --profile-dir: no profiler events")
    check(all(traced.values()), f"zero --profile-dir: the trace misses a "
          f"kernel: {traced}")
    hr = json.loads(ran["host_reads"][1].strip().splitlines()[-1])
    log(f"zero --profile-dir [{card}]: 1 iteration "
        f"({' '.join(ZERO_PROFILE_ARGS)}) in {walls['profiled']:.1f} s "
        "with the process start, the capture and its export; "
        f"{os.path.getsize(trace_path) / 2**20:.1f} MiB Chrome trace, kernel "
        f"records: chase {traced['chase']}, labels {traced['labels']}, tree "
        f"{traced['tree']}")
    per_entry = {e: {k: series[(e, k)] for k in ("labels", "chase", "tree")}
                 for e in sorted(entries)}
    log(f"zero cli: kernel_launches_total of the straight run by entry "
        + ", ".join(f"{e} {v}" for e, v in per_entry.items())
        + f"; the killed and resumed runs in process: {tracked} in tracked "
        f"entries of the process's {process}")
    log(f"zero cli [{card}]: {ZERO_ITERATIONS} iterations at game batch "
        f"{ZERO_BATCH}, "
        f"{ZERO_SIMS} simulations, move limit {ZERO_MOVES}, Dir("
        f"{ZERO_ALPHA}), gate every 2 ({ZERO_GATE_GAMES} games), 19x19 "
        f"12x128 bf16, the four runs and the host-reads count at once: "
        f"straight {walls['straight']:.1f} s with the process start (last "
        f"row: policy loss {final['policy_loss']:.3f}, "
        f"{final['games_per_min']:.2f} games/min; gates "
        + ", ".join(f"{g['wins_a']}-{g['wins_b']}-{g['draws']} "
                    f"promoted={g['promoted']}" for g in gates)
        + f"); killed after iteration {last} and resumed in process "
        f"({walls['killed']:.1f} "
        f"s) and --actor-learner --actors 1 ({walls['actor_learner']:.1f} "
        "s): checkpoint, exports, pool and rows bit-identical")
    return walls, hr, record


def zero_timed(torchgo, dev, card, counters, paths):
    """One iteration in process with the playout caps (p 0.25, cheap 4)
    and the auxiliary heads (weight 1): the wall of play, replay,
    update and a gate match (a sync after each), with the launches of
    the iteration counted from zero; a replay segment under
    ``set_sync_debug_mode("error")``; a profile of replay plies."""
    from rocalphago_tpu_torch.io.metrics import MetricsLogger
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.obs import trace
    from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
    from rocalphago_tpu_torch.training import zero

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    pol, val = (NeuralNetBase.load_model(x) for x in paths)
    cfg = torchgo.GoConfig(size=SIZE, komi=torchgo.default_komi(SIZE))
    it = zero.ZeroIteration(
        cfg, pol.feature_list, val.feature_list, ZERO_BATCH, ZERO_MOVES,
        ZERO_SIMS, dirichlet_alpha=ZERO_ALPHA, cap_p=ZERO_CAP_P,
        cap_cheap=ZERO_CAP_CHEAP, aux_weight=ZERO_AUX, device=dev)
    state = zero.init_zero_state(pol.module, val.module, seed=SEED + 43)
    laps = {}
    real_update = it.apply_updates

    def timed_update(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_update(*a)
        torch.cuda.synchronize()
        laps["update"] = time.perf_counter() - t0
        return out

    it.apply_updates = timed_update
    before = {k: v.detach().clone() for k, v in pol.module.state_dict().items()}
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    _, game_seed = zero.next_keys(state.rng)
    t0 = time.perf_counter()
    games = it.play(state.policy, state.value, game_seed)
    torch.cuda.synchronize()
    laps["play"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    state, m = it.learn(state, games)
    metrics = zero.metrics_to_host(m)
    learn_s = time.perf_counter() - t1
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    laps["replay"] = learn_s - laps["update"]
    del it.apply_updates
    run = it.last_selfplay
    plies = games.actions.shape[0]
    for name, k in launches.items():
        check(k > 0, f"the {name} kernel was not launched by the zero "
              "iteration")
    check(plies == ZERO_MOVES and games.full is not None
          and games.ownership is not None and games.score is not None,
          f"zero iteration: {plies} plies, caps or aux labels missing")
    after = pol.module.state_dict()
    check(all(bool(torch.isfinite(after[k]).all()) for k in after)
          and not all(torch.equal(before[k], after[k]) for k in after)
          and all(np.isfinite(v) for v in metrics.values()),
          "the zero update left the policy unchanged or not finite")
    gate = zero.ZeroGate(cfg, pol.feature_list, os.path.dirname(paths[0]),
                         games=ZERO_GATE_GAMES, threshold=0.55,
                         temperature=1.0, move_limit=ZERO_MOVES, write=False,
                         device=dev)
    t0 = time.perf_counter()
    tally = gate.match(state.policy, zero.snapshot(state.policy),
                       zero.match_generator(SEED, 0, 0, dev))
    laps["gate"] = time.perf_counter() - t0
    wall = laps["play"] + laps["replay"] + laps["update"]
    games_per_min = ZERO_BATCH * 60.0 / wall
    sims_per_s = run.last_sims / laps["play"]
    replay_ply_ms = laps["replay"] / plies * 1e3
    flops = conv_flops(pol.module)[1] + conv_flops(val.module)[1]
    positions = plies * ZERO_BATCH
    mfu = positions * flops / laps["replay"] / BF16_FLOPS_PER_S
    log(f"zero iteration [{card}]: game batch {ZERO_BATCH}, {ZERO_SIMS} "
        f"simulations (cap p {ZERO_CAP_P}, cheap {ZERO_CAP_CHEAP}; full-search"
        f" fraction {run.last_full_frac:.3f}), aux weight {ZERO_AUX}, move "
        f"limit {ZERO_MOVES}, 19x19 12x128 bf16: play {laps['play']:.2f} s, "
        f"replay {laps['replay']:.2f} s, update {laps['update'] * 1e3:.2f} "
        f"ms, gate match ({ZERO_GATE_GAMES} games) {laps['gate']:.2f} s; "
        f"{games_per_min:.2f} games/min (play + replay + update), "
        f"{sims_per_s:.1f} simulations/s ({run.last_sims} lockstep "
        f"simulations), {replay_ply_ms:.2f} ms a replay ply, replay MFU share "
        f"{mfu:.5f} ({positions} positions x {flops / 1e9:.3f} GFLOP); "
        f"policy loss {metrics['policy_loss']:.3f}, aux ownership "
        f"{metrics['aux_loss_ownership']:.4f}; gate tally {tally}; launches "
        f"{launches}")

    # a replay segment with no device->host sync, then a profile
    (actions, live_f, visits, winners, finished, full_f, aux_labels,
     _) = it._record(games)
    wf = winners.float()
    holder = [torchgo.new_states(cfg, ZERO_BATCH, device=dev), 0]

    def one_ply():
        t = holder[1]
        holder[0], _ = it.replay_ply(state, holder[0], wf, finished,
                                     aux_labels, actions[t], live_f[t],
                                     visits[t], full_f[t])
        holder[1] += 1

    one_ply()
    torch.cuda.synchronize()
    # the segment as learn() runs it: in the zero.replay span, pushed to
    # the replay's pipeline (its runner metrics on), a sink configured
    sink = MetricsLogger(os.path.join(os.path.dirname(paths[0]),
                                      "segment.jsonl"), echo=False)
    trace.configure(sink)
    pipe = ChunkPipeline(dev, runner="zero.replay")
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.span("zero.replay", plies=ZERO_PROFILE_PLIES):
            for _ in range(ZERO_PROFILE_PLIES):
                one_ply()
            pipe.push()
            pipe.finish()
    except RuntimeError as e:
        raise SmokeFailure(f"a host sync inside a zero replay segment: "
                           f"{e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
        trace.configure(None)
        sink.close()
    torch.cuda.synchronize()
    log(f"zero: a replay segment of {ZERO_PROFILE_PLIES} plies at game "
        f"batch {ZERO_BATCH} (one 49-plane encode, both nets forward and "
        "backward, aux heads), in its span and pushed to the replay's "
        "pipeline with the runner metrics on, ran with no device->host "
        "sync")
    holder[:] = [torchgo.new_states(cfg, ZERO_BATCH, device=dev), 0]
    for _ in range(ZERO_MOVES - ZERO_PROFILE_PLIES):
        one_ply()
    holder[1] = ZERO_MOVES - ZERO_PROFILE_PLIES
    prof = profile_device(one_ply, ZERO_PROFILE_PLIES,
                          f"{ZERO_PROFILE_PLIES} zero replay plies at game "
                          f"batch {ZERO_BATCH}", "replay ply")
    state.opt_policy.zero_grad(set_to_none=True)
    state.opt_value.zero_grad(set_to_none=True)
    return dict(launches=launches, laps=laps, wall=wall, mfu=mfu,
                games_per_min=games_per_min, sims_per_s=sims_per_s,
                replay_ply_ms=replay_ply_ms, profile=prof, games=games,
                full_frac=run.last_full_frac)


def count_host_reads(fn):
    """``(fn(), host reads)``: ``fn`` under ``set_sync_debug_mode
    ("warn")``, each synchronizing call's warning counted."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def zero_host_reads(torchgo, dev, paths) -> dict:
    """One zero iteration in process (``iteration(state)`` and the
    metrics read, the timed iteration's caps and aux heads) from fresh
    nets, after one that warms: its host reads, and the span records
    and registry writes it made (a sink configured, the registry's
    writes counted). Runs on the commit before the instrumentation as
    well (``--host-reads``)."""
    from rocalphago_tpu_torch.io.metrics import MetricsLogger
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.obs import registry, trace
    from rocalphago_tpu_torch.training import zero

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    pol, val = (NeuralNetBase.load_model(x) for x in paths)
    cfg = torchgo.GoConfig(size=SIZE, komi=torchgo.default_komi(SIZE))
    it = zero.ZeroIteration(
        cfg, pol.feature_list, val.feature_list, ZERO_BATCH, ZERO_MOVES,
        ZERO_SIMS, dirichlet_alpha=ZERO_ALPHA, cap_p=ZERO_CAP_P,
        cap_cheap=ZERO_CAP_CHEAP, aux_weight=ZERO_AUX, device=dev)
    holder = [zero.init_zero_state(pol.module, val.module, seed=SEED + 44)]

    def iteration():
        holder[0], m = it(holder[0])
        return zero.metrics_to_host(m)

    iteration()
    logger = MetricsLogger(os.path.join(os.path.dirname(paths[0]),
                                        "host_reads.jsonl"), echo=False)
    counts = {"spans": 0, "writes": 0}

    class Sink:
        def write(self, event, **fields):
            counts["spans"] += event == "span"
            logger.write(event, **fields)

    def counting(fn):
        def wrapped(self, *a, **kw):
            counts["writes"] += 1
            return fn(self, *a, **kw)
        return wrapped

    methods = ((registry.Counter, "inc"), (registry.Gauge, "set"),
               (registry.Histogram, "observe"))
    real = [getattr(cls, name) for cls, name in methods]
    for (cls, name), fn in zip(methods, real):
        setattr(cls, name, counting(fn))
    trace.configure(Sink())
    try:
        t0 = time.perf_counter()
        metrics, reads = count_host_reads(iteration)
        wall = time.perf_counter() - t0
    finally:
        trace.configure(None)
        logger.close()
        for (cls, name), fn in zip(methods, real):
            setattr(cls, name, fn)
    check(all(np.isfinite(v) for v in metrics.values()),
          f"host-reads iteration metrics {metrics}")
    return dict(reads=reads, wall=wall, **counts)


def instrumentation_cost(work: str) -> tuple:
    """Seconds per span record through a ``MetricsLogger`` sink, and
    per registry write (a get-or-create and an update, the three kinds
    in turn), on this machine's host: the reference's method."""
    from rocalphago_tpu_torch.io.metrics import MetricsLogger
    from rocalphago_tpu_torch.obs import registry, trace

    reps = 500
    probe = MetricsLogger(os.path.join(work, "probe.jsonl"), echo=False)
    trace.configure(probe)
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            with trace.span("probe"):
                pass
        per_span = (time.perf_counter() - t0) / reps
    finally:
        trace.configure(None)
        probe.close()
    reg = registry.Registry()
    t0 = time.perf_counter()
    for i in range(reps):
        reg.counter("probe_total", runner="probe").inc()
        reg.gauge("probe_gauge", runner="probe").set(i)
        reg.histogram("probe_seconds", runner="probe").observe(1e-3)
    per_write = (time.perf_counter() - t0) / (3 * reps)
    return per_span, per_write


def zero_instrumentation(card, paths, timed, straight, hr):
    """The instrumentation's gate: one iteration's host reads, counted
    as the parent commit's were (``--host-reads``, a fresh process,
    ``hr``, run beside phase 18's CLI runs), equal to the parent's; and
    its spans and registry writes, at their cost on this host, under
    ``OVERHEAD_LIMIT`` of the timed iteration's wall. (Counted inside
    this process, after phase 18's other runs, the same iteration once
    read one time fewer; the cause was not traced, so both counts come
    from fresh processes.)"""
    check(hr["spans"] >= 3 and hr["writes"] > 0,
          f"the zero iteration emitted {hr['spans']} spans and "
          f"{hr['writes']} registry writes")
    check(hr["reads"] == ZERO_PARENT_HOST_READS,
          f"a zero iteration makes {hr['reads']} host reads, the commit "
          f"before the instrumentation {ZERO_PARENT_HOST_READS}")
    cli_spans = (sum(e["event"] == "span" for e in run_events(straight))
                 / ZERO_ITERATIONS)
    spans = max(hr["spans"], cli_spans)
    per_span, per_write = instrumentation_cost(os.path.dirname(paths[0]))
    cost = spans * per_span + hr["writes"] * per_write
    share = cost / timed["wall"]
    check(share < OVERHEAD_LIMIT,
          f"instrumentation {share:.4%} of a zero iteration's wall")
    log(f"zero instrumentation [{card}]: host reads of one iteration "
        f"{hr['reads']} under set_sync_debug_mode('warn') (the commit "
        f"before it: {ZERO_PARENT_HOST_READS}); {hr['spans']} span records "
        f"in process ({cli_spans:.1f} an iteration of the CLI run) and "
        f"{hr['writes']} registry writes; {per_span * 1e6:.2f} us a span, "
        f"{per_write * 1e6:.2f} us a write: {cost * 1e3:.3f} ms, "
        f"{share:.5%} of the timed iteration's {timed['wall']:.2f} s "
        f"(limit {OVERHEAD_LIMIT:.0%}); the counted iteration "
        f"{hr['wall']:.2f} s under the sync warnings, beside the CLI runs")
    return dict(hr, per_span=per_span, per_write=per_write, share=share)


def zero_card_vs_cpu(dev, paths, games):
    """The timed iteration's first games learned in float32 (TF32 off)
    on the card and on the CPU, counted as finished so the value and
    aux terms weigh in: both nets' updates within ``FORWARD_ATOL`` +
    ``FORWARD_RTOL``·|x|."""
    from rocalphago_tpu_torch.data.replay import ZeroGames
    from rocalphago_tpu_torch.engine import torchgo
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.training import zero
    from rocalphago_tpu_torch.training.actor import games_to_host

    host = games_to_host(games)
    k = ZERO_CPU_GAMES
    host = ZeroGames(host.actions[:, :k], host.live[:, :k],
                     host.visits[:, :k], host.winners[:k],
                     np.ones((k,), bool), host.full[:, :k],
                     host.ownership[:k], host.score[:k])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = []
    t0 = time.perf_counter()
    try:
        for device in (dev, torch.device("cpu")):
            pol, val = (NeuralNetBase.load_model(x, device=device,
                                                 dtype=torch.float32)
                        for x in paths)
            cfg = torchgo.GoConfig(size=SIZE,
                                   komi=torchgo.default_komi(SIZE))
            it = zero.ZeroIteration(
                cfg, pol.feature_list, val.feature_list, k, ZERO_MOVES,
                ZERO_SIMS, cap_p=ZERO_CAP_P, cap_cheap=ZERO_CAP_CHEAP,
                aux_weight=ZERO_AUX, device=device)
            state = zero.init_zero_state(pol.module, val.module, 0.1)
            old = [{n: v.detach().clone() for n, v in
                    m.state_dict().items()} for m in (pol.module, val.module)]
            state, m = it.learn(state, host)
            ups = {}
            for o, mod, tag in zip(old, (pol.module, val.module),
                                   ("policy", "value")):
                ups.update({f"{tag}.{n}": ((o[n] - v) / 0.1).cpu()
                            for n, v in mod.state_dict().items()})
            runs.append((ups, zero.metrics_to_host(m)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (card, card_m), (cpu, cpu_m) = runs
    rows = []
    for name in cpu:
        diff = (card[name] - cpu[name]).double()
        scale = float(cpu[name].abs().max())
        # an absolute floor of FORWARD_ATOL per entry: a gradient that is
        # 0 in exact arithmetic (the policy head's bias under the
        # shift-invariant softmax) is float32 noise on both sides
        floor = FORWARD_ATOL * cpu[name].numel() ** 0.5
        rows.append((float(diff.norm()) / (float(cpu[name].double().norm())
                                           + floor),
                     float(diff.abs().max()) / (scale + FORWARD_ATOL),
                     name, scale))
    rows.sort(reverse=True)
    moved = max(r[3] for r in rows)
    log("zero learn card vs CPU, worst tensors (relative L2, max over "
        "scale, scale): " + ", ".join(
            f"{n} {l2:.2e} {mx:.2e} {sc:.3e}" for l2, mx, n, sc in rows[:4])
        + "; metrics card " + json.dumps(card_m) + " cpu "
        + json.dumps(cpu_m))
    for l2, mx, name, scale in rows:
        # a gradient summed over every ply, held to its own scale: a
        # float32 rounding difference can flip a ReLU whose input is
        # near 0, which no summation-order bound covers
        check(l2 <= ZERO_GRAD_L2 and mx <= ZERO_GRAD_MAX,
              f"zero learn card vs CPU: {name} relative L2 error {l2:.3e},"
              f" largest error {mx:.3e} of its largest entry {scale:.3e}")
    check(moved > 1e-3 and all(abs(card_m[n] - cpu_m[n])
                               <= 1e-4 * (1 + abs(cpu_m[n])) for n in cpu_m),
          f"zero learn card vs CPU: metrics {card_m} vs {cpu_m}")
    log(f"zero learn, float32 (TF32 off), the timed iteration's first "
        f"{k} games ({ZERO_MOVES} plies, counted as finished): card vs CPU "
        f"updates of both nets within {ZERO_GRAD_L2:g} relative L2 and "
        f"{ZERO_GRAD_MAX:g} of each tensor's largest entry (worst "
        f"{rows[0][0]:.3e}, {max(r[1] for r in rows):.3e}; largest entry "
        f"{moved:.3e}), the metrics equal to 1e-4; "
        f"{time.perf_counter() - t0:.1f} s")


def zero_pool(dev, work: str, card: str):
    """The committed 9×9 pool of ``results/zero_r5/run``: its first and
    last incumbents loaded through ``ZeroGate.load`` and a raw match
    between them."""
    from rocalphago_tpu_torch.engine import torchgo
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.training import zero

    root = os.path.dirname(os.path.abspath(__file__))
    pool = os.path.join(root, ZERO_POOL, "pool")
    with open(os.path.join(root, ZERO_POOL, "value.json")) as f:
        spec = json.load(f)
    spec["weights_file"] = os.path.join(pool, "best.00000.value.msgpack")
    value_spec = os.path.join(work, "pool_value.json")
    with open(value_spec, "w") as f:
        json.dump(spec, f)
    policy = NeuralNetBase.load_model(os.path.join(
        pool, "best.00000.policy.json"))
    value = NeuralNetBase.load_model(value_spec)
    gate = zero.ZeroGate(torchgo.GoConfig(size=9, komi=7.0),
                         policy.feature_list, pool, games=ZERO_POOL_GAMES,
                         threshold=0.55, temperature=1.0,
                         move_limit=ZERO_POOL_MOVES, write=False, device=dev)
    snaps = gate.snapshots()
    first = gate.load(snaps[0], policy.module, value.module)
    last = gate.load(snaps[-1], policy.module, value.module)
    check(not all(torch.equal(first[0].state_dict()[k],
                              last[0].state_dict()[k])
                  for k in first[0].state_dict()),
          "the committed pool's first and last incumbents are equal")
    t0 = time.perf_counter()
    r = gate.match(last[0], first[0], zero.match_generator(SEED, 0, 0, dev))
    check(r["wins_a"] + r["wins_b"] + r["draws"] == ZERO_POOL_GAMES,
          f"pool match tally {r}")
    log(f"committed pool [{card}]: {len(snaps)} incumbents in "
        f"{ZERO_POOL}/pool; best.{snaps[-1][0]:05d} against "
        f"best.{snaps[0][0]:05d}, {ZERO_POOL_GAMES} raw games at 9x9, move "
        f"limit {ZERO_POOL_MOVES}: {r['wins_a']}-{r['wins_b']}-{r['draws']} "
        f"(win rate {r['win_rate_a']:.3f}), "
        f"{time.perf_counter() - t0:.1f} s")


def phase_zero(torchgo, dev, card, counters):
    """The AlphaZero loop (phase 18)."""
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, ZERO_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    paths = zero_specs(work)
    walls, hr, record = zero_cli(work, paths, card)
    t1 = time.perf_counter()
    out = zero_timed(torchgo, dev, card, counters, paths)
    out["instrumentation"] = zero_instrumentation(
        card, paths, out, os.path.join(work, "straight"), hr)
    t2 = time.perf_counter()
    zero_card_vs_cpu(dev, paths, out["games"])
    zero_pool(dev, work, card)
    out["phase_s"] = time.perf_counter() - t0
    out["cli_walls"] = walls
    out["paths"] = paths
    out["record"] = record
    log(f"zero phase: {out['phase_s']:.1f} s (specs, the four CLI runs and "
        f"the host-reads count "
        f"{t1 - t0:.1f} s, the timed iteration and its checks "
        f"{t2 - t1:.1f} s, card vs CPU and the pool "
        f"{time.perf_counter() - t2:.1f} s)")
    return out


# -------------------------------------------------------------- serving


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 2.0 ** -133


def serve_specs(work: str) -> dict:
    """Fresh seeded specs from the port's spec CLI: the 19×19 12 × 128
    policy (48 planes) and value net (49 planes), both with FCN heads,
    which serve every board of the multi-size pool too."""
    from rocalphago_tpu_torch.models import specs

    out = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, seed in (("policy19", 60), ("value19", 61)):
            out[name] = os.path.join(work, f"{name}.json")
            specs.main([name[:-2], "--board", "19", "--seed",
                        str(SEED + seed), "--out", out[name]])
    return out


def serve_launches(counters) -> dict:
    return {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}


def serve_positions(pygo, n: int, seed: int) -> list:
    """``n`` distinct 19×19 positions of 6 to 40 seeded random moves."""
    return random_positions(pygo, n, (6, 40), seed, size=SIZE)


def serve_fleet(pygo, pool, counters, card) -> dict:
    """``FleetDriver.genmove_all`` at every fleet size: moves/s,
    game-simulations/s, evaluator batches and occupancy, launches; one
    round at 8 sessions under ``set_sync_debug_mode("error")``; a
    profiled round at 64 sessions."""
    from rocalphago_tpu_torch.serve.sessions import ServePool, bridge_roots

    out = {}
    for n in SERVE_FLEETS:
        sessions = [pool.open_session(resilient=False) for _ in range(n)]
        try:
            drv = pool.driver(sessions)
            drv.warm()
            games = serve_positions(pygo, n, SEED + 70 + n)
            ev0 = pool.evaluator.stats()
            padded0 = pool.evaluator.padded_total
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            for _ in range(SERVE_GENMOVES):
                moves = drv.genmove_all(games)
                for st, mv in zip(games, moves):
                    check(mv is None or st.is_legal(mv),
                          f"fleet {n}: illegal {mv}")
                    st.do_move(mv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = serve_launches(counters)
            ev = pool.evaluator.stats()
            batches = ev["batches"] - ev0["batches"]
            rows = ev["rows"] - ev0["rows"]
            padded = pool.evaluator.padded_total - padded0
            check(drv.last_n_sim == SERVE_SIMS,
                  f"fleet {n} ran {drv.last_n_sim} simulations")
            check(batches == SERVE_GENMOVES * (SERVE_SIMS + 1),
                  f"fleet {n}: {batches} evaluator batches, expected one "
                  "a convoy")
            for name, k in launches.items():
                check(k > 0, f"fleet {n}: the {name} kernel was not "
                      "launched")
            row = dict(sessions=n, wall_s=wall,
                       moves_per_s=n * SERVE_GENMOVES / wall,
                       sims_per_s=n * SERVE_GENMOVES * SERVE_SIMS / wall,
                       round_ms=wall / SERVE_GENMOVES * 1e3,
                       batches=batches, occupancy=rows / padded,
                       launches=launches)
            out[n] = row
            log(f"serve fleet [{card}]: {n} sessions x {SERVE_GENMOVES} "
                f"genmoves at {SERVE_SIMS} simulations in {wall:.2f} s: "
                f"{row['moves_per_s']:.2f} moves/s, "
                f"{row['sims_per_s']:.1f} game-simulations/s (limit "
                f"{SERVE_SIMS_LIMIT:.0f}), a round {row['round_ms']:.1f} "
                f"ms, {batches} evaluator batches, mean occupancy "
                f"{row['occupancy']:.3f}, launches {launches}")
            if n == 8:
                roots = bridge_roots(pool.cfg, games, pool.device)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    tree = drv.run_round(roots)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                visits = pool.search.root_stats(tree)[0].cpu()
                check(bool((visits.sum(dim=1) == SERVE_SIMS).all()),
                      "the sync-free fleet round lost visits")
                log(f"serve fleet [{card}]: a round of 8 sessions at "
                    f"{SERVE_SIMS} simulations ran under "
                    "set_sync_debug_mode('error'): no host sync")
        finally:
            for s in sessions:
                s.close()
    # a profiled round at the largest fleet, cut to a few simulations
    short = ServePool(pool.value, pool.policy, n_sim=SERVE_PROFILE_SIMS,
                      searcher=pool.search)
    try:
        n = SERVE_FLEETS[-1]
        sessions = [short.open_session(resilient=False) for _ in range(n)]
        drv = short.driver(sessions)
        drv.warm()
        roots = bridge_roots(short.cfg, serve_positions(pygo, n, SEED + 79),
                             short.device)
        prof = profile_device(lambda: drv.run_round(roots), 1,
                              f"a fleet round of {n} sessions at "
                              f"{SERVE_PROFILE_SIMS} simulations", "round")
        if prof is not None:
            convoys = SERVE_PROFILE_SIMS + 1
            prof["per_sim"] = {k: prof[k] / convoys
                               for k in ("launches", "busy_ms", "wall_ms")}
            log(f"serve fleet [{card}]: per convoy of {n} rows "
                f"{prof['per_sim']['launches']:.0f} kernels, "
                f"{prof['per_sim']['wall_ms']:.2f} ms host, "
                f"{prof['per_sim']['busy_ms']:.3f} ms device busy (idle "
                f"share {prof['idle']:.3f})")
        out["profile"] = prof
    finally:
        short.close()
    return out


def serve_threaded(pygo, pool, counters, card) -> dict:
    """``SERVE_THREADS`` sessions through the ladder, each in its own
    thread, ``SERVE_THREAD_GENMOVES`` genmoves each: genmove p50 and p99
    against the 5 s limit, launches per genmove."""
    sessions = [pool.open_session() for _ in range(SERVE_THREADS)]
    games = serve_positions(pygo, SERVE_THREADS, SEED + 80)
    lat, errors = [], []

    def play(sess, game):
        try:
            for _ in range(SERVE_THREAD_GENMOVES):
                t0 = time.perf_counter()
                mv = sess.get_move(game)
                lat.append(time.perf_counter() - t0)
                check(mv is None or game.is_legal(mv), f"illegal {mv}")
                game.do_move(mv)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    ev0 = pool.evaluator.stats()
    padded0 = pool.evaluator.padded_total
    try:
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=play, args=(s, g))
                   for s, g in zip(sessions, games)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = serve_launches(counters)
        check(not errors, f"threaded sessions raised: {errors!r}")
        check(all(not t.is_alive() for t in threads),
              "a threaded session did not finish")
        for s in sessions:
            check(s.player.served["search"] == SERVE_THREAD_GENMOVES
                  and s.raw.last_n_sim == SERVE_SIMS,
                  f"a threaded session degraded: {s.player.stats()}")
    finally:
        for s in sessions:
            s.close()
    ev = pool.evaluator.stats()
    rows = ev["rows"] - ev0["rows"]
    batches = ev["batches"] - ev0["batches"]
    occupancy = rows / (pool.evaluator.padded_total - padded0)
    lat.sort()
    from rocalphago_tpu_torch.interface.resilient import percentile

    p50, p99 = percentile(lat, 0.5), percentile(lat, 0.99)
    genmoves = SERVE_THREADS * SERVE_THREAD_GENMOVES
    per_genmove = {k: v / genmoves for k, v in launches.items()}
    log(f"serve threaded [{card}]: {SERVE_THREADS} sessions x "
        f"{SERVE_THREAD_GENMOVES} genmoves at {SERVE_SIMS} simulations "
        f"through the ladder in {wall:.2f} s: genmove p50 {p50:.3f} s, p99 "
        f"{p99:.3f} s (limit {SERVE_GENMOVE_LIMIT_S:.0f} s), "
        f"{genmoves / wall:.3f} moves/s, "
        f"{genmoves * SERVE_SIMS / wall:.1f} game-simulations/s, "
        f"{batches} evaluator batches ({rows / batches:.2f} rows each, "
        f"occupancy {occupancy:.3f}); launches {launches} "
        f"({per_genmove} a genmove)")
    return dict(p50=p50, p99=p99, wall=wall, launches=launches,
                per_genmove=per_genmove, batches=batches,
                occupancy=occupancy, rows_per_batch=rows / batches,
                sims_per_s=genmoves * SERVE_SIMS / wall)


def serve_slo(pygo, pool, card) -> dict:
    """One session under ``slo_s=SERVE_SLO_S`` with more simulations
    than fit: the genmove comes back with the anytime answer, before
    the SLO plus about one simulation."""
    from rocalphago_tpu_torch.serve.sessions import ServePool

    slo = ServePool(pool.value, pool.policy, n_sim=SERVE_SLO_SIMS,
                    slo_s=SERVE_SLO_S)
    try:
        slo.warm()
        sess = slo.open_session()
        st = serve_positions(pygo, 1, SEED + 85)[0]
        t0 = time.perf_counter()
        mv = sess.get_move(st)
        took = time.perf_counter() - t0
        ran = sess.raw.last_n_sim
        per_sim = took / ran
        check(mv is not None and st.is_legal(mv), f"SLO move {mv}")
        check(sess.raw.last_deadline_hit and 0 < ran < SERVE_SLO_SIMS,
              f"the SLO run ran {ran} simulations")
        check(sess.player.last_rung == "search",
              f"the SLO run served from {sess.player.last_rung}")
        # the deadline is checked between simulations: the overshoot is
        # one simulation, and the root bridge and evaluation before the
        # first (about one more)
        check(took <= SERVE_SLO_S + 2 * per_sim,
              f"the SLO genmove took {took:.3f} s, {ran} simulations of "
              f"{per_sim * 1e3:.1f} ms")
        sess.close()
    finally:
        slo.close()
    log(f"serve SLO [{card}]: slo_s {SERVE_SLO_S}: an anytime answer after "
        f"{took:.3f} s, {ran} of {SERVE_SLO_SIMS} simulations "
        f"({per_sim * 1e3:.2f} ms each)")
    return dict(took=took, ran=ran)


def serve_equalities(pygo, torchgo, pool, card):
    """A one-session pooled genmove equals a standalone
    ``DeviceMCTSPlayer``'s root visits bit for bit (both evaluate at
    batch 1); ``eval_batch_komi`` at the default komi is ``eval_batch``
    bit for bit and a custom komi flips a passed-out row's sign; with an
    ``EvalCache`` a hit is the uncached output exactly and in-batch
    duplicates fan out."""
    from rocalphago_tpu_torch.search import device_mcts
    from rocalphago_tpu_torch.serve import BatchingEvaluator
    from rocalphago_tpu_torch.serve.evalcache import EvalCache
    from rocalphago_tpu_torch.serve.evaluator import cat_states, pad_rows

    seen = []
    orig = device_mcts.DeviceMCTS.root_stats

    def rec(tree):
        out = orig(tree)
        seen.append(out[0].cpu().clone())
        return out

    device_mcts.DeviceMCTS.root_stats = staticmethod(rec)
    try:
        st = serve_positions(pygo, 1, SEED + 86)[0]
        alone = device_mcts.DeviceMCTSPlayer(pool.value, pool.policy,
                                             n_sim=SERVE_SIMS)
        want = alone.get_move(st)
        sess = pool.open_session(resilient=False)
        got = sess.get_move(st)
        sess.close()
    finally:
        device_mcts.DeviceMCTS.root_stats = staticmethod(orig)
    check(got == want and torch.equal(seen[-1], seen[-2]),
          f"pooled {got} / standalone {want}: root visits differ by "
          f"{int((seen[-1] - seen[-2]).abs().sum())}")
    # komi
    search, cfg = pool.search, pool.cfg
    passed = pygo.GameState(size=SIZE)
    passed.do_move(None)
    passed.do_move(None)
    states = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, [pygo.GameState(size=SIZE), passed], device=pool.device,
        with_labels=False))
    p0, v0 = search.eval_batch(states)
    p1, v1 = search.eval_batch_komi(
        states, torch.full((2,), cfg.komi, device=pool.device))
    check(torch.equal(p0, p1) and torch.equal(v0, v1),
          "eval_batch_komi at the default komi differs from eval_batch")
    _, v2 = search.eval_batch_komi(
        states, torch.tensor([cfg.komi, -25.0], device=pool.device))
    check(float(v2[1]) == -float(v0[1]) != 0.0 and float(v2[0]) ==
          float(v0[0]), f"komi -25 gave {v2.tolist()} against {v0.tolist()}")
    # padding: at a fixed padded size the pad rows are ignored bit for
    # bit; across sizes cuDNN may pick another algorithm per shape, so a
    # row at size 8 is held to size 1 within SIZE_ULPS bf16 ulps of the
    # largest output (on an H100 the two agree bit for bit; PERF.md §6)
    many = torchgo.seed_labels(cfg, torchgo.from_pygo(
        cfg, serve_positions(pygo, 8, SEED + 87), device=pool.device,
        with_labels=False))
    real = torchgo.GoState(*(x[:3] for x in many))
    pa = pool.evaluator.eval_direct(pad_rows(real, 8))
    pb = pool.evaluator.eval_direct(cat_states(
        [real, torchgo.GoState(*(x[3:] for x in many))]))
    check(torch.equal(pa[0][:3], pb[0][:3]) and torch.equal(pa[1][:3],
                                                              pb[1][:3]),
          "padded rows changed the real rows at a fixed padded size")
    p8, v8 = pool.evaluator.eval_direct(many)
    alone = [pool.evaluator.eval_direct(
        torchgo.GoState(*(x[i:i + 1] for x in many))) for i in range(8)]
    p1 = torch.cat([a[0] for a in alone])
    v1 = torch.cat([a[1] for a in alone])
    size_err = (float((p8 - p1).abs().max()), float((v8 - v1).abs().max()))
    size_lim = tuple(SIZE_ULPS * bf16_ulp(float(x.abs().max()))
                     for x in (p1, v1))
    argmax_same = int((p8.argmax(dim=1) == p1.argmax(dim=1)).sum())
    check(torch.isfinite(p8).all() and size_err[0] <= size_lim[0]
          and size_err[1] <= size_lim[1],
          f"size 8 vs size 1: {size_err} over the limits {size_lim}")
    log(f"serve padding [{card}]: pad rows ignored bit for bit at size 8; "
        f"8 rows at size 8 vs alone at size 1 (bf16): priors max |diff| "
        f"{size_err[0]:.3e} (limit {size_lim[0]:.3e}), values "
        f"{size_err[1]:.3e} (limit {size_lim[1]:.3e}), argmax equal on "
        f"{argmax_same} of 8")
    # the cache
    ev = BatchingEvaluator(search.eval_with, *pool.evaluator.version_params(),
                           batch_sizes=(1, 4), cache=EvalCache(capacity=64),
                           key_fn=search.eval_key, board=SIZE, start=False,
                           eval_komi_fn=search.eval_with,
                           default_komi=cfg.komi)
    try:
        one = torchgo.GoState(*(x[:1] for x in states))
        other = torchgo.GoState(*(x[1:] for x in states))
        want_p, want_v = ev.eval_direct(one)
        outs = []
        for _ in range(2):                       # a miss, then a hit
            req = ev.submit(one)
            ev.drain_once()
            outs.append(req.result(timeout=60))
        check(all(torch.equal(p, want_p) and torch.equal(v, want_v)
                  for p, v in outs) and ev.cache.stats()["hits"] == 1,
              f"a cache hit differs from the uncached row "
              f"({ev.cache.stats()})")
        ev.cache.clear()
        up, uv = ev.eval_direct(pad_rows(cat_states([one, other]), 4))
        reqs = [ev.submit(x) for x in (one, one, other, one)]
        ev.drain_once()
        res = [r.result(timeout=60) for r in reqs]
        check(ev.dedup_rows_saved_total == 2 and all(
            torch.equal(p, up[j:j + 1]) and torch.equal(v, uv[j:j + 1])
            for (p, v), j in zip(res, (0, 0, 1, 0))),
              "in-batch dedup did not fan out the unique rows")
    finally:
        ev.close()
    log(f"serve equalities [{card}]: pooled genmove {got} = standalone, "
        f"root visits bit-equal ({int(seen[-1].sum())} visits); "
        f"eval_batch_komi at komi {cfg.komi} = eval_batch bit for bit, "
        f"komi -25 flips the passed-out row ({float(v0[1])} -> "
        f"{float(v2[1])}); cache hit and dedup fan-out bit-exact")


def serve_ladder(pygo, pool, card) -> dict:
    """Every rung of the ladder on the card, through a GTP engine on a
    pooled session: a fault plan on ``serve.search`` (the policy rung),
    a real ``torch.cuda.OutOfMemoryError`` inside the search (the reduced
    rung), a hang past ``hang_timeout_s`` (abandoned: the policy rung),
    and the search and policy rungs failing (the fallback rung). Every
    answer legal; ``rocalphago-stats`` counts each rung. A sticky CUDA
    error is raised in a child process, and both errors' types are
    classified as ``is_transient`` says."""
    from rocalphago_tpu_torch.interface.gtp import GTPEngine, vertex_to_move
    from rocalphago_tpu_torch.runtime import faults
    from rocalphago_tpu_torch.runtime.retries import is_transient

    sess = pool.open_session()
    raw = sess.raw.get_move
    oom = {}

    def raising(state):
        if not oom:
            try:
                torch.empty(1 << 46, dtype=torch.uint8, device=pool.device)
            except BaseException as e:  # noqa: BLE001 -- recorded
                oom["type"] = type(e).__qualname__
                oom["transient"] = is_transient(e)
                raise
        return raw(state)

    engine = GTPEngine(sess.player, serve_pool=pool, serve_session=sess)
    for cmd in (f"boardsize {SIZE}", "clear_board", "play b C3",
                "play w G7"):
        check(engine.handle(cmd)[0].startswith("="), cmd)
    steps = (("policy", "error@serve.search", None),
             ("reduced", None, raising),
             ("policy", f"sleep@serve.search={3 * SERVE_HANG_S}", None),
             ("fallback", "error@serve.search,error@serve.policy", None),
             ("search", None, None))
    rungs, hang_t = [], None
    try:
        for want, plan, wrap in steps:
            hang = bool(plan) and plan.startswith("sleep")
            # only the hang step is watched: a whole search may take
            # longer than the hang timeout
            sess.player.hang_timeout_s = SERVE_HANG_S if hang else None
            faults.install(plan)
            sess.raw.get_move = wrap or raw
            before = engine.state.copy()
            t0 = time.perf_counter()
            reply = engine.handle("genmove " + "bw"[before.current_player
                                                   == pygo.WHITE])[0]
            took = time.perf_counter() - t0
            faults.install(None)
            check(reply.startswith("= "), f"{want} rung: {reply!r}")
            mv = vertex_to_move(reply[2:].strip(), SIZE)
            check(mv is None or before.is_legal(mv),
                  f"{want} rung: illegal {mv}")
            rungs.append((sess.player.last_rung,
                          sess.player.last_fallback, sess.raw.last_n_sim))
            check(sess.player.last_rung == want,
                  f"expected the {want} rung, got {rungs[-1]}")
            if hang:
                hang_t = took
                # the abandoned search runs on to its end: wait for it
                # before the next step
                join_abandoned()
    finally:
        faults.install(None)
        sess.raw.get_move = raw
        sess.player.hang_timeout_s = None
    check(oom.get("type") == "OutOfMemoryError" and oom["transient"],
          f"the card's out-of-memory error: {oom}")
    check(rungs[1][2] == SERVE_SIMS // 4,
          f"the reduced rung ran {rungs[1][2]} simulations")
    stats = json.loads(engine.handle("rocalphago-stats")[0][2:])
    served = stats["ladder"]["degradations"]
    counters = stats["registry"]["counters"]
    check(served == {"reduced": 1, "policy": 2, "fallback": 1}
          and stats["ladder"]["reasons"] == {
              "error": 3, "transient_error": 1, "hang": 1}
          and all(counters.get(f'serve_rung_total{{rung="{r}"}}', 0) >= 1
                  for r in ("search", "reduced", "policy", "fallback")),
          f"rocalphago-stats: {stats['ladder']}")
    sess.close()
    code = ("import json, torch\n"
            "from rocalphago_tpu_torch.runtime.retries import is_transient\n"
            "x = torch.zeros(4, device='cuda')\n"
            "i = torch.tensor([1 << 20], device='cuda')\n"
            "try:\n"
            "    x[i] = 1.0\n"
            "    torch.cuda.synchronize()\n"
            "except BaseException as e:\n"
            "    print(json.dumps({'type': type(e).__qualname__,\n"
            "        'mro': [c.__name__ for c in type(e).__mro__],\n"
            "        'message': str(e)[:120],\n"
            "        'transient': is_transient(e)}))\n")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = child_run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(lines, f"no sticky CUDA error was raised: {proc.stderr[-1000:]}")
    sticky = json.loads(lines[-1])
    check(sticky["transient"] is False
          and sticky["message"].startswith("CUDA error:"),
          f"the sticky CUDA error: {sticky}")
    log(f"serve ladder [{card}]: rungs {[r[0] for r in rungs]} (the hang "
        f"abandoned after {hang_t:.2f} s at hang_timeout_s "
        f"{SERVE_HANG_S}), every answer legal; rocalphago-stats "
        f"{stats['ladder']['degradations']}, reasons "
        f"{stats['ladder']['reasons']}; the card's errors: out of memory "
        f"{oom}, sticky {sticky}")
    return dict(oom=oom, sticky=sticky, rungs=rungs)


def join_abandoned() -> None:
    """Wait for the search threads the ladder abandoned as hung."""
    for t in threading.enumerate():
        if t.name.startswith("genmove-"):
            t.join(timeout=300)


def serve_gtp_start(work: str) -> list:
    """Start the GTP entry as a user runs it, two subprocesses over
    stdin scripts: ``--serve`` on the committed 9×9 gumbel nets
    (genmove, komi, both probes), and ``--serve-sizes 9,13,19`` on fresh
    19×19 12 × 128 FCN specs (:func:`serve_specs`, written to ``work``),
    re-routed by ``boardsize 13``; ``[(run, the started child)]`` for
    :func:`serve_gtp_check`."""
    root = os.path.dirname(os.path.abspath(__file__))
    paths = serve_specs(work)
    runs = (
        ("serve", ["--serve", "--policy",
                   os.path.join(root, GUMBEL_DIR, "policy.json"), "--value",
                   os.path.join(root, GUMBEL_DIR, "value.json")],
         ["boardsize 9", "clear_board", "genmove b", "komi 6.5",
          "genmove w", "rocalphago-health", "rocalphago-stats", "quit"], 9),
        ("serve-sizes", ["--serve-sizes", "9,13,19", "--policy",
                         paths["policy19"], "--value", paths["value19"]],
         ["boardsize 13", "komi 6.5", "genmove b", "genmove w",
          "rocalphago-health", "rocalphago-stats", "quit"], 13))
    out = []
    for name, argv, script, size in runs:
        out.append(((work, name, script, size), bg_start(
            [sys.executable, "-m", "rocalphago_tpu_torch.interface.gtp",
             *argv, "--metrics", os.path.join(work, f"{name}.jsonl")],
            os.path.join(work, f"{name}_run"),
            stdin="\n".join(script) + "\n")))
    return out


def serve_gtp_check(card, work, name, script, size, started) -> float:
    """Wait for one of :func:`serve_gtp_start`'s GTP runs and check its
    replies, probes and metrics file (every genmove served by the
    search rung); its wall."""
    metrics = os.path.join(work, f"{name}.jsonl")
    rc, stdout, stderr, wall = bg_wait(started)
    check(rc == 0, f"gtp {name} exited {rc}: {stderr[-2000:]}")
    replies = [r for r in stdout.split("\n\n") if r.strip()]
    check(len(replies) == len(script) and all(
        r.startswith("=") for r in replies),
          f"gtp {name}: {replies}")
    for cmd, reply in zip(script, replies):
        if cmd.startswith("genmove"):
            from rocalphago_tpu_torch.interface.gtp import vertex_to_move

            check(vertex_to_move(reply[1:].strip(), size) is not None,
                  f"gtp {name}: {cmd} -> {reply!r}")
    health = json.loads(replies[script.index("rocalphago-health")][2:])
    stats = json.loads(replies[script.index("rocalphago-stats")][2:])
    check(health["status"] == "ok" and health["genmoves"] == 2
          and stats["game"]["size"] == size
          and stats["game"]["komi"] == 6.5,
          f"gtp {name}: health {health}, game {stats['game']}")
    check(stats["ladder"]["degraded_total"] == 0
          and not stats["ladder"]["rung_failures"]["search"],
          f"gtp {name}: a genmove degraded: {stats['ladder']}")
    serve = health["serve"]
    if name == "serve-sizes":
        check(serve["multisize"] and set(serve["boards"]) ==
              {"9", "13", "19"} and serve["boards"]["13"]["sessions"][
                  "live"] == 1 and serve["boards"]["9"]["sessions"][
                      "live"] == 0,
              f"gtp {name}: the session was not re-routed: {serve}")
    else:
        check(serve["evaluator"]["komi_batches"] >= 1,
              f"gtp {name}: komi did not reach the session: {serve}")
    with open(metrics) as f:
        last = json.loads(f.read().strip().splitlines()[-1])
    check(last["event"] == "registry",
          f"gtp {name}: the metrics file ends with {last['event']}")
    log(f"gtp {name} [{card}]: exit 0 in {wall:.1f} s with start-up, "
        f"beside phase 13's other CLI runs; replies "
        f"{[r[:12] for r in replies if not r.startswith('= {')]}"
        f"; health status {health['status']}, latency "
        f"{health['latency_s']}")
    return wall


def phase_serve(pygo, torchgo, dev, card, counters) -> dict:
    """Serving (phase 19)."""
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.serve.sessions import ServePool

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, SERVE_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    paths = serve_specs(work)
    policy = NeuralNetBase.load_model(paths["policy19"])
    value = NeuralNetBase.load_model(paths["value19"])
    check(policy.module.dtype == value.module.dtype == torch.bfloat16
          and policy.size_generic() and value.size_generic()
          and policy.spec_kwargs["layers"] == 12
          and policy.preprocess.output_dim == 48,
          "serve specs: not the 12 x 128 bf16 FCN nets of 48 / 49 planes")
    pool = ServePool(value, policy, n_sim=SERVE_SIMS)
    try:
        t1 = time.perf_counter()
        pool.warm()
        warm_s = time.perf_counter() - t1
        log(f"serve pool [{card}]: warm {warm_s:.2f} s (one evaluation at "
            f"each size of {pool.evaluator.batch_sizes} and a session's "
            "path)")
        out = dict(fleet=serve_fleet(pygo, pool, counters, card))
        out["threaded"] = serve_threaded(pygo, pool, counters, card)
        out["slo"] = serve_slo(pygo, pool, card)
        serve_equalities(pygo, torchgo, pool, card)
        out["ladder"] = serve_ladder(pygo, pool, card)
    finally:
        join_abandoned()
        pool.close()
    out["paths"] = paths
    out["launches"] = {
        k: sum(out["fleet"][n]["launches"][k] for n in SERVE_FLEETS)
        + out["threaded"]["launches"][k]
        for k in out["threaded"]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"serve phase: {out['phase_s']:.1f} s")
    return out


def labels_sweeps(boards: torch.Tensor) -> int:
    """Sweeps the hook-and-jump fill needs on these boards (the same
    iteration the kernel runs, counted on the plain version's loop)."""
    from rocalphago_tpu_torch.engine.torchgo import neighbors_for, pad_points

    n = boards.shape[1]
    nbrs = neighbors_for(SIZE, boards.device)
    stone = boards != 0
    links = ((pad_points(boards, 0)[:, nbrs] == boards[:, :, None])
             & stone[:, :, None] & (nbrs < n))
    lab = torch.where(stone, torch.arange(n, device=boards.device), n)
    for sweep in range(1, n + 1):
        hook = torch.where(links, pad_points(lab, n)[:, nbrs], n)
        new = torch.minimum(lab, hook.min(dim=2).values)
        new = torch.minimum(new, pad_points(new, n).gather(1, new))
        if torch.equal(new, lab):
            return sweep
        lab = new
    return n


def incr_games(pygo):
    """Phase 20's seeded 19×19 games: the host state after every ply of
    ``INCR_GAMES`` games of ``INCR_PLIES`` random sensible moves, the
    first from a ladder board and the others from the empty board, a
    pass every ``INCR_PASS_EVERY`` plies."""
    rng = np.random.default_rng(SEED + 90)
    games = []
    for g in range(INCR_GAMES):
        st = (ladder_positions(pygo, 1, SEED + 91, SIZE)[0] if g == 0
              else pygo.GameState(size=SIZE, komi=7.5))
        seq = []
        for i in range(INCR_PLIES):
            if st.is_end_of_game:
                break
            moves = st.get_legal_moves(include_eyes=False)
            st.do_move(None if (i % INCR_PASS_EVERY == INCR_PASS_EVERY - 1
                                or not moves)
                       else moves[rng.integers(len(moves))])
            seq.append(st.copy())
        games.append(seq)
    return games


def incr_trajectories(torchgo, dev, card, games):
    """The games through one carried cache on the card (against the
    card's scratch encode) and on the CPU (against the card's planes and
    carry); the chase kernel on every lane the card's encodes launched.
    Returns the card's final stats (int ``[9]``)."""
    from rocalphago_tpu_torch.features import incremental as I
    from rocalphago_tpu_torch.features.planes import encode
    from rocalphago_tpu_torch.ops import chase as C

    cfg = torchgo.GoConfig(size=SIZE)
    card_c = I.init_cache(cfg, device=dev)
    cpu_c = I.init_cache(cfg)
    plies, lanes = 0, []
    with torch.no_grad():
        for g, seq in enumerate(games):
            for i, st in enumerate(seq):
                tc = torchgo.from_pygo(cfg, [st], device="cpu")
                tg = torchgo.GoState(*(x.to(dev) for x in tc))
                with LaneRecorder(C) as rec:
                    got, card_c = I.encode_step(cfg, tg, card_c)
                lanes += rec.lanes
                check(torch.equal(got, encode(cfg, tg)),
                      f"incremental encode on the card differs from the "
                      f"scratch encode: game {g}, ply {i}")
                want, cpu_c = I.encode_step(cfg, tc, cpu_c)
                check(torch.equal(got.cpu(), want),
                      f"incremental planes card vs CPU: game {g}, ply {i}")
                for name, a, b in zip(I.EncodeCache._fields, card_c, cpu_c):
                    check(torch.equal(a.cpu(), b),
                          f"incremental carry card vs CPU: {name}, game "
                          f"{g}, ply {i}")
                plies += 1
    stats = card_c.stats[0].cpu().numpy()
    log(f"incremental encode [{card}]: {plies} plies of {len(games)} {SIZE}x{SIZE} "
        "games through one cache (two jumps between games): card = scratch "
        "= CPU, planes and every cache field, at every ply; stats "
        + ", ".join(f"{k} {int(v)}" for k, v in zip(I.STAT_FIELDS, stats)))
    check(stats[I.STAT_CHASES] > 0 and stats[I.STAT_REUSED] > 0,
          f"the trajectories neither chased nor reused: {stats}")
    check(len(lanes) == plies, f"{len(lanes)} chase launches on the card "
          f"for {plies} incremental encodes")
    boards = torch.cat([b for b, _, _ in lanes])
    labels = torch.cat([lab for _, lab, _ in lanes])
    prey = torch.cat([p for _, _, p in lanes])
    want_c = check_chase(C, boards, labels, prey, SIZE,
                         f"incremental {len(prey)} lanes")
    log(f"incremental chase lanes [{card}]: {len(prey)} lanes "
        f"({int((prey >= 0).sum())} live, {int(want_c.sum())} captured, "
        f"{int((prey < 0).sum())} disabled), one launch an encode: "
        "verdicts and cores bit-exact")
    return stats


def incr_encode_timings(torchgo, dev, card, seq):
    """A warm root encode, scratch and incremental in turns over
    ``INCR_TIMED_PLIES`` plies of one game (batch 1): median µs by CUDA
    events and by the host's clock (synchronised), and kernels an encode
    from the profiler."""
    from rocalphago_tpu_torch.features import incremental as I
    from rocalphago_tpu_torch.features.planes import encode

    cfg = torchgo.GoConfig(size=SIZE)
    states = [torchgo.from_pygo(cfg, [st], device=dev)
              for st in seq[:INCR_TIMED_PLIES]]
    cache = I.init_cache(cfg, device=dev)
    times = {"scratch": ([], []), "incremental": ([], [])}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        for i, st in enumerate(states):
            for mode in ("scratch", "incremental"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                if mode == "scratch":
                    encode(cfg, st)
                else:
                    _, cache = I.encode_step(cfg, st, cache)
                end.record()
                torch.cuda.synchronize()
                if i >= 5:             # warm: the cache holds lanes
                    times[mode][0].append(start.elapsed_time(end) * 1e3)
                    times[mode][1].append((time.perf_counter() - t0) * 1e6)
    out = {m: (float(np.median(ev)), float(np.median(wall)))
           for m, (ev, wall) in times.items()}
    holder = {"scratch": [0], "incremental": [0, cache]}

    def walk(mode):
        def one():
            h = holder[mode]
            st = states[h[0] % len(states)]
            h[0] += 1
            with torch.no_grad():
                if mode == "scratch":
                    encode(cfg, st)
                else:
                    _, h[1] = I.encode_step(cfg, st, h[1])
        return one

    kernels = {m: profile_device(walk(m), 10, f"a {m} root encode",
                                 "encode") for m in out}
    log(f"root encode at {SIZE}x{SIZE}, batch 1, warm [{card}]: " + "; ".join(
        f"{m} {ev:.1f} us by events, {wall:.1f} us wall, "
        f"{(kernels[m] or {}).get('launches', float('nan')):.0f} kernels"
        for m, (ev, wall) in out.items()))
    return out, kernels


def incr_gtp_session(player, counters, script, cmds):
    """One scripted GTP session (``cmds``, its commands): ``(replies,
    each genmove's seconds, launches, registry counter deltas)``."""
    from rocalphago_tpu_torch.interface.gtp import run_gtp
    from rocalphago_tpu_torch.obs import registry

    before = registry.snapshot()["counters"]
    for c in counters:
        c.launches = 0
    instream, out = Timed(script), io.StringIO()
    engine = run_gtp(player, instream, out)
    torch.cuda.synchronize()
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    undegraded(engine)
    check(engine.illegal_from_player == 0,
          f"illegal_from_player = {engine.illegal_from_player}")
    after = registry.snapshot()["counters"]
    deltas = {k: v - before.get(k, 0) for k, v in after.items()
              if v != before.get(k, 0)}
    st = instream.stamps
    lat = [st[i + 1] - st[i] for i, cmd in enumerate(cmds)
           if cmd.startswith("genmove")]
    return ([r for r in out.getvalue().split("\n\n") if r.strip()], lat,
            launches, deltas)


def incr_main_path(pygo, card, counters, specs):
    """The device-search GTP session with the incremental root encode and
    without it, and a Gumbel genmove with its caches."""
    from rocalphago_tpu_torch.interface.gtp import (
        move_to_vertex,
        vertex_to_move,
    )
    from rocalphago_tpu_torch.search.device_mcts import DeviceMCTSPlayer
    from rocalphago_tpu_torch.search.players import build_player

    base = build_player("device-mcts", specs[0], value_path=specs[1])
    board = ladder_positions(pygo, 1, SEED + 92, SIZE)[0]
    plays = [f"play {'b' if board.board[x, y] == 1 else 'w'} "
             f"{move_to_vertex((int(x), int(y)), SIZE)}"
             for x, y in zip(*np.nonzero(board.board))]
    setup = [f"boardsize {SIZE}", "clear_board", "komi 7.5"] + plays
    genmoves = [f"genmove {'bw'[i % 2]}" for i in range(INCR_GENMOVES)]
    tail = ["clear_board", "genmove b", f"boardsize {SIZE}", "genmove w"]
    cmds = setup + genmoves + tail
    script = "\n".join(cmds + ["quit"]) + "\n"
    runs = {}
    for flag in (True, False):
        player = DeviceMCTSPlayer(base.value, base.policy, n_sim=base.n_sim,
                                  incremental=flag)
        runs[flag] = incr_gtp_session(player, counters, script, cmds)
    replies, _, launches, deltas = runs[True]
    check(len(replies) == len(cmds) + 1,
          f"{len(replies)} replies to {len(cmds) + 1} commands")
    for cmd, reply in zip(cmds, replies):
        check(reply.startswith("="), f"{cmd!r} -> {reply!r}")
        if cmd.startswith("genmove"):
            check(vertex_to_move(reply[1:].strip(), SIZE) is not None,
                  f"genmove passed: {reply!r}")
    check(replies == runs[False][0],
          "the device-search session with the incremental root encode "
          "moved otherwise than without it")
    for name, n in launches.items():
        check(n > 0, f"the {name} kernel was not launched by the "
              "incremental device-search session")
    for key in ("encode_delta_total",
                'encode_cache_resets_total{reason="clear_board"}',
                'encode_cache_resets_total{reason="boardsize"}'):
        check(deltas.get(key, 0) > 0, f"{key} did not move: {deltas}")
    check(any(k.startswith("encode_incr_") for k in deltas),
          f"no encode_incr_*_total moved: {deltas}")
    check(not any(k.startswith("encode_") for k in runs[False][3]),
          f"the session without the cache counted {runs[False][3]}")
    p50 = {flag: sorted(r[1])[len(r[1]) // 2] * 1e3
           for flag, r in runs.items()}
    spread = {flag: (min(r[1]) * 1e3, max(r[1]) * 1e3)
              for flag, r in runs.items()}
    log(f"incremental device-search gtp [{card}]: {INCR_GENMOVES} genmoves "
        f"at {base.n_sim} simulations on a ladder board, clear_board, a "
        f"genmove, boardsize {SIZE}, a genmove: every reply legal and equal "
        "to the session without the cache; "
        f"launches {launches}; registry "
        + ", ".join(f"{k} +{v}" for k, v in sorted(deltas.items())
                    if k.startswith("encode_"))
        + f"; genmove p50 (of {len(runs[True][1])}) with the cache "
        f"{p50[True]:.1f} ms "
        f"({spread[True][0]:.1f}-{spread[True][1]:.1f}), without "
        f"{p50[False]:.1f} ms ({spread[False][0]:.1f}-{spread[False][1]:.1f})")

    gumbel = DeviceMCTSPlayer(base.value, base.policy, n_sim=base.n_sim,
                              gumbel=True, incremental=True)
    move = gumbel.get_move(board)
    check(move is not None and board.is_legal(move),
          f"the Gumbel genmove with caches answered {move}")
    check(gumbel._enc_cache is not None
          and int(gumbel._enc_cache.stats[0, 0]) == 1,
          "the Gumbel genmove did not encode its root through the cache")
    log(f"gumbel-mcts genmove with caches= [{card}]: {move}, "
        f"{gumbel.last_n_sim} simulations")
    return dict(launches=launches, p50=p50, spread=spread,
                times={flag: r[1] for flag, r in runs.items()})


def incr_selfplay(torchgo, dev, card, counters):
    """Policy self-play at phase 11's shape with the encode cache and
    without it: a segment with the cache under
    ``set_sync_debug_mode("error")``, then ``INCR_SP_RUNS`` timed runs
    of each mode in turns from one seed (the same actions each time)."""
    from rocalphago_tpu_torch.features import DEFAULT_FEATURES
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.runtime.pipeline import ChunkPipeline
    from rocalphago_tpu_torch.search import selfplay as S

    cfg = torchgo.GoConfig(size=SIZE)
    nets = [CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                      seed=SEED + 20 + i, device=dev) for i in range(2)]
    args = (cfg, DEFAULT_FEATURES, nets[0].module, nets[1].module, SP_BATCH)
    gen = torch.Generator(device=dev)
    warm = S.make_selfplay_chunked(*args, max_moves=SP_CHUNK, chunk=SP_CHUNK,
                                   device=dev, incremental=True)
    states = warm(gen.manual_seed(SEED)).final
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(SP_CHUNK, 2 * SP_CHUNK):
            states, _, _ = warm.ply(states, gen, t)
    except RuntimeError as e:
        raise SmokeFailure(f"a host sync inside an incremental self-play "
                           f"segment: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    runners = {flag: S.make_selfplay_chunked(
        *args, max_moves=SP_MAX_MOVES, chunk=SP_CHUNK, device=dev,
        incremental=flag) for flag in (True, False)}
    rates = {True: [], False: []}
    launches = {c.__name__.rsplit(".", 1)[-1]: 0 for c in counters}
    plies_on, actions = 0, None
    for flag in [False, True, True, False] * INCR_SP_RUNS:
        if len(rates[flag]) == INCR_SP_RUNS:
            continue
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        res = runners[flag](gen.manual_seed(SEED + 1), stop_when_done=True,
                            pipeline=ChunkPipeline(dev))
        torch.cuda.synchronize()
        rates[flag].append(SP_BATCH * 60.0 / (time.perf_counter() - t0))
        if flag:
            for c in counters:
                launches[c.__name__.rsplit(".", 1)[-1]] += c.launches
            plies_on += int(res.live.any(dim=1).sum())
        if actions is None:
            actions = res.actions
        check(torch.equal(res.actions, actions),
              f"self-play with incremental={flag} played other actions")
    per_ply = {k: v / max(plies_on, 1) for k, v in launches.items()}
    log(f"policy self-play with and without the encode cache [{card}]: a "
        f"segment of {SP_CHUNK} plies with it ran with no device->host sync; "
        f"{INCR_SP_RUNS} runs each at batch {SP_BATCH}, the same actions "
        "every run; games/min with the cache "
        + ", ".join(f"{r:.2f}" for r in rates[True]) + ", without "
        + ", ".join(f"{r:.2f}" for r in rates[False])
        + f"; launches with the cache {launches} ("
        + ", ".join(f"{k} {v:.2f}" for k, v in per_ply.items()) + " a ply)")
    return dict(rates=rates, launches=launches, per_ply=per_ply)


def incr_verdict(on, off) -> str:
    """``"on"`` or ``"off"`` where every run of one mode beat every run
    of the other (higher is better), ``"tie"`` where the runs' ranges
    overlap."""
    if min(on) > max(off):
        return "on"
    if min(off) > max(on):
        return "off"
    return "tie"


def phase_incremental(pygo, torchgo, dev, card, counters, specs):
    """Phase 20: the incremental encoder on the card (see the module
    docstring). Returns the launches of its main path and self-play
    runs, and the measurements behind the ``incremental=`` defaults."""
    from rocalphago_tpu_torch.search import device_mcts as D
    from rocalphago_tpu_torch.search import selfplay as S

    t0 = time.monotonic()
    games = incr_games(pygo)
    stats = incr_trajectories(torchgo, dev, card, games)
    enc, kernels = incr_encode_timings(torchgo, dev, card, games[1])
    main_path = incr_main_path(pygo, card, counters, specs)
    sp = incr_selfplay(torchgo, dev, card, counters)
    # genmove seconds (lower is better), games/min (higher is better)
    faster = {"DeviceMCTSPlayer": incr_verdict(
        [-x for x in main_path["times"][True]],
        [-x for x in main_path["times"][False]]),
        "self-play": incr_verdict(sp["rates"][True], sp["rates"][False])}
    log(f"incremental defaults [{card}]: the faster mode -- "
        + ", ".join(f"{k} {v}" for k, v in faster.items())
        + f"; the port's defaults: DeviceMCTSPlayer {D.INCREMENTAL_DEFAULT}, "
        f"self-play {S.INCREMENTAL_DEFAULT} (a tie keeps the reference's: "
        f"on, off); phase 20 {time.monotonic() - t0:.1f} s")
    launches = {k: main_path["launches"][k] + sp["launches"].get(k, 0)
                for k in main_path["launches"]}
    return dict(launches=launches, stats=stats, encode=enc,
                kernels=kernels, main=main_path, selfplay=sp)


def batch_launches(batches: int, genmoves: int) -> dict:
    """The kernels a pooled genmove path launches: a labels and a chase
    launch an evaluator batch (its terminal values and its encode's
    ladder planes), a labels launch a root bridge, two tree launches a
    simulation. Threaded sessions share batches, so the per-genmove
    counts follow how their requests coalesced."""
    return {"labels": batches + genmoves, "chase": batches,
            "tree": 2 * SERVE_SIMS * genmoves}


def gateway_settle(server, pool=None, live: int = 0,
                   timeout: float = 30.0) -> None:
    """Wait until the gateway holds at most ``live`` connections (and
    the pool no session): a close is observed at the server's next
    read."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if server.stats()["conns"]["live"] <= live and (
                pool is None or pool.stats()["sessions"]["live"] == 0):
            return
        time.sleep(0.02)
    check(False, f"the gateway did not settle: {server.stats()['conns']}")


def gateway_load(pygo, pool, server, counters, card, threaded) -> dict:
    """The main path: ``run_load`` with ``GATEWAY_CONNS`` connections of
    ``GATEWAY_GENMOVES`` genmoves, each client's moves recorded and
    replayed on ``pygo``."""
    from rocalphago_tpu_torch.gateway import client as gw
    from rocalphago_tpu_torch.interface.gtp import parse_color, vertex_to_move
    from rocalphago_tpu_torch.interface.resilient import percentile

    games = []

    class Recording(gw.GatewayClient):
        def new_game(self, board=None, komi=None):
            reply = super().new_game(board=board, komi=komi)
            self.game = (reply["board"], reply["komi"], [])
            games.append(self.game)
            return reply

        def genmove(self, color):
            reply = super().genmove(color)
            self.game[2].append((color, reply))
            return reply

    ev0 = pool.evaluator.stats()
    before = server.stats()
    plain = gw.GatewayClient
    gw.GatewayClient = Recording
    try:
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        load = gw.run_load("127.0.0.1", server.port, conns=GATEWAY_CONNS,
                           moves=GATEWAY_GENMOVES, board=SIZE, timeout=600)
        torch.cuda.synchronize()
        launches = serve_launches(counters)
    finally:
        gw.GatewayClient = plain
    gateway_settle(server, pool)
    genmoves = GATEWAY_CONNS * GATEWAY_GENMOVES
    check(load["moves"] == genmoves and load["sheds"] == load["disconnects"]
          == load["errors"] == 0, f"gateway load: {load}")
    check(len(games) == GATEWAY_CONNS, f"{len(games)} games recorded")
    for board, komi, moves in games:
        st = pygo.GameState(size=board, komi=komi)
        for color, reply in moves:
            mv = vertex_to_move(reply["move"], board)
            # the server's last guard turns an illegal move into a pass;
            # no search passes within two plies of the empty board
            check(mv is not None and st.is_legal(mv) and reply["rung"] ==
                  "search", f"gateway genmove {color}: {reply}")
            st.do_move(mv, parse_color(color))
    ev = pool.evaluator.stats()
    batches = ev["batches"] - ev0["batches"]
    check(launches == batch_launches(batches, genmoves),
          f"gateway load launches {launches} for {batches} evaluator "
          f"batches and {genmoves} genmoves")
    stats = server.stats()
    check(stats["requests"]["unhandled"] == 0
          and stats["requests"]["genmoves"] - before["requests"]["genmoves"]
          == genmoves, f"gateway requests: {stats['requests']}")
    lat = sorted(load["latencies_s"])
    p50, p99 = percentile(lat, 0.5), percentile(lat, 0.99)
    per_genmove = {k: v / genmoves for k, v in launches.items()}
    log(f"gateway load [{card}]: {GATEWAY_CONNS} connections x "
        f"{GATEWAY_GENMOVES} genmoves at {SERVE_SIMS} simulations over the "
        f"wire in {load['elapsed_s']:.2f} s: genmove p50 {p50:.3f} s, p99 "
        f"{p99:.3f} s (limit {SERVE_GENMOVE_LIMIT_S:.0f} s; phase 19's "
        f"threaded in process p50 {threaded['p50']:.3f} s, p99 "
        f"{threaded['p99']:.3f} s: the wire tax {p50 - threaded['p50']:+.3f} "
        f"s at p50), server wire_ms {stats['wire_ms']}; every move legal "
        f"on pygo; {batches} evaluator batches; launches {launches} "
        f"({per_genmove} a genmove; phase 19's threaded "
        f"{threaded['per_genmove']}, both a labels and a chase launch a "
        f"batch, a labels launch a root, {2 * SERVE_SIMS} tree launches a "
        f"genmove); requests.unhandled {stats['requests']['unhandled']}")
    return dict(p50=p50, p99=p99, launches=launches, per_genmove=per_genmove,
                batches=batches, elapsed=load["elapsed_s"])


def gateway_shed(pool, server, card) -> int:
    """A fifth connection shed at accept, ``connect_with_retry`` riding it
    out, and a pool's session cap refusing ``new_game``. Returns the
    sheds the pool-cap server counted."""
    from rocalphago_tpu_torch.gateway import client as gw
    from rocalphago_tpu_torch.gateway.server import GatewayServer
    from rocalphago_tpu_torch.serve.sessions import ServePool

    held = [gw.GatewayClient("127.0.0.1", server.port)
            for _ in range(GATEWAY_CONNS)]
    sleeps = []
    try:
        try:
            gw.GatewayClient("127.0.0.1", server.port).close()
            check(False, "a fifth connection was admitted")
        except gw.GatewayRefused as e:
            check(e.code == "overload" and e.retry_after_s == 1.0,
                  f"the shed: {e.code} {e.retry_after_s}")

        def sleep(s):
            sleeps.append(s)
            held.pop().close()
            gateway_settle(server, live=GATEWAY_CONNS - 1)

        gw.connect_with_retry("127.0.0.1", server.port, sleep=sleep).close()
        check(len(sleeps) == 1 and sleeps[0] >= 1.0,
              f"connect_with_retry slept {sleeps}")
    finally:
        for c in held:
            c.close()
    gateway_settle(server, pool)
    capped = ServePool(pool.value, pool.policy, n_sim=SERVE_SIMS,
                       searcher=pool.search, max_sessions=2)
    srv = GatewayServer(capped, max_conns=GATEWAY_CONNS).start()
    clients = []
    try:
        for _ in range(3):
            clients.append(gw.GatewayClient("127.0.0.1", srv.port))
        for c in clients[:2]:
            c.new_game()
        try:
            clients[2].new_game()
            check(False, "the pool's session cap admitted a third game")
        except gw.GatewayRefused as e:
            check(e.code == "overload" and e.retry_after_s == 1.0,
                  f"the admission shed: {e.code} {e.retry_after_s}")
        clients[0].close_game()
        check(clients[2].new_game()["type"] == "ok",
              "a freed session slot was not reused")
    finally:
        for c in clients:
            c.close()
        gateway_settle(srv, capped)
        srv.close()
        capped.close()
    sheds = srv.stats()["conns"]["shed"]
    log(f"gateway shed [{card}]: a fifth connection refused (overload, "
        f"retry_after_s 1.0), connect_with_retry admitted after sleeping "
        f"{sleeps[0]:.3f} s (the hint's floor); the pool's session cap "
        f"(2) refused a third new_game the same way")
    return sheds


def gateway_slo(pool, card) -> int:
    """One connection on a server with ``slo_ms`` 2000 over a pool with
    more simulations than fit: the reply has ``slo_hit`` and comes
    within the SLO plus about one simulation. Returns the server's
    sheds (none)."""
    from rocalphago_tpu_torch.gateway.client import GatewayClient
    from rocalphago_tpu_torch.gateway.server import GatewayServer
    from rocalphago_tpu_torch.serve.sessions import ServePool

    slo = ServePool(pool.value, pool.policy, n_sim=SERVE_SLO_SIMS)
    slo.warm()
    srv = GatewayServer(slo, max_conns=1, slo_ms=GATEWAY_SLO_MS).start()
    try:
        c = GatewayClient("127.0.0.1", srv.port)
        try:
            check(c.hello["slo_ms"] == GATEWAY_SLO_MS, f"hello {c.hello}")
            c.new_game()
            ev0 = slo.evaluator.stats()["batches"]
            reply = c.genmove("b")
            ran = slo.evaluator.stats()["batches"] - ev0 - 1
        finally:
            c.close()
        gateway_settle(srv, slo)
    finally:
        srv.close()
        slo.close()
    per_sim = reply["elapsed_ms"] / max(ran, 1)
    # the deadline is checked between simulations: the overshoot is one
    # simulation, and the root bridge and evaluation before the first
    check(reply["slo_hit"] is True and reply["rung"] == "search"
          and 0 < ran < SERVE_SLO_SIMS
          and reply["elapsed_ms"] <= GATEWAY_SLO_MS + 2 * per_sim,
          f"the SLO genmove: {reply}, {ran} simulations")
    log(f"gateway SLO [{card}]: slo_ms {GATEWAY_SLO_MS:.0f}: slo_hit after "
        f"{reply['elapsed_ms']:.1f} ms, {ran} of {SERVE_SLO_SIMS} "
        f"simulations ({per_sim:.2f} ms each), move {reply['move']}")
    return srv.stats()["conns"]["shed"]


def gateway_faults(pool, server, card) -> None:
    """``kill@gateway.conn`` on one request and a transient on another:
    the killed connection gets ``internal`` and drops, the transient
    fails that request only, the server serves on."""
    from rocalphago_tpu_torch.gateway import client as gw
    from rocalphago_tpu_torch.runtime import faults

    before = server.stats()
    a = gw.GatewayClient("127.0.0.1", server.port)
    b = gw.GatewayClient("127.0.0.1", server.port)
    try:
        a.new_game()
        b.new_game()
        faults.install("kill@gateway.conn:p=1.0,seed=3")
        try:
            a.genmove("b")
            check(False, "the killed request was answered")
        except gw.GatewayError as e:
            check(e.code == "internal" and "connection aborted" in str(e),
                  f"the kill: {e}")
        finally:
            faults.install(None)
        try:
            a.genmove("b")
            check(False, "the killed connection served on")
        except gw.GatewayClosed:
            pass
        faults.install("io_error@gateway.conn:p=1.0,seed=5")
        try:
            b.genmove("b")
            check(False, "the transient request was answered")
        except gw.GatewayError as e:
            check(e.code == "internal" and "transient fault" in str(e),
                  f"the transient: {e}")
        finally:
            faults.install(None)
        reply = b.genmove("b")
        check(reply["type"] == "move" and reply["rung"] == "search",
              f"after the transient: {reply}")
        b.close_game()
    finally:
        faults.install(None)
        a.close()
        b.close()
    gateway_settle(server, pool)
    after = server.stats()
    check(after["faults"]["kills"] == before["faults"]["kills"] + 1
          and after["faults"]["injected"] == before["faults"]["injected"] + 1
          and after["requests"]["unhandled"] == 0
          and after["conns"]["live"] == 0
          and pool.stats()["sessions"]["live"] == 0,
          f"after the faults: {after}, {pool.stats()['sessions']}")
    log(f"gateway faults [{card}]: kill -> internal and the connection "
        f"dropped; transient -> internal on that request, the next "
        f"genmove served ({reply['move']}); unhandled 0, kills "
        f"{after['faults']['kills']}, injected {after['faults']['injected']}"
        ", every slot back")


def http_get(port: int, path: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def gateway_probes_and_drain(pool, server, http, metrics_path, sheds,
                             card) -> None:
    """``/healthz`` and ``/metrics``; then the drain with a genmove in
    flight: its reply, ``goodbye``, 503, TCP refused, sessions at 0,
    the three drain events in order."""
    import socket

    from rocalphago_tpu_torch.gateway import protocol
    from rocalphago_tpu_torch.runtime.jsonl import read_jsonl

    status, body = http_get(http.port, "/healthz")
    health = json.loads(body)
    check(status == 200 and health["status"] == "ok"
          and health["serve"]["sessions"]["live"] == 0
          and health["gateway"]["requests"]["unhandled"] == 0
          and set(health["gateway"]) >= {"proto", "conns", "requests",
                                         "faults", "wire_ms"},
          f"/healthz {status}: {health}")
    status, body = http_get(http.port, "/metrics")
    text = body.decode()
    m = re.search(r'^gateway_connections_total\{result="shed"\} (\S+)$', text,
                  re.M)
    shed_metric = float(m.group(1)) if m else None
    total_shed = server.stats()["conns"]["shed"] + sheds
    check(status == 200 and shed_metric == total_shed
          and all(f in text for f in ("gateway_conns_live",
                                      "gateway_wire_seconds",
                                      "gateway_requests_total",
                                      "gateway_errors_total",
                                      "gateway_faults_total")),
          f"/metrics: shed {shed_metric} vs the servers' {total_shed}")
    # the drain, with a genmove in flight on a raw connection
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=120)
    reader = sock.makefile("rb")
    try:
        protocol.read_frame(reader)                       # hello
        sock.sendall(protocol.encode_frame({"type": "new_game", "id": 1}))
        protocol.read_frame(reader)
        sock.sendall(protocol.encode_frame({"type": "genmove", "id": 2,
                                            "color": "b"}))
        # a genmove of 100 simulations takes seconds: still in flight
        time.sleep(0.2)
        t0 = time.perf_counter()
        server.drain(reason="smoke")
        drain_s = time.perf_counter() - t0
        frames = [protocol.read_frame(reader) for _ in range(3)]
    finally:
        reader.close()
        sock.close()
    check(frames[0]["type"] == "move" and frames[1] == {
        "type": "goodbye", "reason": "draining"} and frames[2] is None,
          f"the drain's frames: {frames}")
    status, body = http_get(http.port, "/healthz")
    check(status == 503 and json.loads(body)["status"] == "draining",
          f"/healthz while draining: {status}")
    try:
        socket.create_connection(("127.0.0.1", server.port), timeout=5).close()
        check(False, "a TCP connect succeeded after the drain")
    except OSError:
        pass
    gateway_settle(server, pool)
    phases = [r["phase"] for r in read_jsonl(metrics_path)
              if r.get("event") == "drain"]
    check(phases == ["gateway_requested", "gateway_accept_stopped",
                     "gateway_drained"], f"drain events {phases}")
    log(f"gateway probes and drain [{card}]: /healthz 200 with the serve "
        f"and gateway blocks, /metrics shed count {shed_metric:.0f} = the "
        f"servers'; drain in {drain_s:.2f} s: the in-flight genmove "
        f"answered ({frames[0]['move']}), then goodbye, /healthz 503, TCP "
        "refused, sessions live 0, events " + " -> ".join(phases))


def gtp_reply(proc) -> str:
    """One GTP reply off a subprocess's stdout (lines up to a blank)."""
    lines = []
    while True:
        line = proc.stdout.readline()
        check(line != "", "the GTP bridge closed its output")
        if line.strip() == "":
            if lines:
                return "".join(lines).strip()
            continue
        lines.append(line)


def gateway_clis(pygo, paths, card) -> dict:
    """The gateway server's CLI on phase 19's specs, driven by the GTP
    bridge's CLI (``--connect``), then SIGTERM."""
    from rocalphago_tpu_torch.interface.gtp import vertex_to_move
    from rocalphago_tpu_torch.runtime.jsonl import read_jsonl

    root = os.path.dirname(os.path.abspath(__file__))
    metrics = os.path.join(root, SERVE_DIR, "gateway_cli.jsonl")
    errlog = open(os.path.join(root, SERVE_DIR, "gateway_cli.err"), "w")
    t0 = time.perf_counter()
    srv = child_popen(
        [sys.executable, "-m", "rocalphago_tpu_torch.gateway.server",
         "--policy", paths["policy19"], "--value", paths["value19"],
         "--port", "0", "--http-port", "0", "--metrics", metrics],
        cwd=root, stdout=subprocess.PIPE, stderr=errlog, text=True)
    bridge = None
    timers = [threading.Timer(CLI_TIMEOUT_S, srv.kill)]
    try:
        timers[0].start()
        line = srv.stdout.readline()
        check(line.startswith("gateway: serving on 127.0.0.1:"),
              f"the gateway CLI said {line!r} (exit {srv.poll()})")
        port = int(line.split(":")[2].split()[0])
        up_s = time.perf_counter() - t0
        bridge = child_popen(
            [sys.executable, "-m", "rocalphago_tpu_torch.interface.gtp",
             "--connect", f"127.0.0.1:{port}"], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        timers.append(threading.Timer(CLI_TIMEOUT_S, bridge.kill))
        timers[1].start()
        st = pygo.GameState(size=SIZE, komi=7.5)
        replies = []

        def say(cmd: str) -> str:
            bridge.stdin.write(cmd + "\n")
            bridge.stdin.flush()
            reply = gtp_reply(bridge)
            replies.append((cmd, reply))
            check(reply.startswith("="), f"gtp --connect: {cmd} -> {reply!r}")
            return reply[1:].strip()

        def genmove(color: str) -> None:
            mv = vertex_to_move(say(f"genmove {color}"), SIZE)
            check(mv is not None and st.is_legal(mv),
                  f"gtp --connect genmove {color}: {replies[-1]}")
            st.do_move(mv)

        t1 = time.perf_counter()
        for cmd in (f"boardsize {SIZE}", "clear_board", "komi 7.5"):
            say(cmd)
        genmove("b")
        white = next(v for v in ("D4", "Q16", "C3")
                     if st.is_legal(vertex_to_move(v, SIZE)))
        say(f"play w {white}")
        st.do_move(vertex_to_move(white, SIZE))
        genmove("b")
        say("quit")
        check(bridge.wait(timeout=60) == 0,
              f"the GTP bridge exited {bridge.returncode}: "
              f"{bridge.stderr.read()[-2000:]}")
        session_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        srv.send_signal(signal.SIGTERM)
        rc = srv.wait(timeout=GATEWAY_DRAIN_S)
        stop_s = time.perf_counter() - t2
        check(rc == 0, f"the gateway CLI exited {rc} on SIGTERM")
    finally:
        for t in timers:
            t.cancel()
        for proc in (bridge, srv):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        errlog.close()
    events = read_jsonl(metrics)
    phases = [r["phase"] for r in events if r.get("event") == "drain"
              and str(r.get("phase", "")).startswith("gateway")]
    check(phases == ["gateway_requested", "gateway_accept_stopped",
                     "gateway_drained"] and events[-1]["event"] == "registry",
          f"the gateway CLI's metrics: drain {phases}, last "
          f"{events[-1]['event'] if events else None}")
    log(f"gateway CLIs [{card}]: the server up in {up_s:.1f} s (start-up, "
        f"specs, warm); gtp --connect {[r for _, r in replies]} in "
        f"{session_s:.1f} s with the bridge's start-up, every reply '=' "
        "and every vertex legal; "
        f"SIGTERM -> exit 0 in {stop_s:.2f} s, drain events "
        + " -> ".join(phases))
    return dict(up_s=up_s, session_s=session_s, stop_s=stop_s)


def phase_gateway(pygo, card, counters, serve) -> dict:
    """Phase 21: the gateway on the card (see the module docstring).
    Returns the load's launches and wire latencies."""
    from rocalphago_tpu_torch.gateway.httpapi import GatewayHTTP
    from rocalphago_tpu_torch.gateway.server import GatewayServer
    from rocalphago_tpu_torch.io.metrics import MetricsLogger
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.serve.sessions import ServePool

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    paths = serve["paths"]
    policy = NeuralNetBase.load_model(paths["policy19"])
    value = NeuralNetBase.load_model(paths["value19"])
    metrics_path = os.path.join(root, SERVE_DIR, "gateway.jsonl")
    for name in ("gateway.jsonl", "gateway_cli.jsonl"):
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(root, SERVE_DIR, name))
    metrics = MetricsLogger(metrics_path, echo=False)
    pool = ServePool(value, policy, n_sim=SERVE_SIMS)
    server = http = None
    try:
        pool.warm()
        server = GatewayServer(pool, max_conns=GATEWAY_CONNS,
                               metrics=metrics).start()
        http = GatewayHTTP(server).start()
        out = dict(load=gateway_load(pygo, pool, server, counters, card,
                                     serve["threaded"]))
        sheds = gateway_shed(pool, server, card)
        sheds += gateway_slo(pool, card)
        gateway_faults(pool, server, card)
        gateway_probes_and_drain(pool, server, http, metrics_path, sheds,
                                 card)
    finally:
        if http is not None:
            http.close()
        if server is not None:
            server.close()
        pool.close()
        metrics.close()
    out["cli"] = gateway_clis(pygo, paths, card)
    out["launches"] = out["load"]["launches"]
    out["phase_s"] = time.perf_counter() - t0
    log(f"gateway phase: {out['phase_s']:.1f} s")
    return out


def fleet_specs(work: str) -> dict:
    """A second seeded pair of phase 19's shape (the 19×19 12 × 128 FCN
    policy and value nets) from the port's spec CLI: what the hot swap
    and the canary install."""
    from rocalphago_tpu_torch.models import specs

    out = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, seed in (("policy19", 62), ("value19", 63)):
            out[name] = os.path.join(work, f"{name}b.json")
            specs.main([name[:-2], "--board", "19", "--seed",
                        str(SEED + seed), "--out", out[name]])
    return out


def recording_acquire(pool):
    """Wrap ``pool.evaluator.acquire``: every version a search pins is
    appended to the returned list, and the event is set at each pin.
    Returns ``(versions, event, restore)``."""
    plain = pool.evaluator.acquire
    versions, pinned = [], threading.Event()

    def acquire(version=None):
        v = plain(version)
        versions.append(v)
        pinned.set()
        return v

    pool.evaluator.acquire = acquire
    return versions, pinned, lambda: setattr(pool.evaluator, "acquire",
                                             plain)


def fleet_swap(pygo, torchgo, pool, second, work, card) -> dict:
    """(a) A ``ParamsPublisher(spill_dir=)`` publishes the second pair
    while a session's genmove is in flight; a ``SpillWatcher`` swaps it
    into the pool. The in-flight genmove ends on its pinned version,
    the next one on the new; the new version evaluates as a fresh pool
    on the second specs does; card memory stays flat across
    ``FLEET_SWAPS`` more swaps."""
    import gc

    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.obs import registry
    from rocalphago_tpu_torch.rollout.hotswap import HotSwapper, SpillWatcher
    from rocalphago_tpu_torch.serve.sessions import ServePool
    from rocalphago_tpu_torch.training.actor import ParamsPublisher
    from rocalphago_tpu_torch.training.zero import snapshot

    spill = os.path.join(work, "spill")
    pol_b = NeuralNetBase.load_model(second["policy19"])
    val_b = NeuralNetBase.load_model(second["value19"])
    pair_a = tuple(snapshot(n.module) for n in (pool.policy, pool.value))
    pair_b = tuple(snapshot(n.module) for n in (pol_b, val_b))
    pub = ParamsPublisher(spill_dir=spill)
    swapper = HotSwapper(pool)
    watcher = SpillWatcher(spill, swapper, pool.policy.module,
                           pool.value.module, poll_s=0.02).start()
    versions, pinned, restore = recording_acquire(pool)
    st = pygo.GameState(size=SIZE, komi=7.5)
    out = {}
    try:
        v0 = pool.params_version
        with pool.open_session() as sess:
            done = {}

            def genmove():
                done["move"] = sess.get_move(st)
                done["version"] = sess.params_version
                done["t"] = time.perf_counter()

            t = threading.Thread(target=genmove, name="smoke-swap-genmove")
            t.start()
            check(pinned.wait(120), "the genmove never pinned a version")
            published = pub.publish(*pair_b)
            t_end = time.monotonic() + 60
            while swapper.version < published and time.monotonic() < t_end:
                time.sleep(0.005)
            t_swapped = time.perf_counter()
            in_flight = t.is_alive()
            t.join(300)
            check(not t.is_alive() and swapper.version == published,
                  f"the swap: watcher at {swapper.version}, genmove "
                  f"alive {t.is_alive()}")
            v1 = pool.params_version
            mv = done["move"]
            check(done["version"] == v0 != v1 and in_flight
                  and t_swapped < done["t"] and mv is not None
                  and st.is_legal(mv),
                  f"in-flight genmove: version {done['version']} (pinned "
                  f"{v0}, new {v1}), swapped in flight {in_flight}, move "
                  f"{mv}")
            st.do_move(mv)
            mv2 = sess.get_move(st)
            check(sess.params_version == v1 and mv2 is not None
                  and st.is_legal(mv2),
                  f"next genmove on version {sess.params_version}, not {v1}")
            rung = sess.player.last_rung
        # the new version evaluates as a fresh pool on the second specs
        many = torchgo.seed_labels(pool.cfg, torchgo.from_pygo(
            pool.cfg, serve_positions(pygo, 8, SEED + 88),
            device=pool.device, with_labels=False))
        got_p, got_v = pool.evaluator.eval_direct(many)
        fresh = ServePool(val_b, pol_b, n_sim=SERVE_SIMS,
                          searcher=pool.search)
        try:
            want_p, want_v = fresh.evaluator.eval_direct(many)
        finally:
            fresh.close()
        err = (float((got_p - want_p).abs().max()),
               float((got_v - want_v).abs().max()))
        lim = tuple(SIZE_ULPS * bf16_ulp(float(x.abs().max()))
                    for x in (want_p, want_v))
        exact = torch.equal(got_p, want_p) and torch.equal(got_v, want_v)
        check(torch.isfinite(got_p).all() and err[0] <= lim[0]
              and err[1] <= lim[1],
              f"the swapped version vs a fresh pool: {err} over {lim}")
        # memory across swaps (A, B, A, ...), one evaluation after each
        mem = []
        for i in range(FLEET_SWAPS + 1):
            # B, A, B, ...: the pool ends on the phase-19 pair (A)
            pub.publish(*(pair_b if i % 2 == 0 else pair_a))
            t_end = time.monotonic() + 60
            while swapper.version < pub.get()[0] and \
                    time.monotonic() < t_end:
                time.sleep(0.005)
            pool.evaluator.eval_direct(many)[0].cpu()
            torch.cuda.synchronize()
            gc.collect()
            mem.append(torch.cuda.memory_allocated(pool.device))
        check(swapper.version == pub.get()[0] and max(mem[1:]) <= mem[0],
              f"card memory across swaps {mem} (watcher at "
              f"{swapper.version})")
        hist = registry.snapshot()["histograms"]["rollout_swap_seconds"]
        out = dict(swap_s=hist["sum"] / hist["count"], swaps=hist["count"],
                   mem=mem, err=err, exact=exact)
        log(f"hot swap [{card}]: a genmove at {SERVE_SIMS} simulations "
            f"pinned version {v0}; the spill of version {published} landed "
            f"while it searched (swapped in flight: {in_flight}); it ended "
            f"on version {v0} with {mv} (rung {rung}), the next on {v1} with "
            f"{mv2}; the swapped version vs a fresh pool on the second "
            f"specs at batch 8: max |diff| priors {err[0]:.3e}, values "
            f"{err[1]:.3e} (limits {lim[0]:.3e}, {lim[1]:.3e}; bit-equal "
            f"{exact}); card memory allocated after {FLEET_SWAPS + 1} "
            f"swaps {mem} bytes (flat); rollout_swap_seconds mean "
            f"{out['swap_s']:.4f} s over {out['swaps']} swaps (the working "
            "copies of both nets)")
    finally:
        restore()
        watcher.stop()
    return out


def fleet_canary(pygo, pool, second, card) -> dict:
    """(b) A candidate staged through ``GatewayServer(canary=)``: the
    candidate arm searches on the staged version; scripted outcomes
    promote one candidate and roll back another, and the rolled-back
    arm's live session falls back to current."""
    from rocalphago_tpu_torch.gateway import client as gw
    from rocalphago_tpu_torch.gateway.server import GatewayServer
    from rocalphago_tpu_torch.interface.gtp import vertex_to_move
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.rollout.canary import CanaryController

    pol_b = NeuralNetBase.load_model(second["policy19"])
    val_b = NeuralNetBase.load_model(second["value19"])
    pair_b = (pol_b.module.state_dict(), val_b.module.state_dict())
    pair_a = tuple({k: v.clone() for k, v in n.module.state_dict().items()}
                   for n in (pool.policy, pool.value))
    can = CanaryController(pool, fraction=1.0, min_games=CANARY_GAMES)
    versions, _, restore = recording_acquire(pool)
    srv = GatewayServer(pool, max_conns=4, canary=can).start()

    def play_one(c, st, color):
        reply = c.genmove(color)
        mv = vertex_to_move(reply["move"], SIZE)
        check(mv is not None and st.is_legal(mv),
              f"canary genmove {color}: {reply}")
        st.do_move(mv)

    try:
        staged = can.stage(*pair_b)
        c = gw.GatewayClient("127.0.0.1", srv.port, timeout=600)
        try:
            c.new_game(board=SIZE)
            play_one(c, pygo.GameState(size=SIZE), "b")
        finally:
            c.close()
        check(versions == [staged] and can.stats()["assigned"][
            "candidate"] == 1, f"candidate arm pinned {versions}, staged "
            f"{staged}")
        for _ in range(CANARY_GAMES):
            can.record("candidate", won=True)
        check(can.state == "promoted" and pool.params_version == staged,
              f"canary after {CANARY_GAMES} wins: {can.stats()}")
        lb_promote = can.stats()["wilson_lb"]
        versions.clear()
        second_v = can.stage(*pair_a)
        c = gw.GatewayClient("127.0.0.1", srv.port, timeout=600)
        try:
            c.new_game(board=SIZE)
            st = pygo.GameState(size=SIZE)
            play_one(c, st, "b")
            for _ in range(CANARY_GAMES):
                can.record("candidate", won=False)
            check(can.state == "rolled_back", f"canary: {can.stats()}")
            play_one(c, st, "w")
        finally:
            c.close()
        check(versions == [second_v, staged],
              f"the rolled-back session pinned {versions}; want "
              f"{[second_v, staged]}")
        gateway_settle(srv, pool)
        check(srv.stats()["requests"]["unhandled"] == 0,
              f"canary gateway: {srv.stats()['requests']}")
        stats = can.stats()
        log(f"canary [{card}]: candidate version {staged} staged, the "
            f"canary arm's genmove searched on it; "
            f"{CANARY_GAMES} scripted wins -> promoted (Wilson lb "
            f"{lb_promote}); candidate {second_v} staged, its live session "
            f"pinned, {CANARY_GAMES} losses -> rolled back (lb "
            f"{stats['wilson_lb']}), the session's next genmove on current "
            f"{staged}; promotions {stats['promotions']}, rollbacks "
            f"{stats['rollbacks']}; gateway requests.unhandled 0")
        return dict(promoted=staged, rolled_back=second_v)
    finally:
        srv.close()
        restore()
        if can.state == "running":
            can.rollback(reason="smoke")


def fleet_router(pygo, pool, counters, card, gw21) -> dict:
    """(c) Two in-process gateway replicas behind a ``RolloutRouter``:
    ``a`` over a 1-session pool sharing the pool's searcher, ``b`` over
    the pool. The main path: ``run_load`` through the router (sticky
    sessions, a spillover off ``a``), every move legal; the same load
    through a router over ``b`` alone (the hop without the split); a
    fleet-wide swap and ``await_convergence``; a game failed over
    mid-drain."""
    from rocalphago_tpu_torch.gateway import client as gw
    from rocalphago_tpu_torch.gateway.server import GatewayServer
    from rocalphago_tpu_torch.interface.gtp import parse_color, vertex_to_move
    from rocalphago_tpu_torch.interface.resilient import percentile
    from rocalphago_tpu_torch.rollout.router import Replica, RolloutRouter
    from rocalphago_tpu_torch.serve.sessions import ServePool

    small = ServePool(pool.value, pool.policy, n_sim=SERVE_SIMS,
                      max_sessions=1, searcher=pool.search)
    a = GatewayServer(small, max_conns=4).start()
    b = GatewayServer(pool, max_conns=GATEWAY_CONNS + 2).start()
    reps = [Replica("127.0.0.1", a.port, gateway=a, name="a"),
            Replica("127.0.0.1", b.port, gateway=b, name="b")]
    router = RolloutRouter(reps, max_conns=8).start()
    games = []

    class Recording(gw.GatewayClient):
        def new_game(self, board=None, komi=None):
            reply = super().new_game(board=board, komi=komi)
            self.game = (reply["board"], reply["komi"], [])
            games.append(self.game)
            return reply

        def genmove(self, color):
            reply = super().genmove(color)
            self.game[2].append((color, reply))
            return reply

    try:
        small.warm()
        ev0 = [p.evaluator.stats()["batches"] for p in (small, pool)]
        plain = gw.GatewayClient
        gw.GatewayClient = Recording
        try:
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            load = gw.run_load("127.0.0.1", router.port, conns=GATEWAY_CONNS,
                               moves=ROUTER_GENMOVES, board=SIZE,
                               timeout=600)
            torch.cuda.synchronize()
            launches = serve_launches(counters)
        finally:
            gw.GatewayClient = plain
        genmoves = GATEWAY_CONNS * ROUTER_GENMOVES
        check(load["moves"] == genmoves and load["sheds"] ==
              load["disconnects"] == load["errors"] == 0,
              f"routed load: {load}")
        for board, komi, moves in games:
            st = pygo.GameState(size=board, komi=komi)
            for color, reply in moves:
                mv = vertex_to_move(reply["move"], board)
                check(mv is not None and st.is_legal(mv)
                      and reply["rung"] == "search",
                      f"routed genmove {color}: {reply}")
                st.do_move(mv, parse_color(color))
        batches = sum(p.evaluator.stats()["batches"] - e
                      for p, e in zip((small, pool), ev0))
        check(launches == batch_launches(batches, genmoves),
              f"routed load launches {launches} for {batches} batches")
        rst = router.stats()
        shares = {n: r["routed"] for n, r in rst["replicas"].items()}
        check(rst["spillovers"] >= 1 and shares["a"] >= 1,
              f"router after the load: {rst}")
        lat = sorted(load["latencies_s"])
        p50, p99 = percentile(lat, 0.5), percentile(lat, 0.99)
        # the control: the same load through a router over ``b`` alone,
        # one pool as phase 21's, so its p50 less phase 21's is the
        # router's hop and the main path's less it the replica split
        for srv in (a, b):
            gateway_settle(srv)
        with RolloutRouter([Replica("127.0.0.1", b.port, gateway=b,
                                    name="b")], max_conns=8).start() as one:
            ctl = gw.run_load("127.0.0.1", one.port, conns=GATEWAY_CONNS,
                              moves=ROUTER_GENMOVES, board=SIZE, timeout=600)
        check(ctl["moves"] == genmoves and ctl["errors"] == ctl["sheds"]
              == ctl["disconnects"] == 0, f"one-replica routed load: {ctl}")
        p50_one = percentile(sorted(ctl["latencies_s"]), 0.5)
        # a fleet-wide swap: one version number on both replicas
        target = max(small.params_version, pool.params_version) + 1
        pair = [n.module.state_dict() for n in (pool.policy, pool.value)]
        t0 = time.perf_counter()
        for p in (small, pool):
            p.set_params(*pair, version=target)
        converged = router.await_convergence(target, timeout=30)
        conv_s = time.perf_counter() - t0
        check(converged and all(r.params_version == target for r in reps),
              f"convergence on {target}: {rst['replicas']}")
        for srv in (a, b):
            gateway_settle(srv)
        # a game failed over mid-drain
        c = gw.GatewayClient("127.0.0.1", router.port, timeout=600)
        try:
            c.new_game(board=SIZE)
            st = pygo.GameState(size=SIZE, komi=7.5)
            for color in "bw":
                if color == "w":
                    holder = a if router.stats()["replicas"]["a"][
                        "sessions"] else b
                    holder.drain(timeout=5.0)
                mv = vertex_to_move(c.genmove(color)["move"], SIZE)
                check(mv is not None and st.is_legal(mv),
                      f"failover genmove {color}: {mv}")
                st.do_move(mv)
            mv = vertex_to_move(c.genmove("b")["move"], SIZE)
            check(mv is not None and st.is_legal(mv),
                  f"the genmove after the failover: {mv}")
        finally:
            c.close()
        fst = router.stats()
        # a backend read past the router's 30 s timeout during the load
        # fails over too: count the mid-drain game's own
        failovers = fst["failovers"] - rst["failovers"]
        retried = fst["retried_genmoves"] - rst["retried_genmoves"]
        check(failovers == 1 and retried <= 1, f"failover: {fst}")
        for srv in (a, b):
            check(srv.stats()["requests"]["unhandled"] == 0,
                  f"replica requests: {srv.stats()['requests']}")
        per_genmove = {k: v / genmoves for k, v in launches.items()}
        wire = gw21["load"]
        log(f"router [{card}]: {GATEWAY_CONNS} connections x "
            f"{ROUTER_GENMOVES} genmove at {SERVE_SIMS} simulations over 2 "
            f"replicas in {load['elapsed_s']:.2f} s: routed shares {shares}, "
            f"spillovers {rst['spillovers']}; genmove p50 {p50:.3f} s, p99 "
            f"{p99:.3f} s beside phase 21's wire p50 {wire['p50']:.3f} s "
            f"(the router's tax {p50 - wire['p50']:+.3f} s at p50); the same "
            f"load through a router over b alone: p50 {p50_one:.3f} s (the "
            f"hop {p50_one - wire['p50']:+.3f} s, the replica split "
            f"{p50 - p50_one:+.3f} s); every "
            f"move legal; launches {launches} ({per_genmove} a genmove, "
            f"{batches} evaluator batches); a fleet-wide swap to version "
            f"{target} converged in {conv_s:.3f} s; a game failed over "
            f"mid-drain (failovers {failovers}, retried genmoves {retried}; "
            f"the load's {rst['failovers']}), its next genmove legal; "
            f"replicas' "
            "requests.unhandled 0, no routed conversation answered an error")
        return dict(p50=p50, p99=p99, p50_one=p50_one, launches=launches,
                    per_genmove=per_genmove, conv_s=conv_s,
                    spillovers=rst["spillovers"], elapsed=load["elapsed_s"])
    finally:
        router.close()
        a.close()
        b.close()
        small.close()


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def read_line(proc, prefix: str, what: str) -> str:
    line = proc.stdout.readline()
    check(line.startswith(prefix),
          f"{what} said {line!r} (exit {proc.poll()})")
    return line


def stop_children(procs, timers) -> None:
    for t in timers:
        t.cancel()
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()


def fleet_clis(pygo, paths, second, work, card) -> dict:
    """(d) The CLIs as a user runs them: the gateway with ``--spill``, the
    router over it, ``gtp --connect`` through the router; a spill shows
    as the new version on ``/healthz``; SIGTERM, and each exits 0."""
    from rocalphago_tpu_torch.interface.gtp import vertex_to_move
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.training.actor import ParamsPublisher

    root = os.path.dirname(os.path.abspath(__file__))
    spill = os.path.join(work, "cli_spill")
    os.makedirs(spill, exist_ok=True)
    errs = [open(os.path.join(work, f"{n}.err"), "w")
            for n in ("gateway", "router", "bridge")]
    http = free_port()
    t0 = time.perf_counter()
    gwp = child_popen(
        [sys.executable, "-m", "rocalphago_tpu_torch.gateway.server",
         "--policy", paths["policy19"], "--value", paths["value19"],
         "--port", "0", "--http-port", str(http), "--playouts",
         str(CLI_PLAYOUTS), "--spill", spill],
        cwd=root, stdout=subprocess.PIPE, stderr=errs[0], text=True)
    procs, timers = [gwp], [threading.Timer(CLI_TIMEOUT_S, gwp.kill)]
    timers[0].start()
    try:
        line = read_line(gwp, "gateway: serving on 127.0.0.1:", "gateway CLI")
        gport = int(line.split(":")[2].split()[0])
        up_s = time.perf_counter() - t0
        rtp = child_popen(
            [sys.executable, "-m", "rocalphago_tpu_torch.rollout.router",
             "--replica", f"127.0.0.1:{gport}:{http}", "--port", "0",
             "--http-port", "0"],
            cwd=root, stdout=subprocess.PIPE, stderr=errs[1], text=True)
        procs.append(rtp)
        line = read_line(rtp, "router: serving on 127.0.0.1:", "router CLI")
        rport = int(line.split(":")[2].split()[0])
        bridge = child_popen(
            [sys.executable, "-m", "rocalphago_tpu_torch.interface.gtp",
             "--connect", f"127.0.0.1:{rport}"], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=errs[2],
            text=True)
        procs.append(bridge)
        timers += [threading.Timer(CLI_TIMEOUT_S, p.kill)
                   for p in (rtp, bridge)]
        for t in timers[1:]:
            t.start()
        st = pygo.GameState(size=SIZE, komi=7.5)
        replies = []

        def say(cmd: str) -> str:
            bridge.stdin.write(cmd + "\n")
            bridge.stdin.flush()
            reply = gtp_reply(bridge)
            replies.append(reply)
            check(reply.startswith("="), f"gtp via the router: {cmd} -> "
                  f"{reply!r}")
            return reply[1:].strip()

        for cmd in (f"boardsize {SIZE}", "clear_board", "komi 7.5"):
            say(cmd)
        for color in "bw":
            mv = vertex_to_move(say(f"genmove {color}"), SIZE)
            check(mv is not None and st.is_legal(mv),
                  f"gtp via the router genmove {color}: {replies[-1]}")
            st.do_move(mv)
        say("quit")
        check(bridge.wait(timeout=60) == 0,
              f"the GTP bridge exited {bridge.returncode}")
        _, body = http_get(http, "/healthz")
        before = json.loads(body)["serve"]["params"]["version"]
        pub = ParamsPublisher(spill_dir=spill)
        pub.publish(NeuralNetBase.load_model(second["policy19"]).module,
                    NeuralNetBase.load_model(second["value19"]).module)
        t1 = time.perf_counter()
        health = {}
        while time.perf_counter() - t1 < 60:
            status, body = http_get(http, "/healthz")
            health = json.loads(body)
            if health["serve"]["params"]["version"] > before:
                break
            time.sleep(0.1)
        seen_s = time.perf_counter() - t1
        check(status == 200 and health["serve"]["params"] == {
            "version": before + 1, "swaps": 1} and health["gateway"][
            "requests"]["unhandled"] == 0,
              f"/healthz after the spill: {health.get('serve')}")
        rcs = []
        t2 = time.perf_counter()
        for proc in (rtp, gwp):
            proc.send_signal(signal.SIGTERM)
            rcs.append(proc.wait(timeout=GATEWAY_DRAIN_S))
        stop_s = time.perf_counter() - t2
        check(rcs == [0, 0], f"router, gateway exits on SIGTERM: {rcs}")
    finally:
        stop_children(procs, timers)
        for f in errs:
            f.close()
    log(f"fleet CLIs [{card}]: the gateway CLI with --spill up in "
        f"{up_s:.1f} s, the router CLI over it, gtp --connect through the "
        f"router {replies} (every reply '=', every vertex legal); a spill "
        f"published -> /healthz serve.params {health['serve']['params']} "
        f"after {seen_s:.2f} s; SIGTERM -> router and gateway exit "
        f"{rcs} in {stop_s:.2f} s")
    return dict(up_s=up_s, seen_s=seen_s, stop_s=stop_s)


def fleet_replay(work, zero_paths, counters, card) -> dict:
    """(e) Replay over the wire: the service CLI; a ``--mode selfplay
    --board 19`` actor process on the card, then the same actor in this
    process (its launches counted); the zero CLI learning one iteration
    from the wire (``--replay-connect``, phase 18's specs); a synthetic
    actor SIGKILLed mid-run and restarted; the produced ids equal the
    ingested ids; the service drained and restarted recovers its buffer
    and dedup window."""
    from rocalphago_tpu_torch.replaynet import actor
    from rocalphago_tpu_torch.replaynet.actor import synth_games
    from rocalphago_tpu_torch.replaynet.client import ReplayClient
    from rocalphago_tpu_torch.runtime.jsonl import read_jsonl

    root = os.path.dirname(os.path.abspath(__file__))
    spill = os.path.join(work, "replay_spill")
    spools = [os.path.join(work, f"spool{i}") for i in range(3)]
    err = open(os.path.join(work, "replay.err"), "w")
    procs, timers = [], []

    def start(args, **kw):
        p = child_popen([sys.executable, "-m", *args], cwd=root,
                        stderr=err, text=True, **kw)
        procs.append(p)
        timers.append(threading.Timer(CLI_TIMEOUT_S, p.kill))
        timers[-1].start()
        return p

    def service():
        p = start(["rocalphago_tpu_torch.replaynet.server", "--port", "0",
                   "--spill-dir", spill, "--capacity", "32"],
                  stdout=subprocess.PIPE)
        line = p.stdout.readline()
        restored = 0
        if line.startswith("replaynet: restored"):
            restored = int(line.split()[2])
            line = p.stdout.readline()
        check(line.startswith("replaynet: serving on 127.0.0.1:"),
              f"the replay service CLI said {line!r}")
        return p, int(line.split(":")[2]), restored

    def run(args) -> float:
        t = time.perf_counter()
        p = start(args, stdout=subprocess.DEVNULL)
        check(p.wait(timeout=CLI_TIMEOUT_S) == 0,
              f"{args[0]} exited {p.returncode}")
        return time.perf_counter() - t

    t0 = time.perf_counter()
    try:
        svc, port, _ = service()
        addr = f"127.0.0.1:{port}"
        selfplay = ["--connect", addr, "--games", "1", "--mode", "selfplay",
                    "--board", str(SIZE), "--move-limit", str(WIRE_MOVES),
                    "--seed", str(SEED), "--device", "cuda"]
        sp_s = run(["rocalphago_tpu_torch.replaynet.actor", *selfplay,
                    "--spool-dir", spools[0], "--actor-id", "0"])
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            check(actor.main([*selfplay, "--spool-dir", spools[2],
                              "--actor-id", "2"]) == 0,
                  "the in-process self-play actor")
        torch.cuda.synchronize()
        actor_launches = serve_launches(counters)
        check(actor_launches["labels"] > 0 and actor_launches["tree"] > 0
              and actor_launches["chase"] == 0,
              f"a self-play actor's batch launched {actor_launches}")
        out = os.path.join(work, "zero_wire")
        zero_s = run(["rocalphago_tpu_torch.training.zero", *zero_paths, out,
                      "--game-batch", "2", "--move-limit", str(WIRE_MOVES),
                      "--sims", "4", "--iterations", "1", "--no-gating",
                      "--seed", str(SEED), "--replay-connect", addr])
        rows = read_jsonl(os.path.join(out, "metrics.jsonl"))
        (it,) = [r for r in rows if r["event"] == "iteration"]
        check(all(np.isfinite(it[k]) for k in ("policy_loss", "value_loss"))
              and os.path.exists(os.path.join(out,
                                              "policy.00001.flax.msgpack")),
              f"the zero CLI over the wire: {it}")
        argv = ["rocalphago_tpu_torch.replaynet.actor", "--connect", addr,
                "--spool-dir", spools[1], "--actor-id", "1", "--games",
                str(REPLAY_GAMES), "--seed", str(SEED)]
        victim = start(argv + ["--rate-s", "0.1"], stdout=subprocess.DEVNULL)
        with ReplayClient("127.0.0.1", port) as c:
            t_end = time.monotonic() + 120
            while c.stats()["ingest"]["puts"] < 2 + REPLAY_KILL_AFTER:
                check(victim.poll() is None and time.monotonic() < t_end,
                      "the synthetic actor ended before its kill")
                time.sleep(0.02)
        victim.kill()
        victim.wait()
        run(argv)
        with ReplayClient("127.0.0.1", port) as c:
            stats = c.stats()
        ids = []
        for sp in spools:
            with ReplayClient("127.0.0.1", port, spool_dir=sp) as c:
                check(c.spool_depth == 0, f"{sp} still spools")
                ids.append(c.produced_ids())
        produced = ids[0] | ids[1] | ids[2]
        svc.send_signal(signal.SIGTERM)
        check(svc.wait(timeout=GATEWAY_DRAIN_S) == 0,
              f"the replay service exited {svc.returncode} on SIGTERM")
        with open(os.path.join(spill, "dedup.json")) as f:
            ingested = set(json.load(f))
        check(produced == ingested and len(produced) == 2 + REPLAY_GAMES
              and stats["ingest"]["puts"] == 2 + REPLAY_GAMES
              and stats["takes"]["batches"] == 1
              and stats["requests"]["unhandled"] == 0,
              f"produced {len(produced)} ids, ingested {len(ingested)} "
              f"(equal: {produced == ingested}); service {stats['ingest']}, "
              f"takes {stats['takes']}, requests {stats['requests']}")
        svc2, port2, restored = service()
        with ReplayClient("127.0.0.1", port2) as c:
            c.put_games(synth_games(SEED, 1, 0), version=0)
            dup = c.dup_acks
            taken = set()
            while True:
                got = c.next_batch()
                if got is None:
                    break
                taken.add(got["record"]["game_id"])
            stats2 = c.stats()
        svc2.send_signal(signal.SIGTERM)
        check(svc2.wait(timeout=GATEWAY_DRAIN_S) == 0,
              f"the restarted service exited {svc2.returncode}")
        # the first self-play batch was learned; the in-process actor's
        # and the synthetic ones restore
        check(restored == REPLAY_GAMES + 1 and dup == 1
              and taken == ids[1] | ids[2] and len(ids[0]) == 1
              and stats2["ingest"]["puts"] == 0
              and stats2["requests"]["unhandled"] == 0,
              f"restart: restored {restored}, dup acks {dup}, taken "
              f"{len(taken)}, {stats2['ingest']}")
    finally:
        stop_children(procs, timers)
        err.close()
    wall = time.perf_counter() - t0
    log(f"replay over the wire [{card}]: the service CLI; a self-play actor "
        f"(--board {SIZE}, on the card) shipped its batch in {sp_s:.1f} s "
        f"with the process start, the same actor in process launched "
        f"{actor_launches} for its batch of 2 games; the zero CLI learned "
        f"iteration 1 from the "
        f"wire in {zero_s:.1f} s (policy loss {it['policy_loss']:.4f}, "
        f"value loss {it['value_loss']:.4f}); a synthetic actor SIGKILLed "
        f"after {REPLAY_KILL_AFTER} batches and restarted; produced ids = "
        f"ingested ids ({len(produced)}), {stats['ingest']}, "
        f"requests.unhandled 0; drained (exit 0) and restarted: restored "
        f"{restored} entries, a re-shipped batch acked dup, the "
        f"{len(taken)} restored batches taken; {wall:.1f} s")
    return dict(selfplay_s=sp_s, zero_s=zero_s, wall=wall,
                ingest_games=stats["ingest"]["games"],
                actor_launches=actor_launches)


def phase_fleet(pygo, torchgo, card, counters, serve, zero, gw21) -> dict:
    """Phase 22: the fleet, part 2 (see the module docstring)."""
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.serve.sessions import ServePool

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, FLEET_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths = serve["paths"]
    second = fleet_specs(work)
    policy = NeuralNetBase.load_model(paths["policy19"])
    value = NeuralNetBase.load_model(paths["value19"])
    pool = ServePool(value, policy, n_sim=SERVE_SIMS)
    try:
        pool.warm()
        out = dict(swap=fleet_swap(pygo, torchgo, pool, second, work, card))
        out["canary"] = fleet_canary(pygo, pool, second, card)
        out["router"] = fleet_router(pygo, pool, counters, card, gw21)
    finally:
        join_abandoned()
        pool.close()
    out["cli"] = fleet_clis(pygo, paths, second, work, card)
    out["replay"] = fleet_replay(work, zero["paths"], counters, card)
    out["launches"] = out["router"]["launches"]
    out["phase_s"] = time.perf_counter() - t0
    log(f"fleet phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------- data parallelism


def bg_start(cmd: list, log_path: str, stdin: str | None = None,
             term: bool = False):
    """Start ``cmd`` from the repository's root, its output into
    ``log_path``.out and .err (children run at once fill no pipe), and
    ``stdin``, if given, from ``log_path``.in; ``(process, log path,
    start time)``. The child gets a SIGKILL when this script ends
    however it ends (a SIGTERM with ``term``: a launcher then stops its
    workers, which run in sessions of their own)."""
    parent = os.getpid()
    sig = signal.SIGTERM if term else signal.SIGKILL

    def pre():
        _PRCTL(_PR_SET_PDEATHSIG, sig)
        if os.getppid() != parent:
            os._exit(1)

    if stdin is not None:
        with open(log_path + ".in", "w") as f:
            f.write(stdin)
    with open(log_path + ".out", "w") as out, \
            open(log_path + ".err", "w") as err, \
            open(log_path + ".in" if stdin is not None else os.devnull) as i:
        p = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
            __file__)), stdin=i, stdout=out, stderr=err, preexec_fn=pre)
    return p, log_path, time.perf_counter()


def bg_wait(started, timeout: float = CLI_TIMEOUT_S):
    """``(rc, stdout, stderr, seconds)`` of a :func:`bg_start`ed child;
    at the time limit, or on an error here, it gets a SIGTERM."""
    p, log_path, t0 = started
    try:
        p.wait(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
    except BaseException:
        p.terminate()
        p.wait(timeout=120)
        raise
    finally:
        texts = []
        for ext in (".out", ".err"):
            with open(log_path + ext) as f:
                texts.append(f.read())
    if p.returncode is None:
        raise SmokeFailure(f"{log_path}: the child did not end")
    return p.returncode, texts[0], texts[1], time.perf_counter() - t0


def bg_stop(started) -> None:
    """Stop whatever of ``started`` (:func:`bg_start` tuples) still
    runs."""
    for p, _, _ in started:
        if p.poll() is None:
            p.terminate()
            p.wait(timeout=120)


def torchrun_start(args: list, log_path: str):
    """:func:`bg_start` of ``python -m torch.distributed.run --standalone
    --nproc-per-node PAR_RANKS ARGS``."""
    return bg_start([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", f"--nproc-per-node={PAR_RANKS}", *args],
                    log_path, term=True)


def rank_backends(err: str) -> dict:
    """``{rank: (backend, why)}`` from the ranks' ``distributed_init``
    lines."""
    return {int(r): (b, why) for r, b, why in re.findall(
        rf"^parallel: rank (\d+) of {PAR_RANKS}, backend (\w+) \((.*)\)$",
        err, re.M)}


def update_l2(got: dict, want: dict, start: dict) -> float:
    """The relative L2 distance between two updates from ``start`` over
    every parameter of the net (a net no update moved must stay put in
    both). Per tensor it would be noise where a gradient is zero but for
    rounding: the policy head's bias, whose softmax residuals cancel."""
    diff = want_sq = 0.0
    for k, p0 in start.items():
        d_want = want[k].double() - p0.double()
        d_got = got[k].double() - p0.double()
        diff += float(((d_got - d_want) ** 2).sum())
        want_sq += float((d_want ** 2).sum())
    if want_sq == 0.0:
        check(diff == 0.0, "a net moved in one run only")
        return 0.0
    return (diff / want_sq) ** 0.5


def host_state(module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items()}


def split_step(spec: str, corpus: str, start: dict) -> tuple:
    """The SL CLI's first step (its batch, draws and rate) computed in
    this process twice: as two ranks compute it (the two halves of the
    minibatch forward and backward apart, each over the global valid
    count, the gradients summed) and as one rank does (the whole
    minibatch at once); the params after each."""
    import torch.nn.functional as F

    from rocalphago_tpu_torch.data.pipeline import (
        ShardedDataset,
        batch_iterator,
        split_indices,
    )
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.training import sl
    from rocalphago_tpu_torch.training.symmetries import (
        draw_elements,
        random_transform_batch,
    )

    dev = torch.device("cuda", 0)
    ds = ShardedDataset(corpus)
    train = split_indices(len(ds), (0.98, 0.01, 0.01), seed=SEED)[0]
    planes, actions = (torch.from_numpy(x).to(dev) for x in next(
        batch_iterator(ds, train, PAR_MINIBATCH, np.random.default_rng(
            np.random.SeedSequence([SEED, 0])), epochs=1)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    planes, actions = random_transform_batch(
        None, planes.float(), actions, SIZE,
        t=draw_elements(gen, PAR_MINIBATCH, dev))
    n = SIZE * SIZE
    count = (actions < n).float().sum().clamp(min=1.0)
    out = []
    for parts in (PAR_RANKS, 1):
        net = NeuralNetBase.load_model(spec, device=dev)
        net.module.load_state_dict(start)
        opt, lr_at = sl.make_optimizer(sl.SLConfig(),
                                       net.module.parameters())
        opt.zero_grad(set_to_none=True)
        rows_a = PAR_MINIBATCH // parts
        for r in range(parts):
            rows = slice(r * rows_a, (r + 1) * rows_a)
            logits = net.module(planes[rows])
            valid = (actions[rows] < n).float()
            xent = F.cross_entropy(logits, actions[rows].clamp(
                max=n - 1).long(), reduction="none")
            ((xent * valid).sum() / count).backward()
        sl.apply_update(opt, lr_at(0))
        out.append(host_state(net.module))
    return tuple(out)


def par_sl_argv(spec: str, corpus: str, out: str) -> list:
    """Phase 23's SL command line (a 1% validation and test split: the
    evaluations stay short; a checkpoint every step)."""
    return [spec, corpus, out, "--minibatch", str(PAR_MINIBATCH), "--epochs",
            "1", "--epoch-length", str(PAR_STEPS), "--train-val-test",
            "0.98", "0.01", "0.01", "--save-every", "1", "--seed", str(SEED)]


def par_sl(work: str, spec: str, corpus: str, ran) -> dict:
    """(a) The SL trainer's CLI over two ranks sharing the card against
    one rank: the same global minibatch, steps and draws. The first
    step equals the same two halves computed in this process
    (:func:`split_step`) within ``PAR_SPLIT_L2``; against one rank's
    whole-minibatch run the updates are within ``PAR_UPDATE_L2`` (bf16:
    cuDNN computes 16 rows and 32 with other algorithms) and the train
    loss within ``PAR_LOSS_RTOL``; the artifacts are rank 0's alone.
    ``ran`` is the two-rank run's :func:`bg_wait`."""
    from rocalphago_tpu_torch.models import NeuralNetBase
    from rocalphago_tpu_torch.training import sl

    two, one = os.path.join(work, "sl_two"), os.path.join(work, "sl_one")
    rc, _, err, wall_two = ran
    check(rc == 0, f"sl over {PAR_RANKS} ranks: rc {rc}\n{err[-4000:]}")
    backends = rank_backends(err)
    check(sorted(backends) == list(range(PAR_RANKS)) and all(
        b == "gloo" for b, _ in backends.values()),
        f"sl ranks: backends {backends}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        sl.run_training(par_sl_argv(spec, corpus, one))
    wall_one = time.perf_counter() - t0
    start = host_state(NeuralNetBase.load_model(spec, device="cpu").module)
    first = final_params(two, 1)
    split, whole = split_step(spec, corpus, start)
    l2_split = update_l2(first, split, start)
    floor = update_l2(split, whole, start)
    check(l2_split <= PAR_SPLIT_L2, f"sl: two ranks' first update "
          f"{l2_split:.3e} from the same halves in one process (limit "
          f"{PAR_SPLIT_L2})")
    l2 = update_l2(first, final_params(one, 1), start)
    l2_all = update_l2(final_params(two, PAR_STEPS),
                       final_params(one, PAR_STEPS), start)
    check(max(l2, l2_all) <= PAR_UPDATE_L2, f"sl: two ranks' updates "
          f"{l2:.3e}, {l2_all:.3e} from one rank's (limit {PAR_UPDATE_L2})")
    rows = {}
    for name, out in (("two", two), ("one", one)):
        rows[name] = [e for e in run_events(out) if e["event"] == "epoch"]
        check(len(rows[name]) == 1, f"sl {name}: {len(rows[name])} epoch "
              "records (rank 1 writes none)")
        for f in ("model.json", "metadata.json", "shuffle.npz",
                  "weights.00000.flax.msgpack"):
            check(os.path.exists(os.path.join(out, f)), f"sl {name}: no {f}")
    loss2, loss1 = rows["two"][0]["train_loss"], rows["one"][0]["train_loss"]
    check(abs(loss2 - loss1) <= PAR_LOSS_RTOL * abs(loss1),
          f"sl: train loss {loss2} over two ranks, {loss1} over one")
    log(f"parallel sl: {PAR_STEPS} steps at global minibatch "
        f"{PAR_MINIBATCH} of the 19x19 12x128 bf16 policy; two ranks "
        f"sharing the card, backends " + ", ".join(
            f"rank {r} {b} ({why})" for r, (b, why) in sorted(
                backends.items())) +
        f"; the first update's relative L2 {l2_split:.3e} against the same "
        f"halves in one process (limit {PAR_SPLIT_L2}), {l2:.3e} against "
        f"one rank's whole minibatch (in one process the halves lie "
        f"{floor:.3e} from the whole: bf16), after {PAR_STEPS} steps "
        f"{l2_all:.3e} (limit {PAR_UPDATE_L2}); "
        f"train loss {loss2:.6f} vs {loss1:.6f}; CLI "
        f"wall {wall_two:.1f} s (two ranks, launcher included) vs "
        f"{wall_one:.1f} s (one rank, in process)")
    return {"update_l2": l2, "update_l2_all": l2_all, "split_l2": l2_split,
            "bf16_floor": floor,
            "loss": (loss2, loss1), "walls": (wall_two, wall_one)}


def record_first_play(path: str):
    """Hook ``ZeroIteration.play``, as phase 18 hooks the checkpointer:
    the first play's record (actions, live rows, visits, winners),
    gathered over the ranks, goes to ``path`` from rank 0. Returns the
    undo."""
    from rocalphago_tpu_torch.training import zero

    real = zero.ZeroIteration.play
    done = []

    def play(self, *a, **kw):
        games = real(self, *a, **kw)
        if not done:
            done.append(path)
            rec = {}
            for k, axis in (("actions", 1), ("live", 1), ("visits", 1),
                            ("winners", 0)):
                x = getattr(games, k)
                rec[k] = (x if self.mesh is None
                          else self.mesh.gather(x, axis)).cpu()
            if self.mesh is None or self.mesh.rank == 0:
                torch.save(rec, path)
        return games

    zero.ZeroIteration.play = play
    return lambda: setattr(zero.ZeroIteration, "play", real)


def zero_ranks_main(record: str, argv: list) -> int:
    """``--zero-ranks RECORD ARGV...``: one rank of phase 23's zero run
    under ``torch.distributed.run``, the zero CLI's entry
    (``zero.run_training``) on ARGV with its first play's record
    written to RECORD (:func:`record_first_play`)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rocalphago_tpu_torch.training import zero

    record_first_play(record)
    zero.run_training(argv)
    return 0


def par_zero_cli(work: str, paths, straight: str, record: str,
                 ran) -> dict:
    """(b) The zero CLI at ``--num-devices 2`` over two ranks
    (``zero_argv(paths, work/zero_two, 1, "--num-devices", "2")``, its
    :func:`bg_wait` ``ran``) against phase 18's one-rank run of the same
    command but the width: the first play's record (``record``, from
    phase 18's killed run, whose first iteration is the straight run's)
    bit for bit, the game statistics equal, the updates within
    ``PAR_ZERO_L2``, every rank launching the three kernels."""
    from rocalphago_tpu_torch.models import NeuralNetBase

    two = os.path.join(work, "zero_two")
    rc, _, err, wall = ran
    check(rc == 0, f"zero over {PAR_RANKS} ranks: rc {rc}\n{err[-4000:]}")
    # each rank's line: the launches its registry counted (every entry's
    # series and the untracked rest), then its wrappers' process totals
    lines = {int(r): (json.loads(reg), json.loads(proc))
             for r, reg, proc in re.findall(
                 rf"zero: rank (\d+) of {PAR_RANKS} on \S+ \(\w+\): kernel "
                 r"launches (\{[^}]*\}) process (\{[^}]*\})", err)}
    launches = {r: reg for r, (reg, _) in lines.items()}
    check(sorted(launches) == list(range(PAR_RANKS)) and all(
        n > 0 for per in launches.values() for n in per.values())
        and all(reg == proc for reg, proc in lines.values()),
        f"zero ranks' launches, registry and process: {lines}")
    got = torch.load(os.path.join(work, "zero_two_play.pt"),
                     weights_only=True)
    want = torch.load(record, weights_only=True)
    for k in ("actions", "winners", "live", "visits"):
        check(torch.equal(got[k], want[k]), f"zero play over two ranks: "
              f"{k} differ from one rank's")
    art = zero_artifacts(two, 1)
    one = zero_artifacts(straight, 1)
    rows = [[r for r in x[1] if r["event"] == "iteration"][0]
            for x in (art, one)]
    for k in ("black_win_rate", "draw_rate", "mean_moves", "finished_rate"):
        check(rows[0][k] == rows[1][k], f"zero: {k} {rows[0][k]} over two "
              f"ranks, {rows[1][k]} over one")
    l2 = {}
    for name, path in zip(("policy", "value"), paths):
        l2[name] = update_l2(art[0][name], one[0][name], host_state(
            NeuralNetBase.load_model(path, device="cpu").module))
        check(l2[name] <= PAR_ZERO_L2, f"zero {name}: update {l2[name]:.3e}"
              f" from one rank's (limit {PAR_ZERO_L2})")
    check(len(run_events(two)) and os.path.exists(
        os.path.join(two, "policy.json")), "zero two ranks: no artifacts")
    log(f"parallel zero CLI: one iteration at game batch {ZERO_BATCH} "
        f"({ZERO_BATCH // PAR_RANKS} a rank), {ZERO_SIMS} simulations, move "
        f"limit {ZERO_MOVES}: the first play's actions, live rows, visits "
        f"and winners bit for bit phase 18's one-rank run's, the game "
        f"statistics equal (mean moves {rows[0]['mean_moves']}, finished "
        f"{rows[0]['finished_rate']}); update relative L2 policy "
        f"{l2['policy']:.3e}, value {l2['value']:.3e} (limit "
        f"{PAR_ZERO_L2}" + ("; no game ended, so the value net moved in "
                            "neither run" if not rows[1]["finished_rate"]
                            else "") + "); launches per rank, from its "
        "registry's kernel_launches_total and equal to its process totals: "
        + ", ".join(f"rank {r} {per}" for r, per in sorted(launches.items()))
        + f"; {wall:.1f} s")
    return {"launches": launches, "update_l2": l2, "wall": wall}


def par_sp_argv(spec: str, out: str) -> list:
    """Phase 23's self-play command line (``--shard`` added for two
    ranks)."""
    return ["--policy", spec, "--games", str(PAR_SP_GAMES), "--max-moves",
            str(PAR_SP_MOVES), "--chunk", str(PAR_SP_CHUNK), "--seed",
            str(SEED), "--out", out]


def par_selfplay(work: str, spec: str, counters, ran) -> dict:
    """(c) The self-play CLI with ``--shard`` over two ranks (its
    :func:`bg_wait` ``ran``) against one rank: every SGF byte for
    byte (moves, results), the same summary counts."""
    from rocalphago_tpu_torch.interface import selfplay_cli

    two, one = os.path.join(work, "sp_two"), os.path.join(work, "sp_one")
    rc, _, err, wall = ran
    check(rc == 0, f"self-play --shard: rc {rc}\n{err[-4000:]}")
    for c in counters:
        c.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        summary = selfplay_cli.main(par_sp_argv(spec, one))
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    names = sorted(os.listdir(one))
    check(sorted(os.listdir(two)) == names, "self-play --shard: other files")
    sgfs = [n for n in names if n.endswith(".sgf")]
    check(len(sgfs) == PAR_SP_GAMES, f"{len(sgfs)} SGFs")
    for n in sgfs:
        with open(os.path.join(one, n), "rb") as a, \
                open(os.path.join(two, n), "rb") as b:
            check(a.read() == b.read(), f"self-play --shard: {n} differs")
    with open(os.path.join(two, "summary.json")) as f:
        shard = json.load(f)
    keys = ("games", "black_wins", "white_wins", "draws", "mean_moves")
    check({k: shard[k] for k in keys} == {k: summary[k] for k in keys},
          f"self-play --shard summary {shard} vs {summary}")
    log(f"parallel self-play --shard: {PAR_SP_GAMES} 19x19 games "
        f"({PAR_SP_GAMES // PAR_RANKS} a rank), up to {PAR_SP_MOVES} plies: "
        f"every SGF byte-equal to one rank's, mean moves "
        f"{summary['mean_moves']}; {wall:.1f} s over two ranks; one-rank "
        f"launches {launches}")
    return {"launches": launches, "wall": wall}


def sl_step_timing(dev, mesh=None, batch: int = PAR_MINIBATCH) -> dict:
    """The SL train step of the flagship policy on ``mesh``'s rows of a
    seeded global minibatch: host ms a step, synchronised (both ranks
    step in lockstep: the gradient all-reduce waits for both), the
    gradient all-reduce alone, and the card memory this rank
    allocated at most."""
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.parallel import mesh as meshlib
    from rocalphago_tpu_torch.training import sl

    torch.cuda.reset_peak_memory_stats(dev)
    net = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                    seed=SEED + 42, device=dev)
    module = net.module
    opt, lr_at = sl.make_optimizer(sl.SLConfig(), module.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = sl.TrainState(module, opt, gen)
    step = sl.make_train_step(module, opt, lr_at, SIZE, True, mesh=mesh)
    rng = np.random.default_rng(SEED + 60)
    planes = (rng.random((batch, SIZE, SIZE, 48)) < 0.2).astype(np.uint8)
    actions = rng.integers(0, SIZE * SIZE, batch).astype(np.int32)
    planes, actions = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                       for x in meshlib.shard_batch(mesh, (planes, actions)))
    out = {"step_ms": wall_ms(lambda: step(state, planes, actions),
                              PAR_TIMED_STEPS),
           "local_batch": int(planes.shape[0])}
    out["allreduce_ms"] = (wall_ms(lambda: mesh.all_reduce_grads([module]),
                                   PAR_TIMED_STEPS)
                           if mesh is not None else 0.0)
    out["grad_bytes"] = 4 * sum(p.numel() for p in module.parameters())
    out["max_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def nccl_probe(dev, group) -> dict:
    """A one-rank NCCL group on the card: an all_reduce, a broadcast,
    one SL step through it (equal to the step without it, bit for bit),
    and the step and the gradient all-reduce timed through it beside the
    step with no group."""
    import torch.distributed as dist

    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.parallel import mesh as meshlib
    from rocalphago_tpu_torch.training import sl

    mesh = meshlib.Mesh(1, 0, dev, group=group)
    x = torch.arange(6, dtype=torch.float32, device=dev)
    ok = torch.equal(mesh.all_reduce(x.clone()), x) and torch.equal(
        mesh.broadcast(x.clone()), x)
    params = []
    for m in (mesh, None):
        net = CNNPolicy(board=SIZE, layers=12, filters_per_layer=128,
                        seed=SEED + 42, device=dev)
        opt, lr_at = sl.make_optimizer(sl.SLConfig(),
                                       net.module.parameters())
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        state = sl.TrainState(net.module, opt, gen)
        rng = np.random.default_rng(SEED + 61)
        planes = torch.as_tensor(rng.random((16, SIZE, SIZE, 48)) < 0.2,
                                 dtype=torch.uint8, device=dev)
        actions = torch.as_tensor(rng.integers(0, SIZE * SIZE, 16),
                                  dtype=torch.int32, device=dev)
        sl.make_train_step(net.module, opt, lr_at, SIZE, True,
                           mesh=m)(state, planes, actions)
        params.append(host_state(net.module))
    same = all(torch.equal(params[0][k], v) for k, v in params[1].items())
    timed = sl_step_timing(dev, mesh)
    plain = sl_step_timing(dev, None)
    return {"backend": dist.get_backend(group), "collectives_ok": ok,
            "step_equal": same, "step_ms": timed["step_ms"],
            "allreduce_ms": timed["allreduce_ms"],
            "plain_step_ms": plain["step_ms"],
            "plain_max_memory_bytes": plain["max_memory_bytes"]}


def ranks_probe(out_dir: str, go: str) -> int:
    """``--ranks-probe DIR GO``, one rank of phase 23's probe under
    ``torch.distributed.run``: the three kernels against their plain
    versions in this rank; then, once the file GO exists (the CLI runs
    that share the card meanwhile have ended), the SL step timed with
    its all-reduce, and on rank 0 a one-rank NCCL group
    (:func:`nccl_probe`); writes ``DIR/rank<r>.json``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from rocalphago_tpu_torch.engine import pygo, torchgo
    from rocalphago_tpu_torch.parallel import mesh as meshlib

    backend = meshlib.distributed_init()
    mesh = meshlib.make_mesh()
    dev = mesh.device
    os.makedirs(out_dir, exist_ok=True)
    res = {"rank": mesh.rank, "width": mesh.width, "backend": backend,
           "device": str(dev)}
    with open(os.path.join(out_dir, f"rank{mesh.rank}.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        res["max_abs_err"] = {
            "tree": float(phase_tree(dev)),
            "labels": float(phase_labels(pygo, dev)),
            "chase": float(phase_chase(pygo, torchgo, dev))}
    deadline = time.monotonic() + PAR_TIMEOUT_S
    while not os.path.exists(go):
        check(time.monotonic() < deadline, "the probe's go file never came")
        time.sleep(0.2)
    mesh.barrier()
    res["sl"] = sl_step_timing(dev, mesh)
    group = dist.new_group([0], backend="nccl")
    if mesh.rank == 0:
        res["nccl"] = nccl_probe(dev, group)
    mesh.barrier()
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def par_probe(work: str, ran) -> dict:
    """(d) and the numbers: the :func:`ranks_probe` over two ranks (its
    :func:`bg_wait` ``ran``)."""
    probe = os.path.join(work, "probe")
    rc, _, err, wall = ran
    check(rc == 0, f"ranks probe: rc {rc}\n{err[-4000:]}")
    ranks = []
    for r in range(PAR_RANKS):
        with open(os.path.join(probe, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for res in ranks:
        check(res["backend"] == "gloo" and res["width"] == PAR_RANKS,
              f"probe rank {res['rank']}: {res['backend']}, width "
              f"{res['width']}")
        check(all(e == 0 for e in res["max_abs_err"].values()),
              f"probe rank {res['rank']}: a kernel disagrees with its plain "
              f"version {res['max_abs_err']}")
    nccl = ranks[0]["nccl"]
    check(nccl["backend"] == "nccl" and nccl["collectives_ok"]
          and nccl["step_equal"], f"one-rank NCCL group: {nccl}")
    sl2, mib = ranks[0]["sl"], 2.0 ** 20
    log(f"parallel probe ({wall:.1f} s, the kernel checks beside the CLI "
        f"runs, the timings after them): the three kernels bit-exact "
        f"against their plain versions in each rank")
    log(f"parallel SL step of the 19x19 12x128 bf16 policy at global "
        f"minibatch {PAR_MINIBATCH}: one rank {nccl['plain_step_ms']:.2f} "
        f"ms ({nccl['plain_max_memory_bytes'] / mib:.0f} MiB); two ranks "
        f"sharing the card (gloo) " + ", ".join(
            f"rank {x['rank']} {x['sl']['step_ms']:.2f} ms with its "
            f"all-reduce of {x['sl']['grad_bytes'] / mib:.2f} MiB "
            f"{x['sl']['allreduce_ms']:.2f} ms "
            f"({x['sl']['allreduce_ms'] / x['sl']['step_ms']:.3f} of a "
            f"step), {x['sl']['max_memory_bytes'] / mib:.0f} MiB"
            for x in ranks) + f"; a one-rank NCCL group: step "
        f"{nccl['step_ms']:.2f} ms, all-reduce {nccl['allreduce_ms']:.3f} ms "
        f"({nccl['allreduce_ms'] / nccl['step_ms']:.4f} of a step); two "
        f"ranks on one card measure overhead, not scaling")
    return {"ranks": ranks, "wall": wall, "sl": sl2, "nccl": nccl}


def phase_parallel(card, counters, sl_paths, zero_paths, zero_straight,
                   zero_record):
    """Data parallelism over ranks (phase 23): two ranks sharing the
    card, started by ``torch.distributed.run`` on the port's CLIs."""
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, PAR_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    spec, corpus = sl_paths
    go = os.path.join(work, "probe.go")
    # the three CLI runs and the probe's kernel checks at once (their
    # checks are timing-free); the probe's timings alone after them
    cmds = {
        "sl": ["-m", "rocalphago_tpu_torch.training.sl",
               *par_sl_argv(spec, corpus, os.path.join(work, "sl_two")),
               "--num-devices", str(PAR_RANKS)],
        "zero": [os.path.abspath(__file__), "--zero-ranks",
                 os.path.join(work, "zero_two_play.pt"),
                 *zero_argv(zero_paths, os.path.join(work, "zero_two"), 1,
                            "--num-devices", str(PAR_RANKS))],
        "selfplay": ["-m", "rocalphago_tpu_torch.interface.selfplay_cli",
                     *par_sp_argv(spec, os.path.join(work, "sp_two")),
                     "--shard"],
        "probe": [os.path.abspath(__file__), "--ranks-probe",
                  os.path.join(work, "probe"), go]}
    started, ran = {}, {}
    try:
        for name, args in cmds.items():
            started[name] = torchrun_start(
                args, os.path.join(work, f"{name}_run"))
        for name in ("sl", "zero", "selfplay"):
            ran[name] = bg_wait(started[name], PAR_TIMEOUT_S)
        log(f"parallel: the three CLI runs over {PAR_RANKS} ranks at once "
            f"in {time.perf_counter() - t0:.1f} s")
        with open(go, "w"):
            pass
        ran["probe"] = bg_wait(started["probe"], PAR_TIMEOUT_S)
    finally:
        bg_stop(started.values())
    out = {"sl": par_sl(work, spec, corpus, ran["sl"])}
    out["zero"] = par_zero_cli(work, zero_paths, zero_straight, zero_record,
                               ran["zero"])
    out["selfplay"] = par_selfplay(work, spec, counters[:2], ran["selfplay"])
    out["probe"] = par_probe(work, ran["probe"])
    out["phase_s"] = time.perf_counter() - t0
    launches = {k: sum(per[k] for per in out["zero"]["launches"].values())
                for k in ("labels", "chase", "tree")}
    for k, n in out["selfplay"]["launches"].items():
        launches[k] += n
    out["launches"] = launches
    log(f"parallel phase: {out['phase_s']:.1f} s on {card}")
    return out


def host_reads_main(root: str) -> int:
    """``--host-reads ROOT``: the port found in ROOT (a checkout, such as
    a ``git archive`` of an earlier commit) builds its kernels and
    counts one zero iteration's host reads (:func:`zero_host_reads`)
    in ``ROOT/build/host_reads``; prints them as JSON."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    try:
        from rocalphago_tpu_torch.engine import torchgo
        from rocalphago_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: no port in {root}: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.KERNELS.build_all()
    work = os.path.join(root, "build", "host_reads")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    hr = zero_host_reads(torchgo, dev, zero_specs(work))
    print(json.dumps({"root": root, "port": os.path.dirname(
        torchgo.__file__), **hr}))
    return 0


def epilogue_at(E, dev, g, shape, dtype) -> dict:
    """The convolution epilogue's kernel at one channels_last shape and
    type, with a random nonzero float32 bias: its forward and ``gz`` bit
    for bit the plain versions', its float32 bias gradient within
    ``EPI_SUM_RTOL`` of the float64 sum (of each channel's absolute
    sum); card ms of each direction beside its bytes bound and the plain
    version's ms."""
    cl = torch.channels_last
    z = torch.randn(shape, generator=g, device=dev).to(dtype).contiguous(
        memory_format=cl)
    b = torch.randn(shape[1], generator=g, device=dev) * 0.5
    gy = (torch.randn(shape, generator=g, device=dev) + 0.5).to(
        dtype).contiguous(memory_format=cl)
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
    where = f"{'x'.join(map(str, shape))} {dtype}"
    y = E.bias_relu_(z.clone(), b)
    check(torch.equal(y.view(as_int), E.bias_relu_plain(z.clone(), b).view(
        as_int)), f"conv_epilogue forward differs from the plain version "
        f"at {where}")
    gz, gb = E.bias_relu_backward(gy, y)
    pgz, _ = E.bias_relu_backward_plain(gy, y)
    check(torch.equal(gz.view(as_int), pgz.view(as_int)),
          f"conv_epilogue: gz differs from threshold_backward's at {where}")
    exact = pgz.double().sum(dim=(0, 2, 3))
    scale = pgz.double().abs().sum(dim=(0, 2, 3))
    err = float(((gb.double() - exact).abs() / scale).max())
    check(err <= EPI_SUM_RTOL, f"conv_epilogue bias gradient at {where}: "
          f"{err:.3g} of the absolute sum off the float64 sum (limit "
          f"{EPI_SUM_RTOL})")
    out = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
           "sum_err": err, "plain_sum_err": float((
               (pgz.sum(dim=(0, 2, 3)).double() - exact).abs()
               / scale).max()), "gy": gy, "y": y}
    act = z.numel() * z.element_size()
    work = z.clone()
    for name, fn, plain_fn, moved in (
            ("forward", lambda: E.bias_relu_(work, b),
             lambda: E.bias_relu_plain(work, b), 2 * act),
            ("backward", lambda: E.bias_relu_backward(gy, y),
             lambda: E.bias_relu_backward_plain(gy, y), 3 * act)):
        ms, plain_ms, (bound_ms, by) = kernel_row(fn, plain_fn, moved, 0,
                                                  reps=50)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": by}
    return out


def phase_conv_epilogue(dev, card) -> list:
    """Phase 24: the kernel rows of the trunk convolutions' epilogue
    (forward, backward) at the SL benchmark cell's shape, each with the
    same reading at the shapes of the smoke's own paths."""
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.ops import conv_epilogue as E
    from rocalphago_tpu_torch.training import sl

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 240)
    cell = epilogue_at(E, dev, g, EPI_SHAPE, torch.bfloat16)
    gy, y = cell.pop("gy"), cell.pop("y")
    rows = []
    for name in ("forward", "backward"):
        rows.append({"name": f"conv_epilogue.{name}", "route": "cuda",
                     "source": "rocalphago_tpu_torch/csrc/conv_epilogue.cu",
                     "replaces": "none (XLA fuses the bias and ReLU into "
                     "the convolution)", **cell[name], "library_ms": None,
                     "max_abs_err": 0.0, "paths": []})
    rows[1]["library_ms"] = cuda_ms(lambda: torch.ops.aten.threshold_backward(
        gy, y, 0).sum(dim=(0, 2, 3)), 20)
    rows[1]["max_abs_err"] = cell["sum_err"]
    del gy, y
    # the shapes the smoke's other phases run the kernel at: the 12 x 128
    # nets of the GTP sessions (batch 1), search (8) and self-play (256)
    for batch in EPI_PATH_BATCHES:
        for dtype in (torch.bfloat16, torch.float32):
            at = epilogue_at(E, dev, g, (batch, EPI_PATH_FILTERS,
                                         EPI_SHAPE[2], EPI_SHAPE[3]), dtype)
            del at["gy"], at["y"]
            for r in rows:
                r["paths"].append({
                    "shape": at["shape"], "dtype": at["dtype"],
                    **at[r["name"].split(".")[1]]})
            rows[1]["paths"][-1]["sum_err"] = at["sum_err"]
            rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                         at["sum_err"])
            log(f"conv_epilogue at {'x'.join(map(str, at['shape']))} "
                f"{at['dtype']}: forward {at['forward']['ms']:.4f} ms "
                f"(bound {at['forward']['bound_ms']:.4f}, plain "
                f"{at['forward']['plain_ms']:.4f}), backward "
                f"{at['backward']['ms']:.4f} ms (bound "
                f"{at['backward']['bound_ms']:.4f}, plain "
                f"{at['backward']['plain_ms']:.4f}); bias gradient "
                f"{at['sum_err']:.3g} off float64 (plain "
                f"{at['plain_sum_err']:.3g})")
    # one SL step of the cell's net
    net = CNNPolicy(board=EPI_SHAPE[2], layers=EPI_LAYERS,
                    filters_per_layer=EPI_SHAPE[1], head="bias", seed=SEED,
                    device=dev)
    opt, lr_at = sl.make_optimizer(sl.SLConfig(learning_rate=0.003),
                                   net.module.parameters())
    step = sl.make_train_step(net.module, opt, lr_at, EPI_SHAPE[2], True)
    state = sl.TrainState(net.module, opt, g)
    planes = torch.randint(0, 2, (EPI_SHAPE[0], EPI_SHAPE[2], EPI_SHAPE[3],
                                  48), generator=g, device=dev,
                           dtype=torch.uint8)
    actions = torch.randint(0, 361, (EPI_SHAPE[0],), generator=g, device=dev,
                            dtype=torch.int32)
    step(state, planes, actions)
    before = E.launches
    step(state, planes, actions)
    torch.cuda.synchronize()
    per_step = E.launches - before
    convs = EPI_LAYERS - 1
    check(per_step == 3 * convs, f"conv_epilogue: {per_step} launches an SL "
          f"step of a {EPI_LAYERS}-layer net (want {3 * convs})")
    for r in rows:
        r["launches"] = per_step // 3 * (1 if r["name"].endswith(
            "forward") else 2)
    log(f"conv_epilogue at {'x'.join(map(str, EPI_SHAPE))} bf16 "
        f"channels_last: forward {rows[0]['ms']:.4f} ms (bound "
        f"{rows[0]['bound_ms']:.4f}, plain {rows[0]['plain_ms']:.4f}), "
        f"backward {rows[1]['ms']:.4f} ms (bound {rows[1]['bound_ms']:.4f}, "
        f"plain {rows[1]['plain_ms']:.4f}, bf16 reduction path "
        f"{rows[1]['library_ms']:.4f}); bias gradient {cell['sum_err']:.3g} "
        f"of the absolute sum off float64 (bf16 reduction "
        f"{cell['plain_sum_err']:.3g}); "
        f"{per_step} launches an SL step on {card}")
    return rows


def conv_epilogue_main() -> int:
    """Phases 1 and 24 alone; prints their kernel rows."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_card()
    rows = phase_conv_epilogue(dev, card)
    print(card)
    print(json.dumps({"kernels": rows}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--host-reads":
        return host_reads_main(sys.argv[2])
    if len(sys.argv) == 4 and sys.argv[1] == "--ranks-probe":
        return ranks_probe(*sys.argv[2:])
    if len(sys.argv) > 3 and sys.argv[1] == "--zero-ranks":
        return zero_ranks_main(sys.argv[2], sys.argv[3:])
    if sys.argv[1:] == ["--conv-epilogue"]:
        return conv_epilogue_main()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from rocalphago_tpu_torch.engine import pygo, torchgo
        from rocalphago_tpu_torch.ops import chase as C
        from rocalphago_tpu_torch.ops import labels as L
        from rocalphago_tpu_torch.ops import tree as T
        from rocalphago_tpu_torch.search.players import build_player
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def on_term(signum, frame):
        # a SIGTERM unwinds the phase under way, so its ``finally``
        # blocks stop what it started (its children also die with this
        # process)
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, on_term)
    t0 = time.monotonic()
    walls = {}

    def phase(n: int, fn, *args):
        """Run phase ``n`` and log its wall time."""
        t = time.monotonic()
        out = fn(*args)
        walls[n] = time.monotonic() - t
        log(f"phase {n} ({fn.__name__}): {walls[n]:.1f} s")
        return out

    card = phase(1, phase_card)
    err = {"tree": phase(2, phase_tree, dev),
           "labels": phase(3, phase_labels, pygo, dev),
           "chase": phase(4, phase_chase, pygo, torchgo, dev)}
    phase(5, phase_encode, pygo, torchgo, dev)
    phase(6, phase_forward, torchgo, dev)
    greedy_launches, p50 = phase(7, phase_gtp, dev, (L, C))
    t8 = time.monotonic()
    phase8 = phase_batched_search(pygo, torchgo, dev)
    specs = model_specs(dev)
    player = build_player("device-mcts", specs[0], value_path=specs[1])
    tree8 = phase_sync_free(pygo, torchgo, dev, player.policy, player.value)
    walls[8] = time.monotonic() - t8
    log(f"phase 8 (phase_batched_search, phase_sync_free): {walls[8]:.1f} s")
    main_path = phase(9, phase_search_gtp, player, (L, C, T))
    t10 = time.monotonic()
    rows = phase_timings(pygo, torchgo, dev, card)
    search_rows = phase_search_timings(torchgo, dev, card, main_path, tree8)
    rows[1]["tree"] = search_rows["tree"]
    walls[10] = time.monotonic() - t10
    log(f"phase 10 (phase_timings, phase_search_timings): {walls[10]:.1f} s")
    sp = phase(11, phase_policy_selfplay, torchgo, dev, card, (L, C))
    ss = phase(12, phase_search_selfplay, torchgo, dev, card, (L, C, T),
               player, sp["final"])
    phase(13, phase_clis_9x9, pygo, card)
    sv = phase(14, phase_supervised, dev, card, (L, C))
    rf = phase(15, phase_reinforcement, torchgo, dev, card, (L, C),
               sv["export"])
    gb = phase(16, phase_gumbel, pygo, torchgo, dev, card, (L, C, T), phase8,
               specs, main_path)
    mc = phase(17, phase_mcts, pygo, torchgo, dev, card, (L, C))
    zr = phase(18, phase_zero, torchgo, dev, card, (L, C, T))
    sv19 = phase(19, phase_serve, pygo, torchgo, dev, card, (L, C, T))
    inc = phase(20, phase_incremental, pygo, torchgo, dev, card, (L, C, T),
                specs)
    gw21 = phase(21, phase_gateway, pygo, card, (L, C, T), sv19)
    fl22 = phase(22, phase_fleet, pygo, torchgo, card, (L, C, T), sv19, zr,
                 gw21)
    par = phase(23, phase_parallel, card, (L, C, T), (sv["spec"],
                                                      sv["corpus"]),
                zr["paths"], os.path.join(os.path.dirname(os.path.abspath(
                    __file__)), ZERO_DIR, "straight"), zr["record"])
    epilogue = phase(24, phase_conv_epilogue, dev, card)
    # the launches of phases 11-22's paths: policy self-play (labels,
    # chase), search self-play (all three), the converter (labels,
    # chase), the RL iteration and the generator (labels, chase), the
    # Gumbel GTP session and Gumbel self-play (all three), the mcts GTP
    # session (labels, chase), the zero iteration, the serving fleets
    # and sessions, the incremental GTP session and self-play runs, the
    # gateway's load and the routed load (all three); the kernels timed
    # at self-play's shapes
    launches = {k: sp["launches"].get(k, 0) + ss["launches"][k]
                + sv["launches"].get(k, 0) + rf["launches"].get(k, 0)
                + rf["gen_launches"].get(k, 0) + gb["main"]["launches"][k]
                + gb["sp_launches"][k] + mc["launches"].get(k, 0)
                + zr["launches"][k] + sv19["launches"][k]
                + inc["launches"][k] + gw21["launches"][k]
                + fl22["launches"][k] + par["launches"][k]
                for k in ss["launches"]}
    shapes = {"labels": sp["labels"], "chase": sp["chase"],
              "tree": ss["tree8"]}
    kernels = []
    for name, src, replaces in (
            ("labels", "rocalphago_tpu_torch/csrc/labels.cu",
             "rocalphago_tpu/ops/labels.py:154"),
            ("chase", "rocalphago_tpu_torch/csrc/chase.cu",
             "rocalphago_tpu/ops/chase.py:342"),
            ("tree", "rocalphago_tpu_torch/csrc/tree.cu",
             "rocalphago_tpu/search/device_mcts.py:322 and :370 "
             "(lax.while_loop, not a Pallas kernel)")):
        ms, plain_ms, (bound_ms, bound_by) = shapes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    kernels += epilogue
    log(f"device-search session "
        f"launches {main_path['launches']}; policy self-play launches "
        f"{sp['launches']}; search self-play launches {ss['launches']}")
    log(f"selfplay_19x19_games_per_min (the port's) {sp['games_per_min']:.2f} "
        f"at batch {SP_BATCH} on {card}")
    log(f"device-search genmove p50 {main_path['p50']:.2f} ms at 100 "
        f"simulations, {main_path['sims_per_s']:.1f} simulations/s on "
        f"{card}")
    log(f"gumbel-mcts genmove p50 {gb['main']['p50']:.2f} ms at 100 "
        f"simulations, {gb['main']['sims_per_s']:.1f} simulations/s, "
        f"launches {gb['main']['launches']}; Gumbel self-play "
        f"{gb['sp_rate']:.1f} simulations/s at batch {SS_BATCH}, launches "
        f"{gb['sp_launches']} on {card}")
    log(f"mcts genmove p50 {mc['p50']:.2f} ms at {MCTS_PLAYOUTS} playouts "
        f"(device rollouts), {mc['rate']:.2f} playouts/s, launches "
        f"{mc['launches']}; a rollout wave of {MCTS_LEAF_BATCH}: "
        f"{mc['replay']['plies']} plies, launches "
        f"{mc['replay']['wave_launches']}, {mc['plies_per_s']:.1f} rollout "
        f"plies/s on {card}")
    log(f"greedy session launches {greedy_launches}; converter launches "
        f"{sv['launches']}; RL iteration launches {rf['launches']}; "
        f"generator launches {rf['gen_launches']}")
    log(f"rl iteration at game batch {RL_BATCH}, move limit {RL_MOVES}: "
        f"{rf['wall']:.2f} s (play {rf['laps']['play']:.2f}, replay "
        f"{rf['laps']['replay']:.2f}, update "
        f"{rf['laps']['update'] * 1e3:.2f} ms), games_per_min "
        f"{rf['games_per_min']:.2f}, replay ply {rf['replay_ply_ms']:.2f} ms, "
        f"replay MFU share {rf['mfu']:.5f}; generator "
        f"{rf['positions_per_s']:.2f} valid positions/s, yield "
        f"{rf['yield_']:.4f} on {card}")
    log(f"SGF conversion {sv['positions_per_s']:.1f} positions/s (host "
        f"replay alone {sv['replay_per_s']['native']:.1f} native, "
        f"{sv['replay_per_s']['pygo']:.1f} pygo); SL train "
        "step " + ", ".join(
            f"{t['ms']:.3f} ms at minibatch {b} ({b / t['ms'] * 1e3:.1f} "
            f"positions/s, MFU share {t['mfu']:.4f})"
            for b, t in sv["timings"].items()) + f" on {card}")
    prof = zr["profile"] or {}
    log(f"zero iteration at game batch {ZERO_BATCH}, {ZERO_SIMS} "
        f"simulations (caps {ZERO_CAP_P}/{ZERO_CAP_CHEAP}, aux), move limit "
        f"{ZERO_MOVES}: play {zr['laps']['play']:.2f} s, replay "
        f"{zr['laps']['replay']:.2f} s, update "
        f"{zr['laps']['update'] * 1e3:.2f} ms, gate {zr['laps']['gate']:.2f} "
        f"s; {zr['games_per_min']:.2f} games/min, {zr['sims_per_s']:.1f} "
        f"simulations/s, full-search fraction {zr['full_frac']:.3f}, "
        f"{zr['replay_ply_ms']:.2f} ms and "
        f"{prof.get('launches', float('nan')):.0f} kernels a replay ply, "
        f"idle share {prof.get('idle', float('nan')):.3f}, replay MFU share "
        f"{zr['mfu']:.5f}; launches {zr['launches']}; phase 18 "
        f"{zr['phase_s']:.1f} s on {card}")
    fleet = sv19["fleet"]
    log("serving: " + "; ".join(
        f"fleet {n}: {fleet[n]['moves_per_s']:.2f} moves/s, "
        f"{fleet[n]['sims_per_s']:.1f} game-simulations/s, occupancy "
        f"{fleet[n]['occupancy']:.3f}, launches {fleet[n]['launches']}"
        for n in SERVE_FLEETS) + f"; threaded genmove p50 "
        f"{sv19['threaded']['p50']:.3f} s, p99 {sv19['threaded']['p99']:.3f} "
        f"s, launches a genmove {sv19['threaded']['per_genmove']}; phase 19 "
        f"{sv19['phase_s']:.1f} s on {card}")
    load = gw21["load"]
    log(f"gateway: genmove over the wire p50 {load['p50']:.3f} s, p99 "
        f"{load['p99']:.3f} s at {GATEWAY_CONNS} connections and "
        f"{SERVE_SIMS} simulations (limit {SERVE_GENMOVE_LIMIT_S:.0f} s), "
        f"launches a genmove {load['per_genmove']}; phase 21 "
        f"{gw21['phase_s']:.1f} s on {card}")
    rt = fl22["router"]
    log(f"fleet: hot swap {fl22['swap']['swap_s']:.4f} s a swap (mean of "
        f"{fl22['swap']['swaps']}); routed genmove p50 {rt['p50']:.3f} s, p99 "
        f"{rt['p99']:.3f} s (the router's tax {rt['p50'] - load['p50']:+.3f} "
        f"s at p50 against phase 21's wire; over one replica "
        f"{rt['p50_one']:.3f} s, {rt['p50_one'] - load['p50']:+.3f} s), "
        f"convergence "
        f"{rt['conv_s']:.3f} s, launches a routed genmove "
        f"{rt['per_genmove']}; a self-play actor's batch of 2 games "
        f"{fl22['replay']['actor_launches']}; wire ingest "
        f"{fl22['replay']['ingest_games']} games; phase 22 "
        f"{fl22['phase_s']:.1f} s on {card}")
    log(f"parallel, two ranks sharing the card: SL update relative L2 "
        f"{par['sl']['update_l2']:.3e}, zero update relative L2 "
        f"{par['zero']['update_l2']}, zero launches per rank "
        f"{par['zero']['launches']}, self-play --shard byte-equal; SL step "
        f"one rank {par['probe']['nccl']['plain_step_ms']:.2f} ms, two ranks "
        f"{par['probe']['sl']['step_ms']:.2f} ms; phase 23 "
        f"{par['phase_s']:.1f} s on {card}")
    log("phase wall times (s): " + json.dumps(
        {n: round(w, 1) for n, w in sorted(walls.items())}))
    log(f"at the end: {nothing_left()}")
    log(f"genmove p50 {p50:.2f} ms on {card}; smoke took "
        f"{time.monotonic() - t0:.0f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
