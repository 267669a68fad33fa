#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``kafka_assigner_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build — every ``kafka_assigner_tpu_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (one ``nvcc`` per source, started together), with the
   registers and shared memory ``-Xptxas -v`` reports per kernel; then the
   native host libraries (``native/greedy.cpp`` with ``g++``,
   ``native/hostcodec.c`` with ``gcc``), each loaded, with their paths and
   build times;
3. kernels — the leadership kernel against its plain PyTorch version,
   bit for bit, on the stress cases of
   ``kafka_assigner_tpu_torch/ops/leadership_cases.py``: RF 1-5, 12 and
   32 with shared- and global-memory slabs, partial and empty rows, P not
   a multiple of 8, multi-topic counter carry; every row on the same
   brokers with N_pad = RF and RF + 1 (every step conflicts); a mixed-RF
   batch; P = 1; one topic of 5,000 partitions (many record tiles, a
   partial last one); one topic of 20,000 rows on a warm slab; -1 and
   >= N_pad candidates; a slab over the shared-memory opt-in limit;
4. main path — BASELINE config 4 (5,000 brokers in 10 racks, 2,000 topics
   x 100 partitions at RF 3, brokers 0-99 replaced by 5000-5099, built as
   ``bench.py:build_headline`` does) written to a snapshot and solved by the
   port's mode-3 CLI on ``cuda``; checks rack-distinct RF-sized replica
   sets, no replica on a removed broker, at most ``cap`` replicas per node
   per topic, moved replicas == the replicas that sat on brokers 0-99, that
   the main path launched the leadership kernel and that its encode and
   decode took the C codec; then the kernel at the main path's shape
   against the plain version on the same inputs;
5. cuda == cpu — a 64-topic prefix of config 4, plan text byte-identical;
6. timing — warm median of 5 solves split into encode, placement,
   leadership and decode (host clocks ending in ``torch.cuda.synchronize``),
   in turns with 5 under ``KA_HOSTCODEC=0`` (the codec A/B: plans
   byte-identical, the C codec asserted to have run),
   the kernel alone at the config-4 shape (median of 10 launches, each
   timed with CUDA events), its byte bound, its dependent-chain floor
   (the chain's steps at this shape times the time per step of the chain
   alone, measured here by the kernel's probe), and the plain version on
   the card at a reduced shape (stated in the output);
7. giant cells — one 200,000-partition RF-3 topic on 5,000 brokers in 10
   racks plus 100 added brokers (``bench.py:472-538``), each through the
   port's CLI on ``cuda``, with the kernel counts reset before and read
   after each: (a) expansion, brokers 0-5,099 live: mode 3, cap 118,
   exactly 10,000 replicas moved (each original broker sheds 2); (b)
   saturated, brokers 100-5,099 live: mode 3, cap 120, exactly 12,000
   moved; (c) fresh: ``PRINT_FRESH_ASSIGNMENT`` of a 200,000-partition
   RF-3 topic on (a)'s brokers, cap 118. Each plan is checked for
   rack-distinct RF-sized lists on live brokers under the cap; each
   placement for the giant-shape chain with no dense or seq leg run; and
   each leadership launch, at (1, 200000, 3) on the inputs the solver gave
   it, against the plain version on all rows, bit-equal;
8. cuda == cpu past a lowered ``KA_DENSE_MASK_BUDGET`` (the giant-shape
   chain at a reduced size; knobs restored afterwards), plan text
   byte-identical: a saturated replace-10 of 100 brokers in 5 racks with
   one 2,000-partition topic, a fresh 2,000-partition plan, and an RF
   decrease with orphans under ``KA_RF_DECREASE_COMPAT=1`` (auction and
   seq chains). Each ``cuda`` run must launch the kernel, place through
   the giant-shape chain (read from the solver's own placement call) and
   agree with the plain version on every launch;
9. giant timing — warm median of 3 solves of (a), (b) and (c) split by
   phase, in turns with 3 under ``KA_HOSTCODEC=0`` (the codec A/B), the
   waves of every leg that ran (no dense or seq leg may run),
   and the kernel at (1, 200000, 3) on (a)'s inputs: median of 10 by CUDA
   events, its byte bound and its chain floor, its result held against
   the one checked in phase 7;
10. what-if at BASELINE config 5 (``rack_striped_cluster(1000, 100, 50, 3,
    10)``, 256 singleton removals of brokers 0-255): the incremental and
    the dense sweep on ``cuda``, equal to each other and to the port's
    ``cpu`` run, every scenario feasible with moved == the replicas the
    removed broker held; warm median of 3 per path split into host prep,
    device sweep, rescue and compose, waves per leg, rows, chunks and peak
    device memory;
11. RANK_DECOMMISSION through the port's CLI on config 4's steady-state
    cluster (5,000 brokers, 2,000 topics x 100 partitions at RF 3), every
    live broker ranked: 5,000 feasible rows sorted least-disruptive-first
    with moved == held; then 16 ``--integer_broker_ids`` candidates and a
    ``--scenario_file`` (a same-rack pair, a cross-rack pair, a hostname,
    the empty scenario), stdout byte-identical on ``cuda`` and ``cpu``;
12. the rescue: 100 brokers in 5 racks, one 2,000-partition RF-3 topic,
    scenarios removing 4 brokers of every rack (cap 75, no slack): the fast
    sweep strands, the ``auto`` chain re-runs those scenarios; the rescued
    count and every result equal on ``cuda`` and ``cpu``; then the
    stranded scenarios' sweeps timed on ``cuda`` on the fast leg, the
    ``auto`` chain and the ``seq`` leg alone;
13. the host modes ``PRINT_CURRENT_ASSIGNMENT`` and ``PRINT_CURRENT_BROKERS``
    on phase 11's snapshot: JSON with all 5,000 brokers and 200,000
    partitions, byte-identical under ``--device cuda`` and ``cpu``;
14. ``ka-groups`` plan on config 4's cluster: a lake-ingest group ``ingest``
    subscribed to every topic, 256 live members of capacity null (fair share
    x 1.25), row i of the 200,000 sorted (topic, partition) rows owned by
    ``c-{i % 320:03d}`` (owners 256-319 have left), heavy-tailed lag from a
    seed. Through ``python -m kafka_assigner_tpu_torch.groups``'s
    ``run_groups`` on ``cuda`` and (in a worker) ``cpu``: stdout
    byte-identical, every row on a live member, ``moves`` == the rows whose
    owner changed, the group-pack kernel launched;
15. ``ka-groups`` sweep on the same group: counts 32, 64, ..., 512 x scales
    100, 150, 200, 300 (64 candidates, C_pad 512), stdout identical on
    ``cuda`` and ``cpu``; then a warm median of 3 of the sweep split into
    host encode, sticky, scan and decode, with the scan's steps and peak
    device memory;
16. ``ka-groups --synthetic --weight throughput --mode sweep`` on phase 11's
    snapshot (no groups section): 8 synthetic members, 48 candidates, stdout
    identical on ``cuda`` and ``cpu``; without ``--synthetic`` the refusal
    (exit 1);
17. the leadership lanes — ``KA_LEADERSHIP=native`` (the host C++ pass,
    ``native/leadership.py``) against ``device`` (the kernel) on config 4
    and the giant expansion: CLI stdout byte-identical, the kernel launched
    on the device lane only; then a warm median of each lane in turns, split
    by phase (the native lane's leadership phase includes copying the
    placement to the host);
18. the solver lanes — ``--solver native`` (the C++ greedy) on config 4
    through the CLI: the same checks as phase 4, moved == ``--solver
    device``'s; ``--solver greedy`` and ``native`` on phase 5's prefix,
    byte-identical, moved == the device's; neither launches the kernel
    (the greedy lanes place orphans first-fit, the device solver by waves, so
    their lists differ where orphans land, as the JAX package's lanes do);
    then ``scripts/torch_bench.py`` in a subprocess, its JSON line printed;
19. observability and the failure policy (``obs/``, ``faults/``), on
    ``cuda``: (a) config 4 through the CLI with ``--report-json``: the
    report valid with status ok, the spans ``metadata/assignment``,
    ``feasibility``, ``plan/solve/{encode,solve,decode}`` and
    ``plan/emit``, ``plan.moves`` == phase 4's moved replicas, 200,000
    partitions, the ``zk.*`` counters, the leadership kernel launched once,
    stdout byte-identical to phase 4's; the span tree's times and the CLI
    wall (host clock around the run) less the mode span printed; (b) one
    warm config-4 solve through ``TopicAssigner.generate_assignments``
    under ``KA_OBS_PROFILE_DIR``: the Chrome trace's dispatch window, the
    device busy time (the union of kernel, memcpy and memset intervals in
    it), the device idle share, the top 8 device ops, the leadership
    kernel's traced time (its chain kernel exactly once) beside phase 6's
    CUDA-events time and phase 6's unprofiled warm median; (c) the 64-topic
    prefix with ``KA_FAULTS_SPEC=solve:0=crash``: ``--failure-policy
    best-effort`` exits 6 with stdout byte-identical to phase 18's
    ``--solver greedy``, the report degraded with ``solve.fallbacks`` 1 and
    ``faults.injected`` 1, the kernel launched 0 times; the default policy
    exits 4 with the report's error a ``SolveError``; with no spec,
    best-effort is byte-identical to strict; (d) phase 14's plan with the
    report (``groups.plans`` 1, ``groups.moves`` == the envelope's, the
    group-pack kernel launched once, stdout == phase 14's), then phase 16's
    synthetic sweep with the crash and best-effort: exit 6, ``"solver":
    "greedy-fallback"``, the group-pack kernel launched 0 times, the
    envelope == the ``--solver greedy`` run's but that marker (the oracle
    run on ``cpu`` in a worker, beside the later phases); (e) phase 11's
    16 candidates with the report: the
    ``whatif/rank`` span, ``whatif.scenarios`` 16, ``whatif.fanout``,
    stdout == phase 11's. Phases 1-18 run strict and unprofiled: the smoke
    fails at start when ``KA_FAILURE_POLICY``, ``KA_FAULTS_SPEC``,
    ``KA_OBS_PROFILE_DIR``, ``KA_PROFILE``, ``KA_OBS_REPORT`` or
    ``KA_OBS_ENABLE`` is set, and phase 19 sets them per run;
20. live ZooKeeper (``io/zkwire.py``, ``io/zk.py``, the streamed ingest of
    ``generator.py``), on ``cuda``: ``tests/jute_server.py`` serves config
    4's tree from a spawned process (5,100 znodes ``/brokers/ids/<id>``,
    brokers 0-99 still registered, and the 2,000 topic znodes); (a) the
    port's mode-3 CLI with ``--zk_string 127.0.0.1:<port>``,
    ``KA_ZK_CLIENT=wire`` and ``--broker_hosts_to_remove b0,...,b99``:
    stdout byte-identical to phase 4's snapshot plan, the same replicas
    moved, the accumulator's encode on the C codec, the solve on its
    preencode (no encode of its own), the leadership kernel launched once
    and that launch held against the plain version on the same inputs (in a
    worker); (b) the same under ``KA_ZK_OVERLAP=0`` (the solve encodes) and
    under ``KA_ZK_INGEST_CHUNK=7``, the same bytes; (c) the 64-topic prefix
    over ZooKeeper on ``cuda`` and ``cpu``, byte-identical and equal to
    phase 5's; (d) with a 1 ms reply delay (``reply_delay_s=0.001``, as
    ``scripts/bench_zk_ingest.py``), one turn: the overlap on, ``KA_ZK_
    OVERLAP=0`` and serial reads (``KA_ZK_PIPELINE=1``), each with
    ``--report-json``: the CLI wall, ``zk/brokers``, ``metadata/assignment``,
    ``ingest.encode_ms`` and ``ingest.overlap_ms``, ``zk.pipeline.*`` and
    ``plan/solve``, each line with the card's name and power limit;
21. warm start in fresh processes (``utils/programstore.py``,
    ``solvers/warmup.py``, ``ka-warm``), each child run through
    ``scripts/torch_bench_warmstart.py``'s child mode, which counts the
    leadership kernel's launches inside the child: (a) ``ka-warm`` on
    phase 4's snapshot against an empty temporary store (exit 0,
    ``warmed``, ``compile.store.misses`` and ``compiles_ms``, the warm-up's
    steps), and beside it under ``KA_PROGRAM_STORE=0`` (exit 1, "NOTHING
    persisted"); neither launches the kernel; (b)
    ``scripts/torch_bench_warmstart.py`` on phase 4's snapshot, its JSON
    line printed, each child's plan byte-identical to phase 4's; (c) phase
    20(d)'s 1 ms server, every library loaded from (a)'s store
    (``compile.store.hits`` and ``loads_ms``, no build), the warm-up on
    against ``KA_WARMUP=0`` in one turn: the CLI wall, the ingest's and
    the warm-up's windows in the child (did the warm-up end inside the
    ingest?) and its steps, the ``warmup`` span beside
    ``metadata/assignment``, ``plan/solve``, ``warmup.*`` and
    ``compile.store.*``; stdout == phase 4's and the kernel launched once
    in each run. Phase 21's launches run
    in child processes and are not held against the plain version one by
    one: each is held through its plan, byte-identical to phase 4's, whose
    launch at the same shape the plain version checked;
22. plan execution (``exec/``, the snapshot backend's simulated
    convergence, the wire client's writes), each ``ka-execute`` run in a
    fresh process through ``python -m kafka_assigner_tpu_torch.exec``: (a)
    config 4's plan through mode 3 on ``cuda`` (stdout == phase 4's, the
    leadership kernel launched and held against the plain version in a
    worker), written to a plan file; (b) ``ka-execute`` of it on a copy of
    phase 4's snapshot with ``--report-json`` at the printed wave size and
    poll interval: exit 0, "verify-after-move OK", the final snapshot
    byte-identical to the plan's NEW ASSIGNMENT written through the port's
    ``write_snapshot``, the journal complete; the wall, waves, the
    ``exec/*`` span totals, one persist's time and the execution entry's
    import in a fresh process (no torch); (c) ``--rollback`` on the same
    copy, back to the original's bytes through ``write_snapshot``; (d) on
    the 64-topic prefix, a process under ``KA_FAULTS_SPEC=wave:1=crash``
    dies at the wave boundary with one wave committed and ``--resume``
    ends byte-identical to an uninterrupted run; (e) the prefix over
    ``tests/jute_server.py`` with its simulated controller (a spawned
    process), the tree read back equal to (d)'s final assignment;
23. the resident daemon (``daemon/``) on phase 20(d)'s tree (1 ms a
    reply): (a)-(d) in this process on cuda, so the leadership kernel's
    launches count here and each is held against the plain version; (a)
    ``AssignerDaemon(solver="device")`` over the wire client with watches:
    construction to ``/readyz`` 200, the first resync (its ``daemon/resync``
    span) split into the reads with the cache's copy and the delta store's
    seeding (the state's ``seed_ms``), ``/state`` (2,000 topics, 5,100 brokers,
    the encode shape, watches on), the post-resync warm-up with no failure;
    (b) ``POST /plan`` with ``broker_hosts_to_remove`` b0-b99 (the solve
    encodes for itself): stdout byte-identical to phase 4's, the kernel
    launched once, the request's wall and spans; (c) brokers 0-99 deleted
    through the wire client, the broker watch's full resync awaited, then
    two ``POST /plan {}`` through the cached merged preencode, each
    byte-identical to phase 4's with one launch; (d) one replica moved by
    ``setData``: one delta re-encode per notification the daemon takes
    (``daemon.reencode.topics`` against ``daemon.watch_events``) and no
    resync, then
    ``POST /plan {}`` byte-identical to a fresh in-process CLI run on cuda
    over the same server; (e) ``python -m kafka_assigner_tpu_torch.daemon``
    in a child process (its launches counted inside it): spawn to banner and
    to ``/readyz`` 200, a ``/plan`` byte-identical to (d)'s CLI run, and
    SIGTERM during a second ``/plan``: ``/readyz`` 503 while it drains, the
    request answered in full, exit 0;
24. the daemon for many clusters, in this process on cuda, on the same
    server right after phase 23: ``AssignerDaemon(clusters=...,
    solver="device")`` with cluster ``a`` (config 4 over the tree as phase
    23 leaves it) and cluster ``b`` (BASELINE config 3, ``build_config3``:
    500 brokers in 5 racks plus 50 added, all live, 1,000 topics x 64
    partitions at RF 3, as a snapshot copied for the daemon, with phase
    14's ``ingest`` group over its topics); (a) construction to the
    aggregate ``/readyz`` 200, each cluster's ``/healthz`` and ``/state``,
    the first resyncs and their ``health.score_ms``; (b) ``POST
    /clusters/a/plan {}`` with ``X-Request-Id: smoke-24b``: stdout
    byte-identical to phase 23(d)'s CLI run, one launch held through that
    run's, the ID in the header, ``result.request_id``, every span and one
    access-log line; (c) ``POST /clusters/b/plan`` removing brokers 0-49:
    moved == the replicas on them, rack-distinct lists on live brokers
    under the cap, one launch at (1000, 64, 3) held against the plain
    version in a worker; (d) ``POST /clusters/b/execute`` of (c)'s plan in
    at most 8 waves: the NDJSON stream start, waves, verify, done; the
    daemon's copy of b byte-identical to the plan's NEW ASSIGNMENT through
    ``write_snapshot``; a second ``/execute`` meanwhile 409; (e)
    ``/clusters/b/groups/plan`` and ``/groups/sweep`` (``ingest``,
    ``groups_real``), each group-pack launch bit-equal to plain in a worker
    and timed alone, with its C_pad and variant; (f) ``/clusters/b/
    recommendations`` and again with ``?move_cost=0``: the envelope valid,
    the verdict and scores, one launch each; (g) ``GET /metrics`` parsed,
    every histogram consistent, both clusters in ``daemon.http.requests``
    and the ``ka_health_*`` gauges, the scrape's bytes and time;
    ``/debug/flight?cluster=b`` with (d)'s ``execute`` and (f)'s
    ``recommendation`` events; (h) ``request_stop`` with a
    ``/clusters/a/plan`` in flight: answered in full, ``serve`` returns 0;
25. the dispatch plane (``daemon/dispatch.py``), in this process on cuda:
    one daemon with the dispatcher over copies of config 4's snapshot (a1,
    a2) and of phase 24's config 3 with its ``ingest`` group (b1, b2),
    clients released through one barrier, each step's gather closed by a
    size trigger of its job count: (a) ``/plan {}`` on a1 and a2 and the
    64-topic prefix on a1: one ``place_batched`` call for the three jobs
    (the ``dispatch`` flight event), stdout == phases 4's and 5's, one
    leadership launch a plan, each held; (b) 8 identical ``/plan {}`` on
    a1: one leader (one ``body`` event of 8 jobs), one launch; (c)
    ``/whatif`` of four removals on a1 and a2: one packed sweep call, bytes
    == a1's alone; (d) the ``ingest`` sweep on b1 and b2: one group-pack
    launch at twice the candidates, held against plain in the workers and
    timed with its bound and chain floor, each envelope == phase 24(e)'s
    but the cluster name; (e) at the default window and at 250 ms, 8
    distinct config-3 plans (8 topic slices of b1) and 8 identical ones
    (one leadership launch a dedup leader): requests per
    second, the walls' median and spread, ``daemon.solve.queue_ms`` and the
    ``dispatch`` spans, against a second daemon under ``KA_DISPATCH=0``;
    (f) ``dispatch:0=crash`` on b1's and b2's packed plans (each job re-run
    alone on the card, bytes unchanged), the ``KA_DISPATCH=0`` daemon with
    no ``dispatch.*`` series and (e)'s bytes, and ``request_stop`` while a
    plan's job waits in a 30 s window: ``close()`` dispatches it and the
    reply is complete. (e) also runs one round at ``KA_DISPATCH_MAX_BATCH=1``
    (the hand-off to the dispatcher's thread without packing), and prints
    each request's queue wait (``daemon.solve.queue_ms``, read by the
    thread that waited);
26. the closed-loop controller (``daemon/controller.py``), in this process
    on cuda, each round started by the daemon's shared ticker
    (``SharedTicker.advance``) and run on the controllers' own threads:
    cluster ``a`` is config 4's steady cluster (phase 11's) with
    ``CONTROLLER_SEEDED`` replicas of ``topic-0000`` piled on broker 0 (the
    reference's ``scripts/controller_smoke.py`` imbalance at config 4's
    size), under ``KA_HEALTH_MOVE_COST=0``, ``KA_CONTROLLER_CONFIRMATIONS=2``
    and the default ``KA_CONTROLLER_MAX_MOVES`` (16). (a) ``a`` on ``auto``
    beside phase 24's config 3 as ``b`` (``off``): one ``confirmed`` round,
    then one round that truncates the plan to a prefix of whole partitions
    within 16 replica moves and acts; the forward journal complete, the
    action record gone, the snapshot re-scored better, ``b``'s bytes
    untouched with no controller activity, ``ka_controller_actions_total``
    for ``a`` only; (b) a fresh daemon of ``a`` under
    ``KA_FAULTS_SPEC=controller@a:1=exec-crash`` and 8-move waves: the
    crash at the second wave boundary rolls the assignment back to the
    bytes before the action and opens the controller's breaker (view and
    trail); (c) a fresh daemon of two copies of config 3 seeded as ``a``
    is, on ``observe`` (rows of different clusters never share a batch
    key, so ``b`` cannot pack with ``a``; config 3 keeps the phase near 90
    s): each of two rounds packs both evaluations into one
    ``place_batched`` call (``dispatch.batches`` +1 a round), the trails
    ``confirmed`` then ``would-act``. Every evaluation's leadership launch
    is held against plain (in a worker, through ``hold``); each evaluation's
    wall and span split, each job's queue wait, the packed call and the
    kernel's time on the recorded inputs are printed;
27. the fleet scheduler (``daemon/fleet.py``), the shape of the
    reference's ``scripts/fleet_smoke.py`` on config 3, at the default
    ``KA_FLEET_*`` knobs (one lease at a time, 64 moves an hour): (a) in
    this process on cuda, one daemon of ``a`` (``FLEET_SEED_A`` replicas
    of its first topic on broker 0, ``auto``), ``b`` (``FLEET_SEED_B``,
    ``auto``) and ``c`` (``off``, with a planted in-progress ``/execute``
    journal of one-move waves throttled by ``KA_EXEC_SIM_POLLS``): the
    boot recovery finishes ``c``'s journal before the HTTP server exists,
    and while it holds the one slot (its first wave boundary held until
    then) a round of the shared ticker has both controllers denied
    (``recovery pending``); then rounds until ``b`` acts: the first action
    lease goes to ``a``, the worse-off cluster, then ``b``'s; no ledger
    the fleet writes holds two leases; ``GET /fleet``, the aggregate
    ``/state``'s ``fleet`` key and ``ka_fleet_*`` on ``/metrics`` match
    the decisions; (b) ``python -c FLEET_CHILD`` (the daemon module, each
    leadership launch saved and counted inside the child) of one seeded
    cluster on ``auto`` with 8-move waves and ``KA_EXEC_THROTTLE``,
    SIGKILLed once its forward journal commits its first wave; a restart
    with no fault knob and no client ``resume`` converges at boot (journal
    complete, snapshot bytes the action record's plan applied, the record
    gone, ``ka_fleet_recoveries_total`` 1) and exits 0 on SIGTERM; (c) a
    boot under ``fleet:0=recovery-crash`` keeps a planted journal
    (``fleet.recovery_failures`` 1), the next boot completes it. Every
    evaluation's leadership launch, in process or saved by the child, is
    held against plain; each round's wall and job's queue waits and the
    kernel's time on the recorded inputs are printed.
28. the mesh (``parallel/mesh.py``) on the one card, every position on
    ``cuda:0``, after phase 27: (a) config 5's 256 removals on
    ``MESH_POSITIONS`` in-process positions of the scenario axis,
    incremental and dense, == phase 10's unsharded results; (b) the same
    sweep in ``MESH_PROCS`` child processes (``mesh_child``, a process
    group over ``gloo``: the ranks share the card) of
    ``MESH_PROC_POSITIONS`` positions each, every rank == (a); (c) in the
    same children, phase 7's giant expansion and saturated cells at full
    size through ``TopicAssigner(TorchSolver("cuda", mesh=build_mesh(1,
    MESH_PROCS)))``: plan bytes == phase 7's, 10,000 and 12,000 moved,
    phase 7's chain and waves, and each rank's leadership launch at (1,
    200000, 3) on phase 7's inputs, bit-equal to its held launch; (d) (c)'s
    expansion on ``MESH_PROCS`` in-process positions, plan == (c)'s, one
    launch a position. Each part prints its wall, its collectives a solve,
    and the sharded time beside the unsharded one of this run: the cost of
    the collectives with every position on one card, not a speedup. A
    child that exits non-zero fails the smoke.

Phase 3b holds the group-pack kernel (KG1, ``csrc/group_pack.cu``) bit-equal
to its plain version on the stress cases of ``ops/group_pack_cases.py``,
with the variant each launched (``registers``, ``shared``, ``global``) and,
in the register variant, the consumers a lane (K) its candidates took;
each of phases 14-16 holds its kernel launch bit-equal to the plain version
on the inputs the main path gave it (in a worker) and times it alone
(median of 10 by CUDA events) beside its C_pad and variant, its byte bound,
its chain floor (the largest orphan count of a candidate times the time of
one step of two warp reductions and a bump alone, measured by the step
probe) and the ratio of the two, the same over the register variant's
floor (the probe's chain with one reduction and a ballot a step), and the
chain at the kernel's own time a step (on one all-orphan candidate at the
K of the longest chain); the kernel's own time a step is also printed at
each K's largest C_pad (32 to 1,024) and at 2,048 (the shared variant).

The what-if and group phases do not order leaders: the leadership kernel is
not on their path, and the smoke checks that they launch it no time.

The plain leadership checks of phases 4 and 7 (config 4's 208,000 rows and
each giant cell's 200,000, a Python loop over rows on the host CPU), and
the plain group-pack checks and ``cpu`` runs of phases 14-16, run in
``PLAIN_WORKERS`` spawned worker processes, one thread each, while the
later phases go on: phases 14-15's ``cpu`` runs start right after phase 4
and phase 16's after phase 11, and each group-pack launch is checked in
slices of ``GROUP_PLAIN_SLICE`` candidates. Their results are collected
after phase 16, so phases 17-18 time a quiet host; each collect prints the
jobs' timeline and its own wait.

Phases 7 and 8 read what the solver hands ``place_batched`` and
``leadership_order`` through :func:`solver_probe`, which wraps the two names
in ``solvers/torch_solver.py`` for the block; the kernel's wrapper and its
launch count are untouched.

In the ``kernels`` line, ``bound_ms`` is the throughput bound (bytes over
the memory rate); ``chain_bound_ms`` is the design's latency floor, which
the throughput bound does not see; ``launches`` sums the counts of every
path driven (config 4, the three giant cells, the reduced ``cuda`` runs,
phase 17's CLI runs on each lane, phase 19's, 20's, 21's and 22's runs,
phase 23's, 24's and 25's requests, phase 26's and 27's evaluations,
phase 28's part-axis solves, 21's, 23(e)'s, 27(b)'s and 28(c)'s counted
inside each child process), and
``launches_by_path`` gives
each; the group-pack entry's counts are those of
phases 14-16, 24 (``daemon_multi_*``) and 25 (``dispatch_*``), and its
``packed_sweep`` is phase 25(d)'s launch.

The last lines are the ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. There is no fallback to
the CPU and none to the plain version.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_BROKERS, N_RACKS, N_TOPICS, P_PER_TOPIC, RF, REPLACED = 5000, 10, 2000, 100, 3, 100
PREFIX_TOPICS = 64
GIANT_P = 200_000
# Reduced giant-chain instance for cuda == cpu: 100 brokers in 5 racks, one
# 2,000-partition topic, brokers 0-9 replaced; the budget sits under its
# P_pad x N_pad (2,000 x 104), and under the compat instance's.
REDUCED = dict(brokers=100, racks=5, partitions=2000, replaced=10, budget=1_000)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
LEADERSHIP_TPU_KERNEL = "kafka_assigner_tpu/ops/pallas_leadership.py:63"
KERNEL_REPS = 10
SOLVE_REPS = 5
GIANT_SOLVE_REPS = 3
WHATIF_REPS = 3
PLAIN_WORKERS = 6
# A group-pack launch's plain check goes to the workers in slices of this
# many candidates: the scan is vectorized over candidates and none reads
# another's rows, so the slices' results are the whole check's.
GROUP_PLAIN_SLICE = 8
CONFIG5_SCENARIOS = 256
# Phase 11's candidates: 16 brokers over every rack of config 4's cluster.
RANK_CANDIDATES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 1234, 2500, 3001, 4444, 4998, 4999)
# Phases 14-16: the consumer group on config 4's cluster.
GROUP_TPU_LOOP = "kafka_assigner_tpu/ops/assignment.py:1599"
GROUP_MEMBERS, GROUP_OWNERS = 256, 320
GROUP_COUNTS = tuple(range(32, 513, 32))
GROUP_SCALES = (100, 150, 200, 300)
GROUP_SWEEP_REPS = 3
# The plain group-pack version timed on the card at this reduced shape.
GROUP_PLAIN_SHAPE = dict(s=4, p=1024, c=512)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


@contextlib.contextmanager
def knobs(**values):
    """Set ``KA_*`` knobs for a block and restore them afterwards."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def solver_probe():
    """Record, for a block, what the port's solver hands its placement and
    the leadership kernel: per placement, ``(legs, giant, waves)`` (the
    chain resolved for the placement's own mode and shape, whether it is
    the giant-shape chain, and the waves of every leg that ran); per
    ordering call, ``(inputs, outputs)``. Wraps the two names in
    ``solvers/torch_solver.py`` and restores them afterwards."""
    import inspect

    from kafka_assigner_tpu_torch.ops.assignment import resolve_chain
    from kafka_assigner_tpu_torch.solvers import torch_solver as ts

    seen = {"chains": [], "orders": []}
    place, order = ts.place_batched, ts.leadership_order
    signature = inspect.signature(place)

    def place_recorded(*args, **kw):
        a = signature.bind(*args, **kw).arguments
        placed = place(*args, **kw)
        legs, _, giant = resolve_chain(a["wave_mode"],
                                       a.get("p_pad") or a["currents"].shape[1],
                                       a["rack_idx"].shape[0], a.get("r_cap"))
        seen["chains"].append((legs, giant, dict(placed.waves)))
        return placed

    def order_recorded(*args, **kw):
        inputs = tuple(t.clone() for t in args[:4])
        outputs = order(*args, **kw)
        seen["orders"].append((inputs, outputs))
        return outputs

    ts.place_batched, ts.leadership_order = place_recorded, order_recorded
    try:
        yield seen
    finally:
        ts.place_batched, ts.leadership_order = place, order


def check_orders(lead, orders, what):
    """Each recorded kernel call against the plain version on the same
    inputs (copied to the CPU); returns max |kernel - plain|."""
    import torch

    worst = 0
    for inputs, (o_k, c_k) in orders:
        torch.cuda.synchronize()
        o_p, c_p = lead.leadership_order_plain(*(a.cpu() for a in inputs))
        err = max(int((o_k.cpu() - o_p).abs().max()), int((c_k.cpu() - c_p).abs().max()))
        if err:
            fail(f"{what}: leadership kernel disagrees with plain at "
                 f"{tuple(inputs[0].shape)}")
        worst = max(worst, err)
    return worst


def timed_job(fn, args):
    """Worker process: ``fn(*args)`` between two epoch stamps, so the parent
    can place the job on its own clock."""
    t0 = time.time()
    out = fn(*args)
    return t0, time.time(), out


def plain_check(inputs, outputs):
    """Worker process: the plain leadership version on ``inputs`` (numpy
    arrays), against the kernel's ``outputs``; returns (max |kernel -
    plain|, seconds)."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from kafka_assigner_tpu_torch.ops.leadership import leadership_order_plain

    t0 = time.perf_counter()
    plain = leadership_order_plain(*(torch.from_numpy(a) for a in inputs))
    err = max(int(np.abs(k - p.numpy()).max()) for k, p in zip(outputs, plain))
    return err, time.perf_counter() - t0


class PlainChecks:
    """Host CPU work in spawned worker processes, so it runs beside the
    later phases: kernel launches held against the plain version, and the
    ``cpu`` runs that ``cuda`` output is compared with. Each job's result
    goes to its ``done`` callback at :meth:`collect`."""

    def __init__(self):
        self.pool = concurrent.futures.ProcessPoolExecutor(
            PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        self.pending = []
        self.t0 = time.time()

    def job(self, kernel, done, fn, *args):
        """Run ``fn(*args)`` in a worker; ``done(result)`` returns max
        |kernel - plain| of ``kernel`` (0 for a job that compares no
        kernel) and fails on any disagreement."""
        self.pending.append((kernel, done, time.time(),
                             self.pool.submit(timed_job, fn, args)))

    def submit(self, what, inputs, outputs):
        inputs = tuple(a.cpu().numpy() for a in inputs)
        outputs = tuple(a.cpu().numpy() for a in outputs)
        shape = f"{inputs[0].shape} N_pad={inputs[2].shape[0]}"

        def done(result):
            err, secs = result
            if err:
                fail(f"{what}: leadership kernel disagrees with plain at {shape}")
            phase("kernels", f"leadership at {what} {shape}: bit-equal to plain on "
                  f"all rows (plain on CPU {secs:.1f} s in a worker)")
            return err

        self.job("leadership", done, plain_check, inputs, outputs)

    def collect(self):
        """Every job's result; fails on any disagreement. Returns max
        |kernel - plain| per kernel. Prints the jobs' timeline on the
        smoke's clock: when the last was queued and ended, the workers' busy
        seconds, and how long this call waited."""
        worst = {}
        t_wait = time.time()
        spans = []
        for kernel, done, queued, future in self.pending:
            start, end, result = future.result()
            spans.append((queued, start, end))
            worst[kernel] = max(worst.get(kernel, 0), done(result))
        if spans:
            t = lambda x: x - self.t0  # noqa: E731
            phase("timing", f"workers ({PLAIN_WORKERS}): {len(spans)} jobs, the last queued "
                  f"at {t(max(q for q, _, _ in spans)):.1f} s, the last ended at "
                  f"{t(max(e for _, _, e in spans)):.1f} s, busy "
                  f"{sum(e - st for _, st, e in spans):.1f} s, longest queue wait "
                  f"{max(st - q for q, st, _ in spans):.1f} s; this collect waited "
                  f"{time.time() - t_wait:.1f} s (smoke clock)")
        self.pending = []
        return worst

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


def check_chains(chains, what, rescue_allowed=True):
    """Every placement of the block ran the giant-shape chain, and only its
    legs; without ``rescue_allowed``, neither dense nor seq ran."""
    if not chains:
        fail(f"{what}: the solver placed nothing")
    for legs, giant, waves in chains:
        if not giant:
            fail(f"{what}: the placement did not take the giant-shape chain ({legs})")
        if not set(waves) <= set(legs):
            fail(f"{what}: legs {sorted(waves)} ran outside the chain {legs}")
        if not rescue_allowed and ("dense" in waves or "seq" in waves):
            fail(f"{what}: a rescue leg ran ({waves})")
    return [waves for _, _, waves in chains]


def native_builds():
    """Phase 2 (host): the greedy library with g++ and the boundary codec
    with gcc, each loaded; a failed build fails the phase."""
    from kafka_assigner_tpu_torch.native import build as nbuild

    for what, make, path, load in (
        ("greedy.cpp (g++)", nbuild.build_native_library, nbuild.greedy_lib_path,
         nbuild.load_native_library),
        ("hostcodec.c (gcc)", nbuild.build_hostcodec, nbuild.codec_lib_path,
         nbuild.load_hostcodec),
    ):
        t0 = time.perf_counter()
        try:
            make()
            load()
        except nbuild.NativeBuildError as e:
            fail(f"native build of {what}: {e}")
        phase("build", f"{what}: {os.path.relpath(path(), ROOT)} built and loaded in "
              f"{time.perf_counter() - t0:.2f} s")


def kernel_cases(cases):
    """Phase 3: kernel vs plain on the stress cases. Returns max |kernel -
    plain| over every case."""
    worst = 0
    for case in cases.stress_cases():
        name, acc, _, counters = case[:4]
        err = cases.check_case(case)
        worst = max(worst, err)
        if err:
            fail(f"leadership kernel disagrees with plain on case {name}")
        b, p, rf = acc.shape
        phase("kernels", f"leadership {name} (B={b} P={p} RF={rf} "
              f"N_pad={counters.shape[0]}): bit-equal")
    return worst


def build_config4():
    from kafka_assigner_tpu_torch.models.synthetic import build_config4

    return build_config4(N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, REPLACED)


def giant_cells(n_brokers=N_BROKERS, n_racks=N_RACKS, partitions=GIANT_P,
                added=REPLACED, name="giant-{:04d}"):
    """The giant topic and its three cells: ``{cell: (topic_map, live,
    rack_map, cap, moved)}``, ``moved`` the replicas the plan must move."""
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster

    topic_map, _, racks = rack_striped_cluster(
        n_brokers, 1, partitions, RF, n_racks, name_fmt=name, extra_brokers=added,
    )
    load = partitions * RF // n_brokers  # replicas per original broker
    cells = {}
    for cell, live in (("expansion", set(range(n_brokers + added))),
                       ("saturated", set(range(added, n_brokers + added)))):
        cap = math.ceil(partitions * RF / len(live))
        removed = n_brokers + added - len(live)
        # Expansion: each original broker sheds load - cap; saturated:
        # the removed brokers' replicas, and nothing else, move.
        moved = removed * load if removed else n_brokers * (load - cap)
        cells[cell] = (topic_map, live, {b: racks[b] for b in live}, cap, moved)
    _, live, rack_map, cap, _ = cells["expansion"]
    fresh = {"giant-fresh": {p: [] for p in range(partitions)}}
    cells["fresh"] = (fresh, live, rack_map, cap, partitions * RF)
    return cells


def write_snapshot(path, topic_map, live, rack_map):
    data = {
        "brokers": [
            {"id": b, "host": f"b{b}", "port": 9092, "rack": rack_map[b]}
            for b in sorted(live)
        ],
        "topics": {
            t: {str(p): r for p, r in parts.items()} for t, parts in topic_map.items()
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)


def run_cli(argv):
    from kafka_assigner_tpu_torch.cli import run_tool

    buf = io.StringIO()
    rc = run_tool(argv, out=buf)
    if rc != 0:
        fail(f"port CLI exited {rc} for {argv}")
    return buf.getvalue()


def plan_section(text, marker="NEW ASSIGNMENT:\n"):
    from kafka_assigner_tpu_torch.io.json_io import parse_reassignment_json

    if marker not in text:
        fail(f"no {marker.strip()} section in the plan")
    return parse_reassignment_json(text.split(marker, 1)[1].strip())


def check_plan(plan, topic_map, live, rack_map, cap, expected_moved, rf=RF):
    """Every partition placed on ``rf`` live brokers of distinct racks, at
    most ``cap`` replicas per node per topic, and exactly
    ``expected_moved`` replicas on brokers that did not hold them."""
    moved = 0
    for t, old in topic_map.items():
        new = plan.get(t)
        if new is None or set(new) != set(old):
            fail(f"topic {t}: partitions missing from the plan")
        per_node = {}
        for p, reps in new.items():
            if len(reps) != rf or len(set(reps)) != rf:
                fail(f"{t}/{p}: replica list {reps} is not {rf} distinct brokers")
            if len({rack_map[b] for b in reps if b in rack_map}) != rf:
                fail(f"{t}/{p}: replicas {reps} not on {rf} distinct racks")
            if any(b not in live for b in reps):
                fail(f"{t}/{p}: replica on a removed or unknown broker: {reps}")
            for b in reps:
                per_node[b] = per_node.get(b, 0) + 1
            moved += len(set(reps) - set(old[p]))
        if max(per_node.values()) > cap:
            fail(f"topic {t}: a node holds more than cap={cap} replicas")
    if moved != expected_moved:
        fail(f"moved {moved} replicas, expected exactly {expected_moved}")
    return moved


def giant_main_paths(cells, work, lead, checks):
    """Phase 7: the three giant cells through the CLI on the card, the
    kernel counts reset just before each and read just after; each
    placement's chain checked, and each kernel launch handed to ``checks``.
    Returns the launches per cell, (a)'s kernel inputs and outputs, and per
    cell the sha256 of the NEW (FRESH) ASSIGNMENT payload, the chain
    ``(legs, giant, waves)`` and the kernel launch ``(inputs, outputs)``."""
    import hashlib

    snaps = {}
    for cell in ("expansion", "saturated"):
        topic_map, live, rack_map, _, _ = cells[cell]
        snaps[cell] = os.path.join(work, f"giant_{cell}.json")
        write_snapshot(snaps[cell], topic_map, live, rack_map)
    p = len(cells["fresh"][0]["giant-fresh"])
    argvs = {
        "expansion": ["--zk_string", f"file://{snaps['expansion']}",
                      "--mode", "PRINT_REASSIGNMENT"],
        "saturated": ["--zk_string", f"file://{snaps['saturated']}",
                      "--mode", "PRINT_REASSIGNMENT"],
        "fresh": ["--zk_string", f"file://{snaps['expansion']}",
                  "--mode", "PRINT_FRESH_ASSIGNMENT", "--topics", "giant-fresh",
                  "--partition_count", str(p), "--desired_replication_factor", str(RF)],
    }
    launches, k_expansion, record = {}, None, {}
    for cell, argv in argvs.items():
        topic_map, live, rack_map, cap, expected = cells[cell]
        with solver_probe() as seen:
            lead.launches["leadership"] = 0
            t0 = time.perf_counter()
            text = run_cli(argv + ["--device", "cuda"])
            wall_s = time.perf_counter() - t0
            launches[cell] = lead.launches["leadership"]
        if launches[cell] < 1:
            fail(f"giant {cell} never launched the leadership kernel")
        marker = "FRESH ASSIGNMENT:\n" if cell == "fresh" else "NEW ASSIGNMENT:\n"
        moved = check_plan(plan_section(text, marker), topic_map, live, rack_map,
                           cap, expected)
        waves = check_chains(seen["chains"], f"giant {cell}", rescue_allowed=False)
        phase("giant", f"({cell}) {argv[3]} on cuda: {wall_s:.2f} s wall, "
              f"P={p} N={len(live)}, moved {moved} replicas (expected exactly "
              f"{expected}), cap {cap}, giant-shape chain {seen['chains'][0][0]}, "
              f"waves {waves}, leadership kernel launches {launches[cell]}")
        for inputs, outputs in seen["orders"]:
            checks.submit(f"the giant {cell} cell's launch, on the inputs the solver "
                          "gave it,", inputs, outputs)
        if cell == "expansion":
            k_expansion = seen["orders"][0]
        payload = text.split(marker, 1)[1].strip()
        record[cell] = {"sha": hashlib.sha256(payload.encode()).hexdigest(),
                        "chain": seen["chains"][0], "order": seen["orders"][0]}
    return launches, k_expansion, record


def reduced_parity(work, lead):
    """Phase 8: cuda == cpu, plan text byte-identical, past a lowered
    KA_DENSE_MASK_BUDGET; each cuda run launches the kernel, places through
    the giant-shape chain and agrees with plain. Returns the launches per
    run and max |kernel - plain|."""
    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster

    r = REDUCED
    cells = giant_cells(r["brokers"], r["racks"], r["partitions"], r["replaced"],
                        name="reduced-{:02d}")
    topic_map, live, rack_map, cap, moved = cells["saturated"]
    snap = os.path.join(work, "reduced_saturated.json")
    write_snapshot(snap, topic_map, live, rack_map)
    base = ["--zk_string", f"file://{snap}"]
    # An RF decrease 4 -> 2 on 25 brokers in 5 racks with brokers 0-4
    # replaced: compat keeps every retained replica and re-places the
    # orphans.
    c_map, _, c_racks = rack_striped_cluster(25, 1, 50, 4, 5, name_fmt="compat-{:02d}",
                                             extra_brokers=5)
    c_live = set(range(5, 30))
    c_snap = os.path.join(work, "compat.json")
    write_snapshot(c_snap, c_map, c_live, {b: c_racks[b] for b in c_live})
    c_argv = ["--zk_string", f"file://{c_snap}", "--mode", "PRINT_REASSIGNMENT",
              "--desired_replication_factor", "2"]
    # (path, what, argv, knobs)
    runs = [
        ("reduced_saturated", "saturated mode 3",
         base + ["--mode", "PRINT_REASSIGNMENT"], {}),
        ("reduced_fresh", "fresh",
         base + ["--mode", "PRINT_FRESH_ASSIGNMENT", "--topics", "reduced-fresh",
                 "--partition_count", str(r["partitions"]),
                 "--desired_replication_factor", str(RF)], {}),
        ("compat_auction", "compat RF 4->2, auction chain", c_argv,
         {"KA_RF_DECREASE_COMPAT": 1, "KA_WAVE_MODE": "auto"}),
        ("compat_seq", "compat RF 4->2, seq chain", c_argv,
         {"KA_RF_DECREASE_COMPAT": 1}),
    ]
    launches, worst = {}, 0
    for path, what, argv, extra in runs:
        with knobs(KA_DENSE_MASK_BUDGET=r["budget"], **extra):
            with solver_probe() as seen:
                lead.launches["leadership"] = 0
                a = run_cli(argv + ["--device", "cuda"])
                launches[path] = lead.launches["leadership"]
            c = run_cli(argv + ["--device", "cpu"])
        if launches[path] < 1:
            fail(f"reduced {what}: the cuda run never launched the leadership kernel")
        if a != c:
            fail(f"reduced {what}: cuda and cpu plans differ")
        waves = check_chains(seen["chains"], f"reduced {what}")
        worst = max(worst, check_orders(lead, seen["orders"], f"reduced {what}"))
        if what == "saturated mode 3":
            check_plan(plan_section(a), topic_map, live, rack_map, cap, moved)
        if what.startswith("compat"):
            old = c_map["compat-00"]
            new = plan_section(a)["compat-00"]
            if not any(set(v) - set(old[p]) for p, v in new.items()):
                fail(f"reduced {what}: the decrease left no orphan to place")
        k_shape = tuple(seen["orders"][0][0][0].shape)
        phase("cuda==cpu", f"reduced {what} (budget {r['budget']}, chain "
              f"{seen['chains'][0][0]}, waves {waves}): plan text byte-identical "
              f"({len(a)} bytes); leadership kernel launches {launches[path]} at "
              f"{k_shape}, bit-equal to plain")
    return launches, worst


def giant_timing(cells):
    """Phase 9 (solves): the codec A/B of each cell, a warm median of
    GIANT_SOLVE_REPS each in turns, split by phase, with the waves of every
    leg that ran."""
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.solvers.base import Context

    out = {}
    for cell in ("expansion", "saturated", "fresh"):
        topic_map, live, rack_map, _, _ = cells[cell]
        assigner = TopicAssigner(device="cuda")
        if cell == "fresh":
            p = len(topic_map["giant-fresh"])

            def plan():
                return [("giant-fresh", assigner.solver.fresh_assignment(
                    "giant-fresh", p, live, rack_map, RF, Context()))]
        else:
            topics = list(topic_map.items())

            def plan():
                assigner.context = Context()
                return assigner.generate_assignments(topics, live, rack_map)

        def solve():
            return plan(), assigner.solver

        med = codec_ab(f"giant {cell}", solve, GIANT_SOLVE_REPS)
        waves = dict(assigner.solver.last_waves)
        if "dense" in waves or "seq" in waves:
            fail(f"giant {cell}: a rescue leg ran ({waves})")
        phase("timing", f"giant {cell} solve median of {GIANT_SOLVE_REPS} (ms): "
              f"{phase_ms(med['c'])}; waves {waves}")
        out[cell] = dict(med, waves=waves)
    return out


def timed_turns(solve, variants, reps):
    """``solve()`` under each variant's knobs in turns, ``reps + 1`` rounds,
    the first a warm-up. ``solve()`` returns ``(plan pairs, solver)``.
    Returns ``{variant: (medians of the total and of each phase (ms), the
    plan's text of the last run, the solver's last_codec and last_leadership
    of the last run, leadership kernel launches over every run)}``."""
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs
    from kafka_assigner_tpu_torch.ops import leadership as lead

    runs = {name: [] for name in variants}
    last, launched = {}, dict.fromkeys(variants, 0)
    for i in range(reps + 1):
        for name, values in variants.items():
            with knobs(**values):
                before = lead.launches["leadership"]
                t0 = time.perf_counter()
                pairs, solver = solve()
                total = (time.perf_counter() - t0) * 1e3
                launched[name] += lead.launches["leadership"] - before
            if i:
                runs[name].append(dict(solver.last_timers, total=total))
            last[name] = (pairs, dict(solver.last_codec), solver.last_leadership)
    last = {name: (format_reassignment_pairs(pairs), *rest)
            for name, (pairs, *rest) in last.items()}
    return {name: ({k: statistics.median(r[k] for r in rs) for k in rs[0]}, *last[name],
                   launched[name])
            for name, rs in runs.items()}


PHASES = ("total", "encode", "place", "leadership", "decode")


def phase_ms(med):
    return ", ".join(f"{k} {med[k]:.1f}" for k in PHASES)


def codec_ab(what, solve, reps):
    """The boundary codec A/B within one call: the C codec and
    ``KA_HOSTCODEC=0`` in turns; fails unless the C codec ran where it is
    on and the plans are byte-identical. Returns the medians of each."""
    got = timed_turns(solve, {"c": {"KA_HOSTCODEC": 1}, "numpy": {"KA_HOSTCODEC": 0}}, reps)
    (med_c, text_c, codec_c, _, _), (med_n, text_n, codec_n, _, _) = got["c"], got["numpy"]
    if codec_c["decode"] != "c" or codec_n != {"encode": "numpy", "decode": "numpy"}:
        fail(f"{what}: codec routes {codec_c} with KA_HOSTCODEC=1, {codec_n} with 0")
    if text_c != text_n:
        fail(f"{what}: the plans differ between the C codec and numpy")
    phase("timing", f"codec A/B {what}, median of {reps} in turns (ms): C codec "
          f"({codec_c['encode']} encode, c decode): {phase_ms(med_c)}; KA_HOSTCODEC=0: "
          f"{phase_ms(med_n)}; plans byte-identical ({len(text_c)} bytes)")
    return {"c": med_c, "numpy": med_n, "routes": codec_c}


def replicas_held(topic_map):
    held = {}
    for cur in topic_map.values():
        for reps in cur.values():
            for b in reps:
                held[b] = held.get(b, 0) + 1
    return held


def as_tuples(results):
    return [dataclasses.astuple(r) for r in results]


def whatif_config5():
    """Phase 10: BASELINE config 5 on both sweep paths on the card, against
    each other and the port's cpu run; warm medians by phase, waves, rows,
    chunks and peak device memory per path. Returns them per path, with the
    results (``as_tuples``)."""
    import torch

    from kafka_assigner_tpu_torch.models.synthetic import build_config5
    from kafka_assigner_tpu_torch.parallel import whatif

    topic_map, live, racks = build_config5()
    scenarios = [[b] for b in range(CONFIG5_SCENARIOS)]
    held = replicas_held(topic_map)
    results, out = {}, {}
    for path, flag in (("incremental", 1), ("dense", 0)):
        with knobs(KA_WHATIF_INCREMENTAL=flag):
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for i in range(WHATIF_REPS + 1):  # 1 cold
                t0 = time.perf_counter()
                res = whatif.evaluate_removal_scenarios(topic_map, live, racks,
                                                        scenarios, 3, device="cuda")
                total = (time.perf_counter() - t0) * 1e3
                if i:
                    runs.append(dict(whatif.last_sweep, total=total))
            peak = torch.cuda.max_memory_allocated()
        rec = runs[-1]
        if rec["path"] != path:
            fail(f"config 5: the {path} sweep did not run ({rec['path']} did)")
        med = {k: statistics.median(r[k] for r in runs)
               for k in ("total", "prep", "sweep", "rescue", "compose")}
        host = med["prep"] + med["compose"]
        phase("whatif", f"config 5 {path} on cuda, 256 scenarios, warm median of "
              f"{WHATIF_REPS} (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
              + f"; host share {host / med['total']:.2f}; rows {rec['rows']}, "
              f"t_pad {rec['t_pad']}, chunks {rec['chunks']}, waves {rec['waves']}, "
              f"rescued {rec['rescued']}, peak device memory {peak / 2**20:.1f} MiB")
        results[path] = as_tuples(res)
        out[path] = dict(med, rows=rec["rows"], chunks=rec["chunks"],
                         waves=rec["waves"], peak_bytes=peak)
    t0 = time.perf_counter()
    cpu = as_tuples(whatif.evaluate_removal_scenarios(topic_map, live, racks, scenarios,
                                                      3, device="cpu"))
    if not results["incremental"] == results["dense"] == cpu:
        fail("config 5: incremental, dense and cpu sweeps differ")
    for removed, moved, feasible, _ in cpu:
        if not feasible or moved != held[removed[0]]:
            fail(f"config 5: scenario {removed} feasible={feasible} moved {moved}, "
                 f"expected {held[removed[0]]}")
    span = sorted({held[b] for b in range(CONFIG5_SCENARIOS)})
    phase("whatif", f"config 5: incremental == dense == cpu ({time.perf_counter() - t0:.1f} s "
          f"on the CPU) on all {CONFIG5_SCENARIOS} scenarios, all feasible, moved == "
          f"replicas held ({span[0]}-{span[-1]})")
    for path in out:
        out[path]["results"] = results[path]
    return out


def rank_config4(work):
    """Phase 11: RANK_DECOMMISSION of every live broker of config 4's
    steady-state cluster through the CLI on cuda, then 16 candidates and a
    scenario file on cuda and cpu. Returns the snapshot and the record."""
    import torch

    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.parallel import whatif

    topic_map, live, racks = rack_striped_cluster(
        N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, name_fmt="topic-{:04d}")
    snap = os.path.join(work, "config4_steady.json")
    write_snapshot(snap, topic_map, live, racks)
    held = replicas_held(topic_map)
    argv = ["--zk_string", f"file://{snap}", "--mode", "RANK_DECOMMISSION"]
    marker = "DECOMMISSION RANKING:\n"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    text = run_cli(argv + ["--device", "cuda"])
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec = dict(whatif.last_sweep)
    rows = json.loads(text.split(marker, 1)[1])
    if len(rows) != len(live) or not all(r["feasible"] for r in rows):
        fail(f"rank: {len(rows)} rows for {len(live)} brokers, or an infeasible one")
    keys = [(not r["feasible"], r["moved_replicas"], r["broker"]) for r in rows]
    if keys != sorted(keys):
        fail("rank: rows are not sorted least-disruptive-first")
    for r in rows:
        if r["moved_replicas"] != held[r["broker"]]:
            fail(f"rank: broker {r['broker']} moved {r['moved_replicas']}, "
                 f"held {held[r['broker']]}")
    span = sorted(set(held.values()))
    host = rec["prep"] + rec["compose"]
    phase("whatif", f"RANK_DECOMMISSION of config 4's {len(live)} brokers on cuda: "
          f"{wall_s:.2f} s wall; sweep (ms) prep {rec['prep']:.1f}, sweep "
          f"{rec['sweep']:.1f}, rescue {rec['rescue']:.1f}, compose {rec['compose']:.1f}; "
          f"host share {host / (host + rec['sweep'] + rec['rescue']):.2f}; path {rec['path']}, "
          f"t_pad {rec['t_pad']}, rows {rec['rows']}, chunks {rec['chunks']}, waves "
          f"{rec['waves']}, peak device memory {peak / 2**30:.2f} GiB; {len(rows)} rows "
          f"feasible, sorted, moved == held ({span[0]}-{span[-1]})")

    scen = os.path.join(work, "scenarios.json")
    with open(scen, "w", encoding="utf-8") as f:
        json.dump([[0, 10], [1, 2], ["b7"], []], f)  # same rack, cross rack
    texts = {}
    for what, extra in (
        ("16 candidates", ["--integer_broker_ids", ",".join(map(str, RANK_CANDIDATES))]),
        ("scenario file", ["--scenario_file", scen]),
    ):
        a = run_cli(argv + extra + ["--device", "cuda"])
        c = run_cli(argv + extra + ["--device", "cpu"])
        if a != c:
            fail(f"rank {what}: cuda and cpu stdout differ")
        texts[what] = a
        phase("cuda==cpu", f"RANK_DECOMMISSION {what} on config 4's cluster: stdout "
              f"byte-identical ({len(a)} bytes, path {whatif.last_sweep['path']})")
    return snap, dict(rec, wall_s=wall_s, peak_bytes=peak,
                      candidates_text=texts["16 candidates"])


def rescue_parity():
    """Phase 12: scenarios the fast sweep strands, re-run by the rescue on
    the auto chain, on cuda and cpu (the instance of
    ``tests/test_torch_whatif.py:rescue_cluster``)."""
    import numpy as np

    from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster
    from kafka_assigner_tpu_torch.parallel import whatif

    topic_map, live, racks = rack_striped_cluster(100, 1, 2000, RF, 5, name_fmt="rescue-{:02d}")
    rng = np.random.default_rng(0)
    by_rack = {}
    for b in sorted(live):
        by_rack.setdefault(racks[b], []).append(b)
    # Four brokers of every rack: cap ceil(6,000 / 80) = 75, no slack.
    scenarios = [sorted(int(x) for r in sorted(by_rack)
                        for x in rng.choice(by_rack[r], 4, replace=False))
                 for _ in range(4)] + [[0], []]
    out = {}
    for dev in ("cuda", "cpu"):
        res = whatif.evaluate_removal_scenarios(topic_map, live, racks, scenarios, RF,
                                                device=dev)
        out[dev] = (as_tuples(res), dict(whatif.last_sweep))
    (a, rec), (c, rec_c) = out["cuda"], out["cpu"]
    if rec["rescued"] < 1 or rec["rescued"] != rec_c["rescued"] or a != c:
        fail(f"rescue: cuda rescued {rec['rescued']}, cpu {rec_c['rescued']}, "
             f"results equal: {a == c}")
    phase("cuda==cpu", f"what-if rescue: {rec['rescued']} of {len(scenarios)} scenarios "
          f"stranded the fast sweep and re-ran on the auto chain ({rec['rescue']:.1f} ms "
          f"on cuda, waves {rec['rescue_waves']}); results equal on cuda and cpu: "
          + ", ".join(f"{m}{'' if f else ' infeasible'}" for _, m, f, _ in a))

    # The four stranded scenarios' sweeps timed on the card: the fast leg,
    # the auto chain the rescue runs, and the seq leg alone.
    import torch

    from kafka_assigner_tpu_torch.carry import to_tensor
    from kafka_assigner_tpu_torch.models.problem import encode_topic_group
    from kafka_assigner_tpu_torch.ops.assignment import whatif_sweep

    encs, cur, jh, pr = encode_topic_group(list(topic_map.items()), racks, live, RF)
    alive = np.zeros((4, encs[0].n_pad), bool)
    alive[:, : encs[0].n] = True
    for s, removed in enumerate(scenarios[:4]):
        alive[s, np.searchsorted(encs[0].broker_ids, removed)] = False
    args = [to_tensor(x, "cuda") for x in (cur, encs[0].rack_idx, jh, pr)]
    args.append(torch.as_tensor(alive).cuda())
    legs = []
    for mode in ("fast", "auto", "seq"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = whatif_sweep(*args, encs[0].n, RF, mode, r_cap=encs[0].r_cap)
        torch.cuda.synchronize()
        legs.append(f"{mode} {(time.perf_counter() - t0) * 1e3:.1f} ms {res.waves}")
    phase("whatif", "rescue instance, the 4 stranded scenarios on cuda: " + "; ".join(legs))


def host_modes(snap, n_brokers, n_partitions):
    """Phase 13: the two current-state modes on phase 11's snapshot."""
    for mode, marker, count in (
        ("PRINT_CURRENT_ASSIGNMENT", "CURRENT ASSIGNMENT:\n",
         lambda d: len(d["partitions"])),
        ("PRINT_CURRENT_BROKERS", "CURRENT BROKERS:\n", len),
    ):
        argv = ["--zk_string", f"file://{snap}", "--mode", mode]
        a = run_cli(argv + ["--device", "cuda"])
        c = run_cli(argv + ["--device", "cpu"])
        got = count(json.loads(a.split(marker, 1)[1]))
        want = n_partitions if mode == "PRINT_CURRENT_ASSIGNMENT" else n_brokers
        if a != c or got != want:
            fail(f"{mode}: {got} entries (expected {want}), or cuda and cpu differ")
        phase("host", f"{mode}: {got} entries, {len(a)} bytes, identical on cuda and cpu")


def group_kernel_cases():
    """Phase 3b: the group-pack kernel against its plain version on the
    stress cases. Returns max |kernel - plain| over every case."""
    from kafka_assigner_tpu_torch.ops import group_pack as gp
    from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases

    worst = 0
    for case in gcases.stress_cases():
        name, w, cap = case[:3]
        err = gcases.check_case(case)
        worst = max(worst, err)
        if err:
            fail(f"group-pack kernel disagrees with plain on case {name}")
        phase("kernels", f"group_pack {name} (S={w.shape[0]} P_pad={w.shape[1]} "
              f"C_pad={cap.shape[0]}{', forced global' if case[7] else ''}; "
              f"variant {variant_name(gp.last_variant, case[5])}): bit-equal")
    return worst


def variant_name(variant, alive):
    """``registers/K`` (the consumers a lane of the candidates, ``alive``
    their liveness), ``shared`` or ``global``."""
    from kafka_assigner_tpu_torch.ops import group_pack as gp

    if variant != "registers":
        return variant
    return "registers/" + ",".join(map(str, sorted({gp.span_slots(row) for row in alive})))


def write_group_snapshot(path, topic_map, live, racks):
    """Config 4's steady cluster with phase 14's ``groups`` section; returns
    the old owner of every (topic, partition)."""
    import numpy as np

    rows = sorted((t, p) for t, parts in topic_map.items() for p in parts)
    rng = np.random.default_rng(0)
    lags = np.minimum((rng.pareto(1.2, len(rows)) * 100).astype(np.int64), 10**7)
    owner, assignment, lag = {}, {}, {}
    for i, (t, p) in enumerate(rows):
        owner[t, p] = f"c-{i % GROUP_OWNERS:03d}"
        assignment.setdefault(t, {})[str(p)] = owner[t, p]
        lag.setdefault(t, {})[str(p)] = int(lags[i])
    write_snapshot(path, topic_map, live, racks)
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    data["groups"] = {"ingest": {
        "members": {f"c-{m:03d}": None for m in range(GROUP_MEMBERS)},
        "assignment": assignment, "lag": lag,
    }}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)
    return owner


def groups_cli(argv):
    """``run_groups(argv)`` with stdout captured: ``(rc, stdout, stderr)``."""
    from kafka_assigner_tpu_torch.cli import run_groups

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_groups(argv)
    return rc, out.getvalue(), err.getvalue()


def groups_cpu_run(argv):
    """Worker process: the ``ka-groups`` run on ``cpu``; returns ``(rc,
    stdout, seconds)``."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    rc, out, _ = groups_cli(argv + ["--device", "cpu"])
    return rc, out, time.perf_counter() - t0


def group_plain_check(inputs, outputs):
    """Worker process: the plain group-pack scan on ``inputs`` (numpy
    arrays: weights, capacities, proc_order, alive, need, assigned, load),
    against the kernel's ``outputs`` (assigned, load, overflowed); returns
    (max |kernel - plain|, seconds)."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from kafka_assigner_tpu_torch.ops.group_pack import pack_scan_plain

    t0 = time.perf_counter()
    t = [torch.from_numpy(a) for a in inputs]
    over = pack_scan_plain(*t)
    plain = (t[5].numpy(), t[6].numpy(), over.numpy())
    err = max(int(np.abs(k.astype(np.int64) - p).max()) for k, p in zip(outputs, plain))
    return err, time.perf_counter() - t0


def hold_group_launch(checks, what, shape, inputs, outputs):
    """Hold one group-pack launch (its ``inputs`` and ``outputs`` on the
    card) against the plain version in the workers, GROUP_PLAIN_SLICE
    candidates a job: capacities and proc_order are shared, every other
    array is sliced on its candidate axis."""
    inputs = tuple(a.cpu().numpy() for a in inputs)
    outputs = tuple(a.cpu().numpy() for a in outputs)
    s = inputs[0].shape[0]
    for lo in range(0, s, GROUP_PLAIN_SLICE):
        hi = min(s, lo + GROUP_PLAIN_SLICE)
        part = "" if (lo, hi) == (0, s) else f", candidates {lo}-{hi - 1}"

        def checked(result, part=part):
            err, secs = result
            if err:
                fail(f"{what}: group-pack kernel disagrees with plain at {shape}{part}")
            phase("kernels", f"group_pack at {what} {shape}{part}: bit-equal to plain on "
                  f"assigned, load and overflowed (plain on CPU {secs:.1f} s in a worker)")
            return err

        checks.job("group_pack", checked, group_plain_check,
                   tuple(a if i in (1, 2) else a[lo:hi] for i, a in enumerate(inputs)),
                   tuple(a[lo:hi] for a in outputs))


@contextlib.contextmanager
def scan_probe():
    """Record, for a block, every group-pack scan call: ``(inputs,
    outputs)``, inputs copied before the call (it updates ``assigned`` and
    ``load`` in place). Wraps ``ops/group_pack.py:pack_scan`` and restores
    it afterwards; the wrapper and its launch count are untouched."""
    from kafka_assigner_tpu_torch.ops import group_pack as gp

    seen = []
    real = gp.pack_scan

    def recorded(*args, **kw):
        inputs = tuple(t.clone() for t in args[:7])
        over = real(*args, **kw)
        seen.append((inputs, (args[5].clone(), args[6].clone(), over.clone())))
        return over

    gp.pack_scan = recorded
    try:
        yield seen
    finally:
        gp.pack_scan = real


def scan_timing(what, inputs, outputs):
    """The kernel alone on a main path's inputs: median of KERNEL_REPS
    launches by CUDA events (``assigned`` and ``load`` re-copied before
    each, outside the events), its result held against the launch checked
    against plain. Returns (ms, min, max)."""
    import torch

    from kafka_assigner_tpu_torch.ops import group_pack as gp

    times = []
    for i in range(KERNEL_REPS + 1):  # 1 warm-up
        assigned, load = inputs[5].clone(), inputs[6].clone()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        over = gp.pack_scan(*inputs[:5], assigned, load)
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    if any(not torch.equal(x, y) for x, y in zip((assigned, load, over), outputs)):
        fail(f"{what}: the timed group-pack launch differs from the checked one")
    return statistics.median(times), min(times), max(times)


class GroupRuns:
    """Phases 14-16's ``ka-groups`` paths. Each path's ``cpu`` run goes to
    the workers as soon as its snapshot exists (phase 14's right after
    phase 4, the synthetic sweep's after phase 11), so the longest of them,
    the sweep's, runs beside the phases before 14; at collect each is held
    against the ``cuda`` run's stdout that :func:`group_phases` records in
    ``texts``."""

    def __init__(self, work, checks):
        from kafka_assigner_tpu_torch.models.synthetic import rack_striped_cluster

        topic_map, live, racks = rack_striped_cluster(
            N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, name_fmt="topic-{:04d}")
        self.snap = os.path.join(work, "config4_groups.json")
        self.owner = write_group_snapshot(self.snap, topic_map, live, racks)
        self.checks = checks
        self.texts = {}
        base = ["--zk_string", f"file://{self.snap}"]
        counts = ",".join(map(str, GROUP_COUNTS))
        scales = ",".join(map(str, GROUP_SCALES))
        self.paths = {
            "group_plan": base + ["--mode", "plan"],
            "group_sweep": base + ["--mode", "sweep", "--counts", counts,
                                   "--scales", scales],
        }
        for path in self.paths:
            self._cpu_run(path)

    def add_synthetic(self, steady_snap):
        """The synthetic sweep over phase 11's steady snapshot."""
        self.paths["group_synthetic"] = ["--zk_string", f"file://{steady_snap}", "--mode",
                                         "sweep", "--synthetic", "--weight", "throughput"]
        self._cpu_run("group_synthetic")

    def _cpu_run(self, path):
        def done(result, path=path):
            rc_c, text_c, secs = result
            text = self.texts.get(path)
            if rc_c != 0 or text_c != text:
                fail(f"{path}: ka-groups stdout differs on cuda and cpu (cpu rc {rc_c}, "
                     f"cuda run done {text is not None})")
            phase("cuda==cpu", f"{path}: ka-groups stdout byte-identical on cuda and "
                  f"cpu ({len(text)} bytes; the cpu run {secs:.1f} s in a worker)")
            return 0

        self.checks.job("group_pack", done, groups_cpu_run, self.paths[path])


def group_phases(runs, steady_snap):
    """Phases 14-16: ``ka-groups`` plan, sweep and the synthetic sweep on
    config 4's cluster (``runs``, whose ``cpu`` runs are already with the
    workers), each ``cuda`` run with the kernel counts reset just before and
    read just after; plain checks go to the workers. Returns the group-pack
    kernel's entry of the ``kernels`` line, and each path's argv and
    ``cuda`` stdout."""
    import numpy as np
    import torch

    from kafka_assigner_tpu_torch.groups import solve as gsolve
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend
    from kafka_assigner_tpu_torch.ops import group_pack as gp
    from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases
    from kafka_assigner_tpu_torch.parallel import whatif

    checks, snap, owner, paths = runs.checks, runs.snap, runs.owner, runs.paths
    by_path, records, texts, timed = {}, {}, runs.texts, {}
    for path, argv in paths.items():
        with scan_probe() as seen:
            gp.launches["group_pack"] = 0
            t0 = time.perf_counter()
            rc, text, err = groups_cli(argv + ["--device", "cuda"])
            wall = time.perf_counter() - t0
            by_path[path] = gp.launches["group_pack"]
        if rc != 0:
            fail(f"{path}: ka-groups exited {rc} on cuda: {err.strip()}")
        if by_path[path] < 1 or len(seen) != by_path[path]:
            fail(f"{path}: the group-pack kernel launched {by_path[path]} times")
        records[path] = dict(whatif.last_groups, wall_s=wall)
        texts[path] = text
        inputs, outputs = seen[0]
        shape = f"S={inputs[0].shape[0]} P_pad={inputs[0].shape[1]} C_pad={inputs[1].shape[0]}"
        hold_group_launch(checks, path, shape, inputs, outputs)
        timed[path] = (inputs, outputs, shape)
        rec = records[path]
        phase("groups", f"{path} on cuda: {wall:.2f} s wall; {shape}; steps (orphan "
              f"rows) max {rec['steps_max']}, sum {rec['steps_sum']}; (ms) encode "
              f"{rec['encode']:.1f}, upload {rec['upload']:.1f}, sticky {rec['sticky']:.1f}, "
              f"scan {rec['scan']:.1f}, download {rec['download']:.1f}, decode "
              f"{rec['decode']:.1f}; group-pack kernel launches {by_path[path]}")

    # Phase 14: every row on a live member, moves == rows whose owner changed.
    plan = json.loads(texts["group_plan"])
    members = {f"c-{m:03d}" for m in range(GROUP_MEMBERS)}
    placed = {(t, int(p)): m for t, per in plan["plan"].items() for p, m in per.items()}
    if set(placed) != set(owner) or not set(placed.values()) <= members:
        fail("group plan: a row is missing or sits on a member that left")
    # A departed member's rows are unowned in the encoding: they are placed,
    # not moved, so moves counts the rows taken off a live owner.
    changed = sum(placed[k] != o for k, o in owner.items() if o in members)
    departed = sum(o not in members for o in owner.values())
    if plan["moves"] != changed:
        fail(f"group plan: moves {plan['moves']} != {changed} rows taken off a live owner")
    phase("groups", f"plan: {len(placed)} rows on {len(set(placed.values()))} live members; "
          f"moves {plan['moves']} == rows taken off a live owner; {departed} rows of "
          f"departed members placed; orphan rows "
          f"{records['group_plan']['steps_sum']}; overflowed {plan['overflowed']}; "
          f"feasible {plan['feasible']}")
    # Phase 15: the cost curve.
    sweep = json.loads(texts["group_sweep"])
    if "recommended_consumers" not in sweep or len(sweep["candidates"]) != \
            len(GROUP_COUNTS) * len(GROUP_SCALES):
        fail("group sweep: no recommendation or a wrong candidate count")
    feas = {s: min([c["consumers"] for c in sweep["candidates"]
                    if c["scale_pct"] == s and c["feasible"]], default=None)
            for s in GROUP_SCALES}
    phase("groups", f"sweep: recommended_consumers {sweep['recommended_consumers']}; "
          f"smallest feasible count per scale {feas}")
    synth = json.loads(texts["group_synthetic"])
    rc, out, err = groups_cli(["--zk_string", f"file://{steady_snap}", "--mode", "sweep",
                               "--weight", "throughput", "--device", "cuda"])
    if rc != 1 or out or "--synthetic" not in err:
        fail(f"the refusal without --synthetic: exit {rc}, stdout {len(out)} bytes")
    phase("groups", f"synthetic: {len(synth['candidates'])} candidates, "
          f"recommended_consumers {synth['recommended_consumers']}; without "
          "--synthetic: refused, exit 1")

    # Phase 15's timing: the sweep through the library, warm median of 3.
    backend = SnapshotBackend(snap)
    part_map = {t: sorted(per) for t, per in
                backend.partition_assignment(backend.all_topics()).items()}
    states, real = gsolve.load_group_states(backend, part_map)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(GROUP_SWEEP_REPS + 1):  # 1 warm-up
        t0 = time.perf_counter()
        gsolve.build_group_bodies(states, real, part_map, "sweep", "lag", None,
                                  list(GROUP_SCALES), 1.25, 256,
                                  counts=list(GROUP_COUNTS), device="cuda")
        if i:
            runs.append(dict(whatif.last_groups, total=(time.perf_counter() - t0) * 1e3))
    peak = torch.cuda.max_memory_allocated()
    keys = ("total", "encode", "upload", "sticky", "scan", "download", "decode")
    med = {k: statistics.median(r[k] for r in runs) for k in keys}
    phase("timing", f"group sweep median of {GROUP_SWEEP_REPS} (ms): "
          + ", ".join(f"{k} {med[k]:.1f}" for k in keys)
          + f"; steps max {runs[-1]['steps_max']}, sum {runs[-1]['steps_sum']}; "
          f"peak device memory {peak / 2**20:.1f} MiB")

    # The kernel alone at each path's shape, its bound, its chain floor (the
    # longest chain times the step probe's time a step) and the register
    # variant's (times the ballot probe's), the ratios to them, and the
    # chain at the kernel's own time a step (one all-orphan candidate, every
    # consumer alive, at the longest chain's K in the register variant).
    probe_ns, probe_cycles = gcases.probe_ns()
    phase("timing", f"group_pack step probe: {probe_ns:.2f} ns, {probe_cycles:.2f} cycles "
          "a step of the chain alone (two warp reductions and the bump, one warp)")
    ballot_ns, ballot_cycles = gcases.probe_ns(ballot=True)
    phase("timing", f"group_pack ballot probe: {ballot_ns:.2f} ns, {ballot_cycles:.2f} "
          "cycles a step of the chain alone (one warp reduction, a ballot and the bump, "
          "one warp): the register variant's floor")
    step_by_c = {}
    for c_pad in gcases.BUCKET_C_PADS + (gcases.SHARED_C_PAD,):
        step_by_c[c_pad] = gcases.step_ns(c_pad)
        label = variant_name(gp.last_variant, [[True] * c_pad])
        phase("timing", f"group_pack kernel's own step at C_pad {c_pad} (variant "
              f"{label}, one all-orphan candidate): {step_by_c[c_pad]:.1f} ns, "
              f"{step_by_c[c_pad] / probe_ns:.2f}x the probe, "
              f"{step_by_c[c_pad] / ballot_ns:.2f}x the ballot probe")
    out = {}
    for path, (inputs, outputs, shape) in timed.items():
        ms, lo, hi = scan_timing(path, inputs, outputs)
        variant = gp.last_variant
        s_, p_ = inputs[0].shape
        c_ = inputs[1].shape[0]
        rec = records[path]
        nbytes = gcases.scan_bytes(s_, p_, c_, rec["steps_sum"])
        orphans = inputs[4].sum(1).tolist()
        longest = max(range(s_), key=orphans.__getitem__)
        slots = gp.span_slots(inputs[3][longest].tolist()) if variant == "registers" else 0
        step_c = 32 * slots if slots else c_
        step = step_by_c.get(step_c) or gcases.step_ns(step_c)
        # Each candidate's chain at its own K's step: the slowest of them.
        slowest_ms = max(n * (step_by_c[32 * gp.span_slots(row)] if slots else step)
                         for n, row in zip(orphans, inputs[3].tolist())) * 1e-6
        chain_bound_ms = rec["steps_max"] * probe_ns * 1e-6
        register_floor_ms = rec["steps_max"] * ballot_ns * 1e-6
        out[path] = dict(ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
                         c_pad=c_, variant=variant, longest_chain_slots=slots,
                         chain_steps=rec["steps_max"], step_probe_ns=probe_ns,
                         chain_bound_ms=chain_bound_ms,
                         ratio_to_chain_floor=ms / chain_bound_ms,
                         register_floor_ms=register_floor_ms,
                         ratio_to_register_floor=ms / register_floor_ms,
                         kernel_step_ns=step, kernel_step_c_pad=step_c,
                         chain_kernel_ms=rec["steps_max"] * step * 1e-6,
                         slowest_chain_kernel_ms=slowest_ms)
        phase("timing", f"group_pack kernel at {path} ({shape}, variant "
              f"{variant_name(variant, inputs[3].tolist())}; the longest chain's "
              f"candidate at {slots} consumers a lane): median {ms:.3f} ms of "
              f"{KERNEL_REPS} (min {lo:.3f}, max {hi:.3f}); byte bound "
              f"{out[path]['bound_ms']:.4f} ms ({nbytes} bytes); chain floor "
              f"{chain_bound_ms:.3f} ms ({rec['steps_max']} steps x {probe_ns:.2f} ns of "
              f"the probe); ms / chain floor {out[path]['ratio_to_chain_floor']:.3f}; "
              f"register floor {register_floor_ms:.3f} ms (x {ballot_ns:.2f} ns of the "
              f"ballot probe), ms / it {out[path]['ratio_to_register_floor']:.3f}; the "
              f"chain at the kernel's own {step:.1f} ns a step (one all-orphan "
              f"candidate at C_pad {step_c}) {out[path]['chain_kernel_ms']:.3f} ms; the "
              f"slowest candidate's chain at its own K's step {slowest_ms:.3f} ms")
    r = GROUP_PLAIN_SHAPE
    rng = np.random.default_rng(1)
    w, cap, cur, order, alive = gcases.instance(rng, r["s"], r["p"], r["p"], r["c"], r["c"])
    case = ("plain-shape", w, cap, cur, order, alive, r["p"], False)
    small = gcases.scan_inputs(case, "cuda")
    plain_in = tuple(x.clone() for x in small)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    over_p = gp.pack_scan_plain(*plain_in)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # The timed launches are held against the plain version's result here.
    small_ms, _, _ = scan_timing("the plain shape", small, (*plain_in[5:], over_p))
    plain_shape = f"S={r['s']} P_pad={r['p']} C_pad={r['c']}"
    phase("timing", f"group_pack at {plain_shape}: kernel {small_ms:.3f} ms, plain on "
          f"the card {plain_ms:.1f} ms")
    main = out["group_sweep"]
    return {
        "name": "group_pack",
        "route": "cuda",
        "source": "kafka_assigner_tpu_torch/csrc/group_pack.cu",
        "replaces": GROUP_TPU_LOOP,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": 0,
        "tolerance": "exact (integer outputs)",
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "plain_shape": plain_shape,
        "ms_at_plain_shape": small_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "chain_steps": main["chain_steps"],
        "chain_bound_ms": main["chain_bound_ms"],
        "step_probe_ns": probe_ns,
        "step_probe_cycles": probe_cycles,
        "ballot_probe_ns": ballot_ns,
        "ballot_probe_cycles": ballot_cycles,
        "chain_kernel_ms": main["chain_kernel_ms"],
        "variant": main["variant"],
        "longest_chain_slots": main["longest_chain_slots"],
        "ratio_to_chain_floor": main["ratio_to_chain_floor"],
        "register_floor_ms": main["register_floor_ms"],
        "ratio_to_register_floor": main["ratio_to_register_floor"],
        "step_ns_by_c_pad": {str(c): v for c, v in step_by_c.items()},
        "by_path": out,
    }, {path: (argv, texts[path]) for path, argv in paths.items()}


def leadership_lanes(argv4, config4, cells, work):
    """Phase 17: ``KA_LEADERSHIP=native`` against ``device`` on config 4 and
    the giant expansion. Through the CLI on cuda: stdout byte-identical, the
    leadership kernel launched on the device lane only. Then a warm median
    of each lane in turns, split by phase; the native lane's leadership
    phase includes copying the placement to the host."""
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.solvers.base import Context

    g_map, g_live, g_racks, _, _ = cells["expansion"]
    g_argv = ["--zk_string", f"file://{os.path.join(work, 'giant_expansion.json')}",
              "--mode", "PRINT_REASSIGNMENT"]
    lanes = {"native": {"KA_LEADERSHIP": "native"}, "device": {"KA_LEADERSHIP": "device"}}
    out = {}
    for what, argv, (topics, live, rack_map), reps in (
        ("config 4", argv4, config4, SOLVE_REPS),
        ("giant expansion", g_argv, (list(g_map.items()), g_live, g_racks), GIANT_SOLVE_REPS),
    ):
        texts, launched = {}, {}
        for lane, values in lanes.items():
            with knobs(**values):
                lead.launches["leadership"] = 0
                texts[lane] = run_cli(argv + ["--device", "cuda"])
                launched[lane] = lead.launches["leadership"]
        if texts["native"] != texts["device"]:
            fail(f"{what}: the plans differ on the native and device leadership lanes")
        if launched["native"] or launched["device"] < 1:
            fail(f"{what}: leadership kernel launches {launched} (native must be 0)")
        assigner = TopicAssigner(device="cuda")

        def solve(topics=topics, live=live, rack_map=rack_map):
            assigner.context = Context()
            return assigner.generate_assignments(topics, live, rack_map), assigner.solver

        got = timed_turns(solve, lanes, reps)
        (med_n, text_n, _, lane_n, k_n), (med_d, text_d, _, lane_d, k_d) = \
            got["native"], got["device"]
        if (lane_n, lane_d) != ("native", "cuda") or k_n or k_d != reps + 1 \
                or text_n != text_d:
            fail(f"{what}: lanes ran {lane_n}/{lane_d}, kernel launches {k_n}/{k_d}, "
                 f"plans equal {text_n == text_d}")
        phase("lanes", f"{what}: CLI stdout byte-identical on KA_LEADERSHIP=native and "
              f"device ({len(texts['native'])} bytes); leadership kernel launches "
              f"{launched['native']} / {launched['device']}; median of {reps} in turns "
              f"(ms): native {phase_ms(med_n)}; device {phase_ms(med_d)}")
        out[what] = {"native": med_n, "device": med_d, "cli_launches": launched}
    return out


def moved_count(plan, topic_map):
    return sum(len(set(reps) - set(topic_map[t][p]))
               for t, per in plan.items() for p, reps in per.items())


def solver_lanes(argv4, device_text, prefix, prefix_text, topic_map, live, rack_map,
                 cap, on_removed):
    """Phase 18: ``--solver native`` on config 4 through the CLI, then
    ``--solver greedy`` and ``native`` on phase 5's prefix; neither launches
    the leadership kernel. The C++ greedy places orphans first-fit where the
    device solver runs its waves, so the two NEW ASSIGNMENT sections agree
    in what moves, not in every list (as in the JAX package's lanes, which
    the CPU tests hold these to). Returns the ``--solver greedy`` prefix
    text."""
    from kafka_assigner_tpu_torch.ops import leadership as lead

    lead.launches["leadership"] = 0
    t0 = time.perf_counter()
    native = run_cli(argv4 + ["--solver", "native", "--device", "cuda"])
    wall = time.perf_counter() - t0
    marker = "NEW ASSIGNMENT:\n"
    if native.split(marker)[0] != device_text.split(marker)[0]:
        fail("--solver native: the CURRENT ASSIGNMENT section differs from --solver device's")
    plan_n, plan_d = plan_section(native), plan_section(device_text)
    moved = check_plan(plan_n, topic_map, live, rack_map, cap, on_removed)
    differ = sum(plan_n[t][p] != plan_d[t][p] for t in plan_n for p in plan_n[t])
    phase("solvers", f"--solver native on config 4 through the CLI: {wall:.2f} s wall, "
          f"moved {moved} == --solver device's; {differ} of "
          f"{sum(map(len, plan_n.values()))} lists differ from the device plan")
    sub = {t: topic_map[t] for t in prefix.split(",")}
    texts = {}
    for solver in ("greedy", "native"):
        t0 = time.perf_counter()
        texts[solver] = run_cli(argv4 + ["--topics", prefix, "--solver", solver,
                                         "--device", "cuda"])
        texts[solver + "_s"] = time.perf_counter() - t0
    if texts["greedy"] != texts["native"]:
        fail(f"{PREFIX_TOPICS}-topic prefix: --solver greedy and native differ")
    want = moved_count(plan_section(prefix_text), sub)
    moved_p = check_plan(plan_section(texts["greedy"]), sub, live, rack_map, cap, want)
    if lead.launches["leadership"]:
        fail(f"the greedy lanes launched the leadership kernel {lead.launches['leadership']}"
             " times")
    phase("solvers", f"{PREFIX_TOPICS}-topic prefix: --solver greedy "
          f"({texts['greedy_s']:.2f} s) and native ({texts['native_s']:.2f} s) "
          f"byte-identical, moved {moved_p} == --solver device's; leadership kernel "
          "launches 0 on the greedy lanes")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "torch_bench.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"scripts/torch_bench.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    bench = json.loads(line)
    extra = bench["extra"]
    if extra["moved_replicas"] != on_removed or extra["codec"] != \
            {"encode": "c", "decode": "c"} or extra["leadership"] != "cuda":
        fail(f"scripts/torch_bench.py: unexpected run {extra}")
    phase("solvers", f"scripts/torch_bench.py in a subprocess ({time.perf_counter() - t0:.1f} s), "
          "its line:")
    print(line, flush=True)
    return texts["greedy"]


#: The knobs phases 1-18 run without; phase 19 sets them per run.
POLICY_KNOBS = ("KA_FAILURE_POLICY", "KA_FAULTS_SPEC", "KA_OBS_PROFILE_DIR", "KA_PROFILE",
                "KA_OBS_REPORT", "KA_OBS_ENABLE")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def cli_run(fn, argv):
    """``fn(argv)`` (the port's ``run`` or ``run_groups``) with stdout and
    stderr captured: ``(rc, stdout, stderr, seconds)``; the fault injector
    starts from a fresh schedule."""
    from kafka_assigner_tpu_torch import faults

    faults.reset()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def read_report(path, status):
    from kafka_assigner_tpu_torch.obs.report import validate_report

    with open(path, encoding="utf-8") as f:
        report = json.load(f)
    problems = validate_report(report)
    if problems or report["status"] != status:
        fail(f"{path}: status {report['status']} (want {status}), problems {problems}")
    return report


def busy_us(intervals, lo, hi):
    """Length of the union of ``intervals`` (start, end) clipped to [lo, hi]."""
    total, cur = 0.0, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if cur is None or a > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def trace_window(path):
    """The dispatch window of one ``dispatch_trace`` Chrome trace: ``(window
    ms, device busy ms, device ops inside the window as (name, ms))``; the
    busy time is the union of kernel, memcpy and memset intervals."""
    from kafka_assigner_tpu_torch.obs.profile import DISPATCH_LABEL

    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    wins = [e for e in events if e.get("name") == DISPATCH_LABEL and e.get("ph") == "X"
            and e.get("cat") != "gpu_user_annotation"]
    if len(wins) != 1:
        fail(f"{path}: {len(wins)} dispatch windows, not 1")
    lo = float(wins[0]["ts"])
    hi = lo + float(wins[0]["dur"])
    dev = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    inside = [(n, (min(b, hi) - max(a, lo)) / 1e3) for n, a, b in dev if b > lo and a < hi]
    return (hi - lo) / 1e3, busy_us([(a, b) for _, a, b in dev], lo, hi) / 1e3, inside


def obs_phases(work, checks, argv4, text4, moved4, config4, k1_ms, warm_med, prefix,
               prefix_text, greedy_prefix, group_runs, steady_snap, rank_text):
    """Phase 19: the run report, the device trace and the failure policy on
    cuda. (a) config 4 through the CLI with ``--report-json``; (b) one warm
    config-4 solve traced under ``KA_OBS_PROFILE_DIR``; (c) the failure
    policy on the 64-topic prefix with ``KA_FAULTS_SPEC=solve:0=crash``;
    (d) ``ka-groups`` with the report, and the synthetic sweep's
    best-effort fallback; (e) RANK_DECOMMISSION of the 16 candidates with the report.
    Returns the leadership kernel's launches per run."""
    from kafka_assigner_tpu_torch import cli
    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.ops import group_pack as gp
    from kafka_assigner_tpu_torch.ops import leadership as lead

    t_phase = time.perf_counter()
    rdir = os.path.join(work, "reports")
    os.makedirs(rdir, exist_ok=True)
    launches = {}

    # (a) the mode-3 report at config 4.
    path = os.path.join(rdir, "config4.json")
    lead.launches["leadership"] = 0
    rc, out, err, wall = cli_run(cli.run, argv4 + ["--device", "cuda", "--report-json", path])
    launches["obs_report_config4"] = lead.launches["leadership"]
    if rc != 0 or out != text4:
        fail(f"19a: exit {rc}; stdout equal to phase 4's: {out == text4}; {err[-500:]}")
    report = read_report(path, "ok")
    spans = {s["path"]: s for s in report["spans"]}
    mode = "mode/PRINT_REASSIGNMENT"
    want = [f"{mode}/{leaf}" for leaf in (
        "metadata/assignment", "feasibility", "plan/solve", "plan/solve/encode",
        "plan/solve/solve", "plan/solve/decode", "plan/emit")]
    counters = report["metrics"]["counters"]
    if [p for p in want if p not in spans] or report["plan"]["moves"] != moved4 \
            or report["plan"]["partitions"] != N_TOPICS * P_PER_TOPIC \
            or counters.get("zk.reads", 0) < 1 or counters.get("zk.bytes", 0) <= 0 \
            or launches["obs_report_config4"] != 1:
        fail(f"19a: spans {sorted(spans)}, plan {report['plan']}, counters {counters}, "
             f"leadership launches {launches['obs_report_config4']}")
    top = spans[mode]
    kids = [s for s in report["spans"] if s["depth"] == 1]
    solve_kids = [s for s in report["spans"] if s["path"].startswith(f"{mode}/plan/solve/")]
    phase("obs", f"(a) config 4 mode 3 with --report-json on cuda: report valid, status ok; "
          f"stdout byte-identical to phase 4's; plan moves {report['plan']['moves']}, "
          f"partitions {report['plan']['partitions']}, leader churn "
          f"{report['plan']['leader_churn']}; zk.reads {counters['zk.reads']}, zk.bytes "
          f"{counters['zk.bytes']}; leadership kernel launches 1")
    phase("obs", f"(a) span tree (ms): {top['path']} {top['ms']}: "
          + ", ".join(f"{s['name']} {s['ms']}" for s in kids)
          + f", not in a child span {top['ms'] - sum(s['ms'] for s in kids):.1f}; plan/solve: "
          + ", ".join(f"{s['name']} {s['ms']}" for s in solve_kids)
          + f"; CLI wall {wall * 1e3:.1f}, of it outside the mode span "
          f"{wall * 1e3 - top['ms']:.1f}")

    # (b) one warm config-4 solve under the profiler.
    topics, live, rack_map = config4
    assigner = TopicAssigner(device="cuda")
    assigner.generate_assignments(topics, live, rack_map)  # warm
    tdir = os.path.join(work, "traces")
    if os.path.isdir(tdir):
        for name in os.listdir(tdir):
            os.unlink(os.path.join(tdir, name))
    lead.launches["leadership"] = 0
    with knobs(KA_OBS_PROFILE_DIR=tdir):
        t0 = time.perf_counter()
        assigner.generate_assignments(topics, live, rack_map)
        traced_wall = (time.perf_counter() - t0) * 1e3
    launches["obs_trace_warm"] = lead.launches["leadership"]
    traces = os.listdir(tdir)
    if len(traces) != 1 or launches["obs_trace_warm"] != 1:
        fail(f"19b: {len(traces)} traces, {launches['obs_trace_warm']} kernel launches")
    window, busy, inside = trace_window(os.path.join(tdir, traces[0]))
    by_name = {}
    for name, dur in inside:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + dur, n + 1)
    chain = [d for n, d in inside if "chain_kernel" in n]
    prologue = [d for n, d in inside if "prologue_kernel" in n]
    timers = assigner.solver.last_timers
    phase("obs", f"(b) warm config-4 solve under KA_OBS_PROFILE_DIR: dispatch window "
          f"{window:.1f} ms (the call's host clock with the profiler's start and the trace's "
          f"export {traced_wall:.1f} ms; the unprofiled warm median of "
          f"phase 6 {warm_med['total']:.1f} ms); phases under the profiler (ms) "
          + ", ".join(f"{k} {timers[k]:.1f}" for k in ("encode", "place", "leadership",
                                                      "decode"))
          + f"; {len(inside)} device events, trace {os.path.getsize(os.path.join(tdir, traces[0]))}"
          " bytes")
    if len(chain) != 1 or len(prologue) != 1:
        fail(f"19b: the leadership kernel appears {len(chain)} (chain) / "
             f"{len(prologue)} (prologue) times in the trace, not once "
             f"({len(inside)} device events)")
    topn = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    phase("obs", f"(b) device busy {busy:.2f} ms of the {window:.1f} ms window: "
          f"idle share {1 - busy / window:.4f}; leadership kernel traced "
          f"{chain[0] + prologue[0]:.3f} ms (chain {chain[0]:.3f}, prologue "
          f"{prologue[0]:.3f}) against {k1_ms:.3f} ms by CUDA events in phase 6")
    phase("obs", "(b) top device ops (total ms, launches): " + "; ".join(
        f"{name[:70]} {tot:.3f} ({n})" for name, (tot, n) in topn))

    # (c) the failure policy on the prefix.
    base = argv4 + ["--topics", prefix, "--device", "cuda"]
    path = os.path.join(rdir, "fallback.json")
    lead.launches["leadership"] = 0
    with knobs(KA_FAULTS_SPEC="solve:0=crash"):
        rc, out, err, secs = cli_run(cli.run, base + ["--failure-policy", "best-effort",
                                                      "--report-json", path])
    launched = lead.launches["leadership"]
    report = read_report(path, "degraded")
    counters = report["metrics"]["counters"]
    if rc != cli.EXIT_DEGRADED or "falling back to the greedy solver" not in err \
            or out != greedy_prefix or counters.get("solve.fallbacks") != 1 \
            or counters.get("faults.injected") != 1 or launched:
        fail(f"19c best-effort: exit {rc}, stdout == phase 18's greedy prefix "
             f"{out == greedy_prefix}, counters {counters}, kernel launches {launched}")
    path = os.path.join(rdir, "strict.json")
    with knobs(KA_FAULTS_SPEC="solve:0=crash"):
        rc_s, out_s, err_s, _ = cli_run(cli.run, base + ["--report-json", path])
    strict = read_report(path, "error")
    if rc_s != cli.EXIT_SOLVE or strict.get("error", {}).get("type") != "SolveError":
        fail(f"19c strict: exit {rc_s}, error {strict.get('error')}")
    lead.launches["leadership"] = 0
    rc_c, out_c, _, _ = cli_run(cli.run, base + ["--failure-policy", "best-effort"])
    launches["obs_policy_clean"] = lead.launches["leadership"]
    if rc_c != 0 or out_c != prefix_text or launches["obs_policy_clean"] != 1:
        fail(f"19c clean best-effort: exit {rc_c}, stdout == strict {out_c == prefix_text}")
    phase("obs", f"(c) {PREFIX_TOPICS}-topic prefix on cuda, KA_FAULTS_SPEC=solve:0=crash: "
          f"best-effort exit 6 in {secs:.2f} s, stdout byte-identical to phase 18's "
          "--solver greedy, report degraded, solve.fallbacks 1, faults.injected 1, "
          "leadership kernel launches 0; strict exit 4, report error SolveError; no spec "
          "+ best-effort: exit 0, stdout byte-identical to strict, kernel launches 1")

    # (d) ka-groups with the report; the synthetic sweep's fallback.
    argv, text = group_runs["group_plan"]
    path = os.path.join(rdir, "groups_plan.json")
    gp.launches["group_pack"] = 0
    rc, out, err, secs = cli_run(cli.run_groups, argv + ["--device", "cuda",
                                                        "--report-json", path])
    kg1 = gp.launches["group_pack"]
    report = read_report(path, "ok")
    counters = report["metrics"]["counters"]
    moves = json.loads(text)["moves"]
    if rc != 0 or out != text or kg1 != 1 or counters.get("groups.plans") != 1 \
            or counters.get("groups.moves") != moves:
        fail(f"19d plan: exit {rc}, stdout == phase 14's {out == text}, KG1 launches "
             f"{kg1}, counters {counters}")
    phase("obs", f"(d) ka-groups plan with --report-json on cuda ({secs:.2f} s): stdout "
          f"byte-identical to phase 14's, groups.plans 1, groups.moves {moves} == the "
          f"envelope's, group-pack kernel launches 1")
    # The oracle (--solver greedy: the host sweep, no device) runs on cpu in
    # a worker beside the later phases; the fallback runs here on cuda.
    argv, _ = group_runs["group_synthetic"]
    fallback = {}

    def oracle_done(result):
        rc_g, out_g, secs_g = result
        body = json.loads(fallback["out"] or "{}")
        if rc_g != 0 or dict(body, solver="greedy") != json.loads(out_g or "{}"):
            fail(f"19d synthetic fallback: the --solver greedy run exited {rc_g}; "
                 f"envelopes equal but the marker {dict(body, solver='greedy')}")
        phase("obs", f"(d) the synthetic sweep's greedy-fallback envelope == --solver "
              f"greedy's but the marker (the oracle on cpu {secs_g:.1f} s in a worker)")
        return 0

    checks.job("group_pack", oracle_done, groups_cpu_run, argv + ["--solver", "greedy"])
    gp.launches["group_pack"] = 0
    with knobs(KA_FAULTS_SPEC="solve:0=crash"):
        rc_f, fallback["out"], _, secs_f = cli_run(
            cli.run_groups, argv + ["--failure-policy", "best-effort", "--device", "cuda"])
    body = json.loads(fallback["out"] or "{}")
    if rc_f != cli.EXIT_DEGRADED or body.get("solver") != "greedy-fallback" \
            or gp.launches["group_pack"]:
        fail(f"19d synthetic fallback: exit {rc_f}, solver {body.get('solver')}, "
             f"group-pack kernel launches {gp.launches['group_pack']}")
    phase("obs", f"(d) the synthetic sweep with solve:0=crash --failure-policy "
          f"best-effort on cuda: exit 6 ({secs_f:.2f} s), solver greedy-fallback, "
          f"{len(body.get('candidates', []))} candidates, group-pack kernel launches 0")

    # (e) RANK_DECOMMISSION of the 16 candidates with the report.
    path = os.path.join(rdir, "rank.json")
    argv = ["--zk_string", f"file://{steady_snap}", "--mode", "RANK_DECOMMISSION",
            "--integer_broker_ids", ",".join(map(str, RANK_CANDIDATES))]
    lead.launches["leadership"] = 0
    rc, out, err, secs = cli_run(cli.run, argv + ["--device", "cuda", "--report-json", path])
    report = read_report(path, "ok")
    paths = {s["path"] for s in report["spans"]}
    counters, gauges = report["metrics"]["counters"], report["metrics"]["gauges"]
    if rc != 0 or out != rank_text or "mode/RANK_DECOMMISSION/whatif/rank" not in paths \
            or counters.get("whatif.scenarios") != len(RANK_CANDIDATES) \
            or "whatif.fanout" not in gauges or lead.launches["leadership"]:
        fail(f"19e: exit {rc}, stdout == phase 11's {out == rank_text}, spans {sorted(paths)}, "
             f"counters {counters}, gauges {gauges}")
    phase("obs", f"(e) RANK_DECOMMISSION of {len(RANK_CANDIDATES)} candidates with "
          f"--report-json on cuda ({secs:.2f} s): stdout byte-identical to phase 11's; "
          f"whatif/rank span, whatif.scenarios {counters['whatif.scenarios']}, whatif.fanout "
          f"{gauges['whatif.fanout']}, spans {sorted(p.split('/', 2)[-1] for p in paths)}")
    phase("timing", f"phase 19 {time.perf_counter() - t_phase:.1f} s")
    return launches


#: Phase 20: the reply delay of the timed runs (1 ms, as
#: scripts/bench_zk_ingest.py:82 models a round trip) and their turns (one:
#: a second turn took 29 s that phase 21's fresh processes need).
ZK_REPLY_DELAY_S = 0.001
ZK_TIMING_TURNS = 1


def zk_tree(n_brokers, n_topics, p_per_topic, rf, n_racks, replaced):
    """Config 4's znode tree: every broker (the replaced ones too, still
    registered) as ``/brokers/ids/<id>`` with host ``b<id>`` and its rack,
    and every topic as ``/brokers/topics/<t>``."""
    from kafka_assigner_tpu_torch.models.synthetic import (
        build_config4,
        rack_striped_cluster,
    )

    topic_map, _, _ = build_config4(n_brokers, n_topics, p_per_topic, rf, n_racks,
                                    replaced)
    _, _, racks = rack_striped_cluster(n_brokers, 0, 0, rf, n_racks,
                                       extra_brokers=replaced)
    tree = {f"/brokers/ids/{b}": json.dumps(
        {"host": f"b{b}", "port": 9092, "rack": racks[b]}).encode() for b in sorted(racks)}
    for t, parts in topic_map.items():
        tree[f"/brokers/topics/{t}"] = json.dumps(
            {"partitions": {str(p): r for p, r in parts.items()}}).encode()
    return tree


def serve_tree(conn, tree, **kw):
    """In a worker process: serve ``tree`` with ``tests/jute_server.py``
    (``kw`` its options) until the parent writes to or closes ``conn``;
    sends ``(port, znodes, bytes)`` once listening."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jute_server", os.path.join(ROOT, "tests", "jute_server.py"))
    jute = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jute)
    server = jute.JuteZkServer(tree, **kw)
    server.start()
    conn.send((server.port, len(tree), sum(len(v) for v in tree.values())))
    try:
        conn.recv()
    except EOFError:
        pass
    server.shutdown()


def zk_server_main(conn, shape, reply_delay_s):
    """Worker process: config 4's tree (:func:`zk_tree` of ``shape``)."""
    sys.path.insert(0, ROOT)
    serve_tree(conn, zk_tree(*shape), reply_delay_s=reply_delay_s)


@contextlib.contextmanager
def server_process(target, *args):
    """``target(conn, *args)`` in a spawned process (its own interpreter,
    so the server's threads do not share the CLI's); yields what it first
    sends and stops the process afterwards."""
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=target, args=(child, *args), daemon=True)
    proc.start()
    child.close()
    try:
        if not parent.poll(300):
            fail("the jute server process did not report a port within 300 s")
        yield parent.recv()
    finally:
        with contextlib.suppress(OSError):
            parent.send("stop")
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
            proc.join(10)


def zk_quorum(reply_delay_s=0.0):
    """Config 4's ZooKeeper tree served from a spawned process; yields
    ``(port, znodes, bytes)``."""
    shape = (N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, REPLACED)
    return server_process(zk_server_main, shape, reply_delay_s)


def zk_phases(work, checks, argv4, text4, prefix, prefix_text, topic_map, live,
              rack_map, cap, on_removed):
    """Phase 20: config 4 over ZooKeeper through the wire client and the
    streamed ingest, on cuda. Returns the leadership kernel's launches per
    run."""
    from kafka_assigner_tpu_torch import cli, generator
    from kafka_assigner_tpu_torch.ops import leadership as lead

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    rdir = os.path.join(work, "reports")
    os.makedirs(rdir, exist_ok=True)
    launches = {}
    removed = ",".join(f"b{b}" for b in range(REPLACED))

    def zk_argv(port):
        return ["--zk_string", f"127.0.0.1:{port}", "--mode", "PRINT_REASSIGNMENT",
                "--broker_hosts_to_remove", removed]

    def run(key, argv, what, want=text4):
        lead.launches["leadership"] = 0
        rc, out, err, wall = cli_run(cli.run, argv)
        launches[key] = lead.launches["leadership"]
        ingest = dict(generator.last_ingest)
        if rc != 0 or out != want:
            fail(f"20 {what}: exit {rc}, stdout equal to the snapshot run's "
                 f"{out == want}; {err[-800:]}")
        return wall, ingest

    with knobs(KA_ZK_CLIENT="wire"), zk_quorum() as (port, znodes, nbytes):
        # (a) config 4 over the socket: the snapshot plan's bytes, the
        # preencode, the C codec, one kernel launch held against plain.
        with solver_probe() as seen:
            wall, ingest = run("zk_config4", zk_argv(port) + ["--device", "cuda"],
                               "(a) config 4")
        orders = seen["orders"]
        if launches["zk_config4"] != 1 or len(orders) != 1:
            fail(f"20 (a): the leadership kernel launched {launches['zk_config4']} times "
                 f"({len(orders)} ordering calls), not once")
        if ingest.get("solve_encode") != "preencoded" or ingest.get("codecs") != ["c"]:
            fail(f"20 (a): the solve did not take a C-codec preencode ({ingest})")
        moved = check_plan(plan_section(text4), topic_map, live, rack_map, cap, on_removed)
        (inputs, outputs), = orders
        checks.submit("phase 20's streamed config-4 solve", inputs, outputs)
        phase("zk", f"(a) config 4 over ZooKeeper ({znodes} znodes, {nbytes} bytes, port "
              f"{port}) on cuda: {wall:.2f} s CLI wall; stdout byte-identical to phase "
              f"4's snapshot plan; moved {moved}; {ingest['topics']} topics streamed in "
              f"{ingest['chunks']} chunks, encode {ingest['encode_ms']:.1f} ms on the "
              f"{'/'.join(ingest['codecs'])} codec ({ingest['overlap_ms']:.1f} ms of it "
              f"while replies were in flight); the solve took the preencode; leadership "
              f"kernel launches 1 at {tuple(inputs[0].shape)}")

        # (b) the overlap off, and a 7-topic chunk: the same bytes.
        with knobs(KA_ZK_OVERLAP=0):
            wall_off, ingest = run("zk_overlap_off", zk_argv(port) + ["--device", "cuda"],
                                   "(b) KA_ZK_OVERLAP=0")
        if ingest.get("preencoded") or ingest.get("solve_encode") != "c":
            fail(f"20 (b): KA_ZK_OVERLAP=0 still streamed an encode ({ingest})")
        with knobs(KA_ZK_INGEST_CHUNK=7):
            wall_7, ingest = run("zk_chunk7", zk_argv(port) + ["--device", "cuda"],
                                 "(b) KA_ZK_INGEST_CHUNK=7")
        if ingest.get("chunks") != -(-N_TOPICS // 7) or ingest.get("solve_encode") != "preencoded":
            fail(f"20 (b): KA_ZK_INGEST_CHUNK=7 gave {ingest}")
        phase("zk", f"(b) KA_ZK_OVERLAP=0 ({wall_off:.2f} s, the solve encoded on the C "
              f"codec) and KA_ZK_INGEST_CHUNK=7 ({wall_7:.2f} s, {ingest['chunks']} "
              "chunks): stdout byte-identical to (a); kernel launches 1 each")

        # (c) the prefix over ZooKeeper, cuda == cpu == phase 5's.
        argv = zk_argv(port) + ["--topics", prefix]
        run("zk_prefix", argv + ["--device", "cuda"], "(c) prefix on cuda", prefix_text)
        run("zk_prefix_cpu", argv + ["--device", "cpu"], "(c) prefix on cpu", prefix_text)
        launches.pop("zk_prefix_cpu")
        phase("zk", f"(c) {PREFIX_TOPICS}-topic prefix over ZooKeeper: cuda and cpu "
              "byte-identical, equal to phase 5's snapshot plan")

    # (d) a 1 ms reply delay: the overlap on, off, and serial reads.
    variants = (("overlap on", {}), ("overlap off", {"KA_ZK_OVERLAP": "0"}),
                ("serial", {"KA_ZK_PIPELINE": "1"}))
    mode = "mode/PRINT_REASSIGNMENT"
    rows = {name: [] for name, _ in variants}
    with knobs(KA_ZK_CLIENT="wire"), zk_quorum(ZK_REPLY_DELAY_S) as (port, _, _):
        for turn in range(ZK_TIMING_TURNS):
            for name, env in variants:
                path = os.path.join(rdir, f"zk_{name.replace(' ', '_')}_{turn}.json")
                with knobs(**env):
                    wall, _ = run(f"zk_delay_{name.replace(' ', '_')}_{turn}",
                                  zk_argv(port) + ["--device", "cuda", "--report-json", path],
                                  f"(d) {name}")
                report = read_report(path, "ok")
                spans = {sp["path"]: sp["ms"] for sp in report["spans"]}
                c, g = report["metrics"]["counters"], report["metrics"]["gauges"]
                h = report["metrics"]["histograms"].get("zk.pipeline.batch_ms", {})
                row = {
                    "wall_ms": wall * 1e3,
                    "metadata_ms": spans[f"{mode}/metadata/assignment"],
                    "brokers_ms": spans.get(f"{mode}/zk/brokers"),
                    "solve_ms": spans[f"{mode}/plan/solve"],
                    "encode_ms": g.get("ingest.encode_ms"),
                    "overlap_ms": g.get("ingest.overlap_ms"),
                    "batches": c.get("zk.pipeline.batches"),
                    "rtts_saved": c.get("zk.pipeline.rtts_saved"),
                    "in_flight": g.get("zk.pipeline.in_flight"),
                    "batch_ms": h.get("sum"),
                    "solve_encode_ms": spans.get(f"{mode}/plan/solve/encode"),
                }
                rows[name].append(row)
                phase("zk", f"(d) 1 ms reply delay, {name}, turn {turn + 1}: CLI wall "
                      f"{row['wall_ms']:.1f} ms; zk/brokers {row['brokers_ms']} ms; "
                      f"metadata/assignment {row['metadata_ms']} ms; "
                      f"ingest.encode_ms {row['encode_ms']}, ingest.overlap_ms "
                      f"{row['overlap_ms']}; zk.pipeline batches {row['batches']}, "
                      f"rtts_saved {row['rtts_saved']}, in_flight {row['in_flight']}, "
                      f"batch_ms sum {row['batch_ms']}; plan/solve {row['solve_ms']} ms "
                      f"(its encode {row['solve_encode_ms']} ms) | {smi}")
    for name, _ in variants:
        med = {k: statistics.median(r[k] for r in rows[name])
               for k in ("wall_ms", "brokers_ms", "metadata_ms", "solve_ms")}
        phase("zk", f"(d) {name}, median of {ZK_TIMING_TURNS}: CLI wall "
              f"{med['wall_ms']:.1f} ms, zk/brokers {med['brokers_ms']:.1f} ms, "
              f"metadata/assignment {med['metadata_ms']:.1f} ms, "
              f"plan/solve {med['solve_ms']:.1f} ms | {smi}")
    phase("timing", f"phase 20 {time.perf_counter() - t_phase:.1f} s")
    return launches


#: Phase 21: fresh processes through the warm-start bench's child mode
#: (scripts/torch_bench_warmstart.py), which runs the CLI or ka-warm in the
#: child and reports the leadership kernel's launches from inside it.
WARMSTART = os.path.join(ROOT, "scripts", "torch_bench_warmstart.py")
#: Phase 21(c)'s turns: one (a second took ~26 s that phase 22 needs).
WARM_TURNS = 1


def warm_child(kind, argv, env=None):
    """One fresh process of the port's CLI (``kind`` ``cli``) or ``ka-warm``
    (``warm``): the bench's ``run_child`` result."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_bench_warmstart", WARMSTART)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.run_child(kind, argv, env)


def warm_steps(r):
    """The warm-up's steps and the kernel fingerprint in one child, as
    ``name ms`` (each window's length, summed over its calls)."""
    out = []
    for name, wins in sorted(r["windows"].items()):
        if name.startswith(("warmup:", "fingerprint:cuda")):
            out.append(f"{name.split(':', 1)[1] if name.startswith('warmup:') else name} "
                       f"{sum(b - a for a, b in wins):.1f}")
    return ", ".join(out) or "none"


def warm_phases(work, snap, text4):
    """Phase 21: warm start in fresh processes, on cuda. (a) ``ka-warm`` on
    phase 4's snapshot against an empty store, and beside it with the store
    off; (b) ``scripts/torch_bench_warmstart.py``; (c) config 4 over
    ZooKeeper at a 1 ms reply delay, loading every library from (a)'s
    store, the warm-up on against ``KA_WARMUP=0`` (WARM_TURNS turns). Returns the
    leadership kernel's launches per child run, as each child counted
    them."""
    import hashlib
    import tempfile

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    launches = {}
    store = tempfile.mkdtemp(prefix="store21-", dir=work)
    warm_argv = ["--zk_string", f"file://{snap}"]
    ms = lambda r, k: r["hist_sums"].get(k, {}).get("sum")  # noqa: E731

    # (a) ka-warm seeds an empty store; beside it, ka-warm with the store
    # off refuses to call its run seeded. (c)'s runs load from this store.
    seeded = "ka-warm: solve_batched: warmed"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        off = pool.submit(warm_child, "warm", warm_argv,
                          {"KA_PROGRAM_STORE_DIR": store, "KA_PROGRAM_STORE": "0"})
        r = warm_child("warm", warm_argv, {"KA_PROGRAM_STORE_DIR": store})
        r_off = off.result()
    launches["warm_seed"] = r["launches"]
    c = r["counters"]
    if r["exit"] != 0 or seeded not in r["stderr_tail"] or not c.get("compile.store.misses"):
        fail(f"21 (a) ka-warm seed: exit {r['exit']}, counters {c}; "
             f"{r['stderr_tail'][-800:]}")
    if r["launches"] or r_off["launches"]:
        fail(f"21 (a) ka-warm launched the leadership kernel {r['launches']}; "
             f"{r_off['launches']} times")
    wins = r["windows"].get("warmup", [[0, 0]])
    phase("warm", f"(a) ka-warm on phase 4's snapshot, an empty store: exit 0, "
          f"{seeded!r}; {c}; compiles_ms {ms(r, 'compile.store.compiles_ms')}; process "
          f"wall {r['wall_ms']:.1f} ms (torch import {r['torch_import_ms']:.1f}, "
          f"host-library prebuild {r['prebuild_ms']:.1f}, warm-up "
          f"{wins[0][1] - wins[0][0]:.1f} ms: {warm_steps(r)}); leadership launches 0; "
          f"beside the store-off run below | {smi}")
    if r_off["exit"] != 1 or "NOTHING persisted" not in r_off["stderr_tail"]:
        fail(f"21 (a) ka-warm with the store off: exit {r_off['exit']}; "
             f"{r_off['stderr_tail'][-800:]}")
    phase("warm", f"(a) ka-warm under KA_PROGRAM_STORE=0: exit 1, 'NOTHING persisted' "
          f"({r_off['wall_ms']:.1f} ms, beside the seeding run); leadership launches 0")

    # (b) the bench: cold, warm, warm + overlap, off; each plan == phase 4's.
    proc = subprocess.run([sys.executable, WARMSTART, "--snapshot", snap], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"21 (b) torch_bench_warmstart.py exited {proc.returncode}: "
             f"{proc.stderr[-1500:]}")
    line = proc.stdout.strip().splitlines()[-1]
    bench = json.loads(line)
    want = hashlib.sha256(text4.encode()).hexdigest()
    for name, child in bench["children"].items():
        if child["plan_sha256"] != want:
            fail(f"21 (b) the bench's {name} plan differs from phase 4's")
        launches[f"warmstart_{name}"] = child["launches"]
    print(line)
    phase("warm", f"(b) torch_bench_warmstart.py: each of {sorted(bench['children'])} "
          f"byte-identical to phase 4's plan, one leadership launch each | {smi}")

    # (c) over ZooKeeper at a 1 ms reply delay, fresh processes in turns.
    removed = ",".join(f"b{b}" for b in range(REPLACED))
    mode = "mode/PRINT_REASSIGNMENT"
    rdir = os.path.join(work, "reports21")
    os.makedirs(rdir, exist_ok=True)
    variants = (("warm-up on", {}), ("KA_WARMUP=0", {"KA_WARMUP": "0"}))
    seeded_env = {"KA_PROGRAM_STORE_DIR": store}
    with knobs(KA_ZK_CLIENT="wire"), zk_quorum(ZK_REPLY_DELAY_S) as (port, _, _):
        for turn in range(WARM_TURNS):
            for name, env in variants:
                key = f"zk_{'on' if env == {} else 'off'}_{turn}"
                path = os.path.join(rdir, f"{key}.json")
                r = warm_child("cli", ["--zk_string", f"127.0.0.1:{port}", "--mode",
                                       "PRINT_REASSIGNMENT", "--broker_hosts_to_remove",
                                       removed, "--device", "cuda", "--report-json", path],
                               {**seeded_env, **env})
                launches[f"warm_{key}"] = r["launches"]
                if r["exit"] != 0 or r["stdout"] != text4 or r["launches"] != 1:
                    fail(f"21 (c) {name}: exit {r['exit']}, stdout equal to phase 4's "
                         f"{r['stdout'] == text4}, launches {r['launches']}; "
                         f"{r['stderr_tail'][-800:]}")
                report = read_report(path, "ok")
                spans = {sp["path"]: sp["ms"] for sp in report["spans"]}
                counters = report["metrics"]["counters"]
                warm = {k: v for k, v in counters.items() if k.startswith("warmup.")}
                store_c = {k: v for k, v in counters.items()
                           if k.startswith("compile.store.")}
                if (warm == {}) != bool(env):
                    fail(f"21 (c) {name}: warmup counters {warm}")
                # Every library from the store ka-warm seeded in (a): the
                # host libraries at startup, the kernel's in the report.
                loads = report["metrics"]["histograms"].get(
                    "compile.store.loads_ms", {}).get("sum")
                if not store_c.get("compile.store.hits") or loads is None \
                        or "compile.store.misses" in store_c \
                        or "compile.store.misses" in r["counters"]:
                    fail(f"21 (c) {name}: not loaded from ka-warm's store: {store_c}, "
                         f"startup {r['counters']}")
                ingest = r["windows"]["ingest"][0]
                wwin = r["windows"].get("warmup", [None])[0]
                inside = (f"{wwin[0]:.1f}-{wwin[1]:.1f} ms, ended "
                          f"{'inside' if wwin[1] <= ingest[1] else 'after'} the ingest"
                          if wwin else "none")
                phase("warm", f"(c) 1 ms reply delay, {name}, turn {turn + 1}: CLI wall "
                      f"{r['wall_ms']:.1f} ms (torch import {r['torch_import_ms']:.1f}, "
                      f"prebuild {r['prebuild_ms']:.1f}); ingest {ingest[0]:.1f}-"
                      f"{ingest[1]:.1f} ms; warm-up {inside} ({warm_steps(r)}); "
                      f"warmup span "
                      f"{spans.get('warmup')} ms beside metadata/assignment "
                      f"{spans.get(f'{mode}/metadata/assignment')} ms; plan/solve "
                      f"{spans.get(f'{mode}/plan/solve')} ms; {warm}; {store_c}, "
                      f"loads_ms {loads:.1f} from ka-warm's store; "
                      f"leadership launches 1; stdout == phase 4's | {smi}")
    phase("timing", f"phase 21 {time.perf_counter() - t_phase:.1f} s")
    return launches


#: Phase 22: ka-execute of config 4's plan. The wave size and the first
#: poll interval are passed explicitly: config 4's plan changes the replica
#: list (order included) of 171,046 of its 208,000 partitions, so at the
#: default of 8 moves a wave it would take ~21,000 waves, each rewriting
#: the whole snapshot and the journal. At 32,768 it takes 6. The 64-topic
#: prefix runs (d) and (e) take waves of 512 (11 waves), so the kill lands
#: with waves still to go.
EXEC_WAVE_SIZE = 32768
EXEC_POLL_INTERVAL = 0.01
EXEC_PREFIX_WAVE = 512
EXEC_PERSIST_REPS = 3


def exec_run(argv, env=None):
    """``python -m kafka_assigner_tpu_torch.exec ARGV`` in a fresh process,
    as a user runs ``ka-execute``: ``(exit code, stderr, seconds)``."""
    full = dict(os.environ, PYTHONPATH=ROOT,
                KA_EXEC_POLL_INTERVAL=str(EXEC_POLL_INTERVAL), **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "kafka_assigner_tpu_torch.exec", *argv],
                          cwd=ROOT, env=full, capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stderr, time.perf_counter() - t0


def canonical_snapshot(src, out, plan=None):
    """``src``'s brokers and topics (with ``plan``'s partitions applied)
    written through the port's ``write_snapshot`` to ``out``; its text."""
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend, write_snapshot

    backend = SnapshotBackend(src)
    topics = {t: dict(parts) for t, parts in backend._topics.items()}
    for t, parts in (plan or {}).items():
        topics[t].update(parts)
    write_snapshot(out, backend.brokers(), topics)
    with open(out, encoding="utf-8") as f:
        return f.read()


def assignment_bytes(backend, topics):
    """The backend's assignment of ``topics`` as canonical plan bytes."""
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_json

    return format_reassignment_json(backend.partition_assignment(topics),
                                    topic_order=sorted(topics))


def exec_server_main(conn, tree_path):
    """Worker process: the znode tree in ``tree_path`` (JSON, path to text)
    with the jute server's simulated controller."""
    with open(tree_path, encoding="utf-8") as f:
        tree = {k: v.encode() for k, v in json.load(f).items()}
    serve_tree(conn, tree, controller_delay_ops=1)


def exec_phases(work, checks, argv4, text4, snap, prefix, prefix_text):
    """Phase 22: plan execution. (a) config 4's plan through mode 3 on cuda
    (the leadership kernel launched and held against plain); (b)
    ``ka-execute`` of it on a copy of phase 4's snapshot; (c) its
    ``--rollback``; (d) on the 64-topic prefix, a kill at a wave boundary
    and ``--resume``; (e) the prefix over ZooKeeper. Returns the kernel's
    launches."""
    from kafka_assigner_tpu_torch.exec.engine import load_plan_file
    from kafka_assigner_tpu_torch.exec.journal import ExecutionJournal
    from kafka_assigner_tpu_torch.io.base import open_backend
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend, write_snapshot
    from kafka_assigner_tpu_torch.ops import leadership as lead

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    xdir = os.path.join(work, "exec")
    os.makedirs(xdir, exist_ok=True)

    def read(path):
        with open(path, encoding="utf-8") as f:
            return f.read()

    def journal_state(path):
        j = json.loads(read(path))
        return j["status"], j["waves_committed"], len(j["moves"])

    # (a) the plan through the normal entry, on cuda.
    lead.launches["leadership"] = 0
    with solver_probe() as seen:
        text = run_cli(argv4 + ["--device", "cuda"])
    launched = lead.launches["leadership"]
    if text != text4 or launched < 1 or len(seen["orders"]) != 1:
        fail(f"22 (a): plan equal to phase 4's {text == text4}, leadership launches "
             f"{launched}, ordering calls {len(seen['orders'])}")
    (inputs, outputs), = seen["orders"]
    checks.submit("phase 22's config-4 plan", inputs, outputs)
    plan_path = os.path.join(xdir, "config4.plan")
    with open(plan_path, "w", encoding="utf-8") as f:
        f.write(text)
    plan, order = load_plan_file(plan_path)
    phase("exec", f"(a) config 4 mode 3 on cuda: stdout byte-identical to phase 4's "
          f"({len(text)} bytes, {sum(len(v) for v in plan.values())} partitions in the "
          f"NEW ASSIGNMENT), leadership kernel launches {launched}, held against plain")

    # The per-wave persist: the whole snapshot through write_snapshot.
    persist = []
    backend = SnapshotBackend(snap)
    for _ in range(EXEC_PERSIST_REPS):
        t0 = time.perf_counter()
        write_snapshot(os.path.join(xdir, "persist.json"), backend.brokers(),
                       backend._topics)
        persist.append((time.perf_counter() - t0) * 1e3)
    persist_bytes = os.path.getsize(os.path.join(xdir, "persist.json"))
    t0 = time.perf_counter()
    SnapshotBackend(os.path.join(xdir, "persist.json"))
    load_ms = (time.perf_counter() - t0) * 1e3

    # The import in a fresh process: ka-execute needs no torch.
    probe = subprocess.run(
        [sys.executable, "-c",
         "import json, sys, time\n"
         "t0 = time.perf_counter()\n"
         "import kafka_assigner_tpu_torch.cli, kafka_assigner_tpu_torch.exec\n"
         "print(json.dumps({'ms': (time.perf_counter() - t0) * 1e3,"
         " 'torch': 'torch' in sys.modules}))"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120)
    imp = json.loads(probe.stdout.strip().splitlines()[-1])
    if probe.returncode != 0 or imp["torch"]:
        fail(f"22: importing the execution entry imported torch or failed: {probe.stderr}")

    # (b) forward: the plan on a copy of phase 4's snapshot.
    cluster = os.path.join(xdir, "config4.json")
    shutil.copy(snap, cluster)
    canonical = canonical_snapshot(snap, os.path.join(xdir, "canonical.json"))
    expected = canonical_snapshot(snap, os.path.join(xdir, "expected.json"), plan)
    report = os.path.join(xdir, "forward.json")
    journal = os.path.join(xdir, "forward.journal")
    rc, err, secs = exec_run(["--zk_string", cluster, "--plan", plan_path,
                              "--journal", journal, "--wave-size", str(EXEC_WAVE_SIZE),
                              "--report-json", report])
    if rc != 0 or "verify-after-move OK" not in err:
        fail(f"22 (b) ka-execute: exit {rc}; {err[-1500:]}")
    if read(cluster) != expected:
        fail("22 (b): the executed snapshot differs from the plan's NEW ASSIGNMENT "
             "written through write_snapshot")
    if journal_state(journal)[0] != "complete":
        fail(f"22 (b): journal {journal_state(journal)}")
    # One journal commit at this move count, as every converged wave makes.
    done = ExecutionJournal.load(journal)
    done.path = os.path.join(xdir, "commit.journal")
    commits = []
    for _ in range(EXEC_PERSIST_REPS):
        t0 = time.perf_counter()
        done.save()
        commits.append((time.perf_counter() - t0) * 1e3)
    rep = read_report(report, "ok")
    c = rep["metrics"]["counters"]
    span_ms = {n: sum(sp["ms"] for sp in rep["spans"] if sp["name"] == n)
               for n in ("exec/wave", "exec/submit", "exec/poll", "exec/verify")}
    mode_ms = next(sp["ms"] for sp in rep["spans"] if sp["depth"] == 0)
    wave_h = rep["metrics"]["histograms"]["exec.wave_ms"]
    phase("exec", f"(b) ka-execute of config 4's plan on a copy of phase 4's snapshot, "
          f"--wave-size {EXEC_WAVE_SIZE}, KA_EXEC_POLL_INTERVAL={EXEC_POLL_INTERVAL}: exit 0, "
          f"verify-after-move OK, final snapshot byte-identical to the NEW ASSIGNMENT "
          f"through write_snapshot, journal complete; process wall {secs * 1e3:.1f} ms, "
          f"mode span {mode_ms:.1f} ms; waves {c['exec.waves']}, moves "
          f"{c['exec.moves']}, noops {rep['plan']['noops']}, polls "
          f"{c['exec.waves'] + c.get('exec.retries', 0)}; span totals (ms): exec/wave "
          f"{span_ms['exec/wave']:.1f}, exec/submit {span_ms['exec/submit']:.1f}, "
          f"exec/poll {span_ms['exec/poll']:.1f}, exec/verify "
          f"{span_ms['exec/verify']:.1f}; exec.wave_ms min {wave_h['min']:.1f} max "
          f"{wave_h['max']:.1f} | {smi}")
    phase("exec", f"(b) one snapshot persist (write_snapshot, {persist_bytes} bytes, "
          f"indent 1 and fsync, as every converged wave writes it): "
          f"{', '.join(f'{v:.1f}' for v in persist)} ms; its load {load_ms:.1f} ms; "
          f"one journal commit ({len(done.moves)} moves, "
          f"{os.path.getsize(done.path)} bytes): "
          f"{', '.join(f'{v:.1f}' for v in commits)} ms; "
          f"importing the execution entry in a fresh process {imp['ms']:.1f} ms, "
          f"torch not imported | {smi}")

    # (c) rollback: back to the original snapshot's canonical bytes.
    journal_rb = os.path.join(xdir, "rollback.journal")
    rc, err, secs = exec_run(["--zk_string", cluster, "--plan", plan_path, "--rollback",
                              "--journal", journal_rb, "--wave-size", str(EXEC_WAVE_SIZE),
                              "--report-json", os.path.join(xdir, "rollback.json")])
    if rc != 0 or "verify-after-move OK" not in err:
        fail(f"22 (c) --rollback: exit {rc}; {err[-1500:]}")
    if read(cluster) != canonical:
        fail("22 (c): the rolled-back snapshot differs from the original's canonical bytes")
    rep = read_report(os.path.join(xdir, "rollback.json"), "ok")
    if rep["mode"] != "ROLLBACK_REASSIGNMENT" or journal_state(journal_rb)[0] != "complete":
        fail(f"22 (c): mode {rep['mode']}, journal {journal_state(journal_rb)}")
    phase("exec", f"(c) --rollback on the same copy: exit 0, verify OK, bytes equal to "
          f"the original snapshot through write_snapshot; process wall "
          f"{secs * 1e3:.1f} ms, waves {rep['metrics']['counters']['exec.waves']} | {smi}")

    # (d) the prefix: killed at a wave boundary, then resumed.
    topics = prefix.split(",")
    pplan = os.path.join(xdir, "prefix.plan")
    with open(pplan, "w", encoding="utf-8") as f:
        f.write(prefix_text)
    psnap = os.path.join(xdir, "prefix.json")
    write_snapshot(psnap, backend.brokers(), {t: backend._topics[t] for t in topics})
    runs = {}
    for name, env in (("uninterrupted", {}), ("killed", {"KA_FAULTS_SPEC": "wave:1=crash"})):
        path = os.path.join(xdir, f"prefix_{name}.json")
        shutil.copy(psnap, path)
        runs[name] = exec_run(["--zk_string", path, "--plan", pplan, "--journal",
                               path + ".journal", "--wave-size", str(EXEC_PREFIX_WAVE)], env)
    rc, err, _ = runs["uninterrupted"]
    if rc != 0:
        fail(f"22 (d) uninterrupted: exit {rc}; {err[-1500:]}")
    killed = os.path.join(xdir, "prefix_killed.json")
    rc, err, _ = runs["killed"]
    status, committed, n_moves = journal_state(killed + ".journal")
    if rc == 0 or "InjectedExecCrash" not in err or (status, committed) != ("in-progress", 1):
        fail(f"22 (d) kill: exit {rc}, journal {status}/{committed}; {err[-800:]}")
    rc, err, _ = exec_run(["--zk_string", killed, "--plan", pplan, "--journal",
                           killed + ".journal", "--wave-size", str(EXEC_PREFIX_WAVE),
                           "--resume"])
    final = read(os.path.join(xdir, "prefix_uninterrupted.json"))
    if rc != 0 or "resuming from journal" not in err or read(killed) != final:
        fail(f"22 (d) --resume: exit {rc}, bytes equal to the uninterrupted run's "
             f"{read(killed) == final}; {err[-800:]}")
    waves = -(-n_moves // EXEC_PREFIX_WAVE)
    phase("exec", f"(d) {PREFIX_TOPICS}-topic prefix, {n_moves} moves in {waves} waves of "
          f"{EXEC_PREFIX_WAVE}: KA_FAULTS_SPEC=wave:1=crash killed the process with 1 wave "
          f"committed; --resume finished it byte-identical to the uninterrupted run")

    # (e) the prefix over ZooKeeper, the jute server's controller applying.
    tree = {f"/brokers/ids/{b.id}": json.dumps({"host": b.host, "port": b.port,
                                                "rack": b.rack})
            for b in backend.brokers()}
    for t in topics:
        tree[f"/brokers/topics/{t}"] = json.dumps(
            {"partitions": {str(p): r for p, r in backend._topics[t].items()}})
    tree_path = os.path.join(xdir, "prefix_tree.json")
    with open(tree_path, "w", encoding="utf-8") as f:
        json.dump(tree, f)
    with server_process(exec_server_main, tree_path) as (port, _, _):
        spec = f"127.0.0.1:{port}"
        rc, err, secs = exec_run(["--zk_string", spec, "--plan", pplan, "--journal",
                                  os.path.join(xdir, "zk.journal"), "--wave-size",
                                  str(EXEC_PREFIX_WAVE)], {"KA_ZK_CLIENT": "wire"})
        if rc != 0 or "verify-after-move OK" not in err:
            fail(f"22 (e) ka-execute over ZooKeeper: exit {rc}; {err[-1500:]}")
        with knobs(KA_ZK_CLIENT="wire"):
            zk = open_backend(spec)
            try:
                got = assignment_bytes(zk, topics)
                in_flight = zk._zk.exists("/admin/reassign_partitions") is not None
            finally:
                zk.close()
    want = assignment_bytes(SnapshotBackend(os.path.join(xdir, "prefix_uninterrupted.json")),
                            topics)
    if got != want or in_flight:
        fail(f"22 (e): the tree read back equals (d)'s final assignment {got == want}, "
             f"a reassignment still in flight {in_flight}")
    phase("exec", f"(e) the prefix over ZooKeeper (jute server, simulated controller, wire "
          f"client): exit 0, verify OK in {secs * 1e3:.1f} ms; the tree read back equals "
          f"(d)'s final assignment ({len(got)} bytes), no reassignment in flight")
    phase("timing", f"phase 22 {time.perf_counter() - t_phase:.1f} s")
    return {"exec_plan": launched}


#: Phase 23: the resident daemon on phase 20(d)'s ZooKeeper tree. Every wait
#: of the phase is bounded by DAEMON_WAIT_S; the in-process daemon resyncs
#: on its watches only (a long interval), and the child's drain window
#: outlasts one config-4 request.
DAEMON_WAIT_S = 300
DAEMON_INTERVAL_S = 3600
DAEMON_DRAIN_S = 120
#: The child's SIGTERM comes this share of its first /plan's wall into the
#: second: inside the request, well before its end.
DAEMON_SIGTERM_AT = 0.25
#: The child daemon: ``python -m kafka_assigner_tpu_torch.daemon ARGV`` run
#: through runpy, as ``-m`` runs it, behind an exit hook that prints the
#: leadership kernel's launches counted inside the child.
DAEMON_CHILD = (
    "import atexit, json, runpy, sys\n"
    "from kafka_assigner_tpu_torch.ops import leadership\n"
    "atexit.register(lambda: print('KA_CHILD_LAUNCHES ' + json.dumps("
    "leadership.launches), file=sys.stderr, flush=True))\n"
    "runpy.run_module('kafka_assigner_tpu_torch.daemon', run_name='__main__', "
    "alter_sys=True)\n"
)


def http_call(port, method, path, payload=None, timeout=600.0):
    """One request to a daemon on this host: ``(status, body, seconds)``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request(method, path, body=None if payload is None else json.dumps(payload))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        return resp.status, body, time.perf_counter() - t0
    finally:
        conn.close()


def wait_for(what, predicate, timeout=DAEMON_WAIT_S, every=0.05):
    """Poll ``predicate`` until true; fail after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            fail(f"23: no {what} within {timeout} s")
        time.sleep(every)


def span_summary(body):
    """The envelope's top span and its children, ``name ms``."""
    spans = body["spans"]
    top = next(i for i, sp in enumerate(spans) if sp["depth"] == 0)
    kids = [f"{sp['name']} {sp['ms']:.1f}" for sp in spans if sp["parent"] == top]
    return f"{spans[top]['name']} {spans[top]['ms']:.1f} ms ({', '.join(kids)})"


def launch_holder(checks, checked=()):
    """``hold(what, orders)``: each recorded leadership launch ``(inputs,
    outputs)`` against the plain version in a worker, or, when its inputs
    and outputs are bit-equal to a launch already held (``checked`` seeds
    them as ``(tensors, what)`` pairs), through that one."""
    import torch

    sent = list(checked)

    def hold(what, orders):
        for inputs, outputs in orders:
            tensors = tuple(inputs) + tuple(outputs)
            for s_tensors, s_what in sent:
                if all(a.shape == b.shape and torch.equal(a, b)
                       for a, b in zip(tensors, s_tensors)):
                    phase("kernels", f"leadership at {what}: inputs and outputs "
                          f"bit-equal to the launch of {s_what}, held against plain")
                    break
            else:
                sent.append((tensors, what))
                checks.submit(what, inputs, outputs)

    return hold


def daemon_phases(work, checks, text4, snap4, prefix4, prefix_text4, checked=()):
    """Phase 23: the resident daemon (``daemon/``) on config 4 over phase
    20(d)'s ZooKeeper tree (brokers 0-99 still registered, 1 ms a reply).
    (a)-(d) run the daemon in this process on cuda, so the leadership
    kernel's launches count here and :func:`solver_probe` holds each against
    the plain version in a worker (a launch on inputs and with outputs equal
    to one already held, such as phase 4's main-path launch among
    ``checked``, ``(tensors, what)`` pairs, is held through that one). (e)
    runs ``python -m
    kafka_assigner_tpu_torch.daemon`` in a child process, whose launches are
    counted inside it, as phase 21's children count theirs: the child runs
    the module through runpy behind an exit hook that prints the count.
    Then phase 24 (:func:`multi_phases`) on the same server, and phase 25
    (:func:`dispatch_phases`) on ``snap4`` (phase 4's snapshot; ``text4`` its
    plan, ``prefix4`` phase 5's topics and ``prefix_text4`` their plan) and
    phase 24's config-3 snapshot, and phase 26 (:func:`controller_phases`).
    Returns the leadership kernel's launches per request of phases 23-25
    and per evaluation of phase 26, and phases 24's and 25's group-pack
    launches."""
    import signal
    import threading

    from kafka_assigner_tpu_torch import generator, obs
    from kafka_assigner_tpu_torch.daemon import AssignerDaemon
    from kafka_assigner_tpu_torch.daemon.state import RESYNC_CHUNK
    from kafka_assigner_tpu_torch.io.zkwire import MiniZkClient
    from kafka_assigner_tpu_torch.ops import leadership as lead

    import torch

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    launches = {}
    hold = launch_holder(checks, checked)

    def request(key, port, payload, what, want):
        """One /plan through the in-process daemon: status ok, stdout
        ``want``, the kernel launched once and held against plain."""
        lead.launches["leadership"] = 0
        with solver_probe() as seen:
            status, body, secs = http_call(port, "POST", "/plan", payload)
        launches[key] = lead.launches["leadership"]
        if status != 200 or body.get("status") != "ok" \
                or body["result"]["stdout"] != want:
            fail(f"23 {what}: HTTP {status}, status {body.get('status')}, stdout equal "
                 f"{status == 200 and body['result']['stdout'] == want}; "
                 f"{body.get('error')}")
        if launches[key] != 1 or len(seen["orders"]) != 1:
            fail(f"23 {what}: the leadership kernel launched {launches[key]} times "
                 f"({len(seen['orders'])} ordering calls), not once")
        hold(f"phase 23 {what}", seen["orders"])
        return body, secs, dict(generator.last_ingest)

    def resync_spans(run):
        """The daemon's ``daemon/resync`` spans recorded into ``run``: each
        full resync's wall and whether it succeeded."""
        return [sp for sp in list(run.spans) if sp["name"] == "daemon/resync"]

    def settled(d, window):
        """No resync, watch event or warm-up counted in the last ``window``
        seconds."""
        keys = ("daemon.resyncs", "daemon.resync_failures", "daemon.watch_events",
                "daemon.warmups", "daemon.warmup_failures")
        seen = {"c": None, "at": time.monotonic()}

        def check():
            c = d.counters()
            now = tuple(c.get(k, 0) for k in keys)
            if now != seen["c"]:
                seen["c"], seen["at"] = now, time.monotonic()
            return time.monotonic() - seen["at"] >= window
        return check

    with knobs(KA_ZK_CLIENT="wire", KA_DAEMON_RESYNC_INTERVAL=DAEMON_INTERVAL_S), \
            zk_quorum(ZK_REPLY_DELAY_S) as (port, znodes, _):
        spec = f"127.0.0.1:{port}"
        # (a) startup. The resync's wall is the daemon's own span, read from
        # a capture open around the start; the seeding is the state's timer.
        with obs.run_capture() as boot:
            t0 = time.perf_counter()
            d = AssignerDaemon(spec, solver="device", device="cuda")
            d.start()
        try:
            hport = d.http_port
            status, _, _ = http_call(hport, "GET", "/readyz")
            ready_s = time.perf_counter() - t0
            if status != 200:
                fail(f"23 (a): /readyz answered {status} after start")
            sup = d.supervisor()
            seed_ms = sup.state.seed_ms
            first = resync_spans(boot)
            if len(first) != 1 or first[0]["status"] != "ok":
                fail(f"23 (a): the start's resync spans {first}")
            sync_ms = first[0]["ms"]
            _, view, _ = http_call(hport, "GET", "/state")
            if (view["topics"], view["brokers"], view["watches"], view["lifecycle"]) \
                    != (N_TOPICS, N_BROKERS + REPLACED, True, "ready"):
                fail(f"23 (a): /state {view}")
            wait_for("warm-up", lambda: d.counters().get("daemon.warmups", 0)
                     + d.counters().get("daemon.warmup_failures", 0) >= 1)
            c = d.counters()
            if c.get("daemon.warmups", 0) < 1 or c.get("daemon.warmup_failures"):
                fail(f"23 (a): warm-up counters {c}")
            phase("daemon", f"(a) AssignerDaemon on cuda over ZooKeeper ({znodes} znodes, "
                  f"1 ms a reply, watches on): construction to /readyz 200 "
                  f"{ready_s * 1e3:.1f} ms; first resync (daemon/resync span) "
                  f"{sync_ms:.1f} ms = the reads and the cache's copy {sync_ms - seed_ms:.1f} "
                  f"+ delta store seeding {seed_ms:.1f} ({N_TOPICS} topics, {RESYNC_CHUNK} a "
                  f"chunk); /state: "
                  f"topics {view['topics']}, brokers {view['brokers']}, encode_shape "
                  f"{view['encode_shape']}, watches {view['watches']}; daemon.warmups "
                  f"{c['daemon.warmups']}, daemon.warmup_failures 0 | {smi}")

            # (b) a plan that bypasses the preencode: brokers excluded.
            removed = ",".join(f"b{b}" for b in range(REPLACED))
            body, b_s, ingest = request("daemon_b_bypass", hport,
                                        {"broker_hosts_to_remove": removed},
                                        "(b) /plan with broker_hosts_to_remove", text4)
            if ingest.get("preencoded") or ingest.get("solve_encode") == "preencoded":
                fail(f"23 (b): the narrowed request took the cached preencode ({ingest})")
            phase("daemon", f"(b) POST /plan with broker_hosts_to_remove b0-b{REPLACED - 1}: "
                  f"status ok, stdout byte-identical to phase 4's, the solve encoded on "
                  f"the {ingest.get('solve_encode')} codec, leadership kernel launches 1; "
                  f"request wall {b_s * 1e3:.1f} ms; spans {span_summary(body)} | {smi}")

            # (c) the removed brokers deregister; the broker watch's full
            # resyncs; then whole-cluster plans through the cached preencode.
            v0, r0 = view["cache_version"], c["daemon.resyncs"]
            with obs.run_capture() as churn:
                w = MiniZkClient(spec)
                w.start()
                try:
                    t0 = time.perf_counter()
                    for b in range(REPLACED):
                        w.delete(f"/brokers/ids/{b}")
                    delete_s = time.perf_counter() - t0
                finally:
                    w.stop()
                    w.close()

                def resynced():
                    _, v, _ = http_call(hport, "GET", "/state")
                    return (v["cache_version"] > v0 and v["brokers"] == N_BROKERS
                            and v["lifecycle"] == "ready" and not v["stale"])

                wait_for("broker resync", resynced, every=0.1)
                # Settled: nothing counted for twice the longest resync seen,
                # so no resync or warm-up is still running.
                window = max(1.0, 2e-3 * max(sp["ms"] for sp in first + resync_spans(churn)))
                wait_for("a settled cache", settled(d, window), every=0.1)
                walls = resync_spans(churn)
            c = d.counters()
            resyncs = c["daemon.resyncs"] - r0
            failed = sum(sp["status"] != "ok" for sp in walls)
            walls_txt = ", ".join(f"{sp['ms']:.1f}" for sp in walls)
            _, view, _ = http_call(hport, "GET", "/state")
            walls_ms = []
            for i in (1, 2):
                body, secs, ingest = request(
                    f"daemon_c_preencode_{i}", hport, {},
                    f"(c) /plan {i} through the cached preencode", text4)
                if not ingest.get("preencoded") or ingest.get("solve_encode") != "preencoded":
                    fail(f"23 (c): the solve did not take the merged preencode ({ingest})")
                walls_ms.append(secs * 1e3)
            phase("daemon", f"(c) brokers 0-{REPLACED - 1} deleted in {delete_s * 1e3:.1f} ms "
                  f"through MiniZkClient.delete; {resyncs} full resync(s) by the broker "
                  f"watch ({failed} failed on a broker deleted mid-read and retried; "
                  f"daemon/resync spans {walls_txt} ms; "
                  f"cache version {v0} -> {view['cache_version']}), brokers "
                  f"{view['brokers']}, ready; two POST /plan {{}}: status ok, "
                  f"stdout byte-identical to phase 4's, the solve on the merged preencode "
                  f"(no encode of its own), leadership kernel launches 1 each; request "
                  f"walls {walls_ms[0]:.1f} and {walls_ms[1]:.1f} ms against (b)'s "
                  f"{b_s * 1e3:.1f} ms; spans {span_summary(body)} | {smi}")

            # (d) churn: one replica of one partition moves to another live
            # broker on its rack; delta re-encodes, no resync.
            topic = sup.state.topic_names()[0]
            parts = sup.state.assignments([topic])[topic]
            racks = {b.id: b.rack for b in sup.state.brokers()}
            # The first replica on a live broker (the plan has not run: some
            # still sit on the removed ones), to the lowest live broker of
            # its rack that the partition does not hold.
            pid, slot, old = next((p, i, r) for p in sorted(parts)
                                  for i, r in enumerate(parts[p]) if r in racks)
            new = next(b for b in sorted(racks) if racks[b] == racks[old]
                       and b not in parts[pid])
            parts[pid] = parts[pid][:slot] + [new] + parts[pid][slot + 1:]
            c = d.counters()
            base = {k: c.get(k, 0) for k in
                    ("daemon.reencode.topics", "daemon.watch_events", "daemon.resyncs")}

            def grew(key):
                return d.counters().get(key, 0) - base[key]

            # The one znode changed is this topic's: every notification the
            # daemon takes is a data watch on it (the test server fires one
            # per armed read, a real quorum one per session and path), and
            # each re-encodes that topic alone.
            w = MiniZkClient(spec)
            w.start()
            try:
                w.set_data(f"/brokers/topics/{topic}", json.dumps(
                    {"partitions": {str(p): r for p, r in parts.items()}}).encode())
            finally:
                w.stop()
                w.close()
            wait_for("the churn's re-encodes",
                     lambda: grew("daemon.reencode.topics") >= 1
                     and grew("daemon.reencode.topics") == grew("daemon.watch_events"))
            wait_for("a settled cache", settled(d, 0.5), every=0.05)
            reencoded, events = grew("daemon.reencode.topics"), grew("daemon.watch_events")
            if reencoded < 1 or reencoded != events or grew("daemon.resyncs") \
                    or sup.state.stale:
                fail(f"23 (d): re-encodes {reencoded} for {events} notifications, resyncs "
                     f"{grew('daemon.resyncs')} (want 0), stale {sup.state.stale}")
            lead.launches["leadership"] = 0
            with solver_probe() as seen:
                cli_text = run_cli(["--zk_string", spec, "--mode", "PRINT_REASSIGNMENT",
                                    "--device", "cuda"])
            launches["daemon_d_cli"] = lead.launches["leadership"]
            hold("phase 23 (d) the fresh CLI run", seen["orders"])
            if cli_text == text4:
                fail("23 (d): the churned plan equals the unchurned one")
            body, d_s, _ = request("daemon_d_churn", hport, {},
                                   "(d) /plan after the churn", cli_text)
            phase("daemon", f"(d) {topic} partition {pid}: replica {old} -> {new} (rack "
                  f"{racks[old]}) by setData; delta re-encodes of that topic "
                  f"(daemon.reencode.topics +{reencoded}, one per notification: "
                  f"daemon.watch_events +{events}), no resync; POST /plan {{}} byte-identical "
                  f"to a fresh port CLI run on cuda over the same server, leadership "
                  f"kernel launches 1 each; request wall {d_s * 1e3:.1f} ms | {smi}")
        finally:
            d.shutdown()
        # The shutdown joined every warm-up the phase started.
        c = d.counters()
        if d.lifecycle() != "stopped" or c.get("daemon.warmup_failures"):
            fail(f"23: the in-process daemon ended {d.lifecycle()}, counters {c}")

        # (e) a real process, then SIGTERM with a request in flight.
        env = dict(os.environ, PYTHONPATH=ROOT, KA_ZK_CLIENT="wire",
                   KA_DAEMON_DRAIN_TIMEOUT=str(DAEMON_DRAIN_S))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", DAEMON_CHILD, "--zk_string", spec,
             "--solver", "device"],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        lines, marks = [], {}

        def read_stderr():
            for ln in proc.stderr:
                lines.append(ln)
                if "listening on http://" in ln:
                    marks.setdefault("banner", time.perf_counter())

        reader = threading.Thread(target=read_stderr, daemon=True)
        reader.start()
        try:
            wait_for("the child's banner",
                     lambda: "banner" in marks or proc.poll() is not None, every=0.02)
            if "banner" not in marks:
                fail(f"23 (e): the child exited {proc.returncode}: {''.join(lines)[-1500:]}")
            banner = next(ln for ln in lines if "listening on http://" in ln)
            cport = int(banner.split("http://127.0.0.1:")[1].split()[0])
            wait_for("the child's /readyz 200",
                     lambda: http_call(cport, "GET", "/readyz", timeout=10)[0] == 200)
            ready_s = time.perf_counter() - t0
            status, body, e1_s = http_call(cport, "POST", "/plan", {})
            if status != 200 or body["status"] != "ok" \
                    or body["result"]["stdout"] != cli_text:
                fail(f"23 (e): the child's /plan: HTTP {status}, status "
                     f"{body.get('status')}, stdout equal to (d)'s CLI run "
                     f"{status == 200 and body['result']['stdout'] == cli_text}")
            second = {}
            t_req = threading.Thread(target=lambda: second.update(
                r=http_call(cport, "POST", "/plan", {})))
            t_req.start()
            sigterm_s = DAEMON_SIGTERM_AT * e1_s
            time.sleep(sigterm_s)
            proc.send_signal(signal.SIGTERM)
            drain = []

            def draining():
                try:
                    drain.append(http_call(cport, "GET", "/readyz", timeout=30)[:2])
                except OSError as e:
                    fail(f"23 (e): /readyz unreachable during the drain ({e}); the "
                         f"request in flight done: {'r' in second}")
                return drain[-1][0] != 200

            wait_for("/readyz turning away after SIGTERM", draining, every=0.01)
            ready_status, ready_body = drain[-1]
            t_req.join(600)
            rc = proc.wait(timeout=DAEMON_WAIT_S)
            reader.join(30)
            status, body, e2_s = second.get("r", (None, {}, 0.0))
            if ready_status != 503 or ready_body.get("status") != "draining":
                fail(f"23 (e): /readyz during the drain: {ready_status} {ready_body}")
            if status != 200 or body.get("status") != "ok" \
                    or body["result"]["stdout"] != cli_text:
                fail(f"23 (e): the request in flight at SIGTERM: HTTP {status}, status "
                     f"{body.get('status')}")
            counted = [json.loads(ln.split(" ", 1)[1]) for ln in lines
                       if ln.startswith("KA_CHILD_LAUNCHES ")]
            if rc != 0 or not counted or counted[-1]["leadership"] != 2 \
                    or not any("drained; exiting 0" in ln for ln in lines):
                fail(f"23 (e): exit {rc}, launches {counted}; {''.join(lines)[-1500:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        launches["daemon_e_child"] = counted[-1]["leadership"]
        phase("daemon", f"(e) python -m kafka_assigner_tpu_torch.daemon --solver device "
              f"in a child process: spawn to banner "
              f"{(marks['banner'] - t0) * 1e3:.1f} ms, to /readyz 200 "
              f"{ready_s * 1e3:.1f} ms; POST /plan {{}} byte-identical to (d)'s CLI run "
              f"in {e1_s * 1e3:.1f} ms; SIGTERM {sigterm_s:.2f} s into a second "
              f"/plan: /readyz 503 draining, the request answered in full "
              f"({e2_s * 1e3:.1f} ms, byte-identical), exit 0; leadership kernel "
              f"launches 2, counted in the child | {smi}")
        phase("timing", f"phase 23 {time.perf_counter() - t_phase:.1f} s | {smi}")

        # Phase 24 on the same server, the tree as (d) left it.
        multi, multi_groups, sweep_24 = multi_phases(work, checks, spec, cli_text, hold)
    launches.update(multi)
    # Phase 25 on snapshots: config 4's (phase 4's) and phase 24's config 3.
    packed, packed_groups = dispatch_phases(
        work, checks, hold, snap4, text4, prefix4, prefix_text4,
        os.path.join(work, "config3_groups.json"), sweep_24)
    launches.update(packed)
    multi_groups.update(packed_groups)
    # Phase 26 on config 4's steady cluster, seeded, and phase 24's config 3.
    launches.update(controller_phases(work, hold, os.path.join(work, "config3_groups.json")))
    # Phase 27: the fleet scheduler on config 3, seeded three ways.
    launches.update(fleet_phases(work, hold))
    return launches, multi_groups


#: Phase 24: the daemon for many clusters. Cluster b is BASELINE config 3
#: (500 brokers in 5 racks plus 50 added, 1,000 topics x 64 partitions at RF
#: 3), its (c) plan removes brokers 0-49, and its execution takes at most 8
#: waves of MULTI_WAVE_SIZE moves (64,000 partitions: two waves). (e) sweeps the
#: ingest group at counts 32-256 x scales 100-300 (32 candidates).
CONFIG3 = dict(n_brokers=500, n_topics=1000, p_per_topic=64, rf=3, n_racks=5, added=50)
MULTI_REMOVED = 50
MULTI_WAVE_SIZE = 32000
MULTI_GROUP_COUNTS = "32,64,96,128,160,192,224,256"
MULTI_GROUP_SCALES = "100,150,200,300"


def multi_phases(work, checks, spec_a, text_a, hold):
    """Phase 24: one ``AssignerDaemon(clusters=..., solver="device")`` on
    cuda in this process, so each launch counts here: cluster ``a`` is
    config 4 over phase 23's ZooKeeper tree (``text_a`` its plan, phase
    23(d)'s CLI run), cluster ``b`` config 3 as a snapshot copied for the
    daemon, with phase 14's ``ingest`` group over its topics. Each
    leadership launch goes through ``hold`` (held against the plain version,
    or through a held launch with the same inputs and outputs); each
    group-pack launch is held against its plain version in a worker.
    Returns the launches per step, ``(leadership, group_pack)``, and (e)'s
    sweep envelope."""
    import http.client
    import threading

    import torch

    from kafka_assigner_tpu_torch import obs
    from kafka_assigner_tpu_torch.daemon import AssignerDaemon
    from kafka_assigner_tpu_torch.exec.engine import parse_plan_payload
    from kafka_assigner_tpu_torch.io.snapshot import SnapshotBackend
    from kafka_assigner_tpu_torch.io.snapshot import write_snapshot as port_write
    from kafka_assigner_tpu_torch.models.synthetic import build_config3
    from kafka_assigner_tpu_torch.obs import health, metrics, promtext
    from kafka_assigner_tpu_torch.ops import group_pack as gp
    from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.parallel import whatif

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    k1, kg1 = {}, {}

    def call(port, method, path, payload=None, headers=None, timeout=600.0):
        """``(status, body, response headers, seconds)``."""
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        t0 = time.perf_counter()
        try:
            conn.request(method, path, headers=headers or {},
                         body=None if payload is None else json.dumps(payload))
            resp = conn.getresponse()
            body = json.loads(resp.read())
            return resp.status, body, dict(resp.getheaders()), time.perf_counter() - t0
        finally:
            conn.close()

    def counted(key, method, path, payload=None, headers=None, want=1):
        """One request with the leadership kernel's count reset just before
        and read just after; every launch held."""
        lead.launches["leadership"] = 0
        with solver_probe() as seen:
            out = call(hport, method, path, payload, headers)
        k1[key] = lead.launches["leadership"]
        if k1[key] != want or len(seen["orders"]) != want:
            fail(f"24 {path}: the leadership kernel launched {k1[key]} times "
                 f"({len(seen['orders'])} ordering calls), not {want}")
        hold(f"phase 24 {key}", seen["orders"])
        return out

    # Cluster b: config 3 with the ingest group, a copy for the daemon.
    topic_map3, live3, racks3 = build_config3(**CONFIG3)
    snap3 = os.path.join(work, "config3_groups.json")
    owner3 = write_group_snapshot(snap3, topic_map3, live3, racks3)
    snap_b = os.path.join(work, "config3_daemon.json")
    shutil.copy(snap3, snap_b)
    access = os.path.join(work, "daemon_multi_access.log")
    if os.path.exists(access):
        os.remove(access)

    # (a) startup, the first resyncs read from a capture open around it.
    # The drain window outlasts one config-4 request, as phase 23(e)'s.
    with obs.run_capture() as boot, knobs(KA_DAEMON_DRAIN_TIMEOUT=DAEMON_DRAIN_S):
        t0 = time.perf_counter()
        d = AssignerDaemon(clusters={"a": spec_a, "b": f"file://{snap_b}"},
                           solver="device", device="cuda", access_log=access)
        d.start()
    served = False
    try:
        hport = d.http_port
        status, _, _, _ = call(hport, "GET", "/readyz")
        ready_s = time.perf_counter() - t0
        if status != 200:
            fail(f"24 (a): /readyz answered {status} after start")
        resync_ms = {sp["name"]: sp["ms"] for sp in boot.spans
                     if sp["name"].startswith("daemon/resync@")}
        views = {}
        for n in ("a", "b"):
            sup = d.supervisors[n]
            wait_for(f"{n}'s warm-up", lambda sup=sup: sup.counters().get("daemon.warmups", 0)
                     + sup.counters().get("daemon.warmup_failures", 0) >= 1)
            _, hz, _, _ = call(hport, "GET", f"/clusters/{n}/healthz")
            _, st, _, _ = call(hport, "GET", f"/clusters/{n}/state")
            if hz["status"] != "ready" or hz["breaker"]["state"] != "closed" \
                    or st["health"] is None or sup.counters().get("daemon.warmup_failures"):
                fail(f"24 (a): cluster {n}: healthz {hz}, counters {sup.counters()}")
            views[n] = (hz, st)
        cum = metrics.cumulative()
        score = {n: cum.snapshot()["hists"]["health.score_ms"][(("cluster", n),)]
                 for n in ("a", "b")}
        for n in ("a", "b"):
            hz, st = views[n]
            h = score[n]
            phase("daemon-multi", f"(a) cluster {n}: /clusters/{n}/healthz {hz['status']}, "
                  f"breaker {hz['breaker']['state']}; /state: {st['brokers']} brokers, "
                  f"{st['topics']} topics, encode_shape {st['encode_shape']}, watches "
                  f"{st['watches']}, traffic_real {st['traffic_real']}, health score "
                  f"{st['health']['score']} (replica spread "
                  f"{st['health']['replica_spread']}, rack violations "
                  f"{st['health']['rack_violations']}); first resync "
                  f"{resync_ms.get(f'daemon/resync@{n}', float('nan')):.1f} ms of which "
                  f"health.score_ms {h['sum'] / max(h['count'], 1):.1f} (mean of "
                  f"{h['count']}) | {smi}")
        phase("daemon-multi", f"(a) AssignerDaemon(clusters=a,b) on cuda: construction to "
              f"the aggregate /readyz 200 {ready_s * 1e3:.1f} ms | {smi}")

        # (b) a's whole-cluster plan, with a request id.
        status, body, headers, b_s = counted(
            "daemon_multi_a_plan", "POST", "/clusters/a/plan", {},
            {"X-Request-Id": "smoke-24b"})
        if status != 200 or body["status"] != "ok" or body["result"]["stdout"] != text_a:
            fail(f"24 (b): HTTP {status}, status {body.get('status')}, stdout equal to "
                 f"23(d)'s CLI run {status == 200 and body['result']['stdout'] == text_a}")
        if headers.get("X-Request-Id") != "smoke-24b" \
                or body["result"].get("request_id") != "smoke-24b" \
                or {sp.get("request_id") for sp in body["spans"]} != {"smoke-24b"}:
            fail(f"24 (b): the request id: header {headers.get('X-Request-Id')}, "
                 f"result {body['result'].get('request_id')}")

        def logged(rid):
            with open(access, encoding="utf-8") as f:
                return [json.loads(ln) for ln in f if rid in ln]

        wait_for("(b)'s access-log line", lambda: logged("smoke-24b"), timeout=30)
        line = logged("smoke-24b")
        if len(line) != 1 or (line[0]["path"], line[0]["cluster"], line[0]["code"]) \
                != ("/clusters/a/plan", "a", 200):
            fail(f"24 (b): access-log lines {line}")
        phase("daemon-multi", f"(b) POST /clusters/a/plan {{}} (X-Request-Id smoke-24b): "
              f"stdout byte-identical to 23(d)'s CLI run, leadership kernel launches 1; "
              f"smoke-24b in the header, result.request_id, every span and one access-log "
              f"line ({line[0]['ms']} ms); request wall {b_s * 1e3:.1f} ms; spans "
              f"{span_summary(body)} | {smi}")

        # (c) b's plan with brokers 0-49 removed, as the CLI takes them.
        removed = set(range(MULTI_REMOVED))
        status, body, _, c_s = counted(
            "daemon_multi_b_plan", "POST", "/clusters/b/plan",
            {"broker_hosts_to_remove": ",".join(f"b{i}" for i in sorted(removed))})
        if status != 200 or body["status"] != "ok":
            fail(f"24 (c): HTTP {status}, status {body.get('status')}, {body.get('error')}")
        text_b = body["result"]["stdout"]
        live_b = live3 - removed
        on_removed = sum(r in removed for parts in topic_map3.values()
                         for reps in parts.values() for r in reps)
        cap = math.ceil(CONFIG3["p_per_topic"] * RF / len(live_b))
        moved = check_plan(plan_section(text_b), topic_map3, live_b, racks3, cap, on_removed)
        phase("daemon-multi", f"(c) POST /clusters/b/plan removing brokers 0-"
              f"{MULTI_REMOVED - 1}: moved {moved} replicas (== the replicas on them), "
              f"rack-distinct on live brokers under cap {cap}; leadership kernel launches 1 "
              f"at ({CONFIG3['n_topics']}, {CONFIG3['p_per_topic']}, {RF}), held against "
              f"plain; request wall {c_s * 1e3:.1f} ms; "
              f"spans {span_summary(body)} | {smi}")

        # (d) b executes (c)'s plan; a second execution meanwhile is a 409.
        plan_b, _ = parse_plan_payload(text_b)
        backend = SnapshotBackend(snap3)
        topics = {t: dict(parts) for t, parts in backend._topics.items()}
        for t, parts in plan_b.items():
            topics[t].update(parts)
        expected = os.path.join(work, "config3_expected.json")
        port_write(expected, backend.brokers(), topics, groups=backend._groups_raw)
        stream = {}

        def execute():
            conn = http.client.HTTPConnection("127.0.0.1", hport, timeout=600)
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/clusters/b/execute", body=json.dumps(
                    {"plan_text": text_b, "wave_size": MULTI_WAVE_SIZE}))
                resp = conn.getresponse()
                raw = resp.read().decode("utf-8")
                stream.update(status=resp.status, secs=time.perf_counter() - t0,
                              events=[json.loads(ln) for ln in raw.splitlines()])
            finally:
                conn.close()

        sup_b = d.supervisors["b"]
        runner = threading.Thread(target=execute)
        # The journal goes to the smoke's own directory, emptied first, so a
        # run killed mid-execution leaves nothing the next run would resume.
        jdir = os.path.join(work, "daemon_multi_journal")
        shutil.rmtree(jdir, ignore_errors=True)
        os.makedirs(jdir)
        with knobs(KA_EXEC_POLL_INTERVAL=EXEC_POLL_INTERVAL, KA_DAEMON_JOURNAL_DIR=jdir):
            runner.start()
            wait_for("b's execution in flight",
                     lambda: sup_b.execution_in_flight() or "status" in stream, every=0.005)
            second = call(hport, "POST", "/clusters/b/execute", {"plan_text": text_b})
            runner.join(600)
        events = stream.get("events", [])
        kinds = [e["event"] for e in events]
        waves = kinds.count("exec/wave.committed")
        if stream.get("status") != 200 or kinds[:1] != ["exec/start"] \
                or kinds[-2:] != ["exec/verify", "exec/done"] \
                or events[-1]["status"] != "ok" or not 1 <= waves <= 8 \
                or kinds.count("exec/wave") != waves:
            fail(f"24 (d): HTTP {stream.get('status')}, events {kinds[:4]}...{kinds[-3:]}")
        if second[0] != 409:
            fail(f"24 (d): the concurrent /execute answered {second[0]}, not 409")
        with open(snap_b, encoding="utf-8") as f, open(expected, encoding="utf-8") as g:
            if f.read() != g.read():
                fail("24 (d): the daemon's copy of b's snapshot differs from the plan's "
                     "NEW ASSIGNMENT written through write_snapshot")
        journals = os.listdir(jdir)
        if len(journals) != 1:
            fail(f"24 (d): journals in the smoke's journal directory: {journals}")
        with open(os.path.join(jdir, journals[0]), encoding="utf-8") as f:
            journal = json.load(f)
        if journal["status"] != "complete" or journal["waves_committed"] != waves:
            fail(f"24 (d): journal {journals[0]}: {journal['status']}, "
                 f"{journal['waves_committed']} waves committed of {waves}")
        start = events[0]
        phase("daemon-multi", f"(d) POST /clusters/b/execute at {MULTI_WAVE_SIZE} moves a "
              f"wave: NDJSON exec/start ({start['moves']} moves, {start['noops']} noops) -> "
              f"{waves} x (exec/wave, exec/wave.committed) -> exec/verify "
              f"({events[-2]['mismatches']} mismatches) -> exec/done ok; the daemon's copy "
              f"of b byte-identical to the NEW ASSIGNMENT through write_snapshot; journal "
              f"{journals[0]} complete in the smoke's directory; a second /execute "
              f"meanwhile: 409; stream wall {stream['secs'] * 1e3:.1f} ms | {smi}")

        # (e) the ingest group's plan and sweep, each launch held.
        group_bodies = {}
        for kind, query in (("plan", ""), ("sweep", f"?counts={MULTI_GROUP_COUNTS}"
                                                    f"&scales={MULTI_GROUP_SCALES}")):
            key = f"daemon_multi_b_groups_{kind}"
            gp.launches["group_pack"] = 0
            lead.launches["leadership"] = 0
            with scan_probe() as seen:
                status, body, _, e_s = call(hport, "GET",
                                            f"/clusters/b/groups/{kind}{query}")
            kg1[key] = gp.launches["group_pack"]
            steps = whatif.last_groups.get("steps_sum", 0)
            if status != 200 or body["degraded"] or not body["groups_real"] \
                    or set(body["groups"]) != {"ingest"} or kg1[key] < 1 \
                    or len(seen) != kg1[key] or lead.launches["leadership"]:
                fail(f"24 (e) {kind}: HTTP {status}, {body.get('error')}, group-pack "
                     f"launches {kg1[key]}")
            g = body["groups"]["ingest"]
            if kind == "plan":
                members = {f"c-{m:03d}" for m in range(GROUP_MEMBERS)}
                placed = {(t, int(p)): m for t, per in g["plan"].items()
                          for p, m in per.items()}
                changed = sum(placed[k] != o for k, o in owner3.items() if o in members)
                if set(placed) != set(owner3) or g["moves"] != changed:
                    fail(f"24 (e): the group plan's rows or moves ({g['moves']} != {changed})")
                what = f"moves {g['moves']}, feasible {g['feasible']}"
            else:
                what = (f"{len(g['candidates'])} candidates, recommended_consumers "
                        f"{g['recommended_consumers']}")
            for i, (inputs, outputs) in enumerate(seen):
                shape = (f"S={inputs[0].shape[0]} P_pad={inputs[0].shape[1]} "
                         f"C_pad={inputs[1].shape[0]}")
                hold_group_launch(checks, f"24 (e) {key}", shape, inputs, outputs)
                ms, lo, hi = scan_timing(key, inputs, outputs)
                nbytes = gcases.scan_bytes(inputs[0].shape[0], inputs[0].shape[1],
                                           inputs[1].shape[0], steps)
                phase("daemon-multi", f"(e) GET /clusters/b/groups/{kind}: group-pack "
                      f"launch {i + 1} of {kg1[key]} at {shape}, variant "
                      f"{variant_name(gp.last_variant, inputs[3].tolist())}, kernel "
                      f"median {ms:.3f} ms of {KERNEL_REPS} (min {lo:.3f}, max {hi:.3f}); "
                      f"byte bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} "
                      f"bytes, {steps} orphan rows)")
            phase("daemon-multi", f"(e) GET /clusters/b/groups/{kind} (ingest, groups_real "
                  f"true): {what}; request wall {e_s * 1e3:.1f} ms | {smi}")
            group_bodies[kind] = body

        # (f) recommendations, twice; the second's launch repeats the first's.
        recs = []
        for i, query in enumerate(("", "?move_cost=0")):
            status, body, _, f_s = counted(f"daemon_multi_b_recommend_{i + 1}", "GET",
                                           f"/clusters/b/recommendations{query}")
            problems = health.validate_recommendation(body)
            if status != 200 or problems:
                fail(f"24 (f): HTTP {status}, {problems or body.get('error')}")
            recs.append(body)
            cur, proj = body["current"], body["candidate"]["projected"]
            phase("daemon-multi", f"(f) GET /clusters/b/recommendations{query}: verdict "
                  f"{body['verdict']}, moves {body['candidate']['moves_required']}, "
                  f"leader moves {body['candidate']['leader_moves']}, improvement "
                  f"{body['cost_model']['improvement']}, cost {body['cost_model']['cost']}; "
                  f"score {cur['score']} -> {proj['score']} (replica spread "
                  f"{cur['replica_spread']} -> {proj['replica_spread']}, leader spread "
                  f"{cur['leader_spread']} -> {proj['leader_spread']}); leadership kernel "
                  f"launches 1; request wall {f_s * 1e3:.1f} ms | {smi}")

        # (g) the scrape and the flight ring.
        conn = http.client.HTTPConnection("127.0.0.1", hport, timeout=60)
        t0 = time.perf_counter()
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        raw = resp.read()
        scrape_s = time.perf_counter() - t0
        conn.close()
        fams = promtext.parse(raw.decode("utf-8"))
        bad = {f: promtext.check_histogram(v) for f, v in fams.items()
               if v["type"] == "histogram" and promtext.check_histogram(v)}
        http_clusters = {lb["cluster"] for _, lb, _ in
                         fams.get("ka_daemon_http_requests_total", {"samples": []})["samples"]
                         if "cluster" in lb}
        health_clusters = {lb.get("cluster") for _, lb, _ in
                           fams.get("ka_health_score", {"samples": []})["samples"]}
        if resp.status != 200 or bad or not {"a", "b"} <= http_clusters \
                or health_clusters != {"a", "b"}:
            fail(f"24 (g): /metrics {resp.status}, histogram findings {bad}, http clusters "
                 f"{http_clusters}, health clusters {health_clusters}")
        _, view, _, _ = call(hport, "GET", "/debug/flight?cluster=b")
        ev = [(e["kind"], e.get("event"), e.get("verdict")) for e in view["events"]]
        if ("execute", "start", None) not in ev or ("execute", "done", None) not in ev \
                or [v for k, _, v in ev if k == "recommendation"] \
                != [r["verdict"] for r in recs] \
                or any(e.get("cluster", "b") != "b" for e in view["events"]):
            fail(f"24 (g): b's flight events {ev}")
        hists = sum(v["type"] == "histogram" for v in fams.values())
        phase("daemon-multi", f"(g) GET /metrics: {len(raw)} bytes in "
              f"{scrape_s * 1e3:.1f} ms, {len(fams)} families parsed, {hists} histograms "
              f"consistent, daemon.http.requests for clusters {sorted(http_clusters)}, "
              f"ka_health_* for a and b; /debug/flight?cluster=b: {len(ev)} events, "
              f"execute start and done, the recommendations {[r['verdict'] for r in recs]} "
              f"| {smi}")

        # (h) the drain with a plan on a in flight.
        sup_a = d.supervisors["a"]
        answer = {}
        lead.launches["leadership"] = 0
        with solver_probe() as seen:
            client = threading.Thread(target=lambda: answer.update(
                r=call(hport, "POST", "/clusters/a/plan", {})))
            client.start()
            wait_for("a's plan in flight", lambda: sup_a.active_requests() >= 1
                     or "r" in answer, every=0.005)
            in_flight = sup_a.active_requests()
            t0 = time.perf_counter()
            d.request_stop()
            rc = d.serve()
            drain_s = time.perf_counter() - t0
            served = True
            client.join(600)
        k1["daemon_multi_a_drain"] = lead.launches["leadership"]
        status, body, _, h_s = answer.get("r", (None, {}, {}, 0.0))
        if rc != 0 or d.lifecycle() != "stopped" or in_flight < 1 or status != 200 \
                or body.get("status") != "ok" or body["result"]["stdout"] != text_a \
                or k1["daemon_multi_a_drain"] != 1:
            fail(f"24 (h): serve returned {rc}, lifecycle {d.lifecycle()}, in flight at "
                 f"the stop {in_flight}, the request: HTTP {status} {body.get('status')}, "
                 f"launches {k1['daemon_multi_a_drain']}")
        hold("phase 24 (h) the plan answered through the drain", seen["orders"])
        phase("daemon-multi", f"(h) request_stop with POST /clusters/a/plan in flight: the "
              f"request answered in full ({h_s * 1e3:.1f} ms, byte-identical), serve() "
              f"returned 0 after {drain_s * 1e3:.1f} ms, leadership kernel launches 1 | {smi}")
    finally:
        if not served:
            d.shutdown()
    phase("timing", f"phase 24 {time.perf_counter() - t_phase:.1f} s | {smi}")
    return k1, kg1, group_bodies["sweep"]


#: Phase 25: the dispatch plane. (a)-(d) and (f)'s crash make their packing
#: deterministic with a size trigger of the step's job count behind a long
#: window; (e) runs at the knob's default window and at the widened one,
#: with no size trigger, as a client burst meets them.
DISPATCH_WINDOW_MS = 250
DISPATCH_LONG_WINDOW_MS = 20000
#: (c)'s removals: four of config 4's live brokers (100-5,099).
DISPATCH_SCENARIOS = [[100], [1100], [2100], [3100]]
#: (e)'s requests a round, and the disjoint topic slices of config 3.
DISPATCH_CLIENTS = 8


def dispatch_phases(work, checks, hold, snap4, text4, prefix4, prefix_text4, snap3,
                    sweep_24):
    """Phase 25: the dispatch plane (``daemon/dispatch.py``) on the card, in
    this process. One ``AssignerDaemon(clusters=..., solver="device")`` with
    the dispatcher (the default) over four snapshot copies: ``a1`` and
    ``a2`` of config 4 (``snap4``, ``text4`` its plan), ``b1`` and ``b2`` of
    config 3 with the ``ingest`` group (``snap3``, ``sweep_24`` phase
    24(e)'s sweep of it). Clients are released through one barrier. (a)
    ``/plan`` on a1 and a2 and the ``prefix4`` subset on a1: their placement
    rows in one call, each plan's stdout its solo bytes, one K1 launch a
    plan; (b) 8 identical ``/plan`` on a1: one leader, one launch; (c) a
    ``/whatif`` of four removals on a1 and a2: one sweep call; (d) the
    sweep on b1 and b2: one KG1 launch at twice the candidates, held against
    plain and timed; (e) requests per second at the default window and at
    250 ms, 8 distinct config-3 plans (8 topic slices of b1) and 8
    identical ones, against a second daemon under
    ``KA_DISPATCH=0``; (f) ``dispatch:0=crash`` on a packed call, the kill
    switch's daemon with no ``dispatch.*`` activity and the same bytes, and
    a drain while a job waits in the gather window. Each leadership launch
    goes through ``hold``; each group-pack launch to the workers. Returns
    the launches per step: ``(leadership, group_pack)``."""
    import threading

    import torch

    from kafka_assigner_tpu_torch import faults, obs
    from kafka_assigner_tpu_torch.daemon import AssignerDaemon
    from kafka_assigner_tpu_torch.obs import flight, metrics
    from kafka_assigner_tpu_torch.ops import group_pack as gp
    from kafka_assigner_tpu_torch.ops import group_pack_cases as gcases
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.utils.env import KNOBS

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    k1, kg1 = {}, {}
    snaps = {}
    for name, src in (("a1", snap4), ("a2", snap4), ("b1", snap3), ("b2", snap3)):
        snaps[name] = os.path.join(work, f"dispatch_{name}.json")
        shutil.copy(src, snaps[name])
    with open(snap3, encoding="utf-8") as f:
        topics3 = sorted(json.load(f)["topics"])
    per = -(-len(topics3) // DISPATCH_CLIENTS)
    slices = [topics3[i * per:(i + 1) * per] for i in range(DISPATCH_CLIENTS)]

    def together(port, calls):
        """``calls`` (method, path, payload) released through one barrier:
        their ``(status, body, seconds)`` in order, and the round's wall."""
        out = [None] * len(calls)
        barrier = threading.Barrier(len(calls) + 1)

        def one(i, method, path, payload):
            barrier.wait(60)
            out[i] = http_call(port, method, path, payload)

        threads = [threading.Thread(target=one, args=(i, *c)) for i, c in enumerate(calls)]
        for t in threads:
            t.start()
        barrier.wait(60)
        t0 = time.perf_counter()
        for t in threads:
            t.join(DAEMON_WAIT_S)
        wall = time.perf_counter() - t0
        if any(o is None for o in out):
            fail(f"25: {sum(o is None for o in out)} of {len(calls)} requests unanswered")
        return out, wall

    def counter(name):
        return sum(metrics.cumulative().snapshot()["counters"].get(name, {}).values())

    def hist(name):
        h = metrics.cumulative().snapshot()["hists"].get(name, {}).values()
        return sum(v["count"] for v in h), sum(v["sum"] for v in h)

    def events(since, entry=None):
        return [e for e in flight.recorder().snapshot(since=since)
                if e["kind"] == "dispatch" and entry in (None, e["entry"])]

    def mark():
        return flight.recorder().stats()["recorded"]

    def gather(jobs, window=DISPATCH_LONG_WINDOW_MS):
        """Knobs for one step: the size trigger at ``jobs``."""
        return knobs(KA_DISPATCH_WINDOW_MS=window, KA_DISPATCH_MAX_BATCH=jobs)

    def plans(what, replies, want):
        for i, (status, body, _s) in enumerate(replies):
            if status != 200 or body.get("status") != "ok" \
                    or body["result"]["stdout"] != want[i]:
                fail(f"25 {what}: request {i}: HTTP {status}, status {body.get('status')}, "
                     f"stdout equal {status == 200 and body['result']['stdout'] == want[i]}"
                     f"; {body.get('error')}")

    def launched(key, seen, want, what):
        k1[key] = lead.launches["leadership"]
        if k1[key] != want or len(seen["orders"]) != want:
            fail(f"25 {what}: the leadership kernel launched {k1[key]} times "
                 f"({len(seen['orders'])} ordering calls), not {want}")
        hold(f"phase 25 {key}", seen["orders"])

    def walls(replies):
        secs = sorted(s for _, _, s in replies)
        return (f"walls median {statistics.median(secs) * 1e3:.1f} ms (min "
                f"{secs[0] * 1e3:.1f}, max {secs[-1] * 1e3:.1f})")

    clusters = {n: f"file://{p}" for n, p in snaps.items()}
    t0 = time.perf_counter()
    with knobs(KA_DISPATCH="1", KA_DISPATCH_WINDOW_MS=DISPATCH_WINDOW_MS):
        d = AssignerDaemon(clusters=clusters, solver="device", device="cuda")
        d.start()
    served = False
    try:
        port = d.http_port
        if d.dispatcher is None or http_call(port, "GET", "/readyz")[0] != 200:
            fail("25: the daemon has no dispatcher, or is not ready after start")
        phase("dispatch", f"AssignerDaemon(clusters=a1,a2,b1,b2) on cuda with the "
              f"dispatcher: construction to /readyz 200 "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms | {smi}")

        # (a) two clusters' plans and a subset: one placement call.
        m, b0 = mark(), counter("dispatch.batches")
        lead.launches["leadership"] = 0
        with solver_probe() as seen, gather(3):
            replies, wall = together(port, [
                ("POST", "/clusters/a1/plan", {}), ("POST", "/clusters/a2/plan", {}),
                ("POST", "/clusters/a1/plan", {"topics": prefix4})])
        plans("(a)", replies, [text4, text4, prefix_text4])
        placed = events(m, "place_batched")
        if [(e["jobs"], e["ok"]) for e in placed] != [(3, True)] \
                or counter("dispatch.batches") - b0 < 1 or len(seen["chains"]) != 1:
            fail(f"25 (a): placement calls {placed}, place_batched calls "
                 f"{len(seen['chains'])}, dispatch.batches +{counter('dispatch.batches') - b0}")
        launched("dispatch_a_packed_plans", seen, 3, "(a)")
        phase("dispatch", f"(a) POST /clusters/a1/plan {{}}, /clusters/a2/plan {{}} and "
              f"/clusters/a1/plan {{topics: {len(prefix4)}}} together: one place_batched "
              f"call of {placed[0]['rows']} rows for the 3 jobs of both clusters "
              f"({placed[0]['ms']:.1f} ms on the dispatcher's thread), each stdout its "
              f"solo bytes (phase 4's and phase 5's), leadership kernel launches 3; "
              f"round wall {wall * 1e3:.1f} ms, {walls(replies)} | {smi}")

        # (b) 8 identical bodies: one leader, one launch.
        m = mark()
        lead.launches["leadership"] = 0
        with solver_probe() as seen, gather(1):
            replies, wall = together(port, [("POST", "/clusters/a1/plan", {})] * 8)
        plans("(b)", replies, [text4] * 8)
        body_ev = events(m, "body")
        if [e["jobs"] for e in body_ev] != [8]:
            fail(f"25 (b): body dedup events {body_ev}")
        launched("dispatch_b_dedup", seen, 1, "(b)")
        phase("dispatch", f"(b) 8 identical POST /clusters/a1/plan {{}}: one leader ran, 7 "
              f"followers served its bytes (== phase 4's), leadership kernel launches 1; "
              f"round wall {wall * 1e3:.1f} ms, {walls(replies)} | {smi}")

        # (c) scenario rows of two clusters: one sweep call.
        m = mark()
        lead.launches["leadership"] = 0
        whatif = {"scenarios": DISPATCH_SCENARIOS}
        with gather(2):
            replies, wall = together(port, [("POST", f"/clusters/{n}/whatif", whatif)
                                            for n in ("a1", "a2")])
        with gather(1):
            solo = http_call(port, "POST", "/clusters/a1/whatif", whatif)
        plans("(c)", replies, [solo[1]["result"]["stdout"]] * 2)
        swept = [e for e in events(m) if e["entry"].startswith("whatif")]
        if not swept or swept[0]["jobs"] != 2 or lead.launches["leadership"]:
            fail(f"25 (c): sweep calls {swept}, leadership launches "
                 f"{lead.launches['leadership']}")
        phase("dispatch", f"(c) POST /whatif of {len(DISPATCH_SCENARIOS)} removals on a1 and "
              f"a2 together: the first {swept[0]['entry']} call packed both "
              f"({swept[0]['rows']} scenario rows, {swept[0]['ms']:.1f} ms), stdout "
              f"byte-identical to a1's alone; sweep calls {[(e['entry'], e['jobs']) for e in swept]}"
              f"; round wall {wall * 1e3:.1f} ms | {smi}")

        # (d) two sweeps: one KG1 launch at twice the candidates.
        query = f"?counts={MULTI_GROUP_COUNTS}&scales={MULTI_GROUP_SCALES}"
        gp.launches["group_pack"] = 0
        with scan_probe() as seen_g, gather(2):
            replies, wall = together(port, [("GET", f"/clusters/{n}/groups/sweep{query}", None)
                                            for n in ("b1", "b2")])
        kg1["dispatch_d_packed_sweeps"] = gp.launches["group_pack"]
        want = {k: v for k, v in sweep_24.items() if k != "cluster"}
        for status, body, _s in replies:
            if status != 200 or {k: v for k, v in body.items() if k != "cluster"} != want:
                fail(f"25 (d): HTTP {status}, envelope equal to 24(e)'s sweep "
                     f"{status == 200 and {k: v for k, v in body.items() if k != 'cluster'} == want}")
        s_one = len(sweep_24["groups"]["ingest"]["candidates"])
        if kg1["dispatch_d_packed_sweeps"] != 1 or len(seen_g) != 1 \
                or seen_g[0][0][0].shape[0] != 2 * s_one:
            fail(f"25 (d): group-pack launches {kg1['dispatch_d_packed_sweeps']}, "
                 f"S {[x[0][0].shape[0] for x in seen_g]}")
        inputs, outputs = seen_g[0]
        s, p_pad, c_pad = inputs[0].shape[0], inputs[0].shape[1], inputs[1].shape[0]
        shape = f"S={s} P_pad={p_pad} C_pad={c_pad}"
        hold_group_launch(checks, "25 (d) the packed sweep", shape, inputs, outputs)
        ms, lo, hi = scan_timing("25 (d)", inputs, outputs)
        steps = inputs[4].sum(1)
        steps_max, steps_sum = int(steps.max()), int(steps.sum())
        nbytes = gcases.scan_bytes(s, p_pad, c_pad, steps_sum)
        probe = gcases.probe_ns()[0]
        phase("dispatch", f"(d) GET /clusters/b1/groups/sweep and b2's together: one "
              f"group-pack launch at {shape} (each request alone S={s_one}), variant "
              f"{variant_name(gp.last_variant, inputs[3].tolist())}, kernel median "
              f"{ms:.3f} ms of {KERNEL_REPS} (min {lo:.3f}, max {hi:.3f}); byte bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes); chain floor "
              f"{steps_max * probe * 1e-6:.3f} ms ({steps_max} steps x {probe:.2f} ns of the "
              f"probe; {steps_sum} orphan rows); both envelopes == phase 24(e)'s but the "
              f"cluster name; round wall {wall * 1e3:.1f} ms | {smi}")
        packed_kg1 = dict(ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                          chain_bound_ms=steps_max * probe * 1e-6, shape=[s, p_pad, c_pad])

        # (e) requests per second with the dispatcher, at the knob's default
        # window and at the widened one; the lock's below.
        def rounds(dd, tag):
            out = {}
            for kind, calls in (
                    ("distinct", [("POST", "/clusters/b1/plan", {"topics": sl})
                                  for sl in slices]),
                    ("identical", [("POST", "/clusters/b1/plan", {})] * DISPATCH_CLIENTS)):
                q0, b0, j0 = hist("daemon.solve.queue_ms"), counter("dispatch.batches"), \
                    counter("dispatch.jobs")
                m = mark()
                lead.launches["leadership"] = 0
                with obs.run_capture() as run, solver_probe() as seen, \
                        queue_probe() as waits:
                    replies, wall = together(dd.http_port, calls)
                q1 = hist("daemon.solve.queue_ms")
                spans = [sp["ms"] for sp in run.spans if sp["name"] == "dispatch"]
                want = DISPATCH_CLIENTS
                if kind == "identical" and tag != "off":
                    # One run a dedup entry: a body that arrives after its
                    # leader finished leads an entry of its own (a ``body``
                    # event only when it has followers).
                    followed = events(m, "body")
                    served = sum(e["jobs"] for e in followed)
                    if served > DISPATCH_CLIENTS:
                        fail(f"25 (e) identical {tag}: body dedup events {followed}")
                    want = len(followed) + DISPATCH_CLIENTS - served
                launched(f"dispatch_e_{kind}_{tag}", seen, want, f"(e) {kind} {tag}")
                out[kind] = [b["result"]["stdout"] for _, b, _ in replies]
                if any(st != 200 or b.get("status") != "ok" for st, b, _ in replies):
                    fail(f"25 (e) {kind} {tag}: {[(st, b.get('error')) for st, b, _ in replies]}")
                phase("dispatch", f"(e) {tag}: {DISPATCH_CLIENTS} {kind} config-3 POST "
                      f"/clusters/b1/plan together: {DISPATCH_CLIENTS / wall:.3f} requests/s "
                      f"(round wall {wall * 1e3:.1f} ms), {walls(replies)}; "
                      f"daemon.solve.queue_ms {q1[1] - q0[1]:.1f} ms over {q1[0] - q0[0]} "
                      f"waits; dispatch spans {len(spans)} totalling {sum(spans):.1f} ms; "
                      f"dispatch.batches +{counter('dispatch.batches') - b0}, dispatch.jobs "
                      f"+{counter('dispatch.jobs') - j0}; each placement job's queue wait (ms) "
                      f"{sorted(round(ms, 1) for _t, w, ms in waits if w == 'rows')}, each "
                      f"body's {sorted(round(ms, 1) for _t, w, ms in waits if w == 'body')}; "
                      f"leadership kernel "
                      f"launches {k1[f'dispatch_e_{kind}_{tag}']} | {smi}")
            return out

        default_ms = KNOBS["KA_DISPATCH_WINDOW_MS"].default
        with knobs(KA_DISPATCH_WINDOW_MS=default_ms):
            on = rounds(d, f"on_{default_ms:g}ms")
        with knobs(KA_DISPATCH_WINDOW_MS=DISPATCH_WINDOW_MS):
            on_wide = rounds(d, f"on_{DISPATCH_WINDOW_MS}ms")
        # The hand-off alone: every job goes to the dispatcher's thread and
        # runs there by itself.
        with knobs(KA_DISPATCH_WINDOW_MS=default_ms, KA_DISPATCH_MAX_BATCH=1):
            on_alone = rounds(d, "on_max_batch_1")
        if on_wide != on or on_alone != on:
            fail("25 (e): the windows' or the unpacked round's replies differ")

        # (f) a packed call that crashes: each job re-runs solo on the card.
        m, f0 = mark(), counter("dispatch.solo_fallbacks")
        faults.reset()
        lead.launches["leadership"] = 0
        with knobs(KA_FAULTS_SPEC="dispatch:0=crash"), solver_probe() as seen, gather(2):
            replies, wall = together(port, [("POST", f"/clusters/{n}/plan", {})
                                            for n in ("b1", "b2")])
            fired = [str(e) for e in faults.active_injector().fired]
        faults.reset()
        plans("(f) the crash", replies, [on["identical"][0]] * 2)
        crashed = [e for e in events(m, "place_batched") if not e["ok"]]
        fell = counter("dispatch.solo_fallbacks") - f0
        # Two bodies without followers, and the crashed call's jobs re-run.
        if fired != ["dispatch:0=crash"] or [e["jobs"] for e in crashed] != [2] or fell != 4:
            fail(f"25 (f): fired {fired}, failed calls {crashed}, solo fallbacks +{fell}")
        launched("dispatch_f_crash", seen, 2, "(f) the crash")
        phase("dispatch", f"(f) KA_FAULTS_SPEC=dispatch:0=crash on b1's and b2's plans "
              f"together: the packed place_batched call of 2 jobs failed, each job re-ran "
              f"its rows alone on the card (dispatch.solo_fallbacks +{fell}: 2 re-runs and "
              f"2 bodies without followers), both stdouts == (e)'s, leadership kernel "
              f"launches 2 | {smi}")

        # (f) the drain: a job waits in a 30 s window when the stop comes.
        answer = {}
        lead.launches["leadership"] = 0
        d.drain_timeout = 1.0
        with solver_probe() as seen, knobs(KA_DISPATCH_WINDOW_MS=30000,
                                           KA_DISPATCH_MAX_BATCH=64):
            client = threading.Thread(target=lambda: answer.update(
                r=http_call(port, "POST", "/clusters/b1/plan", {})))
            client.start()
            wait_for("a job in the gather window", lambda: d.dispatcher._queue
                     or "r" in answer, every=0.005)
            t0 = time.perf_counter()
            d.request_stop()
            rc = d.serve()
            drain_s = time.perf_counter() - t0
            served = True
            client.join(DAEMON_WAIT_S)
        status, body, _s = answer.get("r", (None, {}, 0.0))
        if rc != 0 or status != 200 or body.get("status") != "ok" \
                or body["result"]["stdout"] != on["identical"][0] or drain_s > 20:
            fail(f"25 (f) the drain: serve {rc}, HTTP {status} {body.get('status')}, "
                 f"{drain_s:.1f} s")
        launched("dispatch_f_drain", seen, 1, "(f) the drain")
        phase("dispatch", f"(f) request_stop with b1's plan waiting in a 30 s gather window "
              f"(drain timeout 1 s): close() dispatched it, the reply complete and "
              f"byte-identical, serve() returned 0 after {drain_s * 1e3:.1f} ms | {smi}")
    finally:
        if not served:
            d.shutdown()

    # (e) and (f): the kill switch, a second daemon under the lock.
    with knobs(KA_DISPATCH="0"):
        d0 = AssignerDaemon(clusters={"b1": clusters["b1"]}, solver="device",
                            device="cuda")
        d0.start()
    try:
        if d0.dispatcher is not None:
            fail("25 (e): KA_DISPATCH=0 built a dispatcher")
        off = rounds(d0, "off")
        active = {n: v for sec in ("counters", "hists", "gauges")
                  for n, v in metrics.cumulative().snapshot()[sec].items()
                  if n.startswith("dispatch.") or n == "daemon.solve.queue_ms"}
        if off != on or active:
            fail(f"25 (f) the kill switch: bytes equal {off == on}, dispatch activity "
                 f"{sorted(active)}")
        phase("dispatch", f"(f) KA_DISPATCH=0: no dispatcher, no dispatch.* or "
              f"daemon.solve.queue_ms series; every (e) reply byte-identical to the "
              f"dispatcher's | {smi}")
    finally:
        d0.shutdown()
    phase("timing", f"phase 25 {time.perf_counter() - t_phase:.1f} s | {smi}")
    DISPATCH_KG1.update(packed_kg1)
    return k1, kg1


#: Phase 25(d)'s packed group-pack launch: time, bound, chain floor, shape.
DISPATCH_KG1 = {}


@contextlib.contextmanager
def queue_probe():
    """Each dispatcher wait of the block, ``(thread name, what, ms)``, what
    ``rows`` for a placement job's wait for its packed call and ``body`` for
    a request body's wait in the dedup entry: wraps the name
    ``daemon/dispatch.py`` records ``daemon.solve.queue_ms`` through (on the
    waiting thread, apart from the solve's time)."""
    import threading

    from kafka_assigner_tpu_torch.daemon import dispatch as dispatch_mod

    waits = []
    observe = dispatch_mod.hist_observe

    def recorded(name, value, *args, **kw):
        if name == "daemon.solve.queue_ms":
            caller = sys._getframe(1).f_code.co_name
            waits.append((threading.current_thread().name,
                          "rows" if caller == "submit_rows" else "body", value))
        return observe(name, value, *args, **kw)

    dispatch_mod.hist_observe = recorded
    try:
        yield waits
    finally:
        dispatch_mod.hist_observe = observe


#: Phase 26: the replicas of ``topic-0000`` piled on broker
#: ``CONTROLLER_HOT`` (its rack's replica of each partition replaced), more
#: than ``KA_CONTROLLER_MAX_MOVES``' default 16, so the action truncates.
CONTROLLER_SEEDED = 24
CONTROLLER_HOT = 0
#: (b)'s wave size: the 16-move action runs in two waves.
CONTROLLER_WAVE_SIZE = 8


def seeded_snapshot(path, topic_map, live, racks, count=CONTROLLER_SEEDED):
    """``topic_map`` with ``count`` partitions of its first topic moved onto
    broker ``CONTROLLER_HOT``, each in place of its replica in that broker's
    rack (every partition stays rack-unique): the per-topic cap of one
    replica a broker evicts them again. Written to ``path``."""
    seeded = 0
    for _p, reps in sorted(topic_map[min(topic_map)].items()):
        if seeded == count:
            break
        same = [i for i, b in enumerate(reps) if racks[b] == racks[CONTROLLER_HOT]]
        if CONTROLLER_HOT not in reps and same:
            reps[same[0]] = CONTROLLER_HOT
            seeded += 1
    if seeded != count:
        fail(f"only {seeded} partitions of {min(topic_map)} could be seeded")
    write_snapshot(path, topic_map, live, racks)


def snapshot_health(path):
    """A snapshot's health scores and its assignment as canonical plan
    bytes (topics sorted)."""
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_json
    from kafka_assigner_tpu_torch.obs.health import score_assignment

    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    topics = {t: {int(p): r for p, r in parts.items()} for t, parts in data["topics"].items()}
    scores = score_assignment({b["id"] for b in data["brokers"]}, topics,
                              {b["id"]: b["rack"] for b in data["brokers"] if b.get("rack")})
    return scores, format_reassignment_json(topics, topic_order=sorted(topics))


def controller_phases(work, hold, snap3):
    """Phase 26: the closed-loop controller on the card, in this process
    (module doc). ``hold`` holds each leadership launch against plain;
    ``snap3`` is phase 24's config-3 snapshot, cluster ``b``. Returns the
    leadership kernel's launches per evaluation round."""
    from kafka_assigner_tpu_torch import faults, obs
    from kafka_assigner_tpu_torch.daemon import AssignerDaemon
    from kafka_assigner_tpu_torch.obs import flight, metrics
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.ops import leadership_cases as cases

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    root = os.path.join(work, "controller")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    from kafka_assigner_tpu_torch.models.synthetic import build_config3, rack_striped_cluster

    snap_a = os.path.join(root, "a.json")
    # Config 4's steady cluster, phase 11's.
    seeded_snapshot(snap_a, *rack_striped_cluster(
        N_BROKERS, N_TOPICS, P_PER_TOPIC, RF, N_RACKS, name_fmt="topic-{:04d}"))
    seeded_bytes = open(snap_a, encoding="utf-8").read()
    before, before_text = snapshot_health(snap_a)
    k1 = {}
    base = dict(KA_HEALTH_MOVE_COST=0, KA_CONTROLLER_CONFIRMATIONS=2,
                KA_CONTROLLER_INTERVAL=DAEMON_INTERVAL_S,
                KA_DAEMON_RESYNC_INTERVAL=DAEMON_INTERVAL_S,
                KA_EXEC_POLL_INTERVAL=EXEC_POLL_INTERVAL, KA_DISPATCH=1)
    if os.environ.get("KA_CONTROLLER_MAX_MOVES"):
        fail("26 runs at the default KA_CONTROLLER_MAX_MOVES; unset it")

    def journal_dir(part):
        """A journal directory of the part's own (the daemon reads the knob
        live, so it stays set while the daemon runs)."""
        jdir = os.path.join(root, f"journal_{part}")
        os.makedirs(jdir)
        return jdir

    def start(clusters):
        """A daemon of ``clusters`` on cuda, its warm-ups finished; each
        controller's ticks counted."""
        t0 = time.perf_counter()
        d = AssignerDaemon(clusters=clusters, solver="device", device="cuda")
        d.start()
        wait_for("the warm-ups", lambda: all(
            sum(s.counters().get(k, 0) for k in ("daemon.warmups", "daemon.warmup_failures"))
            for s in d.supervisors.values()))
        ticks = {}
        for name, sup in d.supervisors.items():
            ctl = sup.controller
            if ctl.policy != "off":
                out = ticks[name] = []
                ctl.tick = lambda tick=ctl.tick, out=out: out.append(tick()) or out[-1]
        return d, ticks, time.perf_counter() - t0

    def one_round(d, ticks, i, part):
        """Round ``i`` (from 0) of the shared ticker, awaited until every
        controller's tick returned: (decisions, wall, capture)."""
        with obs.run_capture() as run:
            t0 = time.perf_counter()
            d.ticker.advance()
            wait_for(f"26 {part} round {i + 1}",
                     lambda: all(len(t) > i for t in ticks.values()))
            wall = time.perf_counter() - t0
        return {n: t[i] for n, t in ticks.items()}, wall, run

    def split(run, cluster):
        """The round's spans, by name: total ms and count."""
        by = {}
        for sp in run.spans:
            ms, c = by.get(sp["name"], (0.0, 0))
            by[sp["name"]] = (ms + sp["ms"], c + 1)
        keep = (f"controller/evaluate@{cluster}", "metadata/assignment", "feasibility",
                "plan/solve", "plan/emit", "dispatch", f"controller/act@{cluster}",
                "exec/wave", "exec/verify")
        return ", ".join(f"{k} {by[k][0]:.1f}" + (f" x{by[k][1]}" if by[k][1] > 1 else "")
                         for k in keep if k in by)

    def k1_ms(orders):
        times = cases.event_ms(lambda: lead.leadership_order(*orders[0][0]), 5)
        return statistics.median(times), tuple(orders[0][0][0].shape)

    def evaluated(key, seen, want, part):
        k1[key] = lead.launches["leadership"]
        if k1[key] != want or len(seen["orders"]) != want:
            fail(f"26 {part}: the leadership kernel launched {k1[key]} times "
                 f"({len(seen['orders'])} ordering calls) for {want} evaluations")
        hold(f"phase 26 {key}", seen["orders"])

    faults.reset()
    # (a) act once.
    shutil.copy(snap3, os.path.join(root, "b.json"))
    snap_b = os.path.join(root, "b.json")
    b_bytes = open(snap_b, encoding="utf-8").read()
    jdir = journal_dir("a")
    with knobs(**base, KA_DAEMON_JOURNAL_DIR=jdir):
        d, ticks, boot_s = start({"a": f"file://{snap_a}#controller=auto",
                                  "b": f"file://{snap_b}"})
        try:
            lead.launches["leadership"] = 0
            m_act = flight.recorder().stats()["recorded"]
            with solver_probe() as seen, queue_probe() as waits:
                got = [one_round(d, ticks, i, "(a)") for i in range(2)]
            evaluated("controller_a_act", seen, 2, "(a)")
            sup = d.supervisors["a"]
            view = sup.controller_view()
            trail = [e["decision"] for e in view["decisions"]]
            if [g[0]["a"]["decision"] for g in got] != ["confirmed", "acted"] \
                    or trail != ["confirmed", "truncate", "act", "acted"]:
                fail(f"26 (a): trail {view['decisions']}")
            acted = view["decisions"][-1]
            trunc = view["decisions"][1]
            # The resync the action prompted, to its end (its health and
            # traffic publishing follow the swap that makes `a` ready).
            wait_for("26 (a) the resync after the action", lambda: any(
                e["kind"] == "resync" and e.get("cluster") == "a"
                for e in flight.recorder().snapshot(since=m_act)))
            resync = [e for e in flight.recorder().snapshot(since=m_act)
                      if e["kind"] == "resync" and e.get("cluster") == "a"][0]
            # Timed on a quiet host: a launch timed while another thread
            # holds the GIL waits between its two events.
            ms, shape = k1_ms(seen["orders"])
            after, _ = snapshot_health(snap_a)
            names = sorted(os.listdir(jdir))
            journal = f"ka-controller-a-{acted['plan_sha']}.journal"
            with open(os.path.join(jdir, journal), encoding="utf-8") as f:
                jr = json.load(f)
            if jr["status"] != "complete" or any(n.endswith(".action.json") for n in names):
                fail(f"26 (a): journal {jr['status']}, files {names}")
            if not after.score < before.score or acted["moves"] > 16 or acted["moves"] < 1:
                fail(f"26 (a): score {before.score} -> {after.score}, moves {acted['moves']}")
            # The scrape's ka_controller_actions_total family, read from the
            # registry it renders (the rounds' captures left the engine's list
            # gauges in it, which the exposition does not render).
            acts = sorted(metrics.cumulative().snapshot()["counters"].get(
                "controller.actions", {}))
            b_view = d.supervisors["b"].controller_view()
            b_counters = [k for k in d.counters() if k.startswith("controller.")
                          and k.endswith("@b")]
            if open(snap_b, encoding="utf-8").read() != b_bytes or b_view["decisions"] \
                    or b_counters or acts != [(("cluster", "a"),)]:
                fail(f"26 (a): b's bytes equal {open(snap_b).read() == b_bytes}, b's "
                     f"decisions {b_view['decisions']}, counters {b_counters}, "
                     f"ka_controller_actions_total {acts}")
        finally:
            d.shutdown()
    phase("controller", f"(a) a (config 4, {CONTROLLER_SEEDED} replicas of topic-0000 on "
          f"broker {CONTROLLER_HOT}) on auto beside b (config 3, off): construction to "
          f"warm {boot_s * 1e3:.1f} ms; trail confirmed, truncate ({trunc['full_moves']} "
          f"moves to {trunc['moves']} within the cap {trunc['cap']}), act, acted; "
          f"forward journal complete in {jr['waves_committed']} waves of "
          f"{jr['wave_size']}, action record discarded; health score {before.score} -> "
          f"{after.score} (replica spread {before.replica_spread} -> "
          f"{after.replica_spread}; achieved {acted['achieved']}, projected "
          f"{acted['projected']}); the resync after it {resync['outcome']} in "
          f"{resync['ms']:.1f} ms; "
          f"b's bytes untouched, no decision or controller.* counter for b, "
          f"ka_controller_actions_total for a only | {smi}")
    for i, (dec, wall, run) in enumerate(got):
        phase("controller", f"(a) round {i + 1} ({dec['a']['decision']}): wall "
              f"{wall * 1e3:.1f} ms; spans (ms): {split(run, 'a')} | {smi}")
    phase("controller", f"(a) queue waits (ms): "
          f"{[(w, round(v, 1)) for _t, w, v in waits]}; leadership kernel launches 2 (one "
          f"an evaluation), {ms:.3f} ms median of 5 at {shape} on the recorded inputs, "
          f"after the resync | {smi}")

    # (b) roll back once.
    with open(snap_a, "w", encoding="utf-8") as f:
        f.write(seeded_bytes)
    faults.reset()
    jdir = journal_dir("b")
    with knobs(**base, KA_DAEMON_JOURNAL_DIR=jdir, KA_FAULTS_SPEC="controller@a:1=exec-crash",
               KA_EXEC_WAVE_SIZE=CONTROLLER_WAVE_SIZE):
        d, ticks, boot_s = start({"a": f"file://{snap_a}#controller=auto"})
        try:
            lead.launches["leadership"] = 0
            with solver_probe() as seen:
                got_b = [one_round(d, ticks, i, "(b)") for i in range(2)]
            evaluated("controller_b_rollback", seen, 2, "(b)")
            fired = [str(e) for e in faults.active_injector().fired]
            sup = d.supervisors["a"]
            view = sup.controller_view()
            decs = view["decisions"]
            trail = [e["decision"] for e in decs]
            wait_for("26 (b) the resync after the rollback", lambda: sup.lifecycle() == "ready")
            _, back_text = snapshot_health(snap_a)
            names = sorted(os.listdir(jdir))
            rb = [n for n in names if n.endswith(".rollback.journal")]
            rjr = {}
            if rb:
                with open(os.path.join(jdir, rb[0]), encoding="utf-8") as f:
                    rjr = json.load(f)
        finally:
            d.shutdown()
            faults.reset()
    if fired != ["controller@a:1=exec-crash"] or trail != [
            "confirmed", "truncate", "act", "abort", "rollback", "breaker-open"] \
            or not decs[4]["ok"] or view["breaker"]["state"] != "open" \
            or back_text != before_text or rjr.get("status") != "complete" \
            or [n for n in names if n.endswith((".action.json", ".journal"))] != rb:
        fail(f"26 (b): fired {fired}, trail {decs}, breaker {view['breaker']}, assignment "
             f"restored {back_text == before_text}, files {names}")
    act_ms = sum(sp["ms"] for sp in got_b[1][2].spans if sp["name"] == "controller/act@a")
    waves = sum(sp["name"] == "exec/wave" for sp in got_b[1][2].spans)
    rb_ms = (decs[4]["t"] - decs[3]["t"]) * 1e3
    phase("controller", f"(b) a fresh daemon of a, KA_FAULTS_SPEC=controller@a:1=exec-crash, "
          f"{CONTROLLER_WAVE_SIZE}-move waves: construction to warm {boot_s * 1e3:.1f} ms; trail {', '.join(trail)} (rollback ok); the "
          f"assignment byte-identical to the one before the action; breaker open in the "
          f"view; act {act_ms:.1f} ms in all, {waves - rjr['waves_committed']} forward "
          f"wave(s) before the crash, the rollback {rb_ms:.0f} ms (abort to rollback "
          f"decision) in {rjr['waves_committed']} wave(s) | {smi}")
    for i, (dec, wall, run) in enumerate(got_b):
        phase("controller", f"(b) round {i + 1} ({dec['a']['decision']}): wall "
              f"{wall * 1e3:.1f} ms; spans (ms): {split(run, 'a')} | {smi}")

    # (c) shared ticks: two copies of config 3, seeded as a is, on observe,
    # their evaluations packed (a's rows and b's never share a batch key:
    # another cluster; config 3 keeps the phase near 90 s).
    snap_c1, snap_c2 = (os.path.join(root, f"{n}.json") for n in ("c1", "c2"))
    seeded_snapshot(snap_c1, *build_config3(**CONFIG3))
    c_bytes = open(snap_c1, encoding="utf-8").read()
    shutil.copy(snap_c1, snap_c2)
    jdir = journal_dir("c")
    with knobs(**base, KA_DAEMON_JOURNAL_DIR=jdir, KA_DISPATCH_WINDOW_MS=DISPATCH_LONG_WINDOW_MS,
               KA_DISPATCH_MAX_BATCH=2):
        d, ticks, boot_s = start({"c1": f"file://{snap_c1}#controller=observe",
                                  "c2": f"file://{snap_c2}#controller=observe"})
        try:
            def batches_now():
                return sum(metrics.cumulative().snapshot()["counters"].get(
                    "dispatch.batches", {}).values())

            lead.launches["leadership"] = 0
            batches = [batches_now()]
            m = flight.recorder().stats()["recorded"]
            per_round = []
            with solver_probe() as seen, queue_probe() as waits:
                for i in range(2):
                    n_before = len(waits)
                    _, wall, run = one_round(d, ticks, i, "(c)")
                    batches.append(batches_now())
                    per_round.append((wall, waits[n_before:], run))
            evaluated("controller_c_shared_ticks", seen, 4, "(c)")
            ms, shape = k1_ms(seen["orders"])
            calls = [e for e in flight.recorder().snapshot(since=m)
                     if e["kind"] == "dispatch" and e["entry"] == "place_batched"]
            trails = {n: [e["decision"] for e in s.controller_view()["decisions"]]
                      for n, s in d.supervisors.items()}
            names = os.listdir(jdir)
        finally:
            d.shutdown()
    if any(y - x < 1 for x, y in zip(batches, batches[1:])) \
            or [(e["jobs"], e["ok"]) for e in calls] != [(2, True), (2, True)] \
            or trails != {"c1": ["confirmed", "would-act"], "c2": ["confirmed", "would-act"]} \
            or any(open(p, encoding="utf-8").read() != c_bytes for p in (snap_c1, snap_c2)) \
            or any(n.endswith((".journal", ".action.json")) for n in names):
        fail(f"26 (c): dispatch.batches {batches}, place_batched calls {calls}, trails "
             f"{trails}, files {names}")
    phase("controller", f"(c) c1 and c2 (config 3 with {CONTROLLER_SEEDED} replicas of its "
          f"first topic on broker {CONTROLLER_HOT}, copies) on observe, "
          f"KA_DISPATCH_MAX_BATCH=2: construction to warm {boot_s * 1e3:.1f} ms; trails "
          f"{trails['c1']} on both, no write; dispatch.batches {batches} | {smi}")
    for i, (wall, w, run) in enumerate(per_round):
        phase("controller", f"(c) round {i + 1}: wall {wall * 1e3:.1f} ms; one "
              f"place_batched call of {calls[i]['rows']} rows for both jobs, "
              f"{calls[i]['ms']:.1f} ms on the dispatcher's thread; each job's queue wait "
              f"(ms) {[(t, k, round(v, 1)) for t, k, v in w]}; leadership kernel {ms:.3f} ms "
              f"(median of 5 at {shape} on the recorded inputs) on each evaluating "
              f"thread; spans (ms): {split(run, 'c1')} | {smi}")
    phase("timing", f"phase 26 {time.perf_counter() - t_phase:.1f} s | {smi}")
    return k1


#: Phase 27: the fleet scheduler on config 3 (``CONFIG3``). (a)'s ``a`` has
#: ``FLEET_SEED_A`` replicas of its first topic on broker ``CONTROLLER_HOT``,
#: ``b`` ``FLEET_SEED_B``: each action truncates to ``KA_CONTROLLER_MAX_MOVES``'
#: 16 (a truncated plan leaves out the partitions whose replicas only change
#: order, so an action is two 8-move waves), and ``a`` after its action is
#: better off than ``b`` before its own. ``c`` carries a planted
#: ``/execute`` journal of ``FLEET_C_MOVES`` moves, one a wave, each
#: converging after ``FLEET_SIM_POLLS`` polls ``FLEET_POLL_S`` apart
#: (``KA_EXEC_SIM_POLLS``).
FLEET_SEED_A = 24
FLEET_SEED_B = 18
FLEET_C_MOVES = 4
FLEET_SIM_POLLS = 4
FLEET_POLL_S = 0.1
#: (b): ``FLEET_SEED_KILL`` seeded replicas, an action truncated to 16 moves
#: in two 8-move waves with ``KA_EXEC_THROTTLE`` seconds between them, the
#: window the SIGKILL lands in; the child's controller ticks every
#: ``FLEET_CHILD_INTERVAL_S``.
FLEET_SEED_KILL = 24
FLEET_KILL_WAVE = 8
FLEET_KILL_THROTTLE_S = 3.0
FLEET_CHILD_INTERVAL_S = 1.0
#: The daemon in a child process with each leadership launch recorded: its
#: inputs and outputs saved to ``CHIP_SMOKE_LAUNCH_DIR`` and the kernel
#: wrapper's count printed after it, so a child that is killed has told its
#: count already.
FLEET_CHILD = (
    "import json, os, runpy, sys, torch\n"
    "from kafka_assigner_tpu_torch.ops import leadership\n"
    "from kafka_assigner_tpu_torch.solvers import torch_solver as ts\n"
    "order, out = ts.leadership_order, os.environ['CHIP_SMOKE_LAUNCH_DIR']\n"
    "def recorded(*args, **kw):\n"
    "    inputs = [t.clone() for t in args[:4]]\n"
    "    outputs = order(*args, **kw)\n"
    "    torch.save({'inputs': [t.cpu() for t in inputs],\n"
    "                'outputs': [t.cpu() for t in outputs]},\n"
    "               os.path.join(out, f\"launch_{leadership.launches['leadership']}.pt\"))\n"
    "    print('KA_CHILD_LAUNCHES ' + json.dumps(leadership.launches), file=sys.stderr,\n"
    "          flush=True)\n"
    "    return outputs\n"
    "ts.leadership_order = recorded\n"
    "runpy.run_module('kafka_assigner_tpu_torch.daemon', run_name='__main__', "
    "alter_sys=True)\n"
)
FLEET_KNOBS = ("KA_FLEET_MAX_MOVES", "KA_FLEET_WINDOW", "KA_FLEET_MAX_CONCURRENT",
               "KA_FLEET_LEASE_TTL")


def plant_execute_journal(jdir, cluster, spec, topic_map, racks, n_moves, wave_size):
    """An in-progress ``/execute`` journal of ``cluster`` (connect ``spec``)
    as a daemon killed before its first wave leaves it: ``n_moves``
    partitions of the first topic, each with its first replica moved to an
    empty broker of the same rack. Returns ``(path, plan)``."""
    from kafka_assigner_tpu_torch.exec.journal import ExecutionJournal, plan_fingerprint

    topic = min(topic_map)
    spare = sorted(b for b in racks if b >= CONFIG3["n_brokers"])
    plan = {topic: {}}
    for p in range(n_moves):
        reps = list(topic_map[topic][p])
        new = next(b for b in spare if racks[b] == racks[reps[0]])
        spare.remove(new)
        plan[topic][p] = [new] + reps[1:]
    sha = plan_fingerprint(plan, [topic])
    path = os.path.join(jdir, f"ka-execute-{cluster}-{sha[:12]}.journal")
    moves = [(topic, p, reps) for p, reps in plan[topic].items()]
    ExecutionJournal(path, sha, wave_size, moves, cluster=spec).save()
    return path, plan


def journal_status(path):
    with open(path, encoding="utf-8") as f:
        j = json.load(f)
    return j["status"], j["waves_committed"]


def metric_totals(port, families):
    """``/metrics`` parsed with the port's ``promtext``: each family's
    samples summed (None when the family is absent)."""
    import http.client

    from kafka_assigner_tpu_torch.obs import promtext

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        raw = resp.read().decode("utf-8")
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"27: /metrics answered {resp.status}")
    fams = promtext.parse(raw)
    return {f: (sum(v for _, _, v in fams[f]["samples"]) if f in fams else None)
            for f in families}


def waiting_on_ticker(ctl):
    """Whether the controller's thread is parked in the shared ticker's
    wait (it has read the generation a round must pass)."""
    frame = sys._current_frames().get(ctl._thread.ident)
    while frame is not None:
        if frame.f_code.co_name == "wait_next":
            return True
        frame = frame.f_back
    return False


def fleet_phases(work, hold):
    """Phase 27: the fleet scheduler (``daemon/fleet.py``) on the card, on
    config 3 seeded three ways (module doc). (a) and (c) run the daemon in
    this process on cuda, so each evaluation's leadership launch counts
    here and is held against plain through ``hold``; (b) runs it in child
    processes (:data:`FLEET_CHILD`), whose launches are counted and saved
    inside them and held here. Returns the kernel's launches by path."""
    import signal
    import threading

    import torch

    from kafka_assigner_tpu_torch import faults
    from kafka_assigner_tpu_torch.daemon import AssignerDaemon
    from kafka_assigner_tpu_torch.exec.engine import parse_plan_payload
    from kafka_assigner_tpu_torch.models.synthetic import build_config3
    from kafka_assigner_tpu_torch.obs import metrics
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.ops import leadership_cases as cases

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    set_knobs = [k for k in FLEET_KNOBS if os.environ.get(k)]
    if set_knobs:
        fail(f"27 runs the fleet at its defaults; unset {set_knobs}")
    root = os.path.join(work, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    topic_map, live, racks = build_config3(**CONFIG3)

    def config3(name, seed=0):
        path = os.path.join(root, name)
        tm = {t: {p: list(r) for p, r in parts.items()} for t, parts in topic_map.items()}
        if seed:
            seeded_snapshot(path, tm, live, racks, count=seed)
        else:
            write_snapshot(path, tm, live, racks)
        return path

    def journal_dir(part):
        jdir = os.path.join(root, f"journal_{part}")
        os.makedirs(jdir)
        return jdir

    launches = {}
    base = dict(KA_HEALTH_MOVE_COST=0, KA_CONTROLLER_CONFIRMATIONS=1, KA_CONTROLLER_COOLDOWN=0,
                KA_CONTROLLER_INTERVAL=DAEMON_INTERVAL_S,
                KA_DAEMON_RESYNC_INTERVAL=DAEMON_INTERVAL_S, KA_DISPATCH=1)

    # (a) arbitration: a and b on auto, c off with an interrupted /execute.
    snap_a, snap_b, snap_c = config3("a.json", FLEET_SEED_A), config3("b.json", FLEET_SEED_B), \
        config3("c.json")
    score_a, score_b = snapshot_health(snap_a)[0].score, snapshot_health(snap_b)[0].score
    if not score_a > score_b:
        fail(f"27 (a): a ({score_a}) must score worse than b ({score_b})")
    jdir = journal_dir("a")
    faults.reset()
    with knobs(**base, KA_DAEMON_JOURNAL_DIR=jdir, KA_EXEC_POLL_INTERVAL=FLEET_POLL_S,
               KA_EXEC_SIM_POLLS=FLEET_SIM_POLLS):
        d = AssignerDaemon(clusters={"a": f"file://{snap_a}#controller=auto",
                                     "b": f"file://{snap_b}#controller=auto",
                                     "c": f"file://{snap_c}"},
                           solver="device", device="cuda")
        c_journal, c_plan = plant_execute_journal(
            jdir, "c", d.supervisors["c"].spec, topic_map, racks, FLEET_C_MOVES, 1)
        c_expected = canonical_snapshot(snap_c, os.path.join(root, "c_expected.json"), c_plan)
        fs = d.fleet
        ctls = {n: d.supervisors[n].controller for n in ("a", "b")}
        ticks = {n: [] for n in ctls}
        for n, ctl in ctls.items():
            ctl.tick = lambda tick=ctl.tick, out=ticks[n]: out.append(tick()) or out[-1]
        # Every ledger the fleet writes, its leases counted.
        ledgers = []
        persist = fs._persist

        def persist_seen(path, text):
            ledgers.append(json.loads(text)["leases"])
            return persist(path, text)

        fs._persist = persist_seen
        # c's recovery holds its first wave boundary until both controllers
        # have asked for a lease once: the order is the fleet's priority
        # contest, not thread timing.
        gate = {"entered": threading.Event(), "open": threading.Event()}
        heartbeat = fs.heartbeat

        def gated_heartbeat(cluster):
            if cluster == "c" and not gate["entered"].is_set():
                gate["httpd"] = d.httpd
                gate["recovered"] = fs.recovered()
                gate["entered"].set()
                gate["waited"] = gate["open"].wait(DAEMON_WAIT_S)
            return heartbeat(cluster)

        fs.heartbeat = gated_heartbeat
        rounds = []

        def run_round(i):
            t0 = time.perf_counter()
            n0 = len(waits)
            d.ticker.advance()
            deadline = time.monotonic() + DAEMON_WAIT_S
            while not all(len(t) > i for t in ticks.values()):
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.02)
            rounds.append(({n: t[i] for n, t in ticks.items()},
                           time.perf_counter() - t0, waits[n0:]))
            return True

        def round_one():
            if not gate["entered"].wait(DAEMON_WAIT_S):
                return
            deadline = time.monotonic() + DAEMON_WAIT_S
            while not all(waiting_on_ticker(c) for c in ctls.values()):
                if time.monotonic() > deadline:
                    break
                time.sleep(0.01)
            gate["round_one"] = run_round(0)
            gate["open"].set()

        lead.launches["leadership"] = 0
        helper = threading.Thread(target=round_one, name="fleet-round-one", daemon=True)
        try:
            with solver_probe() as seen, queue_probe() as waits:
                helper.start()
                t0 = time.perf_counter()
                d.start()
                boot_s = time.perf_counter() - t0
                helper.join(DAEMON_WAIT_S)
                recovery = fs.view()
                if not gate.get("round_one") or not gate.get("waited") \
                        or gate.get("httpd") is not None or gate.get("recovered"):
                    fail(f"27 (a): c's recovery gate {gate}")
                c_status = journal_status(c_journal)
                with open(snap_c, encoding="utf-8") as f:
                    c_bytes = f.read()
                if recovery["recovery"] != {"resumed": 1, "rolled_back": 0, "failed": 0,
                                            "skipped": 0} or c_status != ("complete",
                                                                          FLEET_C_MOVES) \
                        or c_bytes != c_expected:
                    fail(f"27 (a): c's boot recovery {recovery['recovery']}, journal "
                         f"{c_status}, bytes the plan applied {c_bytes == c_expected}")
                for i in (1, 2):
                    if any(e["decision"] == "acted" for e in ctls["b"].view()["decisions"]):
                        break
                    wait_for(f"27 (a) ready before round {i + 1}", lambda: all(
                        d.supervisors[n].lifecycle() == "ready" for n in ctls))
                    if not run_round(i):
                        fail(f"27 (a): round {i + 1} did not end: {ticks}")
            wait_for("27 (a) the resyncs after the actions", lambda: all(
                d.supervisors[n].lifecycle() == "ready" for n in ctls))
            evaluations = sum(d.supervisors[n].counters().get("controller.evaluations", 0)
                              for n in ctls)
            launches["fleet_a_arbitration"] = lead.launches["leadership"]
            if lead.launches["leadership"] != evaluations \
                    or len(seen["orders"]) != evaluations or not evaluations:
                fail(f"27 (a): the leadership kernel launched {lead.launches['leadership']} "
                     f"times ({len(seen['orders'])} ordering calls) for {evaluations} "
                     "evaluations")
            hold("phase 27 fleet_a_arbitration", seen["orders"])
            times = cases.event_ms(lambda: lead.leadership_order(*seen["orders"][0][0]), 5)
            k1_ms, k1_shape = statistics.median(times), tuple(seen["orders"][0][0][0].shape)
            trails = {n: [e["decision"] for e in c.view()["decisions"]]
                      for n, c in ctls.items()}
            decs = {n: c.view()["decisions"] for n, c in ctls.items()}
            view = fs.view()
            _, fleet_http, _ = http_call(d.http_port, "GET", "/fleet")
            _, state, _ = http_call(d.http_port, "GET", "/state")
            totals = metric_totals(d.http_port, (
                "ka_fleet_grants_total", "ka_fleet_deferrals_total",
                "ka_fleet_preemptions_total", "ka_fleet_recoveries_total",
                "ka_fleet_leases", "ka_fleet_window_moves"))
            cum = metrics.cumulative().snapshot()["counters"]
            after_a, after_b = snapshot_health(snap_a)[0], snapshot_health(snap_b)[0]
        finally:
            d.shutdown()
            fs.heartbeat = heartbeat
    fleet_decs = view["decisions"]
    for n, e in rounds[0][0].items():
        if (e["decision"], e.get("reason"), e.get("fleet_reason")) \
                != ("hold", "fleet deferred", "recovery pending"):
            fail(f"27 (a): {n}'s round 1 during c's recovery: {e}")
    got = {n: [r[0][n]["decision"] for r in rounds] for n in ctls}
    grants = [e for e in fleet_decs if e["decision"] == "granted"]
    action_grants = [e["cluster"] for e in grants if e.get("kind") != "recovery"]
    held, most = 0, 0
    for e in fleet_decs:
        held += {"granted": 1, "released": -1, "lease-expired": -1}.get(e["decision"], 0)
        most = max(most, held)
    if action_grants != ["a", "b"] or got["a"][1] != "acted" or got["b"][-1] != "acted" \
            or "acted" in got["a"][2:] + got["b"][:-1] \
            or [trails[n].count("act") for n in ctls] != [1, 1] \
            or most != 1 or max(len(x) for x in ledgers) != 1 or view["leases"]:
        fail(f"27 (a): action grants {action_grants}, rounds {got}, trails {trails}, leases "
             f"at once {most} (ledgers {max(len(x) for x in ledgers)}), fleet {fleet_decs}")
    moves = {n: next(e["moves"] for e in decs[n] if e["decision"] == "acted") for n in ctls}
    window = FLEET_C_MOVES + moves["a"] + moves["b"]
    want_fleet = {"recovered": True, "leases": {}, "max_concurrent": 1,
                  "window": {"seconds": 3600.0, "max_moves": 64, "moves": window}}
    summary = {k: fleet_http.get(k) for k in want_fleet}
    count = {k: sum(e["decision"] in ks for e in fleet_decs) for k, ks in (
        ("grants", ("granted",)), ("deferrals", ("deferred", "budget-hold", "preempted")),
        ("preemptions", ("preempted",)), ("recoveries", ("recovered",)))}
    want_totals = {"ka_fleet_grants_total": count["grants"],
                   "ka_fleet_deferrals_total": count["deferrals"],
                   "ka_fleet_preemptions_total": count["preemptions"] or None,
                   "ka_fleet_recoveries_total": 1, "ka_fleet_leases": 0,
                   "ka_fleet_window_moves": window}
    if summary != want_fleet or state.get("fleet") != want_fleet \
            or fleet_http["recovery"] != recovery["recovery"] or totals != want_totals \
            or count["recoveries"] != 1 or sum(cum.get("fleet.grants", {}).values()) \
            != count["grants"]:
        fail(f"27 (a): /fleet {summary}, /state's fleet {state.get('fleet')}, expected "
             f"{want_fleet}; /metrics {totals}, expected {want_totals}")
    if not (after_a.score < score_a and after_b.score < score_b):
        fail(f"27 (a): scores a {score_a} -> {after_a.score}, b {score_b} -> {after_b.score}")
    phase("fleet", f"(a) AssignerDaemon(a=config 3 with {FLEET_SEED_A} replicas of its first "
          f"topic on broker {CONTROLLER_HOT}, auto; b={FLEET_SEED_B}, auto; c=unseeded, off, "
          f"with an in-progress /execute journal of {FLEET_C_MOVES} one-move waves at "
          f"KA_EXEC_SIM_POLLS={FLEET_SIM_POLLS}) on cuda: construction to served "
          f"{boot_s * 1e3:.1f} ms, c's journal resumed by the boot scan before the HTTP "
          f"server existed (complete, bytes the plan applied); round 1 during c's recovery: "
          f"a and b hold (fleet deferred, recovery pending); first action lease to a "
          f"(score {score_a} > b's {score_b}), then b; rounds a {got['a']}, b {got['b']}; "
          f"trails a {trails['a']}, b {trails['b']}; never more than one lease in "
          f"{len(ledgers)} ledger writes; "
          f"/fleet and /state's fleet {want_fleet}; /metrics {totals}; scores a "
          f"{score_a} -> {after_a.score}, b {score_b} -> {after_b.score} | {smi}")
    for i, (dec, wall, w) in enumerate(rounds):
        phase("fleet", f"(a) round {i + 1} ({dec['a']['decision']} / "
              f"{dec['a'].get('reason', '')}; {dec['b']['decision']} / "
              f"{dec['b'].get('reason', '')}): wall {wall * 1e3:.1f} ms; each job's queue "
              f"wait (ms) {[(t, k, round(v, 1)) for t, k, v in w]} | {smi}")
    phase("fleet", f"(a) leadership kernel launches {launches['fleet_a_arbitration']} (one an "
          f"evaluation), {k1_ms:.3f} ms median of 5 at {k1_shape} on the recorded inputs; "
          f"fleet decisions {[(e['decision'], e.get('cluster')) for e in fleet_decs]} | {smi}")

    # (b) a real SIGKILL mid-action in a child daemon, then a restart.
    snap_k = config3("k.json", FLEET_SEED_KILL)
    orig_k = os.path.join(root, "k_before.json")
    shutil.copy(snap_k, orig_k)
    jdir = journal_dir("b")
    spec = f"a=file://{snap_k}#controller=auto"

    def child(tag, **env):
        out = os.path.join(root, f"launches_{tag}")
        os.makedirs(out)
        full = dict(os.environ, PYTHONPATH=ROOT, KA_DAEMON_JOURNAL_DIR=jdir,
                    CHIP_SMOKE_LAUNCH_DIR=out, KA_HEALTH_MOVE_COST="0",
                    KA_CONTROLLER_CONFIRMATIONS="1", KA_CONTROLLER_COOLDOWN="0",
                    KA_DAEMON_RESYNC_INTERVAL=str(DAEMON_INTERVAL_S),
                    KA_EXEC_POLL_INTERVAL=str(EXEC_POLL_INTERVAL),
                    KA_EXEC_WAVE_SIZE=str(FLEET_KILL_WAVE), KA_DISPATCH="1",
                    **{k: str(v) for k, v in env.items()})
        proc = subprocess.Popen([sys.executable, "-c", FLEET_CHILD, "--clusters", spec,
                                 "--solver", "device"],
                                cwd=ROOT, env=full, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        lines = []

        def read_stderr():
            for ln in proc.stderr:
                lines.append(ln)

        reader = threading.Thread(target=read_stderr, daemon=True)
        reader.start()
        return proc, lines, reader, out

    def child_launches(lines, out, tag):
        counted = [json.loads(ln.split(" ", 1)[1])["leadership"] for ln in lines
                   if ln.startswith("KA_CHILD_LAUNCHES ")]
        files = sorted(os.listdir(out))
        n = counted[-1] if counted else 0
        if len(files) != n:
            fail(f"27 (b) {tag}: {n} launches counted, {len(files)} recorded")
        orders = []
        for name in files:
            rec = torch.load(os.path.join(out, name))
            orders.append((tuple(t.cuda() for t in rec["inputs"]),
                           tuple(t.cuda() for t in rec["outputs"])))
        return n, orders

    def forward_in_flight():
        for name in sorted(os.listdir(jdir)):
            if name.startswith("ka-controller-a-") and name.endswith(".journal") \
                    and ".rollback." not in name:
                st = journal_status(os.path.join(jdir, name))
                if st[0] == "in-progress" and st[1] >= 1:
                    return os.path.join(jdir, name)
        return None

    t0 = time.perf_counter()
    proc, lines, reader, out1 = child("killed", KA_CONTROLLER_INTERVAL=FLEET_CHILD_INTERVAL_S,
                                      KA_EXEC_THROTTLE=FLEET_KILL_THROTTLE_S)
    try:
        deadline = time.monotonic() + DAEMON_WAIT_S
        jpath = None
        while jpath is None:
            if proc.poll() is not None or time.monotonic() > deadline:
                fail(f"27 (b): no forward journal with a committed wave (exit "
                     f"{proc.poll()}): {''.join(lines)[-1500:]}")
            time.sleep(0.01)
            jpath = forward_in_flight()
        kill_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGKILL)
        rc_kill = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    reader.join(30)
    n_killed, orders = child_launches(lines, out1, "killed")
    killed_status = journal_status(jpath)
    records = [n for n in sorted(os.listdir(jdir)) if n.endswith(".action.json")]
    if rc_kill != -signal.SIGKILL or killed_status != ("in-progress", 1) or len(records) != 1:
        fail(f"27 (b): exit {rc_kill}, journal {killed_status}, records {records}")
    with open(os.path.join(jdir, records[0]), encoding="utf-8") as f:
        record = json.load(f)
    plan_new, _ = parse_plan_payload(record["plan_text"])
    k_expected = canonical_snapshot(orig_k, os.path.join(root, "k_expected.json"), plan_new)
    if n_killed < 1:
        fail("27 (b): the killed child launched the leadership kernel no time")
    launches["fleet_b_killed_child"] = n_killed
    hold("phase 27 fleet_b_killed_child", orders)

    t0 = time.perf_counter()
    proc, lines, reader, out2 = child("restart", KA_CONTROLLER_INTERVAL=DAEMON_INTERVAL_S)
    try:
        wait_for("27 (b) the restarted child's banner", lambda: proc.poll() is not None or any(
            "listening on http://" in ln for ln in lines), every=0.02)
        if proc.poll() is not None:
            fail(f"27 (b): the restarted child exited {proc.returncode}: "
                 f"{''.join(lines)[-1500:]}")
        banner = next(ln for ln in lines if "listening on http://" in ln)
        port = int(banner.split("http://127.0.0.1:")[1].split()[0])
        restart_s = time.perf_counter() - t0
        _, fleet_view, _ = http_call(port, "GET", "/fleet")
        totals_b = metric_totals(port, ("ka_fleet_recoveries_total",
                                        "ka_fleet_recovery_failures_total"))
        resumed_status = journal_status(jpath)
        left = [n for n in sorted(os.listdir(jdir)) if n.endswith(".action.json")]
        with open(snap_k, encoding="utf-8") as f:
            k_bytes = f.read()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(DAEMON_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    reader.join(30)
    n_restart, _ = child_launches(lines, out2, "restart")
    if fleet_view.get("recovery") != {"resumed": 1, "rolled_back": 0, "failed": 0,
                                      "skipped": 0} \
            or totals_b != {"ka_fleet_recoveries_total": 1,
                            "ka_fleet_recovery_failures_total": None} \
            or resumed_status != ("complete", 2) or left or k_bytes != k_expected \
            or rc != 0 or not any("drained; exiting 0" in ln for ln in lines) or n_restart:
        fail(f"27 (b): restart recovery {fleet_view.get('recovery')}, /metrics {totals_b}, "
             f"journal {resumed_status}, records {left}, bytes the plan applied "
             f"{k_bytes == k_expected}, exit {rc}, launches {n_restart}: "
             f"{''.join(lines)[-1500:]}")
    phase("fleet", f"(b) python -c FLEET_CHILD --clusters a=config 3 with {FLEET_SEED_KILL} "
          f"seeded replicas, auto, {FLEET_KILL_WAVE}-move waves, KA_EXEC_THROTTLE="
          f"{FLEET_KILL_THROTTLE_S}: the forward journal's first wave committed "
          f"{kill_s:.2f} s after the spawn, SIGKILL (exit {rc_kill}): journal in-progress "
          f"at 1 of 2 waves, the action record kept; the restart (no fault knob, no "
          f"client resume, controller parked) served after {restart_s:.2f} s with the "
          f"boot scan's {fleet_view['recovery']}: journal complete, snapshot bytes equal to "
          f"the record's plan applied, action record removed, "
          f"ka_fleet_recoveries_total {totals_b['ka_fleet_recoveries_total']:.0f}; "
          f"SIGTERM exit 0; leadership kernel launches {n_killed} in the killed child "
          f"(saved and held against plain here), 0 in the restart | {smi}")

    # (c) the fleet:0=recovery-crash seam keeps a journal for the next boot.
    snap_r = config3("r.json")
    jdir = journal_dir("c")
    boots = []
    with knobs(**base, KA_DAEMON_JOURNAL_DIR=jdir, KA_EXEC_POLL_INTERVAL=EXEC_POLL_INTERVAL):
        for spec_r in ("fleet:0=recovery-crash", None):
            faults.reset()
            env = {"KA_FAULTS_SPEC": spec_r} if spec_r else {}
            with knobs(**env):
                t0 = time.perf_counter()
                d = AssignerDaemon(clusters={"r": f"file://{snap_r}"}, solver="device",
                                   device="cuda")
                if spec_r:
                    r_journal, r_plan = plant_execute_journal(
                        jdir, "r", d.supervisors["r"].spec, topic_map, racks,
                        FLEET_C_MOVES, FLEET_C_MOVES)
                    r_expected = canonical_snapshot(
                        snap_r, os.path.join(root, "r_expected.json"), r_plan)
                try:
                    d.start()
                    boot = time.perf_counter() - t0
                    cum = metrics.cumulative().snapshot()["counters"]
                    boots.append((d.fleet.view()["recovery"], journal_status(r_journal),
                                  {k: sum(cum.get(k, {}).values()) for k in (
                                      "fleet.recoveries", "fleet.recovery_failures")},
                                  boot))
                finally:
                    d.shutdown()
            faults.reset()
    with open(snap_r, encoding="utf-8") as f:
        r_bytes = f.read()
    if [b[:3] for b in boots] != [
            ({"resumed": 0, "rolled_back": 0, "failed": 1, "skipped": 0}, ("in-progress", 0),
             {"fleet.recoveries": 0, "fleet.recovery_failures": 1}),
            ({"resumed": 1, "rolled_back": 0, "failed": 0, "skipped": 0}, ("complete", 1),
             {"fleet.recoveries": 1, "fleet.recovery_failures": 0})] \
            or r_bytes != r_expected:
        fail(f"27 (c): boots {boots}, bytes the plan applied {r_bytes == r_expected}")
    phase("fleet", f"(c) config 3 with a planted /execute journal of {FLEET_C_MOVES} moves: "
          f"a boot under KA_FAULTS_SPEC=fleet:0=recovery-crash kept it in progress "
          f"(fleet.recovery_failures 1) in {boots[0][3] * 1e3:.1f} ms; the next boot, the "
          f"seam cleared, completed it (fleet.recoveries 1, bytes the plan applied) in "
          f"{boots[1][3] * 1e3:.1f} ms; no leadership launch (recovery solves nothing) "
          f"| {smi}")
    phase("timing", f"phase 27 {time.perf_counter() - t_phase:.1f} s | {smi}")
    return launches


#: Phase 28: the mesh on the one card, every position on ``cuda:0``. (a)
#: puts MESH_POSITIONS positions in this process; (b) and (c) run in
#: MESH_PROCS child processes (``gloo``: the ranks share the card), (b) with
#: MESH_PROC_POSITIONS positions a rank, (c) one; (d) MESH_PROCS positions
#: in this process.
MESH_POSITIONS = 4
MESH_PROCS = 2
MESH_PROC_POSITIONS = 2
MESH_SOLVES = 2  # (c) and (d): a first solve, then a warm one
MESH_CHILD_TIMEOUT_S = 300


def mesh_child(argv) -> int:
    """Phase 28's child process, one rank of MESH_PROCS (run as ``python -c
    "import chip_smoke; ..."`` from the repository root; ``argv``: port,
    rank, launch directory). Starts the process group, then (b) config 5's
    sweep over MESH_PROC_POSITIONS positions a rank on both paths and (c)
    the giant expansion and saturated cells through ``TorchSolver("cuda",
    mesh=build_mesh(1, MESH_PROCS))``, MESH_SOLVES solves each, every
    leadership launch saved to the launch directory. Prints one
    ``KA_MESH_CHILD {...}`` line."""
    import hashlib

    import torch.distributed as dist

    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs
    from kafka_assigner_tpu_torch.models.synthetic import build_config5
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.parallel import mesh as mesh_mod
    from kafka_assigner_tpu_torch.parallel import whatif
    from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

    import torch

    port, rank, out_dir = int(argv[0]), int(argv[1]), argv[2]
    t_start = time.perf_counter()
    mesh_mod.initialize_distributed(f"127.0.0.1:{port}", MESH_PROCS, rank)
    rec = {"rank": rank, "backend": dist.get_backend(),
           "init_s": time.perf_counter() - t_start}
    gathers = {"n": 0}
    for name in ("all_gather", "all_gather_object"):
        def counted(*a, _real=getattr(dist, name), **kw):
            gathers["n"] += 1
            return _real(*a, **kw)
        setattr(dist, name, counted)

    # (b) the scenario axis across the ranks.
    topic_map, live, racks = build_config5()
    scenarios = [[b] for b in range(CONFIG5_SCENARIOS)]
    mesh = mesh_mod.build_mesh(devices=mesh_mod.visible_devices("cuda") * MESH_PROC_POSITIONS)
    rec["b_shape"] = mesh.shape
    for path, flag in (("incremental", 1), ("dense", 0)):
        with knobs(KA_WHATIF_INCREMENTAL=flag):
            walls = []
            for _ in range(WHATIF_REPS + 1):
                n0 = gathers["n"]
                t0 = time.perf_counter()
                res = whatif.evaluate_removal_scenarios(topic_map, live, racks, scenarios,
                                                        3, device="cuda", mesh=mesh)
                walls.append((time.perf_counter() - t0) * 1e3)
        rec[f"b_{path}"] = {"results": as_tuples(res), "path": whatif.last_sweep["path"],
                            "first_ms": walls[0], "ms": statistics.median(walls[1:]),
                            "gathers": gathers["n"] - n0}

    # (c) the part axis across the ranks, on the full giant cells.
    cells = giant_cells()
    part = mesh_mod.build_mesh(1, MESH_PROCS)
    rec["c_shape"] = part.shape
    for cell in ("expansion", "saturated"):
        topic_map, live, rack_map, _, _ = cells[cell]
        topics = list(topic_map.items())
        runs = []
        with solver_probe() as seen:
            lead.launches["leadership"] = 0
            for _ in range(MESH_SOLVES):
                solver = TorchSolver("cuda", mesh=part)
                t0 = time.perf_counter()
                pairs = TopicAssigner(solver).generate_assignments(topics, live, rack_map)
                runs.append({"ms": (time.perf_counter() - t0) * 1e3,
                             "timers": dict(solver.last_timers),
                             "collectives": solver.last_collectives})
            launched = lead.launches["leadership"]
        for i, (inputs, outputs) in enumerate(seen["orders"]):
            torch.save({"inputs": [t.cpu() for t in inputs],
                        "outputs": [t.cpu() for t in outputs]},
                       os.path.join(out_dir, f"{cell}_{rank}_{i}.pt"))
        payload = format_reassignment_pairs(pairs)
        moved = sum(len(set(reps) - set(topic_map[t][p]))
                    for t, a in pairs for p, reps in a.items())
        rec[f"c_{cell}"] = {
            "sha": hashlib.sha256(payload.encode()).hexdigest(), "moved": moved,
            "launches": launched, "saved": len(seen["orders"]),
            "chains": [[list(legs), giant, waves] for legs, giant, waves in seen["chains"]],
            "runs": runs,
        }
    rec["wall_s"] = time.perf_counter() - t_start
    print("KA_MESH_CHILD " + json.dumps(rec), flush=True)
    dist.destroy_process_group()
    return 0


def mesh_phases(work, checks, config5, giant_rec, giant_med, cells):
    """Phase 28: the mesh on the one card, every position on ``cuda:0``;
    sharded results must equal the unsharded ones of this run. (a) config
    5's 256 removals on MESH_POSITIONS in-process positions, both paths,
    == phase 10's; (b) the same sweep in MESH_PROCS child processes of
    MESH_PROC_POSITIONS positions each, every rank == (a); (c) phase 7's
    giant expansion and saturated cells at full size through
    ``TorchSolver("cuda", mesh=build_mesh(1, MESH_PROCS))`` in the same
    children: plan bytes == phase 7's, moved 10,000 and 12,000, phase 7's
    chain and waves, each rank's launches at (1, 200000, 3) bit-equal to
    phase 7's held launch; (d) (c)'s expansion on MESH_PROCS in-process
    positions, plan == (c)'s. ``config5`` is phase 10's record,
    ``giant_rec`` phase 7's and ``giant_med`` phase 9's medians. Prints each
    part's wall, collectives a solve, and the sharded time beside the
    unsharded one: the cost of the collectives with every position on one
    card, not a speedup. Returns the leadership launches per path."""
    import hashlib
    import socket

    import torch

    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.io.json_io import format_reassignment_pairs
    from kafka_assigner_tpu_torch.models.synthetic import build_config5
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.parallel import whatif
    from kafka_assigner_tpu_torch.parallel.mesh import build_mesh
    from kafka_assigner_tpu_torch.solvers.torch_solver import TorchSolver

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    hold = launch_holder(checks, [
        (tuple(giant_rec[cell]["order"][0]) + tuple(giant_rec[cell]["order"][1]),
         f"phase 7's giant {cell} cell") for cell in ("expansion", "saturated")])
    launches = {}

    # (a) the scenario axis in process.
    t0 = time.perf_counter()
    topic_map, live, racks = build_config5()
    scenarios = [[b] for b in range(CONFIG5_SCENARIOS)]
    mesh = build_mesh(devices=["cuda:0"] * MESH_POSITIONS)
    lead.launches["leadership"] = 0
    sweeps = {}
    for path, flag in (("incremental", 1), ("dense", 0)):
        with knobs(KA_WHATIF_INCREMENTAL=flag):
            walls = []
            for _ in range(WHATIF_REPS + 1):
                t1 = time.perf_counter()
                res = whatif.evaluate_removal_scenarios(topic_map, live, racks, scenarios, 3,
                                                        device="cuda", mesh=mesh)
                walls.append((time.perf_counter() - t1) * 1e3)
        got = as_tuples(res)
        if whatif.last_sweep["path"] != path or got != config5[path]["results"]:
            fail(f"28 (a) config 5 {path} on {MESH_POSITIONS} positions: path "
                 f"{whatif.last_sweep['path']}, results equal to phase 10's "
                 f"{got == config5[path]['results']}")
        sweeps[path] = got
        phase("mesh", f"(a) config 5 {path}, {CONFIG5_SCENARIOS} scenarios on "
              f"{mesh.shape} positions of cuda:0 in this process: == phase 10's "
              f"unsharded results; warm median {statistics.median(walls[1:]):.1f} ms "
              f"(first {walls[0]:.1f}) beside phase 10's unsharded {config5[path]['total']:.1f} "
              f"ms: the cost of the split with every position on one card, not a speedup; "
              f"0 collectives a sweep (the blocks join in process); chunks "
              f"{whatif.last_sweep['chunks']}, waves {whatif.last_sweep['waves']}")
    if lead.launches["leadership"]:
        fail("28 (a): the what-if sweep launched the leadership kernel")
    phase("mesh", f"(a) wall {time.perf_counter() - t0:.1f} s")

    # (b) and (c) in MESH_PROCS children, one rank each.
    t0 = time.perf_counter()
    out = os.path.join(work, "mesh_launches")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.mesh_child(sys.argv[1:]))",
         str(port), str(rank), out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(MESH_PROCS)]
    recs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=MESH_CHILD_TIMEOUT_S)
            if proc.returncode != 0:
                fail(f"28: a mesh child exited {proc.returncode}: {stderr[-2000:]}")
            line = [ln for ln in stdout.splitlines() if ln.startswith("KA_MESH_CHILD ")]
            if not line:
                fail(f"28: a mesh child printed no record: {stderr[-2000:]}")
            recs.append(json.loads(line[-1].split(" ", 1)[1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(60)
    children_s = time.perf_counter() - t0
    for r in recs:
        for path in ("incremental", "dense"):
            b = r[f"b_{path}"]
            same = b["results"] == json.loads(json.dumps(sweeps[path]))
            if b["path"] != path or not same:
                fail(f"28 (b) rank {r['rank']} config 5 {path}: path {b['path']}, results "
                     f"equal to (a)'s {same}")
            phase("mesh", f"(b) rank {r['rank']} of {MESH_PROCS} ({r['backend']}, init "
                  f"{r['init_s']:.1f} s), config 5 {path} on {r['b_shape']} positions: == (a)'s "
                  f"results; warm median {b['ms']:.1f} ms (first {b['first_ms']:.1f}) beside "
                  f"phase 10's unsharded {config5[path]['total']:.1f} ms, {b['gathers']} "
                  f"cross-rank gathers a sweep: the cost of the collectives with every "
                  f"position on one card, not a speedup")
    orders_by_cell = {}
    for cell in ("expansion", "saturated"):
        ref = giant_rec[cell]
        _, _, _, _, expected = cells[cell]
        total = 0
        for r in recs:
            c = r[f"c_{cell}"]
            chains = [(tuple(legs), giant, waves) for legs, giant, waves in c["chains"]]
            if c["sha"] != ref["sha"] or c["moved"] != expected:
                fail(f"28 (c) rank {r['rank']} giant {cell}: plan bytes equal to phase 7's "
                     f"{c['sha'] == ref['sha']}, moved {c['moved']} (expected {expected})")
            if any(ch[:2] != ref["chain"][:2] or ch[2] != ref["chain"][2] for ch in chains):
                fail(f"28 (c) rank {r['rank']} giant {cell}: chains {chains}, phase 7's "
                     f"{ref['chain']}")
            if c["launches"] != MESH_SOLVES or c["saved"] != MESH_SOLVES:
                fail(f"28 (c) rank {r['rank']} giant {cell}: {c['launches']} launches "
                     f"counted, {c['saved']} saved, not {MESH_SOLVES}")
            total += c["launches"]
            warm = c["runs"][-1]
            phase("mesh", f"(c) rank {r['rank']} giant {cell} on {r['c_shape']} positions: "
                  f"plan bytes == phase 7's, moved {c['moved']}, chain {chains[0][0]}, waves "
                  f"{chains[0][2]} as phase 7's; leadership launches {c['launches']}; "
                  f"{warm['collectives']} part-axis collectives a solve (each an "
                  f"all_gather over gloo); solve {warm['ms']:.1f} ms (first "
                  f"{c['runs'][0]['ms']:.1f}; place {warm['timers'].get('place', 0):.1f}, "
                  f"leadership {warm['timers'].get('leadership', 0):.1f}) beside phase 9's "
                  f"unsharded {giant_med[cell]['c']['total']:.1f} ms: the cost of the "
                  f"collectives with both positions on one card, not a speedup")
            for i in range(c["saved"]):
                saved = torch.load(os.path.join(out, f"{cell}_{r['rank']}_{i}.pt"))
                inputs = tuple(t.cuda() for t in saved["inputs"])
                outputs = tuple(t.cuda() for t in saved["outputs"])
                if tuple(inputs[0].shape) != (1, GIANT_P, RF) or any(
                        not torch.equal(a, b) for a, b in zip(inputs, ref["order"][0])):
                    fail(f"28 (c) rank {r['rank']} giant {cell}: a launch's inputs differ "
                         f"from phase 7's at {tuple(inputs[0].shape)}")
                orders_by_cell.setdefault(cell, []).append((inputs, outputs))
        launches[f"mesh_part_{cell}"] = total
        hold(f"phase 28 (c) giant {cell}, each rank", orders_by_cell[cell])
    phase("mesh", f"(b)+(c) wall {children_s:.1f} s for {MESH_PROCS} child processes "
          f"(slowest rank {max(r['wall_s'] for r in recs):.1f} s inside)")

    # (d) the part axis in process.
    t0 = time.perf_counter()
    topic_map, live, rack_map, _, expected = cells["expansion"]
    topics = list(topic_map.items())
    walls = []
    with solver_probe() as seen:
        lead.launches["leadership"] = 0
        for _ in range(MESH_SOLVES):
            solver = TorchSolver("cuda", mesh=build_mesh(1, MESH_PROCS,
                                                         devices=["cuda:0"] * MESH_PROCS))
            t1 = time.perf_counter()
            pairs = TopicAssigner(solver).generate_assignments(topics, live, rack_map)
            walls.append((time.perf_counter() - t1) * 1e3)
        launched = lead.launches["leadership"]
    sha = hashlib.sha256(format_reassignment_pairs(pairs).encode()).hexdigest()
    if sha != recs[0]["c_expansion"]["sha"]:
        fail("28 (d): the in-process part-axis plan differs from (c)'s")
    if launched != MESH_SOLVES * MESH_PROCS or len(seen["orders"]) != launched:
        fail(f"28 (d): {launched} leadership launches ({len(seen['orders'])} ordering "
             f"calls), not {MESH_SOLVES * MESH_PROCS}")
    waves = check_chains(seen["chains"], "28 (d)", rescue_allowed=False)
    launches["mesh_part_in_process_expansion"] = launched
    hold("phase 28 (d) giant expansion, each position", seen["orders"])
    phase("mesh", f"(d) giant expansion on {MESH_PROCS} positions of cuda:0 in this process: "
          f"plan bytes == (c)'s, waves {waves[0]}, leadership launches {launched} (one a "
          f"position a solve), {solver.last_collectives} collectives a solve; solve "
          f"{walls[-1]:.1f} ms (first {walls[0]:.1f}) beside phase 9's unsharded "
          f"{giant_med['expansion']['c']['total']:.1f} ms: the cost of the collectives with "
          f"both positions on one card, not a speedup; wall {time.perf_counter() - t0:.1f} s")
    phase("timing", f"phase 28 {time.perf_counter() - t_phase:.1f} s | {smi}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import kafka_assigner_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable next to this script ({e})")
    checks = PlainChecks()
    try:
        return smoke(checks)
    finally:
        checks.close()


def smoke(checks) -> int:
    import torch

    from kafka_assigner_tpu_torch.assigner import TopicAssigner
    from kafka_assigner_tpu_torch.carry import to_tensor
    from kafka_assigner_tpu_torch.models import problem
    from kafka_assigner_tpu_torch.models.problem import context_to_array, encode_topic_group
    from kafka_assigner_tpu_torch.ops import build
    from kafka_assigner_tpu_torch.ops import leadership as lead
    from kafka_assigner_tpu_torch.ops import leadership_cases as cases
    from kafka_assigner_tpu_torch.ops.assignment import place_batched
    from kafka_assigner_tpu_torch.solvers.base import Context

    t_start = time.perf_counter()
    set_knobs = [k for k in POLICY_KNOBS if os.environ.get(k)]
    if set_knobs:
        fail(f"phases 1-18 run strict and unprofiled; unset {set_knobs}")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    phase("device", f"{smi} | torch {torch.__version__} CUDA {torch.version.cuda}")

    built = build.build_all()
    phase("build", f"nvcc sm_90a: {built['seconds']:.2f} s for {sorted(built['ptxas'])}")
    for src, log in built["ptxas"].items():
        for kernel, stats in build.kernel_resources(log).items():
            phase("build", f"{src}: {kernel}: {stats.get('registers')} registers, "
                  f"{stats.get('stack')} bytes stack frame, {stats.get('spill_stores')} "
                  f"bytes spill stores, {stats.get('spill_loads')} bytes spill loads")
    native_builds()

    max_err = kernel_cases(cases)
    group_case_err = group_kernel_cases()

    # --- 4: main path at config 4 -------------------------------------
    topic_map, live, rack_map = build_config4()
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    snap = os.path.join(work, "config4.json")
    write_snapshot(snap, topic_map, live, rack_map)
    argv = ["--zk_string", f"file://{snap}", "--mode", "PRINT_REASSIGNMENT"]
    lead.launches["leadership"] = 0
    t0 = time.perf_counter()
    text = run_cli(argv + ["--device", "cuda"])
    wall_s = time.perf_counter() - t0
    launched = lead.launches["leadership"]
    if launched < 1:
        fail("the main path never launched the leadership kernel")
    if problem.last_codec != {"encode": "c", "decode": "c"}:
        fail(f"the main path's encode and decode did not take the C codec "
             f"({problem.last_codec})")
    removed = set(range(REPLACED))
    on_removed = sum(b in removed for old in topic_map.values()
                     for reps in old.values() for b in reps)
    cap = math.ceil(P_PER_TOPIC * RF / len(live))
    moved = check_plan(plan_section(text), topic_map, live, rack_map, cap, on_removed)
    phase("main", f"config 4 mode 3 on cuda: {wall_s:.2f} s wall, moved {moved} "
          f"replicas (== replicas on brokers 0-{REPLACED - 1}), cap {cap}, "
          f"leadership kernel launches {launched}, encode and decode through the C codec")

    # The kernel at the main path's shape, on the main path's inputs,
    # against the plain version on the same inputs (in a worker).
    topics = list(topic_map.items())
    encs, currents, jhashes, p_reals = encode_topic_group(topics, rack_map, live, RF)
    t32 = lambda a: to_tensor(a, "cuda")  # noqa: E731
    placed = place_batched(
        t32(currents), t32(encs[0].rack_idx), t32(jhashes), t32(p_reals),
        encs[0].n, RF, "auto", None, r_cap=encs[0].r_cap,
    )
    b = len(encs)
    k_args = (
        placed.acc_nodes[:b].contiguous(), placed.acc_count[:b].contiguous(),
        t32(context_to_array(Context(), encs[0])), t32(jhashes[:b]),
    )
    k_out = lead.leadership_order(*k_args)
    checks.submit("the main-path shape", k_args, k_out)
    shape = tuple(k_args[0].shape)
    # Phases 14-15's snapshot, so their cpu runs start in the workers now.
    groups = GroupRuns(work, checks)

    # --- 5: cuda == cpu on a prefix -------------------------------------
    prefix = ",".join(t for t, _ in topics[:PREFIX_TOPICS])
    a = run_cli(argv + ["--topics", prefix, "--device", "cuda"])
    c = run_cli(argv + ["--topics", prefix, "--device", "cpu"])
    if a != c:
        fail(f"{PREFIX_TOPICS}-topic prefix: cuda and cpu plans differ")
    phase("cuda==cpu", f"{PREFIX_TOPICS}-topic prefix of config 4: plan text "
          f"byte-identical ({len(a)} bytes)")

    # --- 6: timing, with the codec A/B ---------------------------------------
    assigner = TopicAssigner(device="cuda")

    def solve_config4():
        assigner.context = Context()
        return assigner.generate_assignments(topics, live, rack_map), assigner.solver

    ab = codec_ab("config 4", solve_config4, SOLVE_REPS)
    if ab["routes"] != {"encode": "c", "decode": "c"}:
        fail(f"config 4: the C codec did not run under KA_HOSTCODEC=1 ({ab['routes']})")
    phase("timing", f"solve median of {SOLVE_REPS} (ms): {phase_ms(ab['c'])}; waves "
          f"{assigner.solver.last_waves}")

    times = cases.event_ms(lambda: lead.leadership_order(*k_args), KERNEL_REPS)
    ms = statistics.median(times)
    small = tuple(t[:2].contiguous() for t in (k_args[0], k_args[1])) + (
        k_args[2], k_args[3][:2].contiguous())
    ms_small = statistics.median(
        cases.event_ms(lambda: lead.leadership_order(*small), 5))
    plain_ms = cases.event_ms(lambda: lead.leadership_order_plain(*small), 1)[0]
    b_, p_, rf_ = shape
    n_pad = k_args[2].shape[0]
    nbytes = kernel_bytes(b_, p_, rf_, n_pad)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    steps = cases.chain_steps(b_ * p_, rf_)
    step_ns, step_cycles = cases.chain_step_ns(rf_)
    chain_bound_ms = steps * step_ns * 1e-6
    small_shape = f"B=2 P={p_} RF={rf_} N_pad={n_pad}"
    phase("timing", f"leadership kernel median {ms:.3f} ms of {KERNEL_REPS} launches "
          f"(min {min(times):.3f}, max {max(times):.3f}) at {shape}; byte bound "
          f"{bound_ms:.4f} ms ({nbytes} bytes); chain floor {chain_bound_ms:.3f} ms "
          f"({steps} steps x {step_ns:.3f} ns, {step_cycles:.2f} cycles, per step of "
          f"the chain alone, measured by the probe); "
          f"at {small_shape}: kernel {ms_small:.3f} ms, plain on the card {plain_ms:.1f} ms")
    phase("timing", f"whole smoke so far {time.perf_counter() - t_start:.1f} s")

    # --- 7-9: the giant cells --------------------------------------------
    cells = giant_cells()
    launches, (k_giant, checked), giant_rec = giant_main_paths(cells, work, lead, checks)
    reduced, err = reduced_parity(work, lead)
    max_err = max(max_err, err)
    giant_med = giant_timing(cells)
    g_times = cases.event_ms(lambda: lead.leadership_order(*k_giant), KERNEL_REPS)
    g_ms = statistics.median(g_times)
    if any(not torch.equal(x, y) for x, y in zip(lead.leadership_order(*k_giant), checked)):
        fail("the timed giant-shape launch differs from the one checked against plain")
    g_shape = tuple(k_giant[0].shape)
    g_bytes = kernel_bytes(*g_shape, k_giant[2].shape[0])
    g_bound_ms = g_bytes / HBM_BYTES_PER_S * 1e3
    g_steps = cases.chain_steps(g_shape[0] * g_shape[1], g_shape[2])
    g_chain_ms = g_steps * step_ns * 1e-6
    phase("timing", f"leadership kernel median {g_ms:.3f} ms of {KERNEL_REPS} launches "
          f"(min {min(g_times):.3f}, max {max(g_times):.3f}) at the giant shape "
          f"{g_shape} N_pad={k_giant[2].shape[0]}; byte bound {g_bound_ms:.4f} ms "
          f"({g_bytes} bytes); chain floor {g_chain_ms:.3f} ms ({g_steps} steps x "
          f"{step_ns:.3f} ns); result equal to the launch checked in phase 7")
    phase("timing", f"whole smoke so far {time.perf_counter() - t_start:.1f} s")

    # --- 10-13: what-if sweeps, RANK_DECOMMISSION, host modes -----------
    # Placement only: the leadership kernel is not on these paths.
    lead.launches["leadership"] = 0
    config5 = whatif_config5()
    steady_snap, rank_rec = rank_config4(work)
    groups.add_synthetic(steady_snap)
    rescue_parity()
    host_modes(steady_snap, N_BROKERS, N_TOPICS * P_PER_TOPIC)
    if lead.launches["leadership"]:
        fail(f"the what-if phases launched the leadership kernel "
             f"{lead.launches['leadership']} times")
    phase("whatif", "phases 10-13 launched the leadership kernel 0 times")

    # --- 14-16: consumer-group packing ------------------------------------
    # The group phases do not order leaders either.
    lead.launches["leadership"] = 0
    gk, group_runs = group_phases(groups, steady_snap)
    if lead.launches["leadership"]:
        fail(f"the group phases launched the leadership kernel "
             f"{lead.launches['leadership']} times")
    phase("groups", "phases 14-16 launched the leadership kernel 0 times")
    # The workers' checks end here, so phases 17-18 time a quiet host.
    worst = checks.collect()
    phase("timing", f"whole smoke so far {time.perf_counter() - t_start:.1f} s")

    # --- 17-18: the leadership lanes and the solver lanes -------------------
    lanes = leadership_lanes(argv, (topics, live, rack_map), cells, work)
    greedy_prefix = solver_lanes(argv, text, prefix, a, topic_map, live, rack_map, cap,
                                 on_removed)

    # --- 19: the run report, the device trace and the failure policy --------
    obs_launches = obs_phases(
        work, checks, argv, text, moved, (topics, live, rack_map), ms, ab["c"], prefix,
        a, greedy_prefix, group_runs, steady_snap, rank_rec["candidates_text"])

    # --- 20: live ZooKeeper and the streamed ingest --------------------------
    zk_launches = zk_phases(work, checks, argv, text, prefix, a, topic_map, live,
                            rack_map, cap, on_removed)

    # --- 21: warm start in fresh processes -----------------------------------
    warm_launches = warm_phases(work, snap, text)

    # --- 23: the resident daemon (before 22: its plain check of the churned
    # launch, a minute in a worker, then ends inside phase 22) ---------------
    daemon_launches, multi_groups = daemon_phases(
        work, checks, text, snap, prefix.split(","), a,
        [(tuple(k_args) + tuple(k_out), "phase 4's main-path shape")])

    # --- 28: the mesh on the card (after 27, which ends daemon_phases) ------
    mesh_launches = mesh_phases(work, checks, config5, giant_rec, giant_med, cells)

    # --- 22: plan execution ---------------------------------------------------
    exec_launches = exec_phases(work, checks, argv, text, snap, prefix, a)
    late = checks.collect()

    max_err = max(max_err, worst.get("leadership", 0), late.get("leadership", 0))
    gk["max_abs_err"] = max(group_case_err, worst.get("group_pack", 0),
                            late.get("group_pack", 0))
    gk["launches_by_path"].update(multi_groups)
    gk["launches"] = sum(gk["launches_by_path"].values())
    gk["packed_sweep"] = dict(DISPATCH_KG1)
    phase("timing", f"whole smoke {time.perf_counter() - t_start:.1f} s")

    by_path = {"config4": launched, **{f"giant_{k}": v for k, v in launches.items()},
               **reduced,
               **{f"lane_{k.replace(' ', '_')}_{lane}": v["cli_launches"][lane]
                  for k, v in lanes.items() for lane in ("native", "device")},
               **obs_launches, **zk_launches, **warm_launches, **exec_launches,
               **daemon_launches, **mesh_launches}
    kernels = {"kernels": [{
        "name": "leadership",
        "route": "cuda",
        "source": "kafka_assigner_tpu_torch/csrc/leadership.cu",
        "replaces": LEADERSHIP_TPU_KERNEL,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max_err,
        "tolerance": "exact (integer outputs)",
        "ms": ms,
        "plain_ms": plain_ms,
        "plain_shape": small_shape,
        "ms_at_plain_shape": ms_small,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "chain_steps": steps,
        "chain_bound_ms": chain_bound_ms,
        "giant_shape": list(g_shape),
        "giant_ms": g_ms,
        "giant_bound_ms": g_bound_ms,
        "giant_chain_steps": g_steps,
        "giant_chain_bound_ms": g_chain_ms,
    }, gk]}
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


def kernel_bytes(b: int, p: int, rf: int, n_pad: int) -> int:
    """Bytes the leadership function must move: candidates in and order out
    (B x P x RF int32 each), counts, hashes, and the counter slab in and
    out."""
    return 4 * (2 * b * p * rf + b * p + b + 2 * n_pad * rf)


if __name__ == "__main__":
    sys.exit(main())
