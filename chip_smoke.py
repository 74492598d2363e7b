#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand
kernels from this checkout, holds each against its plain PyTorch
version, times them on the device, drives the cold single-root RIB
solve, the warm path, the RIB of every prefix shape, the batched
multi-root solves (every table kind, all-sources, fleet) and the rebuild
sequence a Decision runs through the route caches at full size, the
port's own Decision fed publications, one node's route pipeline (the
port's `OpenrNode`: Spark, LinkMonitor, KvStore, Decision, Fib,
PrefixManager, Monitor) and the node daemon `python -m openr_tpu_torch`
on UDP and TCP, and checks their answers.

    python3 chip_smoke.py
    python3 chip_smoke.py --old PARENT/openr_tpu_torch/csrc

With `--old`, the relax, election, KSP and edge-list kernels built from
another checkout's sources (the parent commit's, unpacked with `git
archive`) are timed beside this checkout's at the same calls, in turns
(old, new, new, old): [3]'s er100k calls, [8b]'s and
[8d]'s first KSP fixpoint, the hub root's calls, the
probe's B1 sweep, [8c]'s and [9]'s elections, [9]'s three relax calls
and [10c]'s edge init, full round and whole edge solve (the parent's
edge library driven through its own C entry points: a launch a round and
a host read each).

Phases (any failure exits non-zero and prints no result line):

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles csrc/relax.cu, election.cu, ksp.cu, edge_relax.cu,
     split_loop.cu and rib_epilogue.cu with one nvcc each and, at the
     same time, a cubin of each with
     `-Xptxas -v`, whose registers, shared memory, stack frame and spills
     it prints per kernel; checks the C dispatch against `design_for`;
  3. kernels vs plain on the card, exact int32 equality of dist, the
     changed count, row_flag and rows_changed: every vectorised
     specialisation (W, B in {8, 16, 32, 64}) and the generic kernel on
     shapes outside that table (W 1 to 512, B 8 to 512, both of its
     paths: 16-byte strips and the scalar edge for B or W not a multiple
     of 4), on random
     tables (dense row0 chunks, a Jacobi sweep, dst_rows with dead-slot
     repeats, src_rows indirection, overload mask on/off, INF padding,
     flags an earlier launch set); then both designs at the main path's
     own calls on the 100k-node tables, checked the same way and timed
     on the device: CUPTI kernel durations (torch.profiler) and a
     CUDA-graph replay less a copy-only replay, with `out` and the flags
     restored before every launch, the designs in turns (generic, vec,
     vec, generic), the card's clocks sampled before and after;
  4. main path: `erdos_renyi_lsdb(100_000, avg_degree=20, seed=0,
     max_metric=64)` through `TorchSpfSolver(device="cuda")`, solve and
     compute_routes, root and two neighbor columns checked against
     scipy's Dijkstra and the first hops against a NumPy recomputation;
     the relax launches by design and their CUPTI time in one solve;
     then the same path at a shape outside the specialisation table:
     the hub of `hub_and_spoke(2, 100)` (101 neighbors, B = 128), which
     takes the generic kernel;
  5. the link-flap warm path on the same graph, built as a real
     `LinkState` from its directed edges (in a thread started before
     [2]'s build, with the collector off, joined before [4]'s set-up:
     `start_warm_states`): `WARM_ROUNDS` seeded rounds
     of 32 metric
     changes (16 raised by +20, 16 lowered to 1, none root-incident)
     through `update_adjacency_db_delta` and `warm_compute_routes`, each
     round then reverted the same way; every warm RouteDatabase equal to
     a cold `compute_routes` of a fresh solver, one warm solve against
     scipy; warm and cold p50, the warm stats, the relax launches by
     design and the relax kernel's CUPTI time in one profiled warm solve;
  6. overloads + LFA on a small graph, the packed first-hop and LFA bits
     checked against a NumPy recomputation from scipy distances;
  7. the gather probe (`openr_tpu_torch.probe_gather`) at its full
     shapes: both sweeps exact against the plain version and the probe's
     check sum, CUPTI time of each kernel, the torch-ops sweep's time;
  8. the election and KSP kernels (`csrc/election.cu`, `csrc/ksp.cu`):
     (a) each exact against its plain version on random inputs (election
     tables as `tests/test_prefix_scale.py` draws them and one of 100 000
     slots; on random tables with random bans, (V, D) in ((4096, 8),
     (4096, 64), (32768, 64), (512, 512), (1024, 512), (512, 2048): hub
     rows), B in {8, 40, 256}, overloads off/on, both table residencies
     of `ksp_sssp_kernel` and rows wider than its staging (streamed in
     chunks, read from its plan): one sweep, the fixpoint (the card's
     grid passes at most the plain loop's sweeps), both capped at
     KSP_CAP (the card's result between the fixpoint and the plain
     capped one), one
     walk round incl. the ban words; the whole `ksp_edge_disjoint_dense`
     on the card against the CPU for k in {2, 16}, with and without
     dist0: costs, paths and hops equal, rounds and host reads equal,
     passes at most the sweeps), and one KSP sweep at the er100k
     dense-table shape (streamed), timed; (b) BASELINE config 4 on
     `backbone(32, 32)` (+ one chord per site), `bench_ksp_lfa`'s prefix
     mix and one UCMP anycast /24 per site,
     `TorchSpfSolver(enable_lfa=True, ksp_k=16)` from bb1: the
     RouteDatabase equal to the CPU path's, with KSP PUSH, LFA backup and
     unequal-weight UCMP routes, one KSP host read per chunk; p50 of 5
     calls; host reads, launches and sweeps per RIB; at the path's first
     calls both KSP kernels exact and timed, and the fixpoint of one
     launch equal to the host-read loop of one-sweep launches it
     replaced (in no more passes than its sweeps), both timed, and with
     `--old` against the other checkout's kernel in turns; (c) the 100k
     RIB with `ramp_prefix_state(100 000, anycast_every=4)`, whose
     election runs `elect_seg_kernel`, equal to the NumPy election's RIB;
     p50 of 3 calls, the kernel timed beside `torch.segment_reduce`; the
     solver's election on the device against NumPy at 64 to 50 000
     slots, equal, host wall per call; (d) BASELINE config 4
     at the size the JAX package measured (`backbone(626, 16)`: 10 016
     nodes, 1 001 KSP prefixes in chunks of 256 jobs, k=16, LFA on):
     p50 of 3 calls, the KSP stats and kernel times and the same checks
     at the path's first calls as (b), its routes equal to the CPU
     path's on the same states with 16 KSP prefixes kept;
  9. BASELINE config 2 at full width: `fat_tree(90, metric=10)` (10 125
     nodes, 729 000 directed adjacencies, a real `LinkState`) with
     `ramp_prefix_state(names, 40 000, anycast_every=4)` (20 000
     election slots), the loopbacks and one UCMP /24 per pod (ToRs 0 and
     1 at weights 1 and 3), from a core (node-0) and an aggregation
     switch (node-2025), both of 90 neighbors (B = 128): every relax
     launch on the generic kernel, the election on `elect_seg_kernel`;
     per root the columns of the root and two neighbors against scipy,
     the first hops against NumPy, the RouteDatabase equal to the CPU
     path's, the device election equal to NumPy's; solve and
     compute_routes p50, phases, sweeps; the generic kernel at the
     path's dense, overflow and tail calls, the election at 20 000
     slots and the RIB epilogue at the aggregation root's distances (LFA
     off and on), timed with their bounds;
 10. the batched multi-root paths: (a) `csrc/edge_relax.cu`'s init and
     fixpoint kernels exact against their plain versions on random edge
     lists (padding, parallel edges, unreachable and overloaded nodes,
     overloaded and repeated roots, a hub run of ~300 slots just past
     the split threshold and a 4 096-edge one; B in {1, 8, 32, 33, 256,
     300}): the init with its row marks, single full rounds with the
     changed word, the sharded loop's guarded one-round kernel live
     (equal to the twin) and done (out and changed left as they were),
     the fixpoint at the rule's tiles, at tiles of 8 and
     capped at 2 and 3 rounds with its round count and gathered edges,
     and `batched_sssp` with one host read and the reference loop's
     round count; (b) BASELINE config 3 at full
     width: `_solve_dist(csr, arange(256) % V)` on [4]'s er100k on the
     split, dense, use_pallas and edge tables (counts from 0 around each
     kind and around a dense- and an edge-table RIB): the four matrices
     equal on the 100 000 live rows, three columns equal scipy, the
     dense- and edge-table RIBs from node-0 equal to [4]'s, each through
     one launch of `rib_epilogue_kernel` (timed at vp 131 072, LFA off
     and on, with its bound); per kind p50 of 3 calls, sources/s,
     sweeps or rounds, host reads (the edge kind: 1 a solve), CUPTI per
     kernel (30 calls in one profile), busy share and peak device
     memory; (c) at config 3's calls, exact and timed with their bounds:
     the edge init, one full round (the fixpoint kernel capped at one
     round) after 3 rounds, the fixpoint launch (bound: the start read
     and the result written once, the edges read once) also at tiles of
     32, the whole edge solve (init + fixpoint launch, also as a share of
     (b)'s p50), and kernel A's dense sweep; with `--old` the parent's edge
     init, round and whole solve in turns, and its round at B 16 to 256;
     (d) `all_sources_sssp` on a 4 000-node ER equal to scipy's all
     pairs (chunks of 256, one host read each, and of 384 with a padded
     tail), and with 2%
     overloaded nodes its first chunk equal to the split and dense
     paths; (e) `compute_fleet_ribs` on `fat_tree(16, metric=10)`, every
     RIB equal to its node's `compute_routes`, wall and routes/s, and on
     config 2's two roots equal to [9]'s RIBs; (f) `kernel_impl="dense"`
     on `hub_and_spoke(2, 100)` takes the edge list through the waste
     check, its RIB equal to the split path's;
 11. the rebuild sequence a Decision runs, on [5]'s and [9]'s states,
     through the cross-rebuild route caches (counts from 0 around each
     part): (a) er100k from node-0: cold `compute_routes` (the caches
     keeping nothing, then filling them), hot calls on the unchanged view
     equal to the cold RIB with every plain and node-segment entry the
     cold call's object, then 32-metric flaps each answered by a hot
     `compute_routes` (equal to a fresh solver's) and a
     `warm_compute_routes` (equal to both), and their reverts; the
     entries reused, p50s and span times; (b) config 2 from the
     aggregation root, the same checks against [9]'s RIB, 100 ramp /32s
     withdrawn and re-added through `assemble_prefix_routes`, the
     artifact's warm state measured and dropped, `trim_caches(2)` on
     three fingerprints, and [10e]'s config-2 fleet call twice on one
     solver; (c) the Decision hook's converter on both RIBs, cold and
     hot memo; the solvers' spans land in the port's `Counters`;
 12. the telemetry plane (`openr_tpu_torch/monitor/`), on [11a]'s and
     [11b]'s solvers: (a) er100k: one `nvcc` build a source in a fresh
     `_build/` and none after [2]'s warm mark; host reads and bytes per
     cold, filling and hot `compute_routes`; the cost rows of the split
     RIB solve, the warm solve, `_solve_dist` on the split, dense and
     edge tables at B = 8, one sweep (`_relax_once`), a KSP call
     (`ksp_edge_disjoint_dense`, k = 2, 8 jobs) and the first-hop
     matrix, each kernel's row equal to the kernels line's count
     (`relax.launch_work`, `ksp.sssp_work` / `walk_work`,
     `edge_relax.init_work` / `fix_work`) summed over the same call's
     launches by a spy on the wrappers; the efficiency join; the HBM
     gauges equal to `torch.cuda.memory_allocated` /
     `max_memory_allocated` / `total_memory` read right after; [4]'s
     solve and a hot `compute_routes` timed with the telemetry's
     `enabled` flags off and on, in turns, and the cost of one steady
     probe, one transfer count and one HBM sample; (b) config 2: one hot
     `compute_routes`'s rows (the split RIB on the generic kernel, the
     election at 20 000 slots) against the same count, the join, the
     gauges;
 13. the sharded solve (`openr_tpu_torch/parallel/`) at config 3's
     width, on positions that all sit on this one card: `_solve_dist(csr,
     arange(256) % V)` on [4]'s er100k through `TorchSpfSolver(mesh=...)`
     on meshes 1x1, 4x2 and 2x4 (kernel A on each position's rows and the
     overflow rows under the loop's guard, the exit kernel), each equal
     to the unmeshed split solve; then `sharded_sssp_padded` on config
     3's edge arrays (kernel H's init and guarded single rounds on each
     edge slice, each slice's index built on the card), equal to kernel
     H's `batched_sssp`; then both again on a 4x2 mesh of a NCCL group of
     one process (`distributed.initialize` / `global_mesh`), whose
     exchanges are NCCL's all_gather and all_reduce MIN. Before the
     meshes: a 4x2 edge slice's index built on the card equal to NumPy's
     (both timed), `row_exit_kernel` against its twin and timed at the
     split and edge calls' shapes, the guarded round against its twin
     and timed (live and done). Per mesh: the shard rows, the p50 of 3
     calls beside the unmeshed split's, K, sweeps or rounds, blocks and
     host syncs per call (at most ceil(trips / K) + 1), the index builds'
     ms, one more call followed by a block replayed with every row done
     (its host wall and CUPTI kernels: the no-op cost of a sharded sweep
     and round; the results must stay equal after it), peak device
     memory; under `--only 13`, on 4x2 both calls at each K of
     BLOCK_SWEEP (how K was chosen); the launches of
     kernel A, H's init and guarded round and the exit over the meshes'
     runs. This measures the sharding logic and the collectives at full
     width, not multi-card speed;
 14. the split solve's loop on the card and the RIB epilogue
     (`csrc/split_loop.cu`, `csrc/rib_epilogue.cu`): (a) each kernel
     against its twin at er100k's shapes and on random inputs (the
     compaction at 0, 1, cap and cap + 1 marks and more, the edges of
     its 4 096-flag tiles, lengths below a tile, of 1 and not a multiple
     of 4, cap - 1 / cap / cap + 1 flags over every tile, the dead slot,
     clear off and on, the tail's decision on each of its rows, its
     workspace zero after every launch, 1 000 launches on one workspace
     and a CUDA graph of them replayed 100 times; the step's snapshot
     with the tail's mark (`split_snap_mark_kernel`) in every phase,
     cold and warm, on frontiers of 0, 1, 500 and cap rows; the
     decisions in every phase; kernel A under the loop guard with a live
     count; the epilogue on the solve's distances and INF-holed ones, LFA
     off and on, overloads flipped, and at the CPU tests' shapes: B 8 to
     128 with 0, 1 and B - 1 neighbors on a vp whose packed rows are an
     odd and an even number of bytes, INF rows and columns, LFA and
     overloads both ways), every guarded launch of another phase
     writing nothing (the compaction's workspace included), each timed
     (CUPTI) with its bound and its plain twin: the snapshot at a tail
     step of 300 frontier rows and at a dense step, the compaction
     (beside `torch.nonzero` on the same flags), the decision, the
     epilogue at er100k and at hub102's B = 128, LFA off and on (its
     share also against the whole matrix, the count before the sectors
     of columns 0..N); (b) the whole
     program on a 20 000-node ER, eager and then replayed from its CUDA
     graphs, equal to the CPU twins' distances and buffer: cold, one
     step a block, a spilled tail, a long tail with LFA, overloads with
     LFA, and warm from a sparse and a dense cone; (c) at er100k
     through the solver, the graph nodes a block holds (the kernels the
     wrappers recorded into its capture: steps x (gs + 6)) beside
     CUPTI's kernels in one replayed block, a block replayed with the
     loop done (the no-op steps' cost) and the device-idle share of one
     traced solve (`profiling.trace`). [4] and [10b] print each solve's
     host syncs, replays, steps and useful relax launches, and the idle
     share of one traced call.

 15. the port's Decision (`openr_tpu_torch.decision.decision.Decision`)
     on the card, every adjacency and prefix a publication of canonical
     wire bytes through its `ReplicateQueue`: (a) BASELINE config 5 as
     `benchmarks/bench_churn.py:279-281` builds it (`fat_tree(32,
     metric=10)`, 1 280 nodes, root node-0). Step: 40 seeded metric
     flaps a cycle, then one rebuild, 30 cycles after 5 of warm-up, each
     rebuild on a new worker thread (the first captures the split
     program's CUDA graphs, later ones replay them): the recompute p50 /
     p99, the paths, the decode tiers; after every cycle the RIB equal to
     a fresh card solver's and the update to the diff of the fresh RIBs,
     the CPU path's RIB at the first and last cycle; each rebuild's host
     syncs and reads those of its solver calls, which run with the
     Decision's device current. Live: the Decision started, 1 000
     flaps/s in bursts of 10 for 5 s under the default debounce, one flap
     a burst traced: flap -> RouteUpdate p50 / p99 from the perf events
     (markers in stage order), flaps coalesced a rebuild, every
     debounce fire a rebuild done and none raised (a failed solve
     raises, it never serves the old RIB), the final RIB equal to a
     fresh solve. On a second card, where there is one, a
     Decision on cuda:1; (b) BASELINE config 2 at full width ([9]'s
     states) from node-2025: the cold rebuild (its RIB equal to [9]'s and
     to a separate card solver's), 32 aggregation -> ToR metrics lowered
     (a topology-delta rebuild) and put back (whichever path the warm
     gate takes), 100 ramp /32s withdrawn and re-added (two prefix-only
     rebuilds), each update the diff of the separate solver's RIBs; each
     rebuild's wall, split, warm stats, host syncs and reads, decode
     tiers.

 16. the port's KvStore (`openr_tpu_torch.kvstore`) feeding the port's
     Decision on the card: two stores in one process over
     `InProcKvTransport(codec="bin")`, F standing for the fabric (every
     other node's keys) and N, the root's, whose publications feed the
     Decision (`device="cuda"`, its first rebuild gated on N's initial
     sync). Every "fresh solve" below is a new card solver's of the
     generator's own LSDB (its AdjacencyDatabases, each flap applied as
     it is set on F), never of the Decision's; after the sync and after
     each flap's flood, F and N both hold the generator's Value of each
     key (version, originator, hash and bytes), and the Decision's
     adjacencies of each flapped node are the generator's. (a) BASELINE
     config 5 as [15a] builds it: N's full sync from F, the cold rebuild
     (its kernel launches counted from 0 around it: vec relax, the split
     loop's kernels, the epilogue) equal to a fresh solve; step: 40
     seeded flaps a cycle set on F with `set_key`, flooded in the binary
     codec into N, one rebuild, 30 cycles after 5, every RIB a fresh
     solve's and every update the diff of fresh RIBs; live: the Decision started, 1 000 flaps/s in bursts
     of 10 on F for 5 s, one a burst traced from F's `set_key` to
     ROUTE_UPDATE_SENT (p50 / p99 beside [15a]'s), F's flood counters
     (`floods_sent`, `floods_held`, `flood_keys_coalesced`,
     `floods_rate_limited`) under the default limit; then 10 single
     flaps without a RibPolicy, the policy installed (neighbour weights
     on the cores' loopbacks, one next hop at weight 0, one route at
     weight 0), 10 flaps under it (all full rebuilds), a 2 s policy left
     to expire: every RIB a fresh solve's with the policy applied while
     one is installed, every update their diff, every debounce fire a
     finished rebuild and none raised. BASELINE config 2's start-up
     through KvStore (the full sync of every other node's keys, the cold
     rebuild) runs once, in [17b]'s node.
 17. node N's route pipeline: N is the port's `OpenrNode`
     (`openr_tpu_torch/node.py`, `device=None`: the card) with its
     neighbours' Sparks as speakers on one `MockIoHub` (linked over the
     generator's interfaces, hold time `NODE_SPARK`'s), its KvStore,
     Decision (its first rebuild gated on the store's initial sync), Fib
     on a `MockFibHandler` (each call timed, `fib_handler=`), LinkMonitor
     (N's interfaces up after each link's metric is set to the
     generator's by LinkMonitor's override, as an operator would; Spark
     finds the neighbours, each a traced NEIGHBOR_UP; SR on: its
     adjacency labels replace the generator's, so the MPLS routes differ
     from [15]'s and [16]'s), PrefixManager (the loopback and the
     aggregate `NODE_AGGREGATE` from the config, gated on
     `NODE_AGG_SUPPORT` programmed routes; N's other prefixes as one API
     event) and Monitor, on the node's own queues (the publications and
     route updates coalesce at the bound, telemetry sheds its oldest).
     Store F holds every other node's keys and is every neighbour's
     store (`fabric_for`): F pushes its keys to N, then the neighbours
     come up and LinkMonitor's PeerEvents peer N's store with them. Every
     table check holds the handler's whole table (unicast and MPLS) to
     the converted RIB of a fresh card solve of the generator's LSDB with
     N's databases replaced by LinkMonitor's and PrefixManager's
     (`NodeLsdb`), never of the Decision's state. (a) BASELINE config 5
     at node-0: start-up (the walls of every neighbour found,
     KVSTORE_SYNCED, RIB_COMPUTED and FIB_SYNCED from the interfaces
     coming up, the FULL_SYNC's routes and walls, the start-up's
     launches: vec relax, the split loop's kernels, the epilogue; a
     start-up trace NEIGHBOR_EVENT ... FIB_PROGRAMMED; the aggregate
     absent before Fib's sync, in F after); step: 40 seeded flaps a
     cycle set on F, 30 cycles after 5, the table checked after each,
     flap -> FIB_PROGRAMMED; live: 1 000 flaps/s in bursts of 10 for
     5 s, flap -> FIB_PROGRAMMED p50 / p99 from Monitor's ring beside
     flap -> ROUTE_UPDATE_SENT on the same traces, the event loop's lag;
     own links: `NODE_OWN_LINKS` of node-0's links changed through
     `LinkMonitor.set_link_metric` and reverted, ADJ_DB_UPDATED ->
     FIB_PROGRAMMED and each rebuild's path; [16a]'s RibPolicy installed
     (the table the policy's RIB) and removed; failures: `NODE_FAILS`
     handler calls failed under a cycle of flaps, a full resync after
     them, the trace completed once, converged. (c) the daemon: `python
     -m openr_tpu_torch --config n.json --ready-file ...` as node-0 of
     config 5 (N's config, its 32 links `udp_interfaces` on port 0),
     its neighbours 32 Sparks on `UdpIoProvider` in this process aimed
     at the ports the ready file reports and advertising F's listener
     (F behind an `RpcServer` with `register_rpc`): the daemon's pid
     holds a context on the card (`nvidia-smi --query-compute-apps`, in
     each of 3 samples);
     its `adj:node-0` reaches F over TCP with 32 adjacencies equal to
     (a)'s (neighbours, interfaces, labels); its aggregate reaches F (so
     its Decision solved on the card and its Fib programmed the
     supporting routes). Then over its ctrl API (the ready line's
     `ctrl_port`, `RpcClient`): INITIALIZED; `set_interface_metric` sets
     its 32 interfaces to (a)'s metric 10, and its table is read until it
     equals a fresh `TorchSpfSolver` solve, on the card in this process,
     of the LSDB it reports over ctrl (`get_decision_adjacency_dbs` and
     its store's prefix keys; the wall from the metric change to that);
     its adjacencies then equal (a)'s, metric included;
     `check_fib_oracle` passes with the oracle's route count equal to the
     programmed one; `get_device_telemetry` lists kernel rows of its own
     launches; `validate` passes; each call's wall. One flap set on F
     reaches N over F's session to N's listener; SIGTERM ends it with
     exit 0; the walls from the launch to OPENR_READY, to `adj:node-0`
     in F and to the aggregate in F. (b)
     BASELINE config 2 ([9]'s states) at node-2025: start-up as (a), the
     cold rebuild, the FULL_SYNC's routes and walls, launches (generic
     relax, the election, the epilogue), F's and N's stores holding the
     generator's Value of every key F was loaded with, the table equal to
     a separate card solve's and its unicast part to [9]'s RIB; once a periodic
     full resync of Fib's has run, `NODE_RAMP` ramp /32s withdrawn on F
     (tombstones) and re-added: each one prefix-only rebuild and one
     handler call of that many deletes or adds, flap -> FIB_PROGRAMMED.
     Every solver call of a rebuild ran with the card current; every
     solve read its result back, save a warm call that refused (a full
     solve follows) or found no edge metric changed (it reuses the
     cached solve); no rebuild raised. Each window waits for N to settle
     with O(1) checks first, and runs the O(table) ones (Fib's
     `pending_changes`, the stores' hashes) only once those hold
     (`node_quiet`).
[18] BASELINE config 1 (`config1-emulator`): `emulator.Cluster.from_edges`
     over `topogen.edges_of(fat_tree(6))`, 45 port `OpenrNode`s (9
     cores, 18 aggregation, 18 ToR; 108 links, a /32 loopback each; see
     `CONFIG1_K` for why not fat_tree(10)'s 125 or fat_tree(8)'s 80) in
     this process, every Decision on the card, Spark on the in-process
     hub, KvStore over `InProcKvTransport(codec="bin")`, the Spark timers
     and the debounce scaled as the emulator scales them. Cold start to
     `wait_converged` (the emulator CLI's timeout, max(60, 36 x
     hold)),
     then `wait_quiescent` and `check_cluster` with no violation (every
     store equal, every FIB equal to the port's host oracle over that
     node's LinkState, nothing stuck, counters sane, queues in bounds);
     a core's, an aggregation's and a ToR's table equal to a fresh card
     solve of its LinkState; every Decision on the card backend, every
     solver call with the card current and every solve read back from
     it. Then `ChaosPlan(seed=22).build_storm(links, nodes, duration_s=3,
     n_flaps=8, n_crashes=2, n_partitions=1, graceful_crashes=None)`,
     `run_schedule`, `wait_quiescent` and `check_cluster` again, each
     restarted node on a new solver on the card; its `schedule_hash`.
     Launches counted from 0 around the phase (vec or generic relax, the
     split loop's kernels, the epilogue). Readings: the cold convergence
     wall, the spread of RIB_COMPUTED and FIB_SYNCED across nodes,
     rebuilds per node (p50, max), the full SPF p50 / p99 (a solver's
     `compute_routes` that solved, less its wait for the card's lock)
     and routes/s, that wait apart, every rebuild's wall, the storm's
     wall to quiescence, peak device memory and `nvidia-smi`'s used
     MiB, with the card's name and power limit.

`--only 14` runs the build and [14] alone, `--only 13` the build, [10a]
and [13] with its K sweep, `--only 3` the build and [3], `--only 8` the
build and [8a], [8b] and [8d], `--only 15` the build and [15] (config 2's
states built there, [9]'s RIB not compared), `--only 16` the build and
[16], `--only 17` the build and [17] (config 2's states built there),
`--only 18` the build and [18], each with no
result line. Before the result lines,
[time] gives the host seconds each phase took.

The line before the card's name is a JSON object `{"kernels": [...]}`,
each row's `timed_by` saying whether its `ms` is a CUPTI duration
("cupti") or, where CUPTI kept no launch, a CUDA-graph replay time
("graph"); the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import asyncio
import ctypes
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from openr_tpu_torch.solve_turns import er_linkstate, flap_round, revert_round

INF = 1 << 30
WIDTHS = (8, 16, 32, 64)
GENERIC_SHAPES = [(w, b) for w in (1, 4, 128) for b in (8, 32, 128)] + [
    (8, 128), (32, 128)
] + [  # a fabric's wide shapes, and the scalar edge path's odd ones
    (64, 256), (256, 256), (512, 128), (128, 512), (512, 512), (24, 48),
    (6, 12), (8, 10),
]
TIMING_REPS = 30
#: (V, D) of [8a]'s random KSP tables: resident, resident, streamed, then
#: hub rows (D 512 and 2048: resident at small B, streamed in chunks of
#: the staging at B 256, and at (512, 512) a tile too wide for one warp a
#: row)
KSP_CASES = ((4096, 8), (4096, 64), (32768, 64), (512, 512), (1024, 512),
             (512, 2048))
#: the job counts B each (V, D) runs at: every case, every B of 8 (one
#: partial ban word), 40 (several, the last partial) and 256 (whole
#: words), both overload settings and every plan mode stay covered, in
#: 10 of the 18 cases the full cross runs
KSP_CASE_B = {(4096, 8): (8, 40), (4096, 64): (256,), (32768, 64): (8,),
              (512, 512): (40, 256), (1024, 512): (8, 256),
              (512, 2048): (8, 256)}
DEVICE = "cuda"  # every tensor and solver of the run lives here


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: host seconds by phase tag: the wall from the line before to each line
#: is the tag's of that line ([time] prints them)
PHASE_S: dict[str, float] = {}
T_START = time.perf_counter()  # after the imports
#: the run's wall budget from `T_START`: past it every thread's stack is
#: printed to stderr and the run exits with 1 (a phase stuck on the card
#: or on a wait would otherwise run into the 1 200 s limit unexplained)
RUN_BUDGET_S = 1140
_LAST_LOG = [T_START]


def log(msg: str) -> None:
    now = time.perf_counter()
    m = re.match(r"\[(\w+)\]", msg)
    if m:
        PHASE_S[m.group(1)] = (PHASE_S.get(m.group(1), 0.0)
                               + now - _LAST_LOG[0])
    _LAST_LOG[0] = now
    print(msg, flush=True)


def smi(query: str) -> str:
    """One line of `nvidia-smi --query-gpu=<query>` for card 0 ("" if it
    fails)."""
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else ""


class GcClock:
    """Host ms spent in the garbage collector while entered, and the full
    (generation 2) collections among them."""

    def __init__(self):
        self.ms = 0.0
        self.full = 0
        self._t0 = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.full += info["generation"] == 2

    def __enter__(self):
        self.ms, self.full = 0.0, 0
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        return False


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean ms of `fn()` between two CUDA events, after a warm-up (for
    the plain version, a sequence of many torch ops)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------------- device timing


def kernel_device_us(prof, names) -> tuple[float, int]:
    """(total CUPTI µs, launches) of the kernels whose name holds one of
    `names`, from a finished torch.profiler run. A span's annotation on
    the device timeline (its first to its last kernel, gaps included) is
    not a kernel and is skipped."""
    us, count = 0.0, 0
    for ev in prof.key_averages():
        if (str(getattr(ev, "device_type", "")).endswith("CPU")
                or getattr(ev, "is_user_annotation", False)):
            continue
        if not any(n in ev.key for n in names):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        us += t
        count += ev.count
    return us, count


def cupti_us(launch, restore, name: str, reps: int = TIMING_REPS,
             attempts: int = 3) -> float | None:
    """Mean CUPTI duration (µs) of kernel `name` over `reps` launches,
    each after `restore()` (whose copy kernels are not counted). CUPTI
    may drop launches (more of them late in a long run): the mean is
    over those it kept; a profile that kept none is taken again, up to
    `attempts` profiles; None if none kept any."""
    from torch.profiler import ProfilerActivity, profile

    restore()
    launch()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                restore()
                launch()
            torch.cuda.synchronize()
        us, count = kernel_device_us(prof, (name,))
        if count != reps:
            log(f"      CUPTI kept {count} of {reps} launches of {name}")
        if count:
            return us / count
    return None


def kernel_us(launch, restore, name: str) -> tuple[float, str]:
    """(µs, "cupti") from `cupti_us`; where CUPTI kept no launch in any
    profile, (µs, "graph") from the CUDA-graph replay time (`graph_us`,
    with a 4-byte memset beside `restore` so that neither graph is
    empty). The kernels line carries the source as `timed_by`."""
    us = cupti_us(launch, restore, name)
    if us is not None:
        return us, "cupti"
    pad = torch.zeros(1, dtype=torch.int32, device=DEVICE)

    def restore_pad():
        restore()
        pad.zero_()

    us = graph_us(launch, restore_pad, TIMING_REPS)
    log(f"      {name}: CUPTI kept no launch; CUDA-graph replay "
        f"{us:.3f} us per launch")
    return us, "graph"


def timed_by(sources) -> str:
    """One `timed_by` for a mean over timings from `sources`."""
    return "+".join(sorted(set(sources)))


def graph_us(launch, restore, reps: int) -> float:
    """µs per launch from CUDA-graph replays: `reps` x (restore, launch)
    less `reps` x restore, each the median of three replays."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):  # warm-up off the default stream
        restore()
        launch()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g_copy, g_full = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_copy):
        for _ in range(reps):
            restore()
    with torch.cuda.graph(g_full):
        for _ in range(reps):
            restore()
            launch()

    def replay_ms(g):
        g.replay()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    return (replay_ms(g_full) - replay_ms(g_copy)) / reps * 1e3


# ------------------------------------------------------------ phase 2


#: the hand-kernel sources, each built by one nvcc (all started together)
SOURCES = ("relax", "election", "ksp", "edge_relax", "split_loop",
           "rib_epilogue")
#: kernels `-Xptxas -v` must report per source: relax's generic kernel
#: (strips 0, 1, 2, 4, overload off/on) and a vec kernel per (W, B,
#: overload) specialisation, each with and without the split loop's
#: guard; ksp's SSSP kernel, its wide-row twin and the walk; edge_relax's
#: init and fixpoint kernels, the latter with and without the sharded
#: loop's guard; split_loop's four (the snapshot with the tail's mark,
#: the compaction, the decision, the sharded loops' exit); rib_epilogue's
#: one-chunk and chunked kernels, each with and without LFA
PTXAS_KERNELS = {"relax": 2 * (8 + 2 * len(WIDTHS) ** 2), "election": 1,
                 "ksp": 3, "edge_relax": 3, "split_loop": 4,
                 "rib_epilogue": 4}


def start_ptxas_report(cuda_build, name: str):
    """Start `nvcc -cubin -Xptxas -v` on csrc/<name>.cu; returns
    (process, dir)."""
    tmp = tempfile.mkdtemp(prefix=f"{name}_ptxas_")
    cmd = [
        cuda_build.find_nvcc(), "-gencode=arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
        "-o", str(Path(tmp) / f"{name}.cubin"),
        str(cuda_build.CSRC_DIR / f"{name}.cu"),
    ]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def parse_ptxas(text: str) -> list[tuple[str, int, int, int, int, int]]:
    """(kernel, registers, smem bytes, stack frame bytes, spill stores,
    spill loads) per kernel in `-Xptxas -v` output."""
    rows, cur, spill = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(relax_(?:vec|generic)_kernel)"
                          r"(?:ILi(\d+)E(?:Li(\d+)E)?Lb(\d)ELb(\d)E)?",
                          m.group(1))
            named = re.search(r"(elect_seg_kernel|ksp_sssp_kernel|"
                              r"ksp_walk_kernel|split_snap_mark_kernel|"
                              r"flag_compact_kernel|split_ctl_kernel|"
                              r"row_exit_kernel|"
                              r"rib_epilogue_kernel)(ILb(\d)ELb(\d)E|ILb1E)?",
                              m.group(1))
            edge = re.search(r"edge_(?:init|relax)_kernel(ILb1E)?",
                             m.group(1))
            cur = (k.group(1) if k else named.group(1) if named
                   else edge.group(0).replace("ILb1E", "<guarded>") if edge
                   else m.group(1))
            if named is not None and named.group(3):  # the epilogue's
                chunks = "chunked" if named.group(3) == "1" else "one chunk"
                lfa = ", LFA" if named.group(4) == "1" else ""
                cur += f"<{chunks}{lfa}>"
            elif named is not None and named.group(2):
                cur += "<wide rows>"
            if k is not None and k.group(2):
                over = "over" if k.group(4) == "1" else "no over"
                guard = ",guarded" if k.group(5) == "1" else ""
                shape = (f"{k.group(2)},{k.group(3)}" if k.group(3)
                         else f"strips {k.group(2)}")
                cur += f"<{shape},{over}{guard}>"
            spill = (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            spill = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and cur:
            rows.append((cur, int(m.group(1)), int(m.group(2) or 0), *spill))
            cur = None
    return rows


#: the sources `--old` builds from another checkout, by wrapper module
OLD_SOURCES = ("relax", "election", "edge_relax", "ksp")


def start_old_build(cuda_build, src: Path):
    """Start nvcc on another checkout's `src` into a shared library, with
    the flags of this checkout's builds; returns (process, library, dir)."""
    tmp = tempfile.mkdtemp(prefix=f"old_{src.stem}_")
    out = Path(tmp) / f"libold_{src.stem}.so"
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out, tmp


def load_old(module, path: Path):
    """The other checkout's library, its entry points bound with this
    checkout's ctypes types (those it has); edge_relax's with the round
    design's own (`ROUND_EDGE_ENTRY_POINTS`: this checkout's C entry
    points differ)."""
    lib = ctypes.CDLL(str(path))
    entry_points = (ROUND_EDGE_ENTRY_POINTS
                    if path.stem.endswith("edge_relax")
                    else module.ENTRY_POINTS)
    for name, (argtypes, restype) in entry_points.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


class using_lib:
    """Within the block, `module`'s wrappers launch the kernels of `lib`
    (an `--old` build); None leaves this checkout's."""

    def __init__(self, module, lib):
        self.module, self.lib, self.keep = module, lib, None

    def __enter__(self):
        if self.lib is not None:
            self.keep, self.module._LIB = self.module._LIB, self.lib

    def __exit__(self, *exc):
        if self.lib is not None:
            self.module._LIB = self.keep


def build_all(cuda_build, modules, old_dir: Path | None = None) -> dict:
    """Builds every kernel library and its `-Xptxas -v` cubin, one nvcc
    per source and report (and per `--old` source), all started
    together; prints the report. Returns the `--old` libraries by
    source name (none without `old_dir`)."""
    from concurrent.futures import ThreadPoolExecutor

    from openr_tpu_torch.monitor import compile_ledger

    t0 = time.perf_counter()
    reports = {name: start_ptxas_report(cuda_build, name) for name in SOURCES}
    olds = {name: start_old_build(cuda_build, old_dir / f"{name}.cu")
            for name in (OLD_SOURCES if old_dir else ())}
    old_libs = {}
    try:
        with ThreadPoolExecutor(len(modules)) as pool:
            for fut in [pool.submit(m.build) for m in modules]:
                fut.result()
        outs = {name: proc.communicate(timeout=600)[0]
                for name, (proc, _tmp) in reports.items()}
        by_name = {m.__name__.rsplit(".", 1)[-1]: m for m in modules}
        for name, (proc, lib, _tmp) in olds.items():
            text = proc.communicate(timeout=600)[0]
            if proc.returncode != 0:
                fail(f"nvcc failed for the --old {name}.cu:\n{text}")
            old_libs[name] = load_old(by_name[name], lib)
        if not hasattr(old_libs.get("edge_relax"), "openr_edge_relax"):
            # the other checkout's edge kernels are this one's design: the
            # turns of [10c] drive the round design's entry points only
            old_libs.pop("edge_relax", None)
    finally:
        for proc, tmp in list(reports.values()) + [
                (p, t) for p, _l, t in olds.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(tmp, ignore_errors=True)
    build_s = compile_ledger.ledger().build_seconds()
    log(f"[2] build: {', '.join(s + '.cu' for s in SOURCES)} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc "
        + ", ".join(f"{s} {build_s.get(s, 0.0):.3f} s"
                    for s in SOURCES)
        + "; the -Xptxas -v cubins alongside)")
    for name, (proc, _tmp) in reports.items():
        if proc.returncode != 0:
            fail(f"nvcc -Xptxas -v failed for {name}.cu:\n{outs[name]}")
        ptx = parse_ptxas(outs[name])
        if len(ptx) != PTXAS_KERNELS[name]:
            fail(f"ptxas reported {len(ptx)} kernels for {name}.cu:\n"
                 f"{outs[name]}")
        for kname, regs, smem, frame, st, ld in ptx:
            log(f"[2] ptxas {kname}: {regs} registers, {smem} B smem, stack "
                f"frame {frame} B, spill stores {st} B, spill loads {ld} B")
    if old_libs:
        log(f"[2] --old {', '.join(n + '.cu' for n in old_libs)} built from "
            f"{old_dir}")
    return old_libs


# ------------------------------------------------------------ phase 3


def random_case(g, vp, b, r, w, with_over, dev):
    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    dist = ri(0, 5000, (vp, b))
    dist[torch.rand(vp, b, generator=g) < 0.3] = INF
    nbr = ri(0, vp, (r, w))
    wgt = ri(1, 65, (r, w))
    wgt[torch.rand(r, w, generator=g) < 0.3] = INF  # INF padding slots
    over = (torch.rand(r, w, generator=g) < 0.2) if with_over else None
    roots = ri(0, vp, (b,))
    if with_over:  # the per-root exemption: a root among the neighbors
        nbr[0, 0] = roots[0]
        over[0, 0] = True
    out = [dist, nbr, wgt, roots, over]
    return [None if x is None else x.to(dev) for x in out]


def compare(fn, relax, dist, out0, nbr, wgt, roots, over, flag0, **kw):
    """`fn` (a kernel wrapper) and the plain version on the same inputs,
    each into its own copy of `out0` and of the flags `flag0`; returns
    the max |diff| (0 required) over dist, the changed count, row_flag
    and rows_changed, and the rows the plain version newly flagged."""
    res = []
    for f in (fn, relax.relax_rows_ref):
        out = out0.clone()
        ch = torch.zeros(1, dtype=torch.int32, device=dist.device)
        rf = flag0.clone()
        rc = torch.zeros(1, dtype=torch.int32, device=dist.device)
        f(dist, out, nbr, wgt, roots, over, changed=ch, row_flag=rf,
          rows_changed=rc, **kw)
        res.append((out, ch, rf, rc))
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max().item())
              for a, b in zip(*res))
    return err, int(res[1][3].item())


def phase3_random(relax, dev) -> tuple[dict, dict]:
    """Every specialisation and the generic shapes on random tables;
    returns (worst |diff| by design, cases by design)."""
    g = torch.Generator().manual_seed(20261016)
    worst = {"vec": 0, "generic": 0}
    cases = {"vec": 0, "generic": 0}
    vp = r = 4096
    q = r // 4
    for w, b in [(w, b) for w in WIDTHS for b in WIDTHS] + GENERIC_SHAPES:
        design = relax.design_for(w, b)
        for with_over in (False, True):
            dist, nbr, wgt, roots, over = random_case(
                g, vp, b, r, w, with_over, dev
            )
            flag0 = (torch.rand(vp, generator=g) < 0.05).to(
                torch.int32).to(dev)
            ro = 256
            dst = torch.randint(0, vp, (ro,), generator=g, dtype=torch.int32)
            dst[ro // 2 :] = vp - 1  # dead-slot padding
            dst[:4] = dst[4]  # a live target repeated
            rows = torch.randint(0, vp, (q - 1,), generator=g,
                                 dtype=torch.int32)
            rows[700:] = vp - 1
            dst, rows = dst.to(dev), rows.to(dev)
            tab = (nbr, wgt, over)
            ov_tab = tuple(None if x is None else x[:ro].contiguous()
                           for x in tab)
            calls = (
                # dense row0 chunks (the first of odd length), as in place
                [(tab, dict(row0=0, n=q - 1))]
                + [(tab, dict(row0=c * q, n=q)) for c in range(1, 4)]
                + [(tab, dict(row0=0)),  # a Jacobi sweep over all rows
                   (ov_tab, dict(dst_rows=dst)),  # overflow table form
                   (tab, dict(src_rows=rows, dst_rows=rows))]  # tail form
            )
            for (tn, tw, to), kw in calls:
                err, newly = compare(relax.relax_rows, relax, dist, dist,
                                     tn, tw, roots, to, flag0, **kw)
                if newly == 0:
                    fail(f"random case W={w} B={b} {kw.keys()} lowered "
                         "no row: the flags went untested")
                worst[design] = max(worst[design], err)
                cases[design] += 1
    return worst, cases


def path_calls(solver, ls, tables, me: str = "node-0"):
    """The main path's three relax calls from root `me` on `tables`: a
    dense Gauss-Seidel chunk (the last), the overflow table, and 8 192
    compacted tail rows (random, dead-padded), on the final distances
    with every reachable entry raised by up to 200, so each call lowers
    most of its rows, as the early sweeps of the main path do. Returns
    (dist_in, roots, {kind: (nbr, wgt, kwargs)})."""
    from openr_tpu_torch.ops.spf_split import pick_gs_chunks

    vp = tables["vp"]
    first = solver.solve(ls, me)
    dist_final = first[1].device_tensor
    b = dist_final.shape[1]
    g = torch.Generator(device=DEVICE).manual_seed(7)
    bump = torch.randint(0, 200, dist_final.shape, generator=g,
                         device=DEVICE, dtype=torch.int32)
    dist_in = torch.clamp_max(dist_final + bump, INF).contiguous()
    my_id = first[0].name_to_id[me]
    roots = torch.tensor(
        [my_id] + list(first[3]) + [my_id] * (b - 1 - len(first[3])),
        dtype=torch.int32, device=DEVICE,
    )
    csz = vp // pick_gs_chunks(vp)
    n_tail = min(8192, vp)
    rows = torch.unique(
        torch.randint(0, vp - 1, (n_tail,), generator=g, device=DEVICE)
    ).to(torch.int32)
    rows = torch.cat([rows, torch.full((n_tail - rows.numel(),), vp - 1,
                                       dtype=torch.int32, device=DEVICE)])
    calls = {
        "dense": (tables["base_nbr"], tables["base_wgt"],
                  dict(row0=vp - csz, n=csz)),
        "overflow": (tables["ov_nbr"], tables["ov_wgt"],
                     dict(dst_rows=tables["ov_ids"])),
        "tail": (tables["base_nbr"], tables["base_wgt"],
                 dict(src_rows=rows, dst_rows=rows)),
    }
    return dist_in, roots, calls


def check_calls(relax, dist_in, roots, calls, wrappers) -> dict:
    """Each wrapper (label -> (fn, lib)) against the plain version at
    each call: worst |diff| by label."""
    vp = dist_in.shape[0]
    worst = {label: 0 for label in wrappers}
    zero_flags = torch.zeros(vp, dtype=torch.int32, device=DEVICE)
    for kind, (nbr, wgt, kw) in calls.items():
        for label, (fn, lib) in wrappers.items():
            with using_lib(relax, lib):
                err, newly = compare(fn, relax, dist_in, dist_in, nbr, wgt,
                                     roots, None, zero_flags, **kw)
            worst[label] = max(worst[label], err)
            if newly == 0:
                fail(f"main-path call {kind} lowered no row")
    return worst


def time_calls(relax, dist_in, roots, calls, variants, tag) -> dict:
    """Each variant (label -> (wrapper, profiler name, lib)) at each
    call, in turns (the labels, then the same reversed), timed by CUPTI
    and by CUDA-graph replay with `out` and the flags restored before
    every launch; with the call's bound and the plain version's time.
    The dense chunk relaxes in place; overflow and tail read a pre-round
    snapshot, as on the main path."""
    vp, b = dist_in.shape
    work = dist_in.clone()
    flags = torch.zeros(vp + 1, dtype=torch.int32, device=DEVICE)
    fl = dict(row_flag=flags[:vp], rows_changed=flags[vp:])

    def restore():
        work.copy_(dist_in)
        flags.zero_()

    labels = list(variants)
    out = {}
    for kind, (nbr, wgt, kw) in calls.items():
        w = nbr.shape[1]
        src = work if kind == "dense" else dist_in
        t = {lb: [] for lb in labels}
        tg = {lb: [] for lb in labels}
        for lb in labels + labels[::-1]:
            fn, kname, lib = variants[lb]

            def launch(fn=fn):
                fn(src, work, nbr, wgt, roots, None, **fl, **kw)

            with using_lib(relax, lib):
                t[lb].append(cupti_us(launch, restore, kname, TIMING_REPS))
                tg[lb].append(graph_us(launch, restore, TIMING_REPS))
        p_ms = cuda_ms(lambda: relax.relax_rows_ref(
            src, work, nbr, wgt, roots, None, **fl, **kw))
        n, nbytes, ops, l2 = relax.launch_work(nbr, wgt, b, **kw)
        b_ms, b_by = bound(nbytes, ops)
        res = dict(n=n, w=w, b=b, bytes=nbytes, ops=ops, l2_bytes=l2,
                   bound_us=b_ms * 1e3, bound_by=b_by, plain_ms=p_ms)
        for lb in labels:
            cu = [x for x in t[lb] if x is not None]
            gr = statistics.fmean(tg[lb])
            us = statistics.fmean(cu) if cu else gr
            res[lb] = dict(cupti_us=statistics.fmean(cu) if cu else None,
                           timed_by="cupti" if cu else "graph", graph_us=gr, samples=t[lb], graph_samples=tg[lb],
                           us=us, bound_share=b_ms * 1e3 / us,
                           l2_tbs=l2 / us / 1e6)
        out[kind] = res
        log(f"[{tag}] {kind}: n={n} W={w} B={b}; bound {b_ms * 1e3:.3f} us "
            f"by {b_by} ({nbytes} B, {ops} int ops); L2 gathers {l2} B; "
            f"plain {p_ms:.4f} ms")
        for lb in labels:
            r = res[lb]
            log(f"[{tag}]   {lb}: {r['cupti_us']} us CUPTI "
                f"({r['graph_us']:.3f} graph), share of bound "
                f"{r['bound_share']:.3f}, L2 gathers {r['l2_tbs']:.2f} TB/s;"
                f" samples in turns CUPTI {t[lb]}, graph "
                f"{[round(x, 3) for x in tg[lb]]}")
    return out


def generic_variants(relax, old_libs) -> dict:
    """The generic kernel of this checkout and, with `--old`, the other
    checkout's, as `time_calls` variants."""
    name = relax.KERNEL_NAMES["generic"]
    out = {"generic": (relax.relax_rows_generic, name, None)}
    if "relax" in old_libs:
        out["old generic"] = (relax.relax_rows_generic, name,
                              old_libs["relax"])
    return out


def main_path_calls(relax, solver, ls, tables, old_libs):
    """Both designs (and the `--old` generic kernel) at the main path's
    three calls on the 100k tables: exact against the plain version,
    then timed on the device. Returns ({kind: numbers}, worst |diff| by
    design)."""
    dist_in, roots, calls = path_calls(solver, ls, tables)
    b = dist_in.shape[1]
    for kind, (nbr, _wgt, _kw) in calls.items():
        if relax.design_for(nbr.shape[1], b) != "vec":
            fail(f"main-path call {kind} (W={nbr.shape[1]}, B={b}) has no "
                 "specialisation to time")
    wrappers = {"vec": (relax.relax_rows, None),
                "generic": (relax.relax_rows_generic, None)}
    if "relax" in old_libs:
        wrappers["old generic"] = (relax.relax_rows_generic,
                                   old_libs["relax"])
    worst = check_calls(relax, dist_in, roots, calls, wrappers)
    log(f"[3] both designs vs plain at the main path's calls: max |diff| "
        f"{worst}")
    if any(worst.values()):
        fail(f"relax kernels disagree at main-path shapes ({worst})")
    log(f"[3] clocks before timing (sm MHz, W, C): "
        f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    variants = dict(generic_variants(relax, old_libs),
                    vec=(relax.relax_rows, relax.KERNEL_NAMES["vec"], None))
    out = time_calls(relax, dist_in, roots, calls, variants, "3")
    for kind, res in out.items():
        log(f"[3] {kind}: vec/generic "
            f"{res['vec']['us'] / res['generic']['us']:.3f}")
    log(f"[3] clocks after timing (sm MHz, W, C): "
        f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    worst.pop("old generic", None)
    return out, worst


# ------------------------------------------------------------ phase 4


def check_solve(csr, solved, rdb, cols: int, tag: str,
                me: str = "node-0", n_routes: int | None = None) -> None:
    """The root `me` and its first `cols - 1` neighbor columns against
    scipy's Dijkstra, their first hops against a NumPy recomputation, and
    `n_routes` unicast routes (default: one per other node)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    _csr, dist, fh, nbr_ids, _lfa = solved
    n_live = csr.num_nodes
    e = int(csr.num_edges)
    my_id = _csr.name_to_id[me]
    src_ids = [my_id] + list(nbr_ids[: cols - 1])
    graph = csr_matrix(
        (csr.edge_metric[:e].astype(np.float64),
         (csr.edge_src[:e], csr.edge_dst[:e])),
        shape=(n_live, n_live),
    )
    ref = dijkstra(graph, directed=True, indices=src_ids)
    ref = np.where(np.isinf(ref), INF, ref).astype(np.int64)
    got = np.asarray(dist)[:n_live][:, : len(src_ids)].T.astype(np.int64)
    if not np.array_equal(got, ref):
        bad = int((got != ref).sum())
        fail(f"{tag}: solve disagrees with scipy dijkstra at {bad} entries")
    d_root, d_n = ref[0], ref[1:]
    met = np.array(
        [min(x[1] for x in csr.details(my_id, j)) for j in src_ids[1:]]
    )
    fh_ref = (d_root < INF)[None, :] & (d_n < INF) & (
        met[:, None] + d_n == d_root[None, :]
    )
    if not np.array_equal(fh[: len(src_ids) - 1, :n_live], fh_ref):
        fail(f"{tag}: first-hop bits disagree with the NumPy recomputation")
    want = n_live - 1 if n_routes is None else n_routes
    if len(rdb.unicast_routes) != want:
        fail(f"{tag}: {len(rdb.unicast_routes)} unicast routes, expected "
             f"{want}")


def path_designs(relax, tables, b) -> set[str]:
    """The relax designs the split solve's shapes select."""
    return {relax.design_for(tables["base_nbr"].shape[1], b),
            relax.design_for(tables["ov_nbr"].shape[1], b)}


def phase4_hub(relax, old_libs) -> dict:
    """The main path at a shape outside the specialisation table: a hub
    router's RIB (101 neighbors, B = 128). Returns the launches by
    design from this run (counts set to 0 just before it); with `--old`,
    then times both generic kernels at the hub's calls."""
    from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
    from openr_tpu_torch.utils.topogen import hub_and_spoke

    adj, pfx = hub_and_spoke(hubs=2, spokes=100)
    ls, ps = LinkState(), PrefixState()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    solver = TorchSpfSolver(device=DEVICE)
    relax.reset_launches()
    solved = solver.solve(ls, "node-0")
    rdb = solver.compute_routes(ls, ps, "node-0")
    torch.cuda.synchronize()
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    csr = solved[0]
    b = solved[1].device_tensor.shape[1]
    designs = path_designs(relax, solver._device_arrays(csr), b)
    if "generic" not in designs:
        fail(f"hub root: B={b} selects {designs}, not the generic kernel")
    for d in designs:
        if launches[d] == 0:
            fail(f"hub root: the {d} relax kernel was launched no time")
    check_solve(csr, solved, rdb, cols=b, tag="hub root")
    log(f"[4] hub root: {csr.num_nodes} nodes, B={b}, designs {designs}; "
        f"launches {launches}; all {len(solved[3]) + 1} columns vs scipy, "
        f"first hops and {len(rdb.unicast_routes)} routes: ok")
    if "relax" in old_libs:
        tables = solver._device_arrays(csr)
        dist_in, roots, calls = path_calls(solver, ls, tables)
        variants = generic_variants(relax, old_libs)
        worst = check_calls(relax, dist_in, roots, calls,
                            {k: (v[0], v[2]) for k, v in variants.items()})
        if any(worst.values()):
            fail(f"hub root: generic kernels disagree with plain ({worst})")
        time_calls(relax, dist_in, roots, calls, variants, "4 hub")
    return launches


# ------------------------------------------------------------ phase 5


#: [5]'s rounds of a flap and its revert, then one traced flap and revert
WARM_ROUNDS = 1


def start_warm_states():
    """Starts building [5]'s 100k LinkState, its PrefixState and its CSR
    in a thread, with the collector off until it is joined (the set-up
    makes millions of objects and no garbage); [2]'s nvcc processes and
    [3]'s device work leave the interpreter mostly idle meanwhile.
    Returns the join, which gives (ls, ps, edges, csr, seconds of the
    databases, seconds of the CSR, seconds waited at the join)."""
    import threading

    from openr_tpu_torch.decision import linkstate  # noqa: F401
    from openr_tpu_torch.utils import topogen  # noqa: F401

    box: dict = {}

    def work():
        try:
            t0 = time.perf_counter()
            ls, ps, e = er_linkstate(100_000, avg_degree=20, seed=0,
                                     max_metric=64)
            t1 = time.perf_counter()
            csr = ls.to_csr()
            box["out"] = (ls, ps, e, csr, t1 - t0, time.perf_counter() - t1)
        except BaseException as exc:  # re-raised by the join
            box["err"] = exc

    gc.disable()
    th = threading.Thread(target=work, name="warm-states", daemon=True)
    th.start()

    def join():
        t0 = time.perf_counter()
        th.join()
        gc.enable()
        if "err" in box:
            raise box.pop("err")
        return box.pop("out") + (time.perf_counter() - t0,)

    return join


def phase5_warm(relax, shape4, states) -> dict:
    """The link-flap warm path on the 100k graph (`states`: what
    `start_warm_states`' join returned); returns the relax launches by
    design of its warm calls (counts set to 0 just before each call and
    read just after) and the (LinkState, PrefixState) it ran on, for
    [11]."""
    from torch.profiler import ProfilerActivity, profile

    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    ls, ps, e, csr, t_dbs, t_csr, waited = states
    solver = TorchSpfSolver(device=DEVICE)
    tables = solver._device_arrays(csr)
    shape = (tables["vp"], tables["base_nbr"].shape[1],
             tuple(tables["ov_nbr"].shape))
    if shape != shape4 or csr.num_edges != e:
        fail(f"warm: the LinkState's CSR gives {shape}, {csr.num_edges} "
             f"edges; phase 4 gave {shape4}, {e}")
    log(f"[5] LinkState: {csr.num_nodes} nodes, {csr.num_edges} directed "
        f"edges, vp {shape[0]}, W {shape[1]}, overflow {shape[2]}; set-up "
        f"{t_dbs:.1f} s (AdjacencyDatabases) + {t_csr:.1f} s (CSR), in a "
        f"thread beside [2] and [3] with the collector off, {waited:.1f} s "
        f"of it waited for before [4]")
    rdb, art = solver.compute_routes(ls, ps, "node-0", return_artifact=True)
    cold_solver = TorchSpfSolver(device=DEVICE)
    cold_solver.compute_routes(ls, ps, "node-0")  # uploads its tables
    rng = np.random.default_rng(20261017)
    warm_ms, cold_ms, cold_gc, stats = [], [], [], []
    launches = {"vec": 0, "generic": 0}

    def timed(fn):
        # with the host time inside the garbage collector, which the
        # timed calls include: millions of live objects make a full
        # collection slow
        with GcClock() as g:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        return out, ms, g.ms

    def warm(pairs, tag):
        """One warm call, counts from 0; returns its result and times."""
        nonlocal rdb, art
        relax.reset_launches()
        got, dt, g = timed(lambda: solver.warm_compute_routes(
            art, ls, ps, "node-0", pairs, set(), rdb, 0.25))
        for k, v in relax.LAUNCHES_BY_DESIGN.items():
            launches[k] += v
        if got is None:
            fail(f"warm: {tag}: warm_compute_routes returned None on a "
                 "flap set with no fallback trigger")
        rdb, art = got[0], got[1]
        stats.append(dict(solver.last_warm_stats, region=got[4],
                          wall_ms=dt, gc_ms=g,
                          by_design=dict(relax.LAUNCHES_BY_DESIGN)))
        return dt

    def check(tag, scipy_check=False):
        """The warm RIB against a fresh solver's and the patched cold
        solver's; returns the cold solver's wall ms."""
        fresh = TorchSpfSolver(device=DEVICE).compute_routes(
            ls, ps, "node-0")
        cold, c_dt, g = timed(
            lambda: cold_solver.compute_routes(ls, ps, "node-0"))
        for ref, name in ((fresh, "a fresh solver"),
                          (cold, "the patched cold solver")):
            if (rdb.unicast_routes != ref.unicast_routes
                    or rdb.mpls_routes != ref.mpls_routes):
                fail(f"warm: {tag}: the warm RouteDatabase differs from "
                     f"a cold compute_routes of {name}")
        if scipy_check:
            check_solve(art.solved[0], art.solved, rdb, cols=3,
                        tag=f"warm {tag}")
        cold_gc.append(g)
        return c_dt

    def warm_call(pairs, tag, scipy_check=False):
        warm_ms.append(warm(pairs, tag))
        cold_ms.append(check(tag, scipy_check))

    for rnd in range(WARM_ROUNDS):
        pairs, old_dbs = flap_round(ls, rng, 16, 16)
        warm_call(pairs, f"round {rnd} flap", scipy_check=rnd == 0)
        warm_call(revert_round(ls, old_dbs), f"round {rnd} revert")
    # one more flap, traced alone: the relax kernel's device time and the
    # device's busy time in a warm call
    pairs, old_dbs = flap_round(ls, rng, 16, 16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms = warm(pairs, "traced flap")
    check("traced flap")
    warm_call(revert_round(ls, old_dbs), "traced flap revert")
    k_us, k_n = kernel_device_us(prof, tuple(relax.KERNEL_NAMES.values()))
    dev_us, _n = kernel_device_us(prof, ("",))
    log(f"[5] warm p50 {statistics.median(warm_ms):.3f} ms (samples "
        f"{[round(x, 3) for x in warm_ms]}); cold p50 after the same flap "
        f"{statistics.median(cold_ms):.3f} ms (samples "
        f"{[round(x, 3) for x in cold_ms]}, of which in the garbage "
        f"collector {[round(x, 1) for x in cold_gc]}); host wall, ms")
    for i, st in enumerate(stats):
        log(f"[5] warm call {i}: {st}")
    st = stats[-2]  # the traced call
    log(f"[5] traced warm call ({st['tail_rounds']} tail rounds, "
        f"{st['sweeps']} sweeps, spilled {st['spilled']}, wall "
        f"{traced_ms:.3f} ms under the profiler): relax kernel {k_n} "
        f"launches, {k_us:.1f} us (CUPTI)"
        + (f", {k_us / k_n:.2f} us per launch" if k_n else
           " (not measured: the profiler saw no relax kernel)")
        + f"; all device kernels {dev_us:.1f} us, busy share "
        f"{dev_us / 1e3 / traced_ms:.3f} of the traced wall")
    log(f"[5] {len(stats)} warm calls, none None, each equal to a fresh "
        f"cold compute_routes; round 0 vs scipy: ok; solver "
        f"warm_solves {solver.warm_solves}, solve_count "
        f"{solver.solve_count}, device cache {solver.dev_cache_stats}")
    for d in path_designs(relax, tables, art.solved[1].shape[1]):
        if launches[d] == 0:
            fail(f"warm: the warm path launched the {d} relax kernel no "
                 "time")
    return dict(launches=launches, states=(ls, ps))


# ------------------------------------------------------------ phase 7


def phase7_probe(relax, old_libs) -> dict:
    """`probe_gather` at the probe's shapes, counts from 0: both sweeps
    exact, their CUPTI times, the torch-ops sweep's and the plain
    version's times, and the sweep's bound; with `--old`, then B1 on
    both generic kernels in turns."""
    from openr_tpu_torch import probe_gather as pg

    relax.reset_launches()
    res = pg.measure(DEVICE, pg.VP, reps=20)
    torch.cuda.synchronize()
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    if "relax" in old_libs:
        nbr, wgt, dist = pg.make_inputs(pg.VP, pg.D, pg.B, 0, DEVICE)
        ref = pg.sweep_ref(nbr, wgt, dist)
        turns = {"old generic": [], "generic": []}
        for lb in ("old generic", "generic", "generic", "old generic"):
            with using_lib(relax, old_libs["relax"] if lb.startswith("old")
                           else None):
                err = max_diff([(pg.sweep_b1(nbr, wgt, dist), ref)])
                if err:
                    fail(f"probe: B1 on the {lb} kernel is wrong ({err})")
                turns[lb].append(kernel_us(
                    lambda: pg.sweep_b1(nbr, wgt, dist), lambda: None,
                    relax.KERNEL_NAMES["generic"]))
        log(f"[7] B1 in turns (old, new, new, old), (us, timed by): old generic "
            f"{turns['old generic']}, generic {turns['generic']}")
    names = {name: fn.__name__ for name, fn, _k in pg.VARIANTS}
    out = {names[k]: v for k, v in res.items()}
    for fn, design in (("sweep_b1", "generic"), ("sweep_b2", "vec")):
        row = out[fn]
        if not row["sum_ok"] or row["max_abs_err"]:
            fail(f"probe: {fn} is wrong (sum ok {row['sum_ok']}, max "
                 f"|diff| vs plain {row['max_abs_err']})")
        if launches[design] == 0:
            fail(f"probe: {fn} launched the {design} kernel no time")
    if not out["sweep_torch_ops"]["sum_ok"]:
        fail("probe: the torch-ops sweep is wrong")
    vp, d, b = pg.VP, pg.D, pg.B
    nbytes, ops = pg.sweep_work(vp, d, b)
    b_ms, b_by = bound(nbytes, ops)
    out.update(
        launches=launches,
        plain_ms=out["sweep_ref"]["us"] / 1e3,
        bound_ms=b_ms,
        bound_by=b_by,
    )
    for name, row in res.items():
        log(f"[7] {name}: {row['us']:.2f} us ({row['gbs']:.0f} GB/s eff, "
            f"VP*D*B*4 logical bytes); sum ok {row['sum_ok']}, max |diff| "
            f"vs plain {row['max_abs_err']}")
    log(f"[7] probe VP {vp} D {d} B {b}: bound {out['bound_ms'] * 1e3:.3f} "
        f"us by {out['bound_by']} ({nbytes} B, {ops} int ops); launches "
        f"{launches}")
    return out


# ------------------------------------------------------------ phase 8


def max_diff(pairs) -> int:
    """Max |a - b| over pairs of same-shape tensors (bools as ints)."""
    return max((int((a.long() - b.long()).abs().max().item())
                for a, b in pairs if a.numel()), default=0)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms on the card, "bytes" or "operations"): the package's
    count (`monitor/device.py`), which the kernel cost rows use too."""
    from openr_tpu_torch.monitor import device

    return device.bound(nbytes, ops)


def to_dev(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(DEVICE)


def elect_case(rng, seg, n_nodes):
    """Election inputs on the card for slot owners `seg` (sorted) over
    `n_nodes` nodes, drawn as `tests/test_prefix_scale.py` draws them."""
    m = int(seg.max()) + 1 if len(seg) else 0
    s = len(seg)
    indptr = np.concatenate(([0], np.cumsum(np.bincount(seg, minlength=m))))
    d_vec = np.where(rng.random(n_nodes) < 0.8,
                     rng.integers(1, 100, n_nodes), INF)
    reach = (d_vec < INF) & (rng.random(n_nodes) < 0.9)
    return (to_dev(indptr, np.int32), to_dev(seg, np.int32),
            to_dev(rng.integers(0, n_nodes - 2, s), np.int32),
            to_dev(rng.random(s) < 0.9, bool),
            to_dev(rng.integers(0, 8, s), np.int32),
            to_dev(d_vec, np.int32), to_dev(reach, bool),
            int(rng.integers(0, n_nodes - 2)))


def elect_vs_plain(election_ops, args) -> int:
    got = election_ops.elect_seg(*args)
    ref = election_ops.elect_seg_ref(*args)
    torch.cuda.synchronize()
    return max_diff(zip(got, ref))


def ksp_step_case(ksp_ops, g, v, d, b, with_over):
    """Random dense tables [v, d] (INF padding) with random bans for b
    jobs on the card: (tables, the distances after 2 plain sweeps and at
    the plain fixpoint, its sweep count, dests with one dest == root,
    root). Where d > 64 every 16th row is a hub with all d slots and the
    others keep 8, as in a hub-and-spoke fabric."""
    nbr = torch.randint(0, v, (v, d), generator=g, dtype=torch.int32)
    wgt = torch.randint(1, 20, (v, d), generator=g, dtype=torch.int32)
    wgt[torch.rand(v, d, generator=g) < 0.25] = INF
    if d > 64:
        spoke = torch.arange(v) % 16 != 0
        wgt[spoke[:, None] & (torch.arange(d) >= 8)[None, :]] = INF
    root = 1
    over = torch.rand(v, generator=g) < (0.05 if with_over else 0.0)
    over[root] = with_over  # an overloaded root keeps its out-edges
    blocked = over[nbr.long()] & (nbr != root)
    bans = ksp_ops.pack_bans((torch.rand(v, d, b, generator=g) < 0.05)
                             .to(DEVICE))
    dests = torch.randint(0, v, (b,), generator=g, dtype=torch.int32)
    dests[0] = root
    tab = [x.to(DEVICE) for x in (nbr, wgt, blocked, bans)]
    dist = torch.full((v, b), INF, dtype=torch.int32, device=DEVICE)
    dist[root] = 0
    mid, sweeps = dist, 0
    for i in range(v):
        dist, ch = host_read_sweep(ksp_ops.ksp_relax_ref, dist, tab)
        sweeps += 1
        if i == 1:
            mid = dist.clone()
        if not ch:
            break
    return tab, mid, dist, sweeps, dests.to(DEVICE), root


def host_read_sweep(relax_fn, dist, tab):
    """One sweep by `relax_fn` (`ksp_relax` or its plain version) and
    one host read of its changed flag: (new dist, changed)."""
    out = torch.empty_like(dist)
    changed = torch.zeros(1, dtype=torch.int32, device=dist.device)
    relax_fn(dist, out, *tab, changed)
    return out, int(changed.item())


def relax_vs_plain(ksp_ops, dist_in, tab) -> tuple[int, int]:
    """One sweep by the kernel and the plain version; (max |diff| over
    dist_out and the changed flag, the plain changed flag)."""
    res = []
    for fn in (ksp_ops.ksp_relax, ksp_ops.ksp_relax_ref):
        out = torch.empty_like(dist_in)
        ch = torch.full((1,), 7, dtype=torch.int32, device=DEVICE)
        fn(dist_in, out, *tab, ch)
        res.append((out, ch))
    torch.cuda.synchronize()
    return max_diff(zip(*res)), int(res[1][1].item())


#: [8a]: the passes (card) and Jacobi sweeps (plain) of the capped runs
KSP_CAP = 2


def sssp_vs_plain(ksp_ops, tab, root, b) -> tuple[int, int, int]:
    """The fixpoint from `root` by the kernel (one launch, in place, grid
    passes counted on the card) and the plain version (Jacobi sweeps),
    then both capped at KSP_CAP: the card's capped result must lie, entry
    by entry, between the fixpoint and the plain capped one. Returns
    (max |diff| of the fixpoints plus the capped entries outside those
    bounds, kernel passes, plain sweeps)."""
    v = tab[0].shape[0]
    res = []
    for fn in (ksp_ops.ksp_sssp, ksp_ops.ksp_sssp_ref):
        counters = torch.zeros(2, dtype=torch.int32, device=DEVICE)
        live = torch.ones(1, dtype=torch.int32, device=DEVICE)
        dist = fn(None, *tab, root, b, max_sweeps=v, live=live,
                  counters=counters)
        res.append((dist, counters))
    capped = [fn(None, *tab, root, b, max_sweeps=KSP_CAP)
              for fn in (ksp_ops.ksp_sssp, ksp_ops.ksp_sssp_ref)]
    torch.cuda.synchronize()
    fix = res[1][0]
    outside = int(((capped[0] < fix) | (capped[0] > capped[1])).sum().item())
    return (max_diff([(res[0][0], fix)]) + outside,
            int(res[0][1][1].item()), int(res[1][1][1].item()))


def old_sssp(ksp_ops, lib, tab, root, b):
    """The parent checkout's `ksp_sssp_kernel` (an `--old` build) from
    `root` to its fixpoint, driven as its wrapper drove it: the start and
    the result in two buffers, 2 x [V, NW] change bytes of scratch.
    Returns (distances, sweeps)."""
    nbr, wgt, blocked, bans = tab
    v, d = nbr.shape
    start = torch.empty((v, b), dtype=torch.int32, device=DEVICE)
    out = torch.empty_like(start)
    counters = torch.zeros(2, dtype=torch.int32, device=DEVICE)
    flags = torch.empty(4 + -(-2 * v * ksp_ops.ban_words(b) // 4),
                        dtype=torch.int32, device=DEVICE)
    err = lib.openr_ksp_sssp(
        start.data_ptr(), out.data_ptr(), nbr.data_ptr(), wgt.data_ptr(),
        blocked.data_ptr(), bans.data_ptr(), None, counters.data_ptr(),
        None, flags.data_ptr(), int(root), v, d, b, v,
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the --old ksp_sssp_kernel failed to launch ({err})")
    return out, counters


def walk_vs_plain(ksp_ops, dist, tab, dests, root, max_hops):
    """One round of walks by the kernel and the plain version, each on
    its own copy of the bans; (max |diff| over cost, path, hops, bans and
    any_ok, the plain outputs)."""
    b = dests.shape[0]
    res = []
    for fn in (ksp_ops.ksp_walk, ksp_ops.ksp_walk_ref):
        nbr, wgt, blocked, bans = tab
        bans = bans.clone()
        cost = torch.zeros(b, dtype=torch.int32, device=DEVICE)
        path = torch.full((b, max_hops + 1), -1, dtype=torch.int32,
                          device=DEVICE)
        hops = torch.zeros(b, dtype=torch.int32, device=DEVICE)
        ok = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        fn(dist, nbr, wgt, blocked, bans, dests, root, max_hops, cost, path,
           hops, ok)
        res.append((cost, path, hops, bans, ok))
    torch.cuda.synchronize()
    return max_diff(zip(*res)), res[1]


def ksp_graph(rng, n, extra):
    """A connected random digraph (a ring plus `extra` random links, both
    directions, asymmetric metrics) as dense tables; plus overload bits
    and scipy's distances from root 0 under them."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from openr_tpu_torch.ops.spf import build_dense_tables

    edges = {}
    pairs = [(i, (i + 1) % n) for i in range(n)] + [
        tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(extra)]
    for a, b in pairs:
        if a != b:
            edges[(a, b)] = int(rng.integers(1, 20))
            edges[(b, a)] = int(rng.integers(1, 20))
    items = sorted(edges.items(), key=lambda kv: (kv[0][1], kv[0][0]))
    src = np.array([k[0] for k, _ in items], np.int32)
    dst = np.array([k[1] for k, _ in items], np.int32)
    met = np.array([m for _, m in items], np.int32)
    nbr, wgt = build_dense_tables(src, dst, met, n)
    over = rng.random(n) < 0.03
    over[0] = False
    keep = ~over[src] | (src == 0)
    g = csr_matrix((met[keep].astype(np.float64), (src[keep], dst[keep])),
                   shape=(n, n))
    d0 = dijkstra(g, directed=True, indices=[0])[0]
    dist0 = np.where(np.isinf(d0), INF, d0).astype(np.int32)
    return nbr, wgt, over, dist0


def phase8a_kernels(election_ops, ksp_ops, csr) -> dict:
    """The three kernels against their plain versions on random inputs,
    and one KSP relax sweep at the er100k dense-table shape, timed."""
    rng = np.random.default_rng(3)
    worst = {"elect": 0, "sssp": 0, "walk": 0}
    for _trial in range(5):
        m = int(rng.integers(1, 40))
        seg = np.repeat(np.arange(m), rng.integers(1, 6, m))
        worst["elect"] = max(worst["elect"], elect_vs_plain(
            election_ops, elect_case(rng, seg, 32)))
    # 100 000 slots over 40 000 prefixes (some empty) on 100 000 nodes
    seg = np.sort(rng.integers(0, 40_000, 100_000))
    worst["elect"] = max(worst["elect"], elect_vs_plain(
        election_ops, elect_case(rng, seg, 100_000)))
    # long and empty segments: the lengths each side of a warp and of the
    # kernel's one-thread limit, prefixes of 300 advertisers, several
    # long segments in one warp; and lengths drawn from 0 to 70
    lengths = [np.tile([0, 1, 2, 31, 32, 33, 300, 2, 9, 8, 0, 2], 40),
               rng.integers(0, 71, 3000)]
    for ln in lengths:
        ln[-1] = max(ln[-1], 1)  # the last prefix owns a slot
        seg = np.repeat(np.arange(len(ln)), ln)
        worst["elect"] = max(worst["elect"], elect_vs_plain(
            election_ops, elect_case(rng, seg, 1000)))
    log(f"[8a] elect_seg_kernel vs plain: 5 random tables, one of 100 000 "
        f"slots, two of long and empty segments ({len(lengths[0])} prefixes "
        f"of 0-300 slots, {len(lengths[1])} of 0-70): max |diff| "
        f"{worst['elect']}")

    g = torch.Generator().manual_seed(20261018)
    n_ok, modes, n_sweeps, wide = 0, set(), [], []  # n_sweeps: (passes, sweeps)
    overs = set()
    for i, (v, d) in enumerate(KSP_CASES):
        for b in KSP_CASE_B[(v, d)]:
            tab, mid, fix, sweeps, dests, root = ksp_step_case(
                ksp_ops, g, v, d, b, with_over=(b + i) % 2 == 1)
            overs.add((b + i) % 2 == 1)
            plan = ksp_ops.sssp_plan(v, d, b)
            mode = "resident" if plan[0] else "streamed"
            if plan[3] and plan[3] < d:
                mode = "streamed in chunks"
            modes.add(mode)
            if d >= 512:
                wide.append((d, b, mode, plan))
            err, ch = relax_vs_plain(ksp_ops, mid, tab)
            if not ch:
                fail(f"ksp sweep case V {v} D {d} B={b} lowered nothing: "
                     "untested")
            worst["sssp"] = max(worst["sssp"], err)
            err, s_dev, s_ref = sssp_vs_plain(ksp_ops, tab, root, b)
            if s_ref != sweeps or s_ref < 3:
                fail(f"ksp fixpoint case V {v} D {d} B={b}: plain sweeps "
                     f"{s_ref}, host loop {sweeps}")
            if not 1 <= s_dev <= s_ref:
                fail(f"ksp fixpoint case V {v} D {d} B={b}: {s_dev} grid "
                     f"passes on the card, {s_ref} plain sweeps")
            n_sweeps.append((s_dev, s_ref))
            worst["sssp"] = max(worst["sssp"], err)
            err, ref = walk_vs_plain(ksp_ops, fix, tab, dests, root, v - 1)
            if not int(ref[4].item()):
                fail(f"ksp walk case V {v} D {d} B={b} found no path: "
                     "untested")
            n_ok += int((ref[0] < INF).sum().item())
            worst["walk"] = max(worst["walk"], err)
    if modes != {"resident", "streamed", "streamed in chunks"}:
        fail(f"ksp_sssp_kernel cases ran in {modes} only")
    if overs != {False, True}:
        fail(f"ksp cases ran with overloads {overs} only")
    log(f"[8a] ksp_sssp_kernel plans (rows a block, blocks, smem B, staged "
        f"slots) of the hub-row cases (D, B, mode, plan): {wide}")
    log(f"[8a] ksp_sssp_kernel / ksp_walk_kernel vs plain on random tables "
        f"with 5% bans, (V, D): B {KSP_CASE_B}, overloads off/on, modes "
        f"{sorted(modes)}: one sweep, the "
        f"fixpoint (card passes, plain sweeps {n_sweeps}: passes <= sweeps), "
        f"both capped at {KSP_CAP} (the card between the fixpoint and the "
        f"plain capped result), one walk round ({n_ok} paths walked): max "
        f"|diff| {worst['sssp']} / {worst['walk']}")

    nbr, wgt, over, dist0 = ksp_graph(rng, 1024, 2048)
    blocked = ksp_ops.build_ksp_blocked(nbr, over, 0)
    dests = np.concatenate(([0], rng.choice(np.arange(1, 1024), 31,
                                            replace=False))).astype(np.int32)
    whole, counts = 0, []
    for k in (2, 16):
        for d0 in (None, dist0):
            outs, sts = [], []
            for dev in (DEVICE, "cpu"):
                st: dict = {}
                t = [torch.from_numpy(x).to(dev) for x in (nbr, wgt, blocked)]
                outs.append(ksp_ops.ksp_edge_disjoint_dense(
                    *t, 0, torch.from_numpy(dests).to(dev), k=k,
                    max_hops=1023, stats=st,
                    dist0=None if d0 is None else torch.from_numpy(d0).to(dev),
                ))
                sts.append(st)
            torch.cuda.synchronize()
            whole = max(whole, max_diff(
                (a, b.to(DEVICE)) for a, b in zip(*outs)))
            card, cpu = sts
            if (card["rounds"] != cpu["rounds"]
                    or card["host_reads"] != cpu["host_reads"]
                    or not 1 <= card["sweeps"] <= cpu["sweeps"]):
                fail(f"ksp whole case: card counters {card}, CPU {cpu}")
            counts.append((card["rounds"], card["sweeps"], cpu["sweeps"]))
            if not bool((outs[1][0] < INF).any()):
                fail("ksp whole case found no path: untested")
    worst["sssp"] = max(worst["sssp"], whole)
    worst["walk"] = max(worst["walk"], whole)
    log(f"[8a] ksp_edge_disjoint_dense on the card vs on the CPU (plain), "
        f"1 024-node graph, 32 jobs, k in (2, 16), dist0 off/on: max |diff| "
        f"{whole} (costs, paths, hops); (rounds, card passes, CPU sweeps) "
        f"{counts}: rounds and host reads equal, passes <= sweeps")

    # one sweep at the er100k dense-table shape, B = 32 (and 128, read
    # for the design record only), ~3% bans
    d_nbr, d_wgt = csr.dense_tables()
    v, d = d_nbr.shape
    nbr_t, wgt_t = to_dev(d_nbr, np.int32), to_dev(d_wgt, np.int32)
    blocked_t = torch.zeros(v, d, dtype=torch.bool, device=DEVICE)
    gd = torch.Generator(device=DEVICE).manual_seed(5)
    er = {}
    for b in (32, 128):
        # ban words drawn on the card: the AND of 5 random words sets ~3%
        # of the bits
        bans_t = torch.full((v, d, ksp_ops.ban_words(b)), -1,
                            dtype=torch.int32, device=DEVICE)
        for _ in range(5):
            bans_t &= torch.randint(-(1 << 31), (1 << 31) - 1, bans_t.shape,
                                    generator=gd, device=DEVICE,
                                    dtype=torch.int32)
        # the distances of a sweep early in a fixpoint: each entry at most
        # a few hundred above an unbanned distance, many INF
        dist = torch.randint(0, 5000, (v, b), generator=g, dtype=torch.int32)
        dist[torch.rand(v, b, generator=g) < 0.3] = INF
        dist = dist.to(DEVICE)
        tab = (nbr_t, wgt_t, blocked_t, bans_t)
        err, ch = relax_vs_plain(ksp_ops, dist, tab)
        worst["sssp"] = max(worst["sssp"], err)
        out = torch.empty_like(dist)
        flag = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        us, by = kernel_us(lambda: ksp_ops.ksp_relax(dist, out, *tab, flag),
                           lambda: None, ksp_ops.KERNEL_NAMES["sssp"])
        p_ms = cuda_ms(lambda: ksp_ops.ksp_relax_ref(dist, out, *tab, flag))
        nbytes, ops = ksp_ops.relax_work(wgt_t, b)
        b_ms, b_by = bound(nbytes, ops)
        log(f"[8a] ksp_sssp_kernel, one Jacobi sweep at the er100k dense "
            f"shape (V {v}, D {d}, B {b}; streamed, its one pass from one "
            f"buffer into another): max |diff| vs plain {err} (changed "
            f"{ch}); {us:.2f} us ({by}), bound {b_ms * 1e3:.3f} us by {b_by} "
            f"({nbytes} B), share {b_ms * 1e3 / us:.3f}; plain {p_ms:.4f} ms")
        er[b] = dict(us=us, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                     bytes=nbytes)
    for k_, val in worst.items():
        if val:
            fail(f"phase 8a: {k_} kernel disagrees with its plain version "
                 f"({val})")
    return {"worst": worst, "er100k_relax": er}


def config4_states(rings: int = 32, size: int = 32, extras: bool = True,
                   ksp_keep: int | None = None):
    """BASELINE config 4: `backbone(rings, size)` with `bench_ksp_lfa`'s
    prefix mix (a 10% share of the nodes' /24s KSP2_ED_ECMP over SR-MPLS,
    `default_rng(0)`). With `extras`, one chord per site (positions 0 and
    2, metric 10: the ring alone is bipartite with even metrics, so no
    neighbor is ever a strict loop-free alternate) and one UCMP anycast
    /24 per site from its positions 16 (weight 1) and 18 (weight 3),
    which bb1 reaches at one IGP cost through different first hops.
    `ksp_keep` = n keeps only the n lowest-numbered KSP nodes' prefixes
    KSP (the others plain). Returns (ls, ps, the KSP node ids)."""
    from dataclasses import replace

    from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
    from openr_tpu_torch.types import (
        Adjacency,
        ForwardingAlgorithm,
        ForwardingType,
        IpPrefix,
        PrefixDatabase,
        PrefixEntry,
        PrefixMetrics,
    )
    from openr_tpu_torch.utils.topogen import backbone

    dbs = {db.this_node_name: db for db in backbone(rings, size)}
    for r in range(rings if extras else 0):
        a, b = r * size, r * size + 2
        for x, y in ((a, b), (b, a)):
            db = dbs[f"bb{x}"]
            dbs[f"bb{x}"] = replace(db, adjacencies=db.adjacencies + (
                Adjacency(other_node_name=f"bb{y}", if_name=f"if{x}-{y}",
                          other_if_name=f"if{y}-{x}", metric=10),))
    ls, ps = LinkState(), PrefixState()
    for db in dbs.values():
        ls.update_adjacency_db(db)
    n = rings * size
    rng = np.random.default_rng(0)
    ksp_nodes = set(rng.choice(n, size=max(1, int(n * 0.1)),
                               replace=False).tolist())
    if ksp_keep is not None:
        ksp_nodes = set(sorted(ksp_nodes)[:ksp_keep])
    for i in range(n):
        ksp = i in ksp_nodes
        ps.update_prefix_db(PrefixDatabase(
            this_node_name=f"bb{i}",
            prefix_entries=(PrefixEntry(
                prefix=IpPrefix.make(f"10.{(i >> 8) & 255}.{i & 255}.0/24"),
                metrics=PrefixMetrics(),
                forwarding_type=(ForwardingType.SR_MPLS if ksp
                                 else ForwardingType.IP),
                forwarding_algorithm=(ForwardingAlgorithm.KSP2_ED_ECMP if ksp
                                      else ForwardingAlgorithm.SP_ECMP),
            ),),
        ))
    for r in range(rings if extras else 0):
        for pos, w in ((16, 1), (18, 3)):
            ps.update_prefix_db(PrefixDatabase(
                this_node_name=f"bb{r * size + pos}",
                prefix_entries=(PrefixEntry(
                    prefix=IpPrefix.make(f"20.{r}.0.0/24"), weight=w),),
            ))
    return ls, ps, ksp_nodes


def ksp_path_run(ksp_ops, solver, ls, ps, me, reps: int) -> dict:
    """`compute_routes` of a KSP configuration on the card: a warm-up
    that uploads the tables and captures the inputs of the first
    `ksp_sssp` and `ksp_walk` calls, then `reps` timed calls with the
    launch counts from 0, then one call under the profiler (CUPTI µs and
    launches per KSP kernel)."""
    from torch.profiler import ProfilerActivity, profile

    captured: dict = {}
    origs = {name: getattr(ksp_ops, name) for name in ("ksp_sssp",
                                                      "ksp_walk")}

    def capturing(name):
        def call(*args, **kw):
            # the first call's inputs, copied on the stream before the
            # call writes
            captured.setdefault(name, (
                [x.clone() if isinstance(x, torch.Tensor) else x
                 for x in args],
                {k: x.clone() if isinstance(x, torch.Tensor) else x
                 for k, x in kw.items()}))
            return origs[name](*args, **kw)
        return call

    for name in origs:
        setattr(ksp_ops, name, capturing(name))
    try:
        solver.compute_routes(ls, ps, me)  # warm-up: uploads, captures
    finally:
        for name, fn in origs.items():
            setattr(ksp_ops, name, fn)
    ksp_ops.reset_launches()
    times, ksp_ms = [], []
    for _ in range(reps):
        t1 = time.perf_counter()
        rdb = solver.compute_routes(ls, ps, me)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        ksp_ms.append(solver.last_ksp_stats["ms"])
    launches = dict(ksp_ops.LAUNCHES)
    st = dict(solver.last_ksp_stats)
    phases = dict(solver.last_phase_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.compute_routes(ls, ps, me)
        torch.cuda.synchronize()
    cu = {k: kernel_device_us(prof, (n,))
          for k, n in ksp_ops.KERNEL_NAMES.items()}
    return dict(captured=captured, times=times, ksp_ms=ksp_ms,
                launches=launches, stats=st, phases=phases, cu=cu, rdb=rdb,
                reps=reps)


def wall_ms(fn, reps: int = 3) -> float:
    """Median host wall (ms) of `fn()` followed by a synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def fixpoint_at_call(ksp_ops, sx, old_lib=None) -> dict:
    """On the captured inputs `sx` of a path's first SSSP: one Jacobi
    sweep of `ksp_sssp_kernel` against its plain version (CUPTI-timed,
    with the per-sweep bound), and the fixpoint by one launch (in place,
    grid passes counted on the card) against the host-read loop of
    one-sweep launches and the plain fixpoint: the same distances, passes
    at most the loop's and the plain sweeps, each timed. With `old_lib`
    (the `--old` build of `ksp.cu`), the parent's fixpoint launch on the
    same inputs: equal, and timed in turns with this one (old, new, new,
    old)."""
    args, _kw = sx
    _dist0, nbr, wgt, blocked, bans, root, b = args
    tab = (nbr, wgt, blocked, bans)
    v = nbr.shape[0]
    start = torch.full((v, b), INF, dtype=torch.int32, device=DEVICE)
    start[root] = 0
    err1, _ch = relax_vs_plain(ksp_ops, start, tab)
    out = torch.empty_like(start)
    flag = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    sweep_us, _by = kernel_us(
        lambda: ksp_ops.ksp_relax(start, out, *tab, flag), lambda: None,
        ksp_ops.KERNEL_NAMES["sssp"])
    sweep_plain = cuda_ms(lambda: ksp_ops.ksp_relax_ref(start, out, *tab,
                                                        flag))
    s_bytes, s_ops = ksp_ops.relax_work(wgt, b)

    def device_fix(fn=ksp_ops.ksp_sssp):
        counters = torch.zeros(2, dtype=torch.int32, device=DEVICE)
        return fn(None, *tab, root, b, max_sweeps=v, counters=counters), \
            counters

    def host_loop():
        dist, n = start, 0
        for _ in range(v):
            dist, ch = host_read_sweep(ksp_ops.ksp_relax, dist, tab)
            n += 1
            if not ch:
                break
        return dist, n

    fix, counters = device_fix()
    plain, p_counters = device_fix(ksp_ops.ksp_sssp_ref)
    host, host_sweeps = host_loop()
    torch.cuda.synchronize()
    passes = int(counters[1].item())
    err = max(err1, max_diff([(fix, host), (fix, plain)]))
    if (int(p_counters[1].item()) != host_sweeps
            or not 1 <= passes <= host_sweeps):
        fail(f"device fixpoint ran {passes} grid passes, the host-read loop "
             f"{host_sweeps} sweeps, the plain one {int(p_counters[1].item())}")
    name = ksp_ops.KERNEL_NAMES["sssp"]
    turns = {"new": [], "old": []}
    old = None
    if old_lib is not None:
        old_fix, old_counters = old_sssp(ksp_ops, old_lib, tab, root, b)
        torch.cuda.synchronize()
        err = max(err, max_diff([(fix, old_fix)]))
        old = dict(sweeps=int(old_counters[1].item()))
        for lb in ("old", "new", "new", "old"):
            fn = ((lambda: old_sssp(ksp_ops, old_lib, tab, root, b))
                  if lb == "old" else device_fix)
            turns[lb].append(kernel_us(fn, lambda: None, name)[0])
        old["us"] = statistics.fmean(turns["old"])
    fix_us, fix_by = kernel_us(lambda: device_fix(), lambda: None, name)
    if turns["new"]:
        turns["new"].append(fix_us)
        fix_us = statistics.fmean(turns["new"])
    f_bytes, f_ops = ksp_ops.sssp_work(nbr, wgt, blocked, fix)
    rows, grid, smem, _stage = ksp_ops.sssp_plan(v, nbr.shape[1], b)
    return dict(
        err=err, v=v, d=nbr.shape[1], b=b, passes=passes, sweeps=host_sweeps,
        mode="resident" if rows else "streamed", rows=rows,
        grid=grid, smem=smem, sweep_us=sweep_us, sweep_plain_ms=sweep_plain,
        sweep_bytes=s_bytes, sweep_bound=bound(s_bytes, s_ops), us=fix_us,
        timed_by=fix_by, turns=turns, old=old,
        dev_wall_ms=wall_ms(device_fix), host_wall_ms=wall_ms(host_loop),
        plain_ms=wall_ms(lambda: device_fix(ksp_ops.ksp_sssp_ref), reps=1),
        bytes=f_bytes, ops=f_ops, bound=bound(f_bytes, f_ops),
    )


def walk_at_call(ksp_ops, wk) -> dict:
    """`ksp_walk_kernel` against its plain version on the captured
    inputs `wk` of a path's first walk, timed by CUPTI, with its bytes
    bound, the longest job's hops and µs per hop."""
    w_dist, w_nbr, w_wgt, w_blocked, w_bans, w_dests, w_root, w_hops = wk[0][:8]
    b = w_dests.shape[0]
    err, wref = walk_vs_plain(ksp_ops, w_dist, (w_nbr, w_wgt, w_blocked,
                                                w_bans), w_dests, w_root,
                              w_hops)
    bans_w = w_bans.clone()
    path_w = torch.full((b, w_hops + 1), -1, dtype=torch.int32, device=DEVICE)
    bufs = [torch.zeros(b, dtype=torch.int32, device=DEVICE) for _ in range(2)]
    ok_w = torch.zeros(1, dtype=torch.int32, device=DEVICE)

    def w_restore():
        bans_w.copy_(w_bans)
        path_w.fill_(-1)

    def w_call(fn):
        fn(w_dist, w_nbr, w_wgt, w_blocked, bans_w, w_dests, w_root, w_hops,
           bufs[0], path_w, bufs[1], ok_w)

    us, by = kernel_us(lambda: w_call(ksp_ops.ksp_walk), w_restore,
                       ksp_ops.KERNEL_NAMES["walk"])
    plain = cuda_ms(lambda: (w_restore(), w_call(ksp_ops.ksp_walk_ref)))
    hops = wref[2]
    rows = int((hops + 1).sum().item())
    longest = int(hops.max().item())
    nbytes, ops = ksp_ops.walk_work(w_nbr.shape[1], hops)
    return dict(err=err, us=us, timed_by=by, plain_ms=plain, rows=rows,
                longest=longest,
                us_per_hop=us / max(longest, 1), bytes=nbytes,
                bound=bound(nbytes, ops), b=b,
                d=w_nbr.shape[1])


def log_ksp_run(ksp_ops, tag: str, run: dict, fx: dict, wk: dict) -> None:
    """The KSP lines of [8b] / [8d]: per RIB, the kernels at the path's
    first calls, the device fixpoint against the host-read loop (and,
    with `--old`, against the parent's kernel in turns)."""
    st, reps = run["stats"], run["reps"]
    per_rib = {k: n / reps for k, n in run["launches"].items()}
    log(f"[{tag}] per RIB: host reads {st['host_reads']}, launches "
        f"{per_rib}, rounds {st['rounds']}, grid passes {st['sweeps']}; KSP "
        f"phase {[round(x, 3) for x in run['ksp_ms']]} ms, compute_routes "
        f"p50 {statistics.median(run['times']):.3f} ms")
    for k, (us, n) in run["cu"].items():
        per = ""
        if n:
            per = f", {us / n:.2f} us each"
            if k == "sssp" and st["sweeps"]:
                per += f", {us / st['sweeps']:.3f} us per grid pass"
        log(f"[{tag}] {ksp_ops.KERNEL_NAMES[k]} in one profiled compute_routes: {n} "
            f"launches, {us:.1f} us (CUPTI){per}")
    sb, fb = fx["sweep_bound"], fx["bound"]
    log(f"[{tag}] ksp_sssp_kernel at the path's first SSSP (V {fx['v']}, D "
        f"{fx['d']}, B {fx['b']}; {fx['mode']}: {fx['rows']} rows a block, "
        f"{fx['grid']} blocks, "
        f"{fx['smem']} B smem): one Jacobi sweep {fx['sweep_us']:.2f} us, "
        f"plain {fx['sweep_plain_ms']:.4f} ms, sweep bound "
        f"{sb[0] * 1e3:.3f} us by {sb[1]} ({fx['sweep_bytes']} B); fixpoint "
        f"in one launch: {fx['passes']} grid passes (the plain loop "
        f"{fx['sweeps']} sweeps), {fx['us']:.1f} us ({fx['timed_by']}; "
        f"{fx['us'] / fx['passes']:.3f} us per pass), bound "
        f"{fb[0] * 1e3:.3f} us by {fb[1]} ({fx['bytes']} B, {fx['ops']} ops), "
        f"share {fb[0] * 1e3 / fx['us']:.4f}; host wall: one launch "
        f"{fx['dev_wall_ms']:.3f} ms vs the host-read loop of "
        f"{fx['sweeps']} one-sweep launches {fx['host_wall_ms']:.3f} ms "
        f"(same fixpoint); plain fixpoint {fx['plain_ms']:.3f} ms; max "
        f"|diff| {fx['err']}")
    if fx["old"]:
        o = fx["old"]
        log(f"[{tag}] ksp_sssp_kernel in turns with the --old build (old, "
            f"new, new, old; CUPTI us): new {[round(x, 1) for x in fx['turns']['new']]}"
            f", old {[round(x, 1) for x in fx['turns']['old']]} ({o['sweeps']} "
            f"Jacobi sweeps); new / old {fx['us'] / o['us']:.4f}; the same "
            f"fixpoint")
    wb = wk["bound"]
    log(f"[{tag}] ksp_walk_kernel at the path's first walk (B {wk['b']}, D "
        f"{wk['d']}, {wk['rows']} rows walked, longest job {wk['longest']} "
        f"hops): {wk['us']:.2f} us ({wk['us_per_hop']:.3f} us per hop of the "
        f"longest), plain {wk['plain_ms']:.4f} ms, bytes bound "
        f"{wb[0] * 1e3:.3f} us by {wb[1]} ({wk['bytes']} B); max |diff| "
        f"{wk['err']}")


def phase8b_config4(ksp_ops, old_lib=None) -> dict:
    """Config 4 (KSP k=16 + LFA + UCMP) through `compute_routes` on the
    card, equal to the CPU path; the KSP kernels vs plain at the calls
    the path made, timed. Launch counts from 0 around the timed calls."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    t0 = time.perf_counter()
    ls, ps, ksp_nodes = config4_states()
    n_ksp = len(ksp_nodes)
    me = "bb1"
    cpu = TorchSpfSolver(device="cpu", enable_lfa=True, ksp_k=16)
    ref = cpu.compute_routes(ls, ps, me)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    solver = TorchSpfSolver(device=DEVICE, enable_lfa=True, ksp_k=16)
    run = ksp_path_run(ksp_ops, solver, ls, ps, me, reps=5)
    captured, times, launches = run["captured"], run["times"], run["launches"]
    st, phases, rdb = run["stats"], run["phases"], run["rdb"]
    if (rdb.unicast_routes != ref.unicast_routes
            or rdb.mpls_routes != ref.mpls_routes):
        fail("config 4: the RouteDatabase on the card differs from the CPU "
             "path's")
    routes = rdb.unicast_routes.values()
    n_push = sum(1 for e in routes for nh in e.nexthops
                 if nh.mpls_action is not None and nh.mpls_action.push_labels)
    n_backup = sum(1 for e in routes if e.backup_nexthops)
    n_ucmp = sum(1 for e in routes if len({nh.weight for nh in e.nexthops}) > 1)
    if not (n_push and n_backup and n_ucmp):
        fail(f"config 4: KSP PUSH nexthops {n_push}, routes with backups "
             f"{n_backup}, routes with unequal weights {n_ucmp}: each must "
             "be > 0")
    for k, n in launches.items():
        if n == 0:
            fail(f"config 4: ksp {k} kernel launched no time")
    if st["host_reads"] != st["chunks"]:
        fail(f"config 4: {st['host_reads']} KSP host reads for "
             f"{st['chunks']} chunks")

    # the kernels vs plain at the calls the path made, and their times
    fx = fixpoint_at_call(ksp_ops, captured["ksp_sssp"], old_lib)
    wk = walk_at_call(ksp_ops, captured["ksp_walk"])
    if fx["err"] or wk["err"]:
        fail(f"config 4: ksp kernels disagree with plain at the path's calls "
             f"(sssp {fx['err']}, walk {wk['err']})")
    p50 = statistics.median(times)
    log(f"[8b] config 4: {len(ls.nodes)} nodes, {len(ps.prefixes)} prefixes "
        f"({n_ksp} KSP, 32 UCMP anycast), root {me}, k=16, LFA on: "
        f"compute_routes p50 {p50:.3f} ms (samples "
        f"{[round(x, 3) for x in times]}); phases {phases}; KSP {st}; CPU "
        f"path incl. set-up {cpu_ms:.0f} ms")
    log(f"[8b] RouteDatabase on the card == CPU: {len(rdb.unicast_routes)} "
        f"unicast + {len(rdb.mpls_routes)} mpls; PUSH nexthops {n_push}, "
        f"routes with backups {n_backup}, with unequal UCMP weights {n_ucmp};"
        f" launches {launches}")
    log_ksp_run(ksp_ops, "8b", run, fx, wk)
    return {"launches": launches, "sssp": fx, "walk": wk}


def phase8d_config4_ref(ksp_ops, old_lib=None) -> dict:
    """BASELINE config 4 at the size the JAX package measured it
    (`bench_ksp_lfa.py --rings 626`: 10 016 nodes, 1 001 KSP prefixes,
    k=16, LFA on, root bb1; BASELINE.md:78) through `compute_routes` on
    the card: p50 of 3 calls, the KSP stats, CUPTI per kernel, both KSP
    kernels vs plain at the path's first calls (B = 256), the device
    fixpoint against the host-read loop. The CPU path takes minutes for
    1 001 KSP jobs, so it answers the same states with only the 16
    lowest-numbered KSP prefixes kept KSP: every route of a prefix that
    is KSP in both, or plain in both, is equal, and every KSP prefix of
    the card's RIB has a PUSH route."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    t0 = time.perf_counter()
    ls, ps, ksp_nodes = config4_states(626, 16, extras=False)
    me = "bb1"
    solver = TorchSpfSolver(device=DEVICE, enable_lfa=True, ksp_k=16)
    run = ksp_path_run(ksp_ops, solver, ls, ps, me, reps=3)
    rdb = run["rdb"]
    t_card = time.perf_counter()
    _ls, ps_sub, kept = config4_states(626, 16, extras=False, ksp_keep=16)
    ref = TorchSpfSolver(device="cpu", enable_lfa=True, ksp_k=16
                         ).compute_routes(ls, ps_sub, me)
    cpu_s = time.perf_counter() - t_card
    only_card = {f"10.{(i >> 8) & 255}.{i & 255}.0/24"
                 for i in ksp_nodes - kept}
    if set(rdb.unicast_routes) != set(ref.unicast_routes):
        fail("config 4 at 10k: the card's and the CPU's RIBs hold different "
             "prefixes")
    n_diff = sum(1 for p, e in rdb.unicast_routes.items()
                 if p.prefix not in only_card and ref.unicast_routes[p] != e)
    n_push = sum(1 for p, e in rdb.unicast_routes.items()
                 if p.prefix in only_card and any(
                     nh.mpls_action is not None and nh.mpls_action.push_labels
                     for nh in e.nexthops))
    if n_diff or rdb.mpls_routes != ref.mpls_routes:
        fail(f"config 4 at 10k: {n_diff} routes differ from the CPU path's")
    if n_push != len(only_card):
        fail(f"config 4 at 10k: {n_push} of {len(only_card)} KSP prefixes "
             "have PUSH routes")
    for k, n in run["launches"].items():
        if n == 0:
            fail(f"config 4 at 10k: ksp {k} kernel launched no time")
    st = run["stats"]
    if st["host_reads"] != st["chunks"]:
        fail(f"config 4 at 10k: {st['host_reads']} KSP host reads for "
             f"{st['chunks']} chunks")
    fx = fixpoint_at_call(ksp_ops, run["captured"]["ksp_sssp"], old_lib)
    wk = walk_at_call(ksp_ops, run["captured"]["ksp_walk"])
    if fx["err"] or wk["err"]:
        fail(f"config 4 at 10k: ksp kernels disagree with plain (sssp "
             f"{fx['err']}, walk {wk['err']})")
    p50 = statistics.median(run["times"])
    log(f"[8d] config 4 at the reference's size: {len(ls.nodes)} nodes, "
        f"{len(ksp_nodes)} KSP prefixes, root {me}, k=16, LFA on: "
        f"compute_routes p50 {p50:.3f} ms (samples "
        f"{[round(x, 3) for x in run['times']]}); phases {run['phases']}; "
        f"KSP {st}; launches {run['launches']}; equal to the CPU "
        f"path on {len(rdb.unicast_routes) - len(only_card)} routes (16 KSP), "
        f"{n_push} PUSH routes for the rest; set-up + CPU "
        f"{time.perf_counter() - t0:.1f} s (CPU {cpu_s:.1f} s)")
    log_ksp_run(ksp_ops, "8d", run, fx, wk)
    return dict(p50=p50, sssp=fx, walk=wk, stats=st,
                launches=run["launches"])


def phase8c_election(election_ops, solver, ls, csr, old_libs) -> dict:
    """The 100k RIB with 25 000 anycast /32s through `compute_routes`,
    whose election runs `elect_seg_kernel`; equal to the NumPy election's
    RIB. Launch count from 0 around the timed calls."""
    from openr_tpu_torch.utils.topogen import ramp_prefix_state

    t0 = time.perf_counter()
    ps = ramp_prefix_state(csr.node_names, 100_000, anycast_every=4)
    view = ps.election_view(csr.name_to_id, csr.base_version)
    slots = len(view.multi.adv)
    set_up = time.perf_counter() - t0
    if slots < solver.elect_device_min:
        fail(f"election: {slots} slots stay below elect_device_min")
    solver.compute_routes(ls, ps, "node-0")  # warm-up: uploads the matrix
    election_ops.reset_launches()
    dev0 = solver.elect_stats["device_elections"]
    times, elect_ms = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        rdb = solver.compute_routes(ls, ps, "node-0")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        elect_ms.append(solver.last_phase_ms["election"])
    launches = election_ops.LAUNCHES
    n_dev = solver.elect_stats["device_elections"] - dev0
    keep = solver.elect_device_min
    solver.elect_device_min = slots + 1  # the NumPy election
    try:
        ref = solver.compute_routes(ls, ps, "node-0")
    finally:
        solver.elect_device_min = keep
    if (rdb.unicast_routes != ref.unicast_routes
            or rdb.mpls_routes != ref.mpls_routes):
        fail("election: the RIB through the device election differs from "
             "the NumPy election's")
    if launches == 0 or n_dev == 0:
        fail(f"election: elect_seg_kernel launches {launches}, device "
             f"elections {n_dev}")

    # the kernel vs plain at this shape, timed, with the library call
    _c, dist, fh, _n, _l = solver.solve(ls, "node-0")
    my_id = csr.name_to_id["node-0"]
    tm = elect_at_call(election_ops, solver, view, dist, fh, my_id,
                       old_libs, "8c")
    p50 = statistics.median(times)
    cross = election_crossover(solver, csr, dist, fh.any(axis=0), my_id,
                               view)
    log(f"[8c] election at scale: er100k + ramp_prefix_state(100 000, "
        f"anycast_every=4): {len(view.plain_p)} plain + "
        f"{len(view.multi.prefixes)} anycast prefixes, {slots} advertiser "
        f"slots (set-up {set_up:.1f} s); full RIB "
        f"p50 {p50:.3f} ms (samples {[round(x, 3) for x in times]}), "
        f"election phase {[round(x, 3) for x in elect_ms]} ms; "
        f"{len(rdb.unicast_routes)} unicast routes == the NumPy "
        f"election's; device elections {n_dev}, launches {launches}")
    return dict(tm, launches=launches, crossover=cross)


def elect_at_call(election_ops, solver, view, dist, fh, my_id, old_libs,
                  tag) -> dict:
    """`elect_seg_kernel` on the solver's cached advertiser matrix of
    `view` and the solve's root column: exact against the plain version,
    timed by CUPTI (with `--old`, beside the other checkout's kernel in
    turns), the plain version and `torch.segment_reduce` max + min (the
    library yardstick) timed, and the bytes bound."""
    d_root = dist[:, 0]
    reach = (d_root < INF) & fh.any(axis=0)
    t = solver._elect_dev[view.gen]
    args = (t["indptr"], t["seg"], t["adv"], t["known"], t["rank"],
            dist.device_tensor[:, 0].contiguous(), to_dev(reach, bool), my_id)
    labels = ["new"] + (["old"] if "election" in old_libs else [])
    turns = {lb: [] for lb in labels}
    err = 0
    for lb in labels + labels[::-1]:
        with using_lib(election_ops,
                       old_libs.get("election") if lb == "old" else None):
            err = max(err, elect_vs_plain(election_ops, args))
            turns[lb].append(kernel_us(lambda: election_ops.elect_seg(*args),
                                       lambda: None, election_ops.KERNEL_NAME))
    if err:
        fail(f"election: kernel disagrees with plain at the path's shape "
             f"({err})")
    us = statistics.fmean(x for x, _by in turns["new"])
    by = timed_by(b for _x, b in turns["new"])
    p_ms = cuda_ms(lambda: election_ops.elect_seg_ref(*args))
    lengths = (t["indptr"][1:] - t["indptr"][:-1]).long()
    data_r = t["rank"].float()
    data_d = args[5][t["adv"].long()].float()
    lib_ms = cuda_ms(lambda: (
        torch.segment_reduce(data_r, "max", lengths=lengths),
        torch.segment_reduce(data_d, "min", lengths=lengths)))
    m, s = len(view.multi.prefixes), len(view.multi.adv)
    nbytes, ops = election_ops.elect_work(m, s)
    b_ms, b_by = bound(nbytes, ops)
    log(f"[{tag}] elect_seg_kernel (M {m}, S {s}): {us:.2f} us, plain "
        f"{p_ms:.4f} ms, torch.segment_reduce max+min {lib_ms:.4f} ms, bound "
        f"{b_ms * 1e3:.3f} us by {b_by} ({nbytes} B), share "
        f"{b_ms * 1e3 / us:.3f}; max |diff| vs plain {err}; CUPTI in turns "
        f"{turns}")
    return dict(us=us, timed_by=by, plain_ms=p_ms, lib_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, err=err, turns=turns)


def elections_equal(dev, ref, tag: str) -> None:
    """Two `MultiElection`s agree: every mask, and min_igp wherever a
    prefix survives."""
    for f in ("survive", "local", "is_best", "chosen"):
        if not np.array_equal(getattr(dev, f), getattr(ref, f)):
            fail(f"election at {tag}: device and NumPy differ in {f}")
    sel = ref.survive
    if not np.array_equal(dev.min_igp[sel], ref.min_igp[sel]):
        fail(f"election at {tag}: min_igp differs")


def election_crossover(solver, csr, dist, fh_any, my_id, view_100k) -> dict:
    """Host wall µs of the solver's election, on the device and in NumPy,
    at 64 to 16 384 slots (`ramp_prefix_state(n, anycast_every=4)`) and
    at [8c]'s 50 000, on the er100k solve from node-0; the two paths'
    results equal. Median of 15 calls per path, the paths in turns."""
    from openr_tpu_torch.utils.topogen import ramp_prefix_state

    keep = solver.elect_device_min
    res = {}
    try:
        for n in (128, 2048, 8192, 16384, 32768, 100_000):
            view = view_100k if n == 100_000 else ramp_prefix_state(
                csr.node_names, n, anycast_every=4).election_view(
                    csr.name_to_id, csr.base_version)
            multi, slots = view.multi, len(view.multi.adv)
            t = {"device": [], "numpy": []}
            got = {}
            for path in ("device", "numpy", "numpy", "device"):
                solver.elect_device_min = 0 if path == "device" else slots + 1
                got[path] = solver._elect_multi(multi, dist, fh_any, my_id,
                                                view.gen)  # warm-up
                for _ in range(15):
                    t0 = time.perf_counter()
                    solver._elect_multi(multi, dist, fh_any, my_id, view.gen)
                    t[path].append((time.perf_counter() - t0) * 1e6)
            elections_equal(got["device"], got["numpy"], f"{slots} slots")
            res[slots] = {k: statistics.median(v) for k, v in t.items()}
            log(f"[8c] election at {slots} slots ({len(multi.prefixes)} "
                f"prefixes): device {res[slots]['device']:.1f} us, NumPy "
                f"{res[slots]['numpy']:.1f} us (host wall, median of 30); "
                "equal")
    finally:
        solver.elect_device_min = keep
    return res


# ------------------------------------------------------------ phase 9

#: BASELINE config 2 (BASELINE.md:40, "10k-node Clos fabric, ECMP +
#: per-prefix UCMP weights") as the JAX package ran it: `fat_tree(90)`,
#: metric 10 (`benchmarks/bench_churn.py:281`); what its split tables must
#: be (checked on a CPU copy and again on the card)
CONFIG2 = dict(k=90, n_ramp=40_000, nodes=10_125, edges=729_000,
               vp=10_240, w=64, ov=(8192, 32), uniform=10, slots=20_000)


def config2_states(k: int, n_ramp: int):
    """BASELINE config 2's states: `fat_tree(k, metric=10)` as a real
    `LinkState`; one `PrefixState` with `ramp_prefix_state(names,
    n_ramp, anycast_every=4)` (every 4th /32 anycast from two nodes),
    the topology's loopbacks, and one UCMP anycast /24 per pod from its
    ToRs 0 and 1 at weights 1 and 3, all added with
    `update_prefix_db`."""
    from openr_tpu_torch.decision.linkstate import LinkState
    from openr_tpu_torch.types import IpPrefix, PrefixDatabase, PrefixEntry
    from openr_tpu_torch.utils.topogen import fat_tree, ramp_prefix_state

    adj, pfx = fat_tree(k, metric=10)
    ls = LinkState()
    for db in adj:
        ls.update_adjacency_db(db)
    names = [db.this_node_name for db in adj]
    ps = ramp_prefix_state(names, n_ramp, anycast_every=4)
    for db in pfx:
        ps.update_prefix_db(db)
    half = k // 2
    tor0 = half * half + k * half
    for pod in range(k):
        for t, w in ((0, 1), (1, 3)):
            ps.update_prefix_db(PrefixDatabase(
                this_node_name=names[tor0 + pod * half + t],
                prefix_entries=(PrefixEntry(
                    prefix=IpPrefix.make(f"20.{pod}.0.0/24"), weight=w),),
            ))
    return ls, ps


def phase9_config2(relax, election_ops, old_libs, k: int = CONFIG2["k"],
                   n_ramp: int = CONFIG2["n_ramp"]) -> dict:
    """BASELINE config 2 through `TorchSpfSolver(device="cuda")` from a
    core and an aggregation switch (both of k neighbors, B =
    pad(k + 1)): counts from 0 around each root's 5 solves and 3
    compute_routes; every relax launch generic, the election on the
    card; checked against scipy, NumPy and the CPU path. Then the generic
    kernel at the core root's three calls and the election at this
    view, timed."""
    from torch.profiler import ProfilerActivity, profile

    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.ops.spf_split import build_split_tables

    t0 = time.perf_counter()
    ls, ps = config2_states(k, n_ramp)
    csr = ls.to_csr()
    host = build_split_tables(csr.edge_src, csr.edge_dst, csr.edge_metric,
                              csr.num_nodes)
    view = ps.election_view(csr.name_to_id, csr.base_version)
    slots = len(view.multi.adv)
    got = dict(nodes=csr.num_nodes, edges=int(csr.num_edges), vp=host["vp"],
               w=host["base_nbr"].shape[1], ov=tuple(host["ov_nbr"].shape),
               uniform=host["uniform_metric"], slots=slots)
    if k == CONFIG2["k"] and n_ramp == CONFIG2["n_ramp"]:
        want = {key: CONFIG2[key] for key in got}
        if got != want:
            fail(f"config 2: states give {got}, expected {want}")
    set_up = time.perf_counter() - t0
    half = k // 2
    roots = ("node-0", f"node-{half * half}")  # a core, an aggregation
    t1 = time.perf_counter()
    cpu = TorchSpfSolver(device="cpu")
    refs = {me: cpu.compute_routes(ls, ps, me) for me in roots}
    cpu_s = time.perf_counter() - t1

    solver = TorchSpfSolver(device=DEVICE)
    tables = solver._device_arrays(csr)
    dev_shape = (tables["vp"], tables["base_nbr"].shape[1],
                 tuple(tables["ov_nbr"].shape), tables["uniform_metric"])
    if dev_shape != (got["vp"], got["w"], got["ov"], got["uniform"]):
        fail(f"config 2: device tables {dev_shape}, host copy {got}")
    mb = {name: tables[name].numel() * tables[name].element_size() / 1e6
          for name in ("base_nbr", "base_wgt", "ov_nbr", "ov_wgt")}
    if slots < solver.elect_device_min:
        fail(f"config 2: {slots} election slots stay below "
             f"elect_device_min {solver.elect_device_min}")
    log(f"[9] config 2: fat_tree({k}, metric=10): {got['nodes']} nodes, "
        f"{got['edges']} directed adjacencies; {len(ps.prefixes)} prefixes "
        f"(ramp {n_ramp} with every 4th anycast, {csr.num_nodes} loopbacks, "
        f"{k} UCMP /24s), {slots} election slots; tables vp {got['vp']}, W "
        f"{got['w']} ({mb['base_nbr'] + mb['base_wgt']:.2f} MB nbr+wgt), "
        f"overflow {got['ov']} ({mb['ov_nbr'] + mb['ov_wgt']:.2f} MB), "
        f"uniform metric {got['uniform']} (host copy and card agree); "
        f"set-up {set_up:.1f} s, CPU path's two RIBs {cpu_s:.1f} s")

    out = {"roots": {}, "generic_launches": 0, "elect_launches": 0,
           "states": (ls, ps), "ribs": {}}
    for me in roots:
        my_id = csr.name_to_id[me]
        relax.reset_launches()
        election_ops.reset_launches()
        # the warm-up solve runs eagerly (its kernels launched by their
        # wrappers); the first timed solve captures the program, which it
        # and the later ones replay
        solver._programs.clear()
        solver.solve(ls, me)  # warm-up
        dev0 = solver.elect_stats["device_elections"]
        solve_ms, rib_ms = [], []
        for _ in range(5):
            t1 = time.perf_counter()
            solved = solver.solve(ls, me)
            solve_ms.append((time.perf_counter() - t1) * 1e3)
        st = dict(solver.last_solve_stats)
        for _ in range(3):
            t1 = time.perf_counter()
            rdb = solver.compute_routes(ls, ps, me)
            torch.cuda.synchronize()
            rib_ms.append((time.perf_counter() - t1) * 1e3)
        launches = dict(relax.LAUNCHES_BY_DESIGN)
        e_launches = election_ops.LAUNCHES
        n_dev = solver.elect_stats["device_elections"] - dev0
        phases = dict(solver.last_phase_ms)
        b = solved[1].device_tensor.shape[1]
        if launches["vec"] or not launches["generic"]:
            fail(f"config 2 {me}: relax launches {launches}; every one must "
                 "be generic")
        if e_launches < 3 or n_dev < 3:
            fail(f"config 2 {me}: elect_seg_kernel launches {e_launches}, "
                 f"device elections {n_dev}, for 3 RIBs")
        ref = refs[me]
        check_solve(csr, solved, rdb, cols=3, tag=f"config 2 {me}", me=me,
                    n_routes=len(ref.unicast_routes))
        if (rdb.unicast_routes != ref.unicast_routes
                or rdb.mpls_routes != ref.mpls_routes):
            fail(f"config 2 {me}: the RouteDatabase on the card differs from "
                 "the CPU path's")
        n_ucmp = sum(1 for p, e in rdb.unicast_routes.items()
                     if p.prefix.startswith("20."))
        if n_ucmp != k:
            fail(f"config 2 {me}: {n_ucmp} UCMP /24 routes of {k}")
        _c, dist, fh, _n, _l = solved
        fh_any = fh.any(axis=0)
        keep = solver.elect_device_min
        try:
            pair = {}
            for path, floor in (("device", 0), ("numpy", slots + 1)):
                solver.elect_device_min = floor
                pair[path] = solver._elect_multi(view.multi, dist, fh_any,
                                                 my_id, view.gen)
        finally:
            solver.elect_device_min = keep
        elections_equal(pair["device"], pair["numpy"], f"config 2 {me}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            solver.solve(ls, me)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t1) * 1e3
        prof_st = dict(solver.last_solve_stats)
        k_us, k_n = kernel_device_us(prof, (relax.KERNEL_NAMES["generic"],))
        dev_us, _ = kernel_device_us(prof, ("",))
        row = dict(b=b, solve_p50=statistics.median(solve_ms),
                   rib_p50=statistics.median(rib_ms), solve_ms=solve_ms,
                   rib_ms=rib_ms, stats=st, phases=phases,
                   launches=launches, elect_launches=e_launches,
                   kernel_us=k_us, kernel_n=k_n, busy=dev_us / 1e3 / traced_ms)
        if me == roots[1]:  # the epilogue at the aggregation root's B = 128
            row["epilogue"] = epilogue_timed(*rib_arrays(solver, csr, solved,
                                                         me), f"9 {me}")
        out["roots"][me] = row
        out["ribs"][me] = rdb
        out["generic_launches"] += launches["generic"]
        out["elect_launches"] += e_launches
        log(f"[9] {me} (B={b}): solve p50 {row['solve_p50']:.3f} ms (samples "
            f"{[round(x, 3) for x in solve_ms]}); compute_routes p50 "
            f"{row['rib_p50']:.3f} ms (samples "
            f"{[round(x, 3) for x in rib_ms]}); last_phase_ms {phases}; "
            f"per solve: sweeps {st['sweeps']}, tail rounds "
            f"{st['tail_rounds']}, spilled {st['spilled']}, host syncs "
            f"{st['host_syncs']}, relax launches {st['relax_launches']}")
        log(f"[9] {me}: launches in 5 solves + 3 RIBs {launches}, "
            f"elect_seg_kernel {e_launches}; {len(rdb.unicast_routes)} "
            f"unicast + {len(rdb.mpls_routes)} mpls routes == the CPU path's "
            f"({k} UCMP); root + 2 neighbor columns vs scipy, first hops vs "
            f"NumPy, the device election == NumPy's: ok; one profiled solve "
            f"({prof_st['sweeps']} sweeps, {prof_st['tail_rounds']} tail "
            f"rounds, {traced_ms:.3f} ms): relax_generic_kernel {k_n} launches"
            f", {k_us:.1f} us (CUPTI), all kernels {dev_us:.1f} us, busy "
            f"share {row['busy']:.3f}")

    # the generic kernel at the core root's three calls, and the election
    dist_in, roots_t, calls = path_calls(solver, ls, tables, roots[0])
    variants = generic_variants(relax, old_libs)
    worst = check_calls(relax, dist_in, roots_t, calls,
                        {lb: (v[0], v[2]) for lb, v in variants.items()})
    if any(worst.values()):
        fail(f"config 2: generic kernels disagree with plain at the path's "
             f"calls ({worst})")
    log(f"[9] clocks before timing (sm MHz, W, C): "
        f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    out["calls"] = time_calls(relax, dist_in, roots_t, calls, variants, "9")
    out["worst"] = worst["generic"]
    solved = solver.solve(ls, roots[0])
    out["elect"] = elect_at_call(election_ops, solver, view, solved[1],
                                 solved[2], csr.name_to_id[roots[0]],
                                 old_libs, "9")
    return out


# ----------------------------------------------------------- phase 10

#: (V, average out-degree, extra in-edges of hub node 0) of [10a]'s
#: random edge lists: a plain graph, one whose hub run (~300 slots) is
#: just past the split threshold (`edge_relax.SEG_EDGES`, 256: two
#: segments), and one with a 4 096-edge hub run (17 segments)
EDGE_CASES = ((3000, 6, 0), (2000, 3, 300), (6000, 3, 4096))
EDGE_B = (1, 8, 32, 33, 256, 300)
#: [10a]: a graph whose row bitmap is too wide for the kernel's shared
#: memory (V past 196 480), so its rounds read and set the bits in global
#: memory; at these B
EDGE_WIDE_V = ((250_000, 3, 0), (8, 36))
#: [10a]: the fixpoint again at this tile width where B is wider (more
#: tiles, the last ragged), and capped at these round counts (an even
#: count leaves a tile's result in the first buffer, which the kernel
#: copies out)
EDGE_SMALL_TILE = 8
EDGE_CAPS = (2, 3)
#: BASELINE config 3 ("100k-node Erdős–Rényi graph, batched all-sources
#: SSSP", BASELINE.md) as `bench.py:933-954` runs it: 256 roots on the
#: er100k LSDB, `np.arange(256) % num_nodes`
CONFIG3_B = 256
#: [10c]: the fixpoint at config 3 again at this tile width, whose slabs
#: fit L2 (the rule takes 128), and, with `--old`, the parent's full round
#: at these B (the L2 sweep)
CONFIG3_NARROW_TILE = 32
OLD_ROUND_B = (16, 32, 64, 128, 256)
#: [10b]: the solves of each kind in its one profile: CUPTI drops more
#: launches late in a long run, and kept none of 4 edge solves' 8
PROFILED_CALLS = 30
#: [10b]'s table kinds: TorchSpfSolver knobs and the table each picks
TABLE_KINDS = {
    "split": ({}, "split"),
    "dense": (dict(use_dense=True), "dense"),
    "pallas": (dict(use_pallas=True), "dense"),
    "edge": (dict(use_dense=False), "edge"),
}
#: [10d]: all_sources_sssp's ER (4 000 nodes in 4 096 slots: 16 chunks of
#: 256, the last of 160 live roots) and the fleet's fat tree
#: (`benchmarks/bench_fleet.py:28,50`: k 16, metric 10, 320 nodes)
ALL_SOURCES_N = 4000
FLEET_K = 16


def edge_arrays(rng, n, deg, hub_in, over_frac=0.05):
    """A random directed edge list in the CsrGraph layout: dst-sorted,
    padded with blocked INF edges into the dead slot; parallel edges,
    unreachable nodes (the last 3), overloaded nodes and a hub (node 0,
    `hub_in` extra in-edges). Returns (src, dst, metric, over, vp) as
    NumPy arrays."""
    live = n - 3
    e = n * deg
    src = rng.integers(0, live, e)
    dst = rng.integers(0, live, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    dup = rng.random(len(src)) < 0.05
    src = np.concatenate([src, src[dup], rng.integers(1, live, hub_in)])
    dst = np.concatenate([dst, dst[dup], np.zeros(hub_in, np.int64)])
    met = rng.integers(1, 65, len(src))
    order = np.argsort(dst, kind="stable")
    vp = 1 << int(n).bit_length()
    ep = 1 << int(len(src) + 64).bit_length()
    es = np.zeros(ep, np.int32)
    ed = np.full(ep, vp - 1, np.int32)
    em = np.full(ep, INF, np.int32)
    es[: len(src)], ed[: len(src)] = src[order], dst[order]
    em[: len(src)] = met[order]
    over = np.zeros(vp, bool)
    over[rng.choice(live, max(1, int(over_frac * live)), replace=False)] = True
    return es, ed, em, over, vp


def edge_tensors(edge_ops, es, ed, em, over, vp) -> dict:
    """The edge arrays, `build_blocked`'s mask and the `EdgeIndex` on the
    card."""
    from openr_tpu_torch.ops.spf import build_blocked

    t = dict(src=to_dev(es, np.int32), dst=to_dev(ed, np.int32),
             metric=to_dev(em, np.int32),
             blocked=to_dev(build_blocked(em, es, over), np.bool_))
    index = edge_ops.device_edge_index(t["src"], t["dst"], t["metric"], vp)
    return dict(t, row_start=index.row_start, index=index)


def edge_args(t, with_blocked=True):
    keys = ("src", "dst", "metric") + (("blocked",) if with_blocked else ())
    return [t[k] for k in keys]


def plain_edge_sssp(edge_ops, t, roots, vp):
    """The reference's loop of full rounds on the plain versions, on the
    card: (dist, rounds)."""
    cur = torch.empty((vp, roots.shape[0]), dtype=torch.int32, device=DEVICE)
    nxt = torch.empty_like(cur)
    ch = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    edge_ops.edge_init_ref(cur, *edge_args(t, False), roots)
    rounds = 0
    for _ in range(vp):
        edge_ops.edge_round_ref(cur, nxt, *edge_args(t), ch)
        rounds += 1
        cur, nxt = nxt, cur
        if int(ch.item()) == 0:
            break
    return cur, rounds


def plain_marks(dist, tile: int) -> torch.Tensor:
    """The init's row marks from its result: per tile of `tile` columns,
    int32 words of the rows with a finite entry, bit v % 32 of word
    v // 32."""
    v = dist.shape[0]
    w = -(-v // 128) * 4  # `edge_relax.bitmap_words`
    words = []
    for c0 in range(0, dist.shape[1], tile):
        fin = torch.zeros(w * 32, dtype=torch.int64, device=dist.device)
        fin[:v] = (dist[:, c0 : c0 + tile] < INF).any(1).long()
        shift = torch.arange(32, device=dist.device, dtype=torch.int64)
        x = (fin.view(w, 32) << shift).sum(1)
        words.append(torch.where(x >= 1 << 31, x - (1 << 32), x))
    return torch.cat(words).to(torch.int32)


def edge_init_vs_plain(edge_ops, t, roots, vp, tile) -> int:
    """The init kernel against `edge_init_ref` on [vp, B rounded up to
    4] (padding columns INF), its row marks against `plain_marks`: max
    |diff|."""
    bp = -(-roots.shape[0] // 4) * 4
    k = torch.full((vp, bp), -7, dtype=torch.int32, device=DEVICE)
    p = torch.empty_like(k)
    marks = torch.full((-(-bp // tile) * edge_ops.bitmap_words(vp),), -1,
                       dtype=torch.int32, device=DEVICE)
    edge_ops.edge_init(k, *edge_args(t, False), roots, t["index"], tile,
                       marks)
    edge_ops.edge_init_ref(p, *edge_args(t, False), roots)
    torch.cuda.synchronize()
    return max_diff([(k, p), (marks, plain_marks(p, tile))])


def edge_rounds_vs_plain(edge_ops, t, roots, vp, rounds: int = 2) -> int:
    """`rounds` single full rounds from the init, the kernel capped at
    one round against `edge_round_ref` on the same inputs (dist and the
    changed word): max |diff|."""
    bp = -(-roots.shape[0] // 4) * 4
    cur = torch.empty((vp, bp), dtype=torch.int32, device=DEVICE)
    edge_ops.edge_init_ref(cur, *edge_args(t, False), roots)
    pairs = []
    for _ in range(rounds):
        outs = []
        for fn, extra in ((edge_ops.edge_round, (t["row_start"],)),
                          (edge_ops.edge_round_ref, ())):
            out = torch.full_like(cur, -7)
            ch = torch.full((1,), 5, dtype=torch.int32, device=DEVICE)
            fn(cur, out, *edge_args(t), *extra, ch,
               **({"index": t["index"]} if extra else {}))
            outs.append((out, ch))
        pairs += [(outs[0][0], outs[1][0]), (outs[0][1], outs[1][1])]
        cur = outs[1][0]
    torch.cuda.synchronize()
    return max_diff(pairs)


def edge_guarded_vs_plain(edge_ops, t, roots, vp) -> int:
    """The guarded one-round kernel (the sharded loop's,
    `edge_round(ctl=...)`) from the init: live against `edge_round_ref`
    (dist and the changed word), and done, when it must leave out and
    changed as they were: max |diff|."""
    from openr_tpu_torch.ops import split_loop

    bp = -(-roots.shape[0] // 4) * 4
    cur = torch.empty((vp, bp), dtype=torch.int32, device=DEVICE)
    edge_ops.edge_init_ref(cur, *edge_args(t, False), roots)
    pairs = []
    for done in (False, True):
        ctl = split_loop.new_ctl(split_loop.NET, 0, 0, vp, DEVICE)
        if done:
            ctl[split_loop.PHASE] = split_loop.DONE
        out = torch.full_like(cur, -7)
        ch = torch.full((1,), 5, dtype=torch.int32, device=DEVICE)
        edge_ops.edge_round(cur, out, *edge_args(t), t["row_start"], ch,
                            index=t["index"], ctl=ctl,
                            phase_mask=1 << split_loop.NET)
        want, want_ch = torch.full_like(cur, -7), ch.clone().fill_(5)
        if not done:
            edge_ops.edge_round_ref(cur, want, *edge_args(t), want_ch)
        pairs += [(out, want), (ch, want_ch)]
    torch.cuda.synchronize()
    return max_diff(pairs)


def edge_fix_vs_plain(edge_ops, t, roots, vp, tile, cap=None) -> int:
    """The init and the fixpoint launch at tile width `tile` (capped at
    `cap` rounds) against `batched_sssp_ref` at the same tiles: max
    |diff| of dist; fails on a different round count or gathered-edge
    count."""
    got, st = edge_ops._solve_cuda(*edge_args(t), roots, vp, t["index"],
                                   tile, max_rounds=cap)
    ref_st = {}
    ref = edge_ops.batched_sssp_ref(*edge_args(t), roots, vp, tile,
                                    edge_ops.walked_slots(t["index"]),
                                    max_rounds=cap, stats=ref_st)
    rounds, _last, gathered = st.tolist()
    if (rounds, gathered) != (ref_st["rounds"], ref_st["gathered_edges"]):
        fail(f"phase 10a: kernel rounds {rounds}, gathered {gathered}; plain "
             f"{ref_st['rounds']}, {ref_st['gathered_edges']} (V {vp}, B "
             f"{roots.shape[0]}, tile {tile}, cap {cap})")
    return max_diff([(got, ref)])


def phase10a_edge(edge_ops) -> dict:
    """`csrc/edge_relax.cu` against its plain versions on random edge
    lists (padding, parallel edges, unreachable and overloaded nodes,
    overloaded and repeated roots, a hub run past the split threshold and
    a 4 096-edge one) at every B of EDGE_B: the init with its row marks,
    single full rounds, and the fixpoint (the rule's tiles, tiles of
    EDGE_SMALL_TILE, and capped at EDGE_CAPS rounds) with its round and
    gathered-edge counts; `batched_sssp` with one host read and the
    reference loop's round count."""
    rng = np.random.default_rng(10)
    worst, cases, segs = 0, 0, []
    wide, wide_b = EDGE_WIDE_V
    for (n, deg, hub), widths in [(c, EDGE_B) for c in EDGE_CASES] + [
            (wide, wide_b)]:
        es, ed, em, over, vp = edge_arrays(rng, n, deg, hub)
        t = edge_tensors(edge_ops, es, ed, em, over, vp)
        segs.append(int(t["index"].seg_node.shape[0]))
        for b in widths:
            r = rng.integers(0, n, b).astype(np.int32)
            if b >= 3:
                r[1] = r[0]  # repeated
                r[2] = np.flatnonzero(over)[0]  # overloaded
            if hub and b >= 4:
                r[3] = 0  # the hub itself
            roots = to_dev(r, np.int32)
            tile = edge_ops.tile_cols(b)
            worst = max(worst, edge_init_vs_plain(edge_ops, t, roots, vp,
                                                  tile),
                        edge_rounds_vs_plain(edge_ops, t, roots, vp),
                        edge_guarded_vs_plain(edge_ops, t, roots, vp))
            runs = [(tile, None)] + [(tile, c) for c in EDGE_CAPS]
            if b > EDGE_SMALL_TILE:
                runs.append((EDGE_SMALL_TILE, None))
            for tl, cap in runs:
                worst = max(worst, edge_fix_vs_plain(edge_ops, t, roots, vp,
                                                     tl, cap))
            st = {}
            got = edge_ops.batched_sssp(*edge_args(t), roots, vp, stats=st,
                                        index=t["index"])
            ref, ref_rounds = plain_edge_sssp(edge_ops, t, roots, vp)
            worst = max(worst, max_diff([(got, ref)]))
            if st["rounds"] != ref_rounds or st["host_reads"] != 1:
                fail(f"phase 10a: {st['rounds']} kernel rounds and "
                     f"{st['host_reads']} host reads, {ref_rounds} rounds "
                     f"of the reference loop (V {n}, B {b})")
            if not bool((ref == INF).any()):
                fail("phase 10a: no unreachable entry in the check")
            cases += 1
    log(f"[10a] edge_init_kernel / edge_relax_kernel vs plain: {cases} "
        f"cases (V {[c[0] for c in EDGE_CASES]}, hub runs "
        f"{[c[2] for c in EDGE_CASES]}, segments {segs}, B {EDGE_B}; V "
        f"{wide[0]}, its bitmaps in global memory, B {wide_b}): the "
        f"init with its row marks, 2 full rounds, the guarded one-round "
        f"kernel live (== the twin) and done (out and changed untouched), "
        f"the fixpoint at the "
        f"rule's tiles, at tiles of {EDGE_SMALL_TILE} and capped at "
        f"{EDGE_CAPS} rounds, rounds and gathered edges equal, "
        f"batched_sssp with 1 host read and the reference loop's rounds; "
        f"max |diff| {worst}")
    if worst:
        fail(f"phase 10a: edge kernels disagree with plain ({worst})")
    return dict(worst=worst, cases=cases)


def scipy_columns(csr, roots) -> np.ndarray:
    """[len(roots), num_nodes] scipy Dijkstra distances on `csr`'s live
    edges, INF for unreachable (no overloaded node)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    n, e = csr.num_nodes, int(csr.num_edges)
    g = csr_matrix((csr.edge_metric[:e].astype(np.float64),
                    (csr.edge_src[:e], csr.edge_dst[:e])), shape=(n, n))
    d = dijkstra(g, directed=True, indices=list(roots))
    return np.where(np.isinf(d), INF, d).astype(np.int64)


def phase10b_config3(relax, edge_ops, ls, ps, csr, rdb_split,
                     b: int = CONFIG3_B) -> dict:
    """BASELINE config 3 at full width: `_solve_dist(csr, arange(256) %
    V)` on every table kind, counts from 0 around each kind's run and
    around an edge-table compute_routes; the four dist matrices equal,
    three columns equal scipy, the edge RIB equal to [4]'s split RIB;
    per kind p50 of 3 calls, sources/s, sweeps or rounds, host reads,
    launches, CUPTI per kernel and peak device memory."""
    from torch.profiler import ProfilerActivity, profile

    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    n = csr.num_nodes
    roots = (np.arange(b) % n).astype(np.int32)
    names = (relax.KERNEL_NAMES["vec"], relax.KERNEL_NAMES["generic"],
             edge_ops.KERNEL_NAMES["init"], edge_ops.KERNEL_NAMES["round"])
    dense_design = relax.design_for(csr.dense_width(), b)
    rows, live = {}, {}
    for kind, (knobs, table) in TABLE_KINDS.items():
        solver = TorchSpfSolver(device=DEVICE, **knobs)
        if solver._pick_table(csr) != table:
            fail(f"config 3 {kind}: picked {solver._pick_table(csr)}, "
                 f"expected {table}")
        torch.cuda.synchronize()
        relax.reset_launches()
        edge_ops.reset_launches()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        d = solver._solve_dist(csr, roots)  # warm-up: builds the tables
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        times, calls_st = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            d = solver._solve_dist(csr, roots)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            calls_st.append(dict(solver.last_solve_stats))
        st = dict(solver.last_solve_stats)
        peak = torch.cuda.max_memory_allocated()
        before = kernel_launches(relax, edge_ops)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_CALLS):
                solver._solve_dist(csr, roots)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        after = kernel_launches(relax, edge_ops)
        kind_launches = dict(relax=dict(relax.LAUNCHES_BY_DESIGN),
                             edge=dict(edge_ops.LAUNCHES))
        if table == "split":
            want = sum(kind_launches["relax"].values())
        elif table == "edge":
            want = min(kind_launches["edge"].values())
        else:
            want = kind_launches["relax"][dense_design]
        if not want:
            fail(f"config 3 {kind}: launches {kind_launches}: a kernel of "
                 "its path was launched no time")
        if table == "edge" and st["host_reads"] != 1:
            fail(f"config 3 edge: {st['host_reads']} host reads a solve, "
                 "not 1")
        per = {nm: kernel_device_us(prof, (nm,)) for nm in names}
        launched = {nm: after[nm] - before[nm] for nm in names}
        busy = busy_share(prof, per, launched, traced_ms)
        live[kind] = d[:n].clone()
        if table == "split":
            from openr_tpu_torch.monitor.profiling import annotate

            def traced_call():
                with annotate("chip_smoke:config3_split"):
                    solver._solve_dist(csr, roots)
                    torch.cuda.synchronize()

            idle, span = trace_idle_share(traced_call,
                                          "chip_smoke:config3_split")
            log(f"[10b] config 3 split per call: host syncs "
                f"{[x['host_syncs'] for x in calls_st]}, replays "
                f"{[x['replays'] for x in calls_st]}, steps "
                f"{[x['steps'] for x in calls_st]}, useful relax launches "
                f"{[x['relax_launches'] for x in calls_st]}, graph nodes "
                f"{st['graph_nodes']}; device-idle share of one traced call "
                f"{'not measured' if idle is None else round(idle, 4)} over "
                f"its {span:.3f} ms span (profiling.trace)")
        p50 = statistics.median(times)
        rows[kind] = dict(
            rows=int(d.shape[0]), p50_ms=p50, times=times, first_ms=first_ms,
            sources_per_s=b / (p50 / 1e3), stats=st,
            kernels={nm: (v[0], v[1], launched[nm])
                     for nm, v in per.items() if launched[nm] or v[1]},
            busy=busy,
            peak_bytes=peak,
            peak_over_base=peak - base, launches=kind_launches,
        )
        del solver, d
    ref = live["split"]
    for kind, d in live.items():
        if not torch.equal(d, ref):
            bad = int((d != ref).sum().item())
            fail(f"config 3: the {kind} distances differ from split's at "
                 f"{bad} entries")
    cols = (0, b // 2, b - 1)
    want = scipy_columns(csr, roots[list(cols)])
    got = ref[:, list(cols)].T.long().cpu().numpy()
    if not np.array_equal(got, want):
        fail("config 3: distances disagree with scipy dijkstra")
    from openr_tpu_torch.ops import rib_epilogue

    # the dense- and edge-table RIBs, through kernel C; counts from 0
    # around each RIB
    epi = {}
    for kind, use_dense in (("dense", True), ("edge", False)):
        rib_solver = TorchSpfSolver(device=DEVICE, use_dense=use_dense)
        edge_ops.reset_launches()
        epi0 = rib_epilogue.LAUNCHES
        rdb = rib_solver.compute_routes(ls, ps, "node-0")
        torch.cuda.synchronize()
        epi[kind] = rib_epilogue.LAUNCHES - epi0
        if kind == "edge":
            rib_stats = dict(rib_solver.last_solve_stats)
            rib_launches = dict(edge_ops.LAUNCHES)
        if (rdb.unicast_routes != rdb_split.unicast_routes
                or rdb.mpls_routes != rdb_split.mpls_routes):
            fail(f"config 3: the {kind}-table RouteDatabase differs from the "
                 "split path's")
        if epi[kind] != 1:
            fail(f"config 3: the {kind}-table RIB launched "
                 f"rib_epilogue_kernel {epi[kind]} times, not once")
        solved = rib_solver.solve(ls, "node-0")
        check_solve(csr, solved, rdb, cols=3, tag=f"config 3 {kind} RIB")
        if kind == "dense":  # the epilogue at vp 131 072, its main shape
            epi["timing"] = epilogue_timed(
                *rib_arrays(rib_solver, csr, solved, "node-0"), "10b")
        del rib_solver, solved
    if not all(rib_launches.values()):
        fail(f"config 3: edge launches {rib_launches} in the edge-table "
             "RIB: a kernel of the path was launched no time")
    # the kernels line's launches: kernel A's dense design in the dense
    # and use_pallas kinds, the edge kernels in the edge kind and its RIB
    dense_launches = sum(rows[k]["launches"]["relax"][dense_design]
                         for k in ("dense", "pallas"))
    e_launches = {st: rows["edge"]["launches"]["edge"][st] + n
                  for st, n in rib_launches.items()}
    card = smi("name,power.limit")
    for kind, r in rows.items():
        st = r["stats"]
        steps = (f"sweeps {st['sweeps']}" if "sweeps" in st
                 else f"rounds {st['rounds']} ({st['tiles']} tiles of "
                 f"{st['tile_cols']} columns, {st['gathered_edges']} "
                 "gathered edges)")
        reads = st.get("host_reads", st.get("host_syncs"))
        # a replayed split call launches through its graph: no wrapper
        # counts it, CUPTI does
        kern = "; ".join(f"{nm} {v[1]} kept by CUPTI ({v[2]} launched by "
                         "its wrapper), "
                         + (f"{v[0] / v[1]:.2f} us each" if v[1]
                            else "not measured")
                         for nm, v in r["kernels"].items())
        log(f"[10b] config 3 {kind} ({TABLE_KINDS[kind][1]} tables, "
            f"{r['rows']} rows x {b}): p50 {r['p50_ms']:.3f} ms (samples "
            f"{[round(x, 3) for x in r['times']]}, first call with the "
            f"table build {r['first_ms']:.1f} ms); sources/s "
            f"{r['sources_per_s']:.1f}; {steps}, host reads {reads}; "
            f"wrapper launches in its {4 + PROFILED_CALLS} calls (a "
            f"replayed split call's not among them) {r['launches']}; "
            f"CUPTI ({PROFILED_CALLS} calls in one profile): "
            f"{kern or 'not measured'}; busy share "
            f"{'not measured' if r['busy'] is None else round(r['busy'], 3)}"
            "; peak "
            f"device memory {r['peak_bytes'] / 2**20:.1f} MiB "
            f"({r['peak_over_base'] / 2**20:.1f} MiB over the run's "
            f"{(r['peak_bytes'] - r['peak_over_base']) / 2**20:.1f}); "
            f"card {card}")
    log(f"[10b] config 3: the four kinds' {n} x {b} distances equal; "
        f"columns {cols} == scipy; the dense and edge RIBs (the edge "
        f"solve {rib_stats}, edge launches {rib_launches}) == [4]'s split "
        f"RIB ({len(rdb.unicast_routes)} unicast + {len(rdb.mpls_routes)} "
        f"mpls), their root and 2 neighbour columns == scipy and first "
        f"hops == NumPy's, rib_epilogue_kernel launched once a RIB "
        f"({ {k: epi[k] for k in ('dense', 'edge')} }); {dense_design} "
        f"launches in the dense + pallas kinds {dense_launches}, edge "
        f"launches in the edge kind + its RIB {e_launches}")
    return dict(rows=rows, dense_launches=dense_launches,
                edge_launches=e_launches, roots=roots, epilogue=epi)


def kernel_launches(relax, edge_ops) -> dict:
    """The wrappers' launch counts, by kernel name."""
    return {relax.KERNEL_NAMES[d]: n
            for d, n in relax.LAUNCHES_BY_DESIGN.items()} | {
        edge_ops.KERNEL_NAMES[st]: n for st, n in edge_ops.LAUNCHES.items()}


def busy_share(prof, per, launched, traced_ms) -> float | None:
    """The device's busy share of a profiled window of `traced_ms`: every
    kernel CUPTI kept, plus, for each named kernel of `per` ((µs, kept)
    by name) of which CUPTI kept fewer than the wrappers `launched`, its
    mean kept time for each launch it dropped. None where a named kernel
    was launched and CUPTI kept none of it."""
    dev_us, _ = kernel_device_us(prof, ("",))
    for nm, (us, kept) in per.items():
        if launched[nm] and not kept:
            return None
        if kept:
            dev_us += us / kept * max(0, launched[nm] - kept)
    return dev_us / 1e3 / traced_ms


#: The C entry points of csrc/edge_relax.cu's round design (an init
#: launch, then a launch a round whose changed word the host reads back),
#: for an `--old` checkout that has it
ROUND_EDGE_ENTRY_POINTS = {
    "openr_edge_init": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p], ctypes.c_int),
    "openr_edge_relax": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p] * 2, ctypes.c_int),
    "openr_edge_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def old_edge_call(lib, name, *args) -> None:
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the --old {name} failed: "
             f"{lib.openr_edge_error_string(err).decode()} ({err})")


def old_edge_init(lib, out, t, roots) -> None:
    old_edge_call(lib, "openr_edge_init", out.data_ptr(),
                  t["row_start"].data_ptr(), t["src"].data_ptr(),
                  t["metric"].data_ptr(), roots.data_ptr(), *out.shape)


def old_edge_round(lib, din, dout, t, changed) -> None:
    old_edge_call(lib, "openr_edge_relax", din.data_ptr(), dout.data_ptr(),
                  t["row_start"].data_ptr(), t["src"].data_ptr(),
                  t["metric"].data_ptr(), t["blocked"].data_ptr(),
                  *din.shape, changed.data_ptr())


def old_edge_solve(lib, t, roots, vp):
    """The round design's `batched_sssp` through its own C entry points
    (an `--old` library): the init,
    then a launch a round, the changed word read back after each:
    (dist, rounds)."""
    cur = torch.empty((vp, roots.shape[0]), dtype=torch.int32, device=DEVICE)
    nxt = torch.empty_like(cur)
    ch = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    old_edge_init(lib, cur, t, roots)
    rounds = 0
    for _ in range(vp):
        old_edge_round(lib, cur, nxt, t, ch)
        rounds += 1
        cur, nxt = nxt, cur
        if int(ch.item()) == 0:
            break
    return cur, rounds


def profiled_us(fn, names, launches: int) -> float | None:
    """CUPTI µs of the kernels named `names` in one profiled call of
    `fn`, which launches them `launches` times; a profile that kept
    fewer is taken again, up to 3; None if none kept them all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us, count = kernel_device_us(prof, names)
        if count == launches:
            return us
    return None


def state_after(edge_ops, t, roots, vp, rounds: int = 3):
    """The init and `rounds` full rounds on the plain versions."""
    cur = torch.empty((vp, roots.shape[0]), dtype=torch.int32, device=DEVICE)
    nxt = torch.empty_like(cur)
    ch = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    edge_ops.edge_init_ref(cur, *edge_args(t, False), roots)
    for _ in range(rounds):
        edge_ops.edge_round_ref(cur, nxt, *edge_args(t), ch)
        cur, nxt = nxt, cur
    return cur


def fix_at(edge_ops, t, rt, v, tile) -> dict:
    """The init and the fixpoint launch at config 3's call with tiles of
    `tile` columns: the result, its stats, and the fixpoint launch's
    time (CUPTI; buf0 restored to the init before each launch)."""
    b = rt.shape[0]
    start = torch.empty((v, b), dtype=torch.int32, device=DEVICE)
    marks = torch.empty(-(-b // tile) * edge_ops.bitmap_words(v),
                        dtype=torch.int32, device=DEVICE)
    edge_ops.edge_init(start, *edge_args(t, False), rt, t["index"], tile,
                       marks)
    buf0, buf1 = torch.empty_like(start), torch.empty_like(start)
    fargs = (t["src"], t["metric"], t["blocked"], t["index"], tile, marks, v)
    buf0.copy_(start)
    st = edge_ops._fix(buf0, buf1, *fargs).tolist()
    res = buf1.clone()
    us, by = kernel_us(lambda: edge_ops._fix(buf0, buf1, *fargs),
                       lambda: buf0.copy_(start),
                       edge_ops.KERNEL_NAMES["round"])
    return dict(dist=res, rounds=st[0], gathered=st[2], us=us, timed_by=by,
                tile=tile)


def phase10c_kernels_at_config3(relax, edge_ops, csr, roots,
                                old_lib=None, p50_ms=None) -> dict:
    """The edge kernels and the dense sweep of kernel A at config 3's
    calls: the init, one full round (the fixpoint kernel capped at one
    round, every row marked) at the state after the init and 3 rounds,
    and the whole solve (init, then the fixpoint launch), each exact
    against its plain version, timed (CUPTI) with its bound (the whole
    solve's also as a share of `p50_ms`, [10b]'s edge p50); the fixpoint
    at CONFIG3_NARROW_TILE columns too; with `old_lib` (the
    round design's `edge_relax.cu`, through its own C entry points) its
    init, its round and its whole solve (a launch a round, a host read
    each) at the same calls, in turns with this checkout's (old, new,
    new, old), and its round at the widths of OLD_ROUND_B; kernel A's
    dense sweep after 3 sweeps."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    v, b = csr.padded_nodes, roots.shape[0]
    rt = to_dev(roots, np.int32)
    t = edge_tensors(edge_ops, csr.edge_src, csr.edge_dst, csr.edge_metric,
                     csr.node_overloaded, v)
    tile = edge_ops.tile_cols(b)
    out = {}
    # ---- edge_init_kernel ------------------------------------------------
    err_init = edge_init_vs_plain(edge_ops, t, rt, v, tile)
    k0 = torch.empty((v, b), dtype=torch.int32, device=DEVICE)
    marks = torch.empty(-(-b // tile) * edge_ops.bitmap_words(v),
                        dtype=torch.int32, device=DEVICE)
    us, by = kernel_us(lambda: edge_ops.edge_init(
        k0, *edge_args(t, False), rt, t["index"], tile, marks), lambda: None,
        edge_ops.KERNEL_NAMES["init"])
    p0 = torch.empty_like(k0)
    p_ms = cuda_ms(lambda: edge_ops.edge_init_ref(p0, *edge_args(t, False),
                                                  rt))
    nbytes, ops = edge_ops.init_work(t["index"], v, b, tile, rt)
    b_ms, b_by = bound(nbytes, ops)
    out["init"] = dict(us=us, timed_by=by, plain_ms=p_ms, bound_ms=b_ms,
                       bound_by=b_by, err=err_init, bytes=nbytes, ops=ops)
    # ---- one full round from the state after 3 rounds --------------------
    cur = state_after(edge_ops, t, rt, v)
    ko, po = torch.empty_like(cur), torch.empty_like(cur)
    kc = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    pc = torch.zeros_like(kc)
    edge_ops.edge_round(cur, ko, *edge_args(t), t["row_start"], kc,
                        index=t["index"])
    edge_ops.edge_round_ref(cur, po, *edge_args(t), pc)
    err_round = max_diff([(ko, po), (kc, pc)])
    lowered = int((po < cur).sum().item())
    us, by = kernel_us(lambda: edge_ops.edge_round(
        cur, ko, *edge_args(t), t["row_start"], kc, index=t["index"]),
        lambda: None, edge_ops.KERNEL_NAMES["round"])
    p_ms = cuda_ms(lambda: edge_ops.edge_round_ref(cur, po, *edge_args(t),
                                                   pc))
    nbytes, ops, gath = edge_ops.round_work(t["src"], t["blocked"],
                                            t["index"], v, b)
    round_ms, b_by = bound(nbytes, ops)
    out["round"] = dict(us=us, timed_by=by, plain_ms=p_ms, bound_ms=round_ms,
                        bound_by=b_by, err=err_round, bytes=nbytes, ops=ops,
                        gather=gath, lowered=lowered)
    # ---- the whole solve: the init, then the fixpoint launch --------------
    ref_st = {}
    t0 = time.perf_counter()
    ref = edge_ops.batched_sssp_ref(*edge_args(t), rt, v, tile,
                                    edge_ops.walked_slots(t["index"]),
                                    stats=ref_st)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    fx = fix_at(edge_ops, t, rt, v, tile)
    narrow = fix_at(edge_ops, t, rt, v, CONFIG3_NARROW_TILE)
    if (fx["rounds"], fx["gathered"]) != (ref_st["rounds"],
                                          ref_st["gathered_edges"]):
        fail(f"phase 10c: the fixpoint's rounds / gathered edges "
             f"{fx['rounds']} / {fx['gathered']}, plain {ref_st['rounds']} "
             f"/ {ref_st['gathered_edges']}")
    err_fix = max_diff([(fx["dist"], ref), (narrow["dist"], ref)])
    rounds = fx["rounds"]
    f_bytes, f_ops = edge_ops.fix_work(t["src"], t["blocked"], t["index"],
                                       v, ref)
    fix_bound, f_by = bound(f_bytes, f_ops)
    out["fix"] = dict(us=fx["us"], timed_by=fx["timed_by"], plain_ms=ref_ms,
                      bound_ms=fix_bound, bound_by=f_by, err=err_fix,
                      bytes=f_bytes, ops=f_ops,
                      gather=fx["gathered"] * tile * 4, rounds=rounds,
                      gathered=fx["gathered"], tile=tile)
    solve_us = out["init"]["us"] + fx["us"]
    # the whole solve, roots to result: no start matrix to read
    r_bytes, r_ops = edge_ops.root_work(t["index"], rt)
    solve_bytes, solve_ops = f_bytes - v * b * 4 + r_bytes, f_ops + r_ops
    solve_bound, solve_by = bound(solve_bytes, solve_ops)
    # ---- the --old kernels, in turns with this checkout's -------------------
    old = None
    if old_lib is not None:
        old = dict(init=[], round=[], solve=[], solve_dev=[], new_solve=[],
                   sweep={})
        ok0 = torch.empty_like(k0)
        oko = torch.empty_like(cur)
        och = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        old_edge_init(old_lib, ok0, t, rt)
        old_edge_round(old_lib, cur, oko, t, och)
        od, o_rounds = old_edge_solve(old_lib, t, rt, v)
        err_old = max_diff([(ok0, p0), (oko, po), (od, ref)])
        if err_old or o_rounds != rounds:
            fail(f"phase 10c: the --old kernels disagree ({err_old}, rounds "
                 f"{o_rounds} against {rounds})")
        edge_names = tuple(edge_ops.KERNEL_NAMES.values())

        def new_solve():
            edge_ops._solve_cuda(*edge_args(t), rt, v, t["index"], tile)

        for lb in ("old", "new", "new", "old"):
            if lb == "new":
                old["new_solve"].append(wall_ms(new_solve))
                continue
            old["init"].append(kernel_us(
                lambda: old_edge_init(old_lib, ok0, t, rt), lambda: None,
                edge_ops.KERNEL_NAMES["init"])[0])
            old["round"].append(kernel_us(
                lambda: old_edge_round(old_lib, cur, oko, t, och),
                lambda: None, edge_ops.KERNEL_NAMES["round"])[0])
            old["solve"].append(wall_ms(
                lambda: old_edge_solve(old_lib, t, rt, v)))
            old["solve_dev"].append(profiled_us(
                lambda: old_edge_solve(old_lib, t, rt, v), edge_names,
                1 + rounds))
        for ob in OLD_ROUND_B:
            r_b = to_dev(np.arange(ob, dtype=np.int32), np.int32)
            s_b = state_after(edge_ops, t, r_b, v)
            o_b = torch.empty_like(s_b)
            us_b, _by = kernel_us(
                lambda: old_edge_round(old_lib, s_b, o_b, t, och),
                lambda: None, edge_ops.KERNEL_NAMES["round"])
            old["sweep"][ob] = us_b
            del s_b, o_b
    # ---- kernel A's dense sweep (W = D, B = 256) ---------------------------
    solver = TorchSpfSolver(device=DEVICE, use_dense=True)
    tab = solver._device_arrays(csr, "dense")
    nbr, wgt = tab["nbr"], tab["wgt"]
    dist = torch.full((v, b), INF, dtype=torch.int32, device=DEVICE)
    dist[rt.long(), torch.arange(b, device=DEVICE)] = 0
    for _ in range(3):
        dist, _c = relax.relax_sweep(dist, nbr, wgt, rt, None)
    kw = dict(row0=0, n=v)
    zero_flags = torch.zeros(v, dtype=torch.int32, device=DEVICE)
    err_a, _newly = compare(relax.relax_rows, relax, dist, dist, nbr, wgt,
                            rt, None, zero_flags, **kw)
    work = dist.clone()
    chg = torch.zeros(1, dtype=torch.int32, device=DEVICE)

    def restore():
        work.copy_(dist)

    design = relax.design_for(nbr.shape[1], b)
    us, by = kernel_us(lambda: relax.relax_rows(dist, work, nbr, wgt, rt,
                                                None, changed=chg, **kw),
                       restore, relax.KERNEL_NAMES[design])
    p_ms = cuda_ms(lambda: relax.relax_rows_ref(dist, work, nbr, wgt, rt,
                                                None, changed=chg, **kw))
    _n, nbytes, ops, l2 = relax.launch_work(nbr, wgt, b, **kw)
    b_ms, b_by = bound(nbytes, ops)
    out["dense"] = dict(us=us, timed_by=by, plain_ms=p_ms, bound_ms=b_ms,
                        bound_by=b_by, err=err_a, bytes=nbytes, ops=ops,
                        gather=l2, design=design, w=int(nbr.shape[1]))
    card = smi("name,power.limit")
    for kind, r in out.items():
        extra = (f", gathers {r['gather']} B "
                 f"({r['gather'] / r['us'] / 1e6:.2f} TB/s)"
                 if r.get("gather") else "")
        label = {"round": "full round", "fix": "fixpoint launch"}.get(kind,
                                                                      kind)
        log(f"[10c] config 3 {label} call (B {b}"
            + (f", W {r['w']}, {r['design']}" if kind == "dense" else "")
            + (f", {r['lowered']} entries lowered" if kind == "round" else "")
            + (f", {r['rounds']} rounds in tiles of {r['tile']}, "
               f"{r['gathered']} gathered edges" if kind == "fix" else "")
            + f"): {r['us']:.2f} us ({r['timed_by']}); bound "
            f"{r['bound_ms'] * 1e3:.3f} "
            f"us by {r['bound_by']} ({r['bytes']} B, {r['ops']} int ops; "
            f"share {r['bound_ms'] * 1e3 / r['us']:.3f}){extra}; plain "
            f"{r['plain_ms']:.3f} ms; max |diff| {r['err']}; card {card}")
        if r["err"]:
            fail(f"phase 10c: the {kind} call disagrees with plain "
                 f"({r['err']})")
    fx_r = out["fix"]
    log(f"[10c] config 3 fixpoint launch beside its bound: the Jacobi "
        f"design's floor, {rounds} rounds x a full round's bound "
        f"{round_ms * 1e3:.3f} us = {rounds * round_ms * 1e3:.3f} us "
        f"(share {rounds * round_ms * 1e3 / fx_r['us']:.3f}); the skip "
        f"gathered {fx_r['gather']} B, {fx_r['gather'] / (rounds * gath):.3f}"
        f" of {rounds} full rounds' {rounds * gath} B")
    share = (f"; {solve_us / 1e3 / p50_ms:.3f} of [10b]'s edge p50 "
             f"{p50_ms:.3f} ms" if p50_ms else "")
    log(f"[10c] config 3 whole edge solve (init + fixpoint launch): "
        f"{solve_us:.2f} us of device time{share}; bound "
        f"{solve_bound * 1e3:.3f} us by {solve_by} ({solve_bytes} B, "
        f"{solve_ops} int ops: the result written once, the edges and the "
        f"roots' out-edges read once); share "
        f"{solve_bound * 1e3 / solve_us:.3f}; card {card}")
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    log(f"[10c] config 3 fixpoint launch by tile width: the rule's {tile} "
        f"columns {fx['us']:.2f} us against {narrow['tile']} columns "
        f"{narrow['us']:.2f} us ({narrow['timed_by']}; {narrow['rounds']} "
        f"rounds, {narrow['gathered']} gathered edges, slab "
        f"{v * narrow['tile'] * 4 / l2:.3f} of L2 {l2} B), "
        f"{narrow['us'] / fx['us']:.3f}x")
    if old is not None:
        mean = statistics.mean

        def dev_ratio():  # this checkout's: its two kernels' CUPTI means
            o = [x for x in old["solve_dev"] if x is not None]
            return (f"{mean(o) / solve_us:.3f}x" if o
                    else "not measured (CUPTI dropped launches)")

        log(f"[10c] the --old edge_relax.cu in turns (old, new, new, old): "
            f"init {[round(x, 2) for x in old['init']]} us against "
            f"{out['init']['us']:.2f}; full round "
            f"{[round(x, 2) for x in old['round']]} us against "
            f"{out['round']['us']:.2f}; whole solve wall "
            f"{[round(x, 3) for x in old['solve']]} ms (device, one "
            f"profiled solve each: {old['solve_dev']} us) against "
            f"{[round(x, 3) for x in old['new_solve']]} ms (device "
            f"{solve_us:.2f} us, its init and fixpoint launch above): "
            f"{mean(old['solve']) / mean(old['new_solve']):.3f}x by wall, "
            f"{dev_ratio()} by device time; card {card}")
        log("[10c] the --old full round by B (state after 3 rounds): "
            + "; ".join(f"B {ob}: {us_b:.2f} us ({us_b / ob:.3f} us a "
                        "column)" for ob, us_b in old["sweep"].items()))
        if mean(old["new_solve"]) >= mean(old["solve"]):
            fail("phase 10c: the edge solve is not faster than the --old "
                 "one")
    log(f"[10c] the edge kernels walk {edge_ops.walked_slots(t['index'])} "
        f"of {t['src'].shape[0]} "
        "edge slots (the padding past the last finite slot is never read); "
        "the bounds count the walked ones")
    out["solve_us"], out["solve_bound_ms"], out["old"] = (solve_us,
                                                         solve_bound, old)
    return out


def phase10d_all_sources(edge_ops, n: int = ALL_SOURCES_N) -> dict:
    """`all_sources_sssp` on the card: every row of an ER of `n` nodes
    against scipy (chunks of 256; and chunks of 384, whose tail pads,
    equal to it); then, with 2% of the nodes overloaded, one chunk equal
    to the split and dense paths' `_solve_dist`."""
    from openr_tpu_torch.convert import csr_from_numpy
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.ops.spf import all_sources_sssp, build_blocked
    from openr_tpu_torch.utils.topogen import erdos_renyi_csr, node_name

    es, ed, em, vp, nn, e = erdos_renyi_csr(n, avg_degree=20, seed=0,
                                            max_metric=64)
    over = np.zeros(vp, bool)
    t = edge_tensors(edge_ops, es, ed, em, over, vp)
    edge_ops.reset_launches()
    t0 = time.perf_counter()
    st = {}
    got = all_sources_sssp(*edge_args(t), vp, chunk=256, stats=st,
                           index=t["index"])
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(edge_ops.LAUNCHES)
    got2 = all_sources_sssp(*edge_args(t), vp, chunk=384, index=t["index"])
    t0 = time.perf_counter()
    csr = csr_from_numpy(
        num_nodes=nn, num_edges=e, edge_src=es, edge_dst=ed, edge_metric=em,
        node_overloaded=over, node_mask=np.arange(vp) < nn,
        node_names=[node_name(i) for i in range(nn)], adj_details={},
    )
    want = scipy_columns(csr, range(nn))
    scipy_s = time.perf_counter() - t0
    pad = np.full((vp - nn, vp), INF, np.int64)
    pad[np.arange(vp - nn), np.arange(nn, vp)] = 0  # a slot reaches itself
    if not np.array_equal(got[:nn, :nn], want) or (got[:nn, nn:] != INF).any():
        fail("phase 10d: all_sources_sssp disagrees with scipy's all pairs")
    if not np.array_equal(got[nn:], pad) or not np.array_equal(got, got2):
        fail("phase 10d: all_sources_sssp's padding rows or its padded "
             "tail chunk are wrong")
    if not all(launches.values()):
        fail(f"phase 10d: edge launches {launches}")
    if st["host_reads"] != -(-vp // 256):
        fail(f"phase 10d: {st['host_reads']} host reads for "
             f"{-(-vp // 256)} chunks")
    # overloads: one chunk against the split and dense paths
    rng = np.random.default_rng(4)
    over[rng.choice(nn, nn // 50, replace=False)] = True
    csr_o = csr_from_numpy(
        num_nodes=nn, num_edges=e, edge_src=es, edge_dst=ed, edge_metric=em,
        node_overloaded=over, node_mask=np.arange(vp) < nn,
        node_names=[node_name(i) for i in range(nn)], adj_details={},
    )
    blocked = to_dev(build_blocked(em, es, over), np.bool_)
    got_o = all_sources_sssp(t["src"], t["dst"], t["metric"], blocked, vp,
                             chunk=256, index=t["index"])
    roots = np.arange(256, dtype=np.int32)
    for knobs in ({}, dict(use_dense=True)):
        d = TorchSpfSolver(device=DEVICE, **knobs)._solve_dist(csr_o, roots)
        d = d[:nn].T.cpu().numpy()
        if not np.array_equal(d, got_o[:256, :nn]):
            fail(f"phase 10d: with overloads, all_sources_sssp's first chunk "
                 f"differs from the {knobs or 'split'} path")
    log(f"[10d] all_sources_sssp: ER {nn} nodes ({vp} slots, {e} edges), "
        f"{-(-vp // 256)} chunks of 256 in {wall:.1f} ms ({st['rounds']} "
        f"rounds, {st['host_reads']} host reads; edge launches {launches}); every "
        f"row == scipy's all pairs ({scipy_s:.1f} s on the host), padding "
        f"rows exact, chunks of 384 (tail padded) equal; with "
        f"{int(over.sum())} overloaded nodes the first chunk == split and "
        f"dense _solve_dist; card {smi('name,power.limit')}")
    return dict(wall_ms=wall, launches=launches)


def phase10e_fleet(relax, edge_ops, p9, k: int = FLEET_K) -> dict:
    """`compute_fleet_ribs` on the card: `fat_tree(k, metric=10)`, every
    node's RIB equal to its own `compute_routes` on the card, wall and
    routes/s (counts from 0 around the fleet call); then config 2's two
    roots from [9]'s states, equal to [9]'s RIBs."""
    from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
    from openr_tpu_torch.decision.fleet import compute_fleet_ribs
    from openr_tpu_torch.utils.topogen import fat_tree

    adj, pfx = fat_tree(k, metric=10)
    ls, ps = LinkState(), PrefixState()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    solver = TorchSpfSolver(device=DEVICE)
    compute_fleet_ribs(ls, ps, nodes=[ls.nodes[0]], solver=solver)  # warm
    relax.reset_launches()
    t0 = time.perf_counter()
    fleet = compute_fleet_ribs(ls, ps, solver=solver)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    if not sum(launches.values()):
        fail("phase 10e: the fleet solve launched no relax kernel")
    n_routes = sum(len(r.unicast_routes) + len(r.mpls_routes)
                   for r in fleet.values())
    per = TorchSpfSolver(device=DEVICE)
    t0 = time.perf_counter()
    for node in ls.nodes:
        want = per.compute_routes(ls, ps, node)
        got = fleet[node]
        if (got.unicast_routes != want.unicast_routes
                or got.mpls_routes != want.mpls_routes):
            fail(f"phase 10e: the fleet RIB of {node} differs from its own "
                 "compute_routes")
    per_s = time.perf_counter() - t0
    log(f"[10e] fleet: fat_tree({k}, metric=10), {len(fleet)} nodes: "
        f"compute_fleet_ribs {wall:.1f} ms for {n_routes} routes "
        f"({n_routes / (wall / 1e3):.0f} routes/s; relax launches "
        f"{launches}); every RIB == its node's own compute_routes on the "
        f"card ({per_s:.1f} s for the {len(fleet)} of them); card "
        f"{smi('name,power.limit')}")
    ls2, ps2 = p9["states"]
    roots = list(p9["ribs"])
    relax.reset_launches()
    t0 = time.perf_counter()
    got2 = compute_fleet_ribs(ls2, ps2, nodes=roots,
                              solver=TorchSpfSolver(device=DEVICE))
    wall2 = (time.perf_counter() - t0) * 1e3
    for me in roots:
        want = p9["ribs"][me]
        if (got2[me].unicast_routes != want.unicast_routes
                or got2[me].mpls_routes != want.mpls_routes):
            fail(f"phase 10e: config 2's fleet RIB of {me} differs from [9]'s")
    log(f"[10e] fleet on config 2, nodes {roots}: one chunk, "
        f"{wall2:.1f} ms, relax launches {dict(relax.LAUNCHES_BY_DESIGN)}; "
        f"both RIBs == [9]'s")
    return dict(wall_ms=wall, routes=n_routes, launches=launches,
                config2_ms=wall2)


def phase10f_hub(edge_ops) -> None:
    """The table knobs on a hub: `kernel_impl="dense"` on
    `hub_and_spoke(2, 100)` picks the edge list through the waste check,
    and its RIB equals the split path's."""
    from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
    from openr_tpu_torch.utils.topogen import hub_and_spoke

    adj, pfx = hub_and_spoke(hubs=2, spokes=100)
    ls, ps = LinkState(), PrefixState()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    solver = TorchSpfSolver(device=DEVICE, kernel_impl="dense")
    csr = ls.to_csr()
    if solver._pick_table(csr) != "edge":
        fail(f"phase 10f: kernel_impl='dense' on the hub picked "
             f"{solver._pick_table(csr)}, not edge")
    edge_ops.reset_launches()
    rdb = solver.compute_routes(ls, ps, "node-0")
    torch.cuda.synchronize()
    launches = dict(edge_ops.LAUNCHES)
    want = TorchSpfSolver(device=DEVICE).compute_routes(ls, ps, "node-0")
    if (rdb.unicast_routes != want.unicast_routes
            or rdb.mpls_routes != want.mpls_routes or not all(
                launches.values())):
        fail(f"phase 10f: the hub's edge-table RIB differs from split's "
             f"(edge launches {launches})")
    log(f"[10f] hub_and_spoke(2, 100), kernel_impl='dense': D "
        f"{csr.dense_width()} x {csr.padded_nodes} slots > 8 x "
        f"{csr.num_edges} edges, so the edge list; edge launches "
        f"{launches}; RIB ({len(rdb.unicast_routes)} routes) == split's")


# ------------------------------------------------------------------ main


# ----------------------------------------------------------- phase 11

#: [11]: cold samples (the first with the route caches keeping nothing,
#: the last filling them), hot calls on an unchanged view, flap rounds
#: at er100k, ramp /32s withdrawn and re-added at config 2, extra roots
#: before the trim, the trim's cap
DECISION_COLD = 2
DECISION_HOT = 3
DECISION_FLAPS = 2
DECISION_PREFIXES = 100
DECISION_EXTRA_ROOTS = ("node-1", "node-2")
DECISION_TRIM = 2


def timed_call(fn, gc_ms: list | None = None):
    """(fn(), host wall ms); appends the ms it spent in the collector to
    `gc_ms`."""
    with GcClock() as g:
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
    if gc_ms is not None:
        gc_ms.append(round(g.ms, 1))
    return out, ms


def node_sections(rdb, adj_labels) -> tuple[dict, dict]:
    """The routes the caches hand back as the same objects on an
    unchanged view: unicast routes off the general path (no UCMP /24s,
    the `20.` prefixes of config 2) and the node-segment labels."""
    uni = {p: e for p, e in rdb.unicast_routes.items()
           if not p.prefix.startswith("20.")}
    mpls = {k: e for k, e in rdb.mpls_routes.items() if k not in adj_labels}
    return uni, mpls


def reused(new: dict, old: dict) -> float:
    """The share of `new`'s entries that are `old`'s objects."""
    return sum(1 for k, e in new.items() if old.get(k) is e) / max(len(new), 1)


def same_rib(a, b, tag: str) -> None:
    if a.unicast_routes != b.unicast_routes or a.mpls_routes != b.mpls_routes:
        fail(f"[11] {tag}: the RouteDatabases differ")


def cold_and_hot(solver, ls, ps, me, adj_labels, tag):
    """`DECISION_COLD` cold calls (all but the last with a fingerprint cap
    of 0, so the caches keep nothing; the last fills them and returns an
    artifact), then `DECISION_HOT` calls on the unchanged view, each equal
    to the cold RIB with its plain, anycast and node-segment entries the
    cold call's objects. Returns (cold RIB, artifact, cold ms, hot ms,
    ms in the garbage collector per call)."""
    cold_ms, hot_ms, gc_ms = [], [], []
    solver.solve(ls, me)  # uploads the tables: the cold calls time routes
    for i in range(DECISION_COLD):
        solver.trim_caches(0 if i < DECISION_COLD - 1 else 8)
        (rdb, art), ms = timed_call(lambda: solver.compute_routes(
            ls, ps, me, return_artifact=True), gc_ms)
        cold_ms.append(ms)
    for i in range(DECISION_HOT):
        hot, ms = timed_call(lambda: solver.compute_routes(ls, ps, me), gc_ms)
        hot_ms.append(ms)
        same_rib(hot, rdb, f"{tag} hot call {i}")
        for a, b in zip(node_sections(rdb, adj_labels),
                        node_sections(hot, adj_labels)):
            if not a or reused(b, a) != 1.0:
                fail(f"[11] {tag} hot call {i}: {reused(b, a):.4f} of "
                     f"{len(b)} entries are the cold call's objects, not all")
    return rdb, art, cold_ms, hot_ms, gc_ms


def own_adj_labels(ls, me) -> set:
    db = ls.adjacency_db(me)
    return {a.adj_label for a in db.adjacencies} if db else set()


def phase11a_er100k(relax, states) -> dict:
    """The rebuild sequence Decision runs, at er100k on [5]'s `LinkState`
    (counts from 0 around it): cold, hot on an unchanged view, then
    `DECISION_FLAPS` rounds of a 32-metric flap, each answered by a hot
    `compute_routes` (equal to a fresh solver's in the first round) and a
    `warm_compute_routes` from the cold artifact (equal to both), then
    reverted, whose hot RIB is the cold RIB again."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.monitor import Counters

    ls, ps = states
    me = "node-0"
    spans = Counters()
    solver = TorchSpfSolver(device=DEVICE, counters=spans)
    adj_labels = own_adj_labels(ls, me)
    relax.reset_launches()
    rdb0, art, cold_ms, hot_ms, gc_ms = cold_and_hot(
        solver, ls, ps, me, adj_labels, "11a er100k")
    phases = dict(solver.last_phase_ms)
    rng = np.random.default_rng(20261017)
    flap_ms, warm_ms, revert_ms, shares = [], [], [], []
    base = rdb0  # the RIB and artifact a warm call starts from
    for rnd in range(DECISION_FLAPS):
        pairs, old_dbs = flap_round(ls, rng, 16, 16)
        t0 = time.perf_counter()
        rdb1 = solver.compute_routes(ls, ps, me)
        flap_ms.append((time.perf_counter() - t0) * 1e3)
        if rnd == 0:
            fresh = TorchSpfSolver(device=DEVICE).compute_routes(ls, ps, me)
            same_rib(rdb1, fresh, "11a er100k after the flap: hot vs fresh")
        shares.append((reused(rdb1.unicast_routes, rdb0.unicast_routes),
                       reused(rdb1.mpls_routes, rdb0.mpls_routes)))
        t0 = time.perf_counter()
        got = solver.warm_compute_routes(art, ls, ps, me, pairs, set(), base,
                                         0.25)
        warm_ms.append((time.perf_counter() - t0) * 1e3)
        if got is None:
            fail("[11] 11a er100k: warm_compute_routes declined a 32-metric "
                 "flap")
        same_rib(got[0], rdb1, f"11a er100k flap {rnd}: warm vs hot")
        revert_round(ls, old_dbs)
        t0 = time.perf_counter()
        rdb2, art = solver.compute_routes(ls, ps, me, return_artifact=True)
        revert_ms.append((time.perf_counter() - t0) * 1e3)
        base = rdb2
        same_rib(rdb2, rdb0, f"11a er100k revert {rnd}")
        back = [reused(b, a) for a, b in zip(node_sections(rdb0, adj_labels),
                                             node_sections(rdb2, adj_labels))]
        shares.append(tuple(back))
    torch.cuda.synchronize()
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    if not launches["vec"]:
        fail(f"[11] 11a er100k: relax launches {launches}; the vec kernel "
             "must run")
    out = dict(cold_ms=cold_ms, hot_ms=hot_ms, flap_ms=flap_ms,
               warm_ms=warm_ms, revert_ms=revert_ms, shares=shares,
               rdb=rdb0, launches=launches, solver=solver, me=me)
    log(f"[11a] er100k from {me}: {len(rdb0.unicast_routes)} unicast + "
        f"{len(rdb0.mpls_routes)} mpls routes; compute_routes cold p50 "
        f"{statistics.median(cold_ms):.3f} ms (samples "
        f"{[round(x, 3) for x in cold_ms]}), hot on the unchanged view p50 "
        f"{statistics.median(hot_ms):.3f} ms ({[round(x, 3) for x in hot_ms]}"
        f"; every plain and node-segment entry the cold call's object), "
        f"after a 32-metric flap p50 {statistics.median(flap_ms):.3f} ms "
        f"({[round(x, 3) for x in flap_ms]}), warm_compute_routes p50 "
        f"{statistics.median(warm_ms):.3f} ms "
        f"({[round(x, 3) for x in warm_ms]}), after the revert p50 "
        f"{statistics.median(revert_ms):.3f} ms "
        f"({[round(x, 3) for x in revert_ms]}); host wall; in the garbage "
        f"collector, cold and hot calls: {gc_ms} ms")
    log(f"[11a] entries reused (unicast, mpls): after each flap and after "
        f"its revert {[tuple(round(x, 4) for x in s) for s in shares]}; "
        f"the flap's hot RIB == a fresh solver's == the warm RIB; relax "
        f"launches {launches}; last_phase_ms of the cold call {phases}; "
        f"span p50s (ms) {span_p50s(spans)}")
    return out


def phase11b_config2(relax, election_ops, p9, p10e) -> dict:
    """The same at config 2 from the aggregation root (node-2025, its
    MPLS labels of 45 ECMP next hops each) on [9]'s states, equal to [9]'s
    RIB; a prefix-only change through `assemble_prefix_routes`; the
    artifact's warm state; `trim_caches`; and the fleet call of [10e]
    twice on one solver, the second from its caches."""
    from openr_tpu_torch.decision.fleet import compute_fleet_ribs
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.monitor import Counters
    from openr_tpu_torch.types import PrefixDatabase

    ls, ps = p9["states"]
    roots = list(p9["ribs"])
    me = roots[1]
    want = p9["ribs"][me]
    spans = Counters()
    solver = TorchSpfSolver(device=DEVICE, counters=spans)
    adj_labels = own_adj_labels(ls, me)
    relax.reset_launches()
    election_ops.reset_launches()
    rdb0, art, cold_ms, hot_ms, gc_ms = cold_and_hot(
        solver, ls, ps, me, adj_labels, "11b config2")
    phases = dict(solver.last_phase_ms)
    same_rib(rdb0, want, "11b config2 cold vs [9]'s RIB")

    # a prefix-only change: ramp /32s withdrawn, then re-added
    picked = [(p, dict(per)) for p, per in ps.prefixes.items()
              if p.prefix.startswith("16.") and len(per) == 1
              and p in want.unicast_routes]
    picked = picked[:DECISION_PREFIXES]
    scope = {p for p, _per in picked}
    for p, per in picked:
        for node in per:
            ps.withdraw(node, p)
    t0 = time.perf_counter()
    gone = solver.assemble_prefix_routes(art, ps, scope)
    withdraw_ms = (time.perf_counter() - t0) * 1e3
    if gone:
        fail(f"[11] 11b: {len(gone)} withdrawn prefixes still have routes")
    for p, per in picked:
        for node, e in per.items():
            ps.update_prefix_db(PrefixDatabase(this_node_name=node,
                                               prefix_entries=(e,)))
    t0 = time.perf_counter()
    back = solver.assemble_prefix_routes(art, ps, scope)
    readd_ms = (time.perf_counter() - t0) * 1e3
    if back != {p: want.unicast_routes[p] for p in scope}:
        fail("[11] 11b: the re-added prefixes' entries differ from [9]'s")
    t0 = time.perf_counter()
    new_view = solver.compute_routes(ls, ps, me)
    new_view_ms = (time.perf_counter() - t0) * 1e3
    same_rib(new_view, want, "11b config2 after the prefix change")
    uni_share = reused(new_view.unicast_routes, rdb0.unicast_routes)
    mpls_share = reused(new_view.mpls_routes, rdb0.mpls_routes)

    # the artifact's warm state
    w0 = art.warm_state_bytes()
    np.asarray(art.solved[1])
    w1 = art.warm_state_bytes()
    art.drop_warm_state()
    w2 = art.warm_state_bytes()
    if not (w1 > 0 and w2 == 0):
        fail(f"[11] 11b: warm_state_bytes {w0} -> {w1} (mirror) -> {w2} "
             "(dropped)")
    if solver.assemble_prefix_routes(art, ps, scope) != back:
        fail("[11] 11b: assemble_prefix_routes changed after the drop")

    # trim: more fingerprints than the cap, then the cap
    for root in DECISION_EXTRA_ROOTS:
        solver.compute_routes(ls, ps, root)
    caches = (solver._uni_cache, solver._mpls_cache, solver._mpls_cls_cache)
    before = [len(c) for c in caches]
    solver.trim_caches(DECISION_TRIM)
    after = [len(c) for c in caches]
    if max(after) > DECISION_TRIM or max(before) <= DECISION_TRIM:
        fail(f"[11] 11b: fingerprints {before} -> {after} after "
             f"trim_caches({DECISION_TRIM})")
    torch.cuda.synchronize()
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    e_launches = election_ops.LAUNCHES
    if not launches["generic"] or not e_launches:
        fail(f"[11] 11b: relax launches {launches}, elect_seg_kernel "
             f"{e_launches}; both kernels must run")

    # [10e]'s fleet call, twice on one solver
    fleet_solver = TorchSpfSolver(device=DEVICE)
    fleet_ms = []
    for i in range(2):
        t0 = time.perf_counter()
        got = compute_fleet_ribs(ls, ps, nodes=roots, solver=fleet_solver)
        fleet_ms.append((time.perf_counter() - t0) * 1e3)
        for root in roots:
            same_rib(got[root], p9["ribs"][root],
                     f"11b fleet pass {i} {root} vs [9]")
    cap = fleet_solver._mpls_fingerprint_cap
    if cap < len(roots) + 1 or len(fleet_solver._mpls_cache) != len(roots):
        fail(f"[11] 11b: the fleet's fingerprint cap {cap}, fingerprints "
             f"{len(fleet_solver._mpls_cache)}")
    out = dict(me=me, cold_ms=[round(x, 3) for x in cold_ms], hot_ms=hot_ms,
               rdb=rdb0, fleet_ms=fleet_ms, solver=solver,
               launches=launches, elect_launches=e_launches)
    log(f"[11b] config 2 from {me}: {len(rdb0.unicast_routes)} unicast + "
        f"{len(rdb0.mpls_routes)} mpls routes == [9]'s; compute_routes cold "
        f"p50 {statistics.median(cold_ms):.3f} ms "
        f"({[round(x, 3) for x in cold_ms]}), hot on the unchanged view p50 "
        f"{statistics.median(hot_ms):.3f} ms ({[round(x, 3) for x in hot_ms]}"
        f"; every plain, anycast and node-segment entry the cold call's "
        f"object); last_phase_ms of the cold call {phases}; host wall; in "
        f"the garbage collector, cold and hot calls: {gc_ms} ms")
    log(f"[11b] {len(scope)} ramp /32s withdrawn: assemble_prefix_routes "
        f"{withdraw_ms:.3f} ms, no route; re-added: {readd_ms:.3f} ms, == "
        f"[9]'s entries; then compute_routes on the new view "
        f"{new_view_ms:.3f} ms == [9]'s RIB, entries reused (unicast "
        f"{uni_share:.4f}, mpls {mpls_share:.4f}); warm_state_bytes {w0} -> "
        f"{w1} (host mirror) -> {w2} (dropped), the scoped routes unchanged "
        f"after the drop; fingerprints {before} -> {after} after "
        f"trim_caches({DECISION_TRIM}); relax launches {launches}, "
        f"elect_seg_kernel {e_launches}; span p50s (ms) {span_p50s(spans)}")
    log(f"[11b] fleet on config 2, nodes {roots}, one solver: "
        f"{[round(x, 1) for x in fleet_ms]} ms (first pass, second pass "
        f"from the caches; [10e]'s call on a fresh solver "
        f"{p10e['config2_ms']:.1f} ms); fingerprint cap {cap}; RIBs == [9]'s")
    return out


def phase11c_convert(ribs: dict) -> None:
    """The hook's converter on full RIBs, with the port's own route types
    as the target modules (this script imports nothing of the JAX
    package): cold memo, then hot memo; each converted RIB equals its
    source with one new object per entry."""
    from openr_tpu_torch.decision.hook import RouteConverter
    from openr_tpu_torch.types import network, routes

    for tag, rdb in ribs.items():
        conv = RouteConverter(routes, network)
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = conv.route_db(rdb)
            ms.append((time.perf_counter() - t0) * 1e3)
        same_rib(got, rdb, f"11c {tag}: converted vs source")
        n = len(rdb.unicast_routes) + len(rdb.mpls_routes)
        fresh = sum(1 for k, e in got.unicast_routes.items()
                    if e is not rdb.unicast_routes[k])
        fresh += sum(1 for k, e in got.mpls_routes.items()
                     if e is not rdb.mpls_routes[k])
        if fresh != n:
            fail(f"[11] 11c {tag}: {fresh} of {n} entries converted")
        nhs = sum(len(e.nexthops) for e in rdb.mpls_routes.values())
        log(f"[11c] convert {tag}: {len(rdb.unicast_routes)} unicast + "
            f"{len(rdb.mpls_routes)} mpls entries ({nhs} mpls next hops), "
            f"{len(conv)} objects memoised: cold memo {ms[0]:.3f} ms, hot "
            f"memo {ms[1]:.3f} ms per full RIB; host wall")


def phase11_er100k(mods, states, p4, fresh: bool) -> None:
    """[11a], its RIB's conversion and [12a] on its solver, run right
    after [5] so that [5]'s 100k `LinkState` (millions of live objects,
    which every later full collection would walk) is freed before [6]."""
    t0 = time.perf_counter()
    a = phase11a_er100k(mods[0], states)
    phase11c_convert({"er100k": a["rdb"]})
    log(f"[11a] {time.perf_counter() - t0:.1f} s in all")
    phase12a_er100k(mods, a["solver"], *states, a["me"], p4, fresh)


def phase11_config2(mods, p9, p10e) -> None:
    """[11b] and its RIB's conversion; then, with every object alive so
    far frozen out of the collector, one more cold call."""
    t0 = time.perf_counter()
    b = phase11b_config2(mods[0], mods[1], p9, p10e)
    phase11c_convert({f"config2-10k {b['me']}": b["rdb"]})
    ls, ps = p9["states"]
    solver = b["solver"]
    solver.trim_caches(0)  # cold calls: the caches keep nothing
    gc.freeze()
    frozen = gc.get_freeze_count()
    try:
        cold = []
        for _ in range(2):
            with GcClock() as g:
                t1 = time.perf_counter()
                solver.compute_routes(ls, ps, b["me"])
                ms = (time.perf_counter() - t1) * 1e3
            cold.append((round(ms, 3), round(g.ms, 1), g.full))
    finally:
        gc.unfreeze()
    log(f"[11b] cold compute_routes with the {frozen} live objects frozen "
        f"out of the collector (`gc.freeze()`): (ms, ms in the collector, "
        f"full collections) {cold}; not frozen, above: {b['cold_ms']} ms")
    log(f"[11b] {time.perf_counter() - t0:.1f} s in all; card "
        f"{smi('name,power.limit')}")
    phase12b_config2(mods, solver, ls, ps, b["me"])


# ------------------------------------------------------------ phase 12

#: timed calls per mode in the overhead turns (off, on, on, off, ...):
#: [4]'s solve, then a hot compute_routes
TELEMETRY_TURNS = (31, 11)
#: roots of [12a]'s `_solve_dist` rows (one per table kind)
TELEMETRY_B = 8


class LaunchWork:
    """Within the block, every launch of the wrappers the main paths use
    (the relax rows, the election, the KSP fixpoint and walk, the edge
    solve) adds its count, as the kernels line counts it, to `bytes` and
    `ops`: a spy on the wrappers, apart from the cost rows' own sink."""

    def __init__(self, relax, election_ops, ksp_ops, edge_ops):
        self.mods = (relax, election_ops, ksp_ops, edge_ops)
        self.bytes = self.ops = self.launches = 0
        self.keep = []

    def add(self, nbytes, ops):
        self.bytes += int(nbytes)
        self.ops += int(ops)
        self.launches += 1

    def __enter__(self):
        relax, election_ops, ksp_ops, edge_ops = self.mods
        orig_relax, orig_elect = relax._relax, election_ops.elect_seg
        orig_sssp, orig_walk = ksp_ops.ksp_sssp, ksp_ops.ksp_walk
        orig_edge = edge_ops.batched_sssp

        def spy_relax(entry, dist_in, out, nbr, wgt, roots, over, row0, n,
                      src_rows, dst_rows, *rest):
            # rest: changed, row_flag, rows_changed and the loop guard
            # (ctl, phase_mask, n_live), read as the launch finds it
            if torch.cuda.is_current_stream_capturing():
                # recorded into a CUDA graph: launches nothing
                return orig_relax(entry, dist_in, out, nbr, wgt, roots, over,
                                  row0, n, src_rows, dst_rows, *rest)
            live = relax._count(nbr, row0, n, src_rows, dst_rows)
            guard = rest[3:6]
            if guard and (guard[0] is not None or guard[2] is not None):
                live = relax.live_rows(*guard, live)
            if live:
                self.add(*relax.launch_work(
                    nbr, wgt, dist_in.shape[1], over=over, row0=row0,
                    n=live, src_rows=src_rows, dst_rows=dst_rows)[1:3])
            return orig_relax(entry, dist_in, out, nbr, wgt, roots, over,
                              row0, n, src_rows, dst_rows, *rest)

        def spy_elect(indptr, seg, adv, *a, **kw):
            if indptr.shape[0] > 1:
                self.add(*election_ops.elect_work(indptr.shape[0] - 1,
                                                  adv.shape[0]))
            return orig_elect(indptr, seg, adv, *a, **kw)

        def alive(live):
            return live is None or bool(int(live[0]))

        def spy_sssp(dist0, nbr, wgt, blocked, *a, live=None, **kw):
            on = alive(live)
            out = orig_sssp(dist0, nbr, wgt, blocked, *a, live=live, **kw)
            self.add(*(ksp_ops.sssp_work(nbr, wgt, blocked, out) if on
                       else (0, 0)))
            return out

        def spy_walk(dist, nbr, wgt, blocked, bans, dests, root, max_hops,
                     cost, path, hops, any_ok, *, live=None, counters=None):
            on = alive(live)
            got = orig_walk(dist, nbr, wgt, blocked, bans, dests, root,
                            max_hops, cost, path, hops, any_ok, live=live,
                            counters=counters)
            self.add(*(ksp_ops.walk_work(nbr.shape[1], hops) if on
                       else (0, 0)))
            return got

        def spy_edge(src, dst, metric, blocked, roots, v, row_start=None,
                     stats=None, index=None):
            dist = orig_edge(src, dst, metric, blocked, roots, v, row_start,
                             stats=stats, index=index)
            b = roots.shape[0]
            self.add(*edge_ops.init_work(index, v, b, edge_ops.tile_cols(b),
                                         roots))
            self.add(*edge_ops.fix_work(src, blocked, index, v, dist))
            return dist

        from openr_tpu_torch.ops import rib_epilogue, split_loop as sl

        def spy_loop(name, ctl_at, mask_at, work):
            orig = getattr(sl, name)

            def call(*a, **kw):
                if (not torch.cuda.is_current_stream_capturing()
                        and sl.runs(a[ctl_at], a[mask_at])):
                    self.add(*work(*a))
                return orig(*a, **kw)

            self.keep.append((sl, name, orig))
            setattr(sl, name, call)

        def snap_mark_work(d, _s, rf, frontier, out_nbr, _m, ctl, _k,
                           with_frontier, dead):
            nbytes, ops = sl.snap_work(d.numel(), rf.numel())
            if int(ctl[sl.PHASE]) != sl.TAIL:
                return nbytes, ops
            f = frontier[: int(ctl[sl.N_FRONT])].long()
            mb, mo = sl.mark_work(f.shape[0], out_nbr.shape[1],
                                  int((out_nbr[f] != dead).sum()),
                                  with_frontier)
            return nbytes + mb, ops + mo

        self.keep = []
        spy_loop("snap_mark", 6, 7, snap_mark_work)
        spy_loop("flag_compact", 2, 3, lambda f, o, c, k, s1, s2, dd, clear:
                 sl.compact_work(f.shape[0], o.shape[0],
                                 int((f != 0).sum()), clear))
        spy_loop("split_ctl", 0, 1, lambda *a: sl.ctl_work())
        orig_buf = rib_epilogue.rib_buffer

        def spy_buf(dist, metric, ids, over, my_id, with_lfa):
            self.add(*rib_epilogue.epilogue_work(*dist.shape, ids.shape[0],
                                                 with_lfa))
            return orig_buf(dist, metric, ids, over, my_id, with_lfa)

        self.keep.append((rib_epilogue, "rib_buffer", orig_buf))
        rib_epilogue.rib_buffer = spy_buf
        self.keep += [(relax, "_relax", orig_relax),
                     (election_ops, "elect_seg", orig_elect),
                     (ksp_ops, "ksp_sssp", orig_sssp),
                     (ksp_ops, "ksp_walk", orig_walk),
                     (edge_ops, "batched_sssp", orig_edge)]
        relax._relax, election_ops.elect_seg = spy_relax, spy_elect
        ksp_ops.ksp_sssp, ksp_ops.ksp_walk = spy_sssp, spy_walk
        edge_ops.batched_sssp = spy_edge
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.keep:
            setattr(mod, name, fn)


def span_p50s(counters) -> dict:
    """The spans' p50 ms from a `Counters` snapshot (its histogram's,
    within ~12%)."""
    return {k[len("profile."):-len(".p50")]: round(v, 3)
            for k, v in sorted(counters.snapshot().items())
            if k.startswith("profile.") and k.endswith("_ms.p50")}


def row_vs_spy(mods, fn: str, call, tag: str) -> dict:
    """`call()` with the telemetry's rows dropped first and the launch
    spy on: the cost row `fn` it captures must hold the spy's bytes,
    operations and launches. Returns the row."""
    from openr_tpu_torch.monitor import device

    device.telemetry().reset()
    with LaunchWork(*mods) as spy:
        call()
        torch.cuda.synchronize()
    row = device.kernel_rows().get(fn)
    if row is None:
        fail(f"[12] {tag}: no cost row {fn}")
    if (row.bytes_accessed, row.flops, row.launches) != (
            spy.bytes, spy.ops, spy.launches):
        fail(f"[12] {tag}: cost row {fn} holds {row.bytes_accessed:.0f} B, "
             f"{row.flops:.0f} ops, {row.launches} launches; the kernels "
             f"line's count over the same call {spy.bytes} B, {spy.ops} "
             f"ops, {spy.launches} launches")
    return row


def check_hbm(counters, tag: str) -> tuple[int, int, int]:
    """The gauges `sample_hbm` writes against torch's allocator read
    right after; returns (in use, peak, limit)."""
    from openr_tpu_torch.monitor import device

    torch.cuda.synchronize()
    if device.sample_hbm(counters) is None:
        fail(f"[12] {tag}: sample_hbm returned None on the card")
    want = (torch.cuda.memory_allocated(0), torch.cuda.max_memory_allocated(0),
            torch.cuda.get_device_properties(0).total_memory)
    got = tuple(int(counters.get(f"device.0.hbm_{k}", -1))
                for k in ("bytes_in_use", "peak_bytes", "limit_bytes"))
    if got != want:
        fail(f"[12] {tag}: HBM gauges {got} != torch's allocator {want}")
    return got


def telemetry_turns(fn, turns: int) -> dict:
    """Host wall ms of `fn()` with the telemetry's own flags (the device
    telemetry's and the work ledger's `enabled`) off and on, in turns
    (off, on, on, off, ...): p50 and mean per mode, and the p50s'
    difference."""
    from openr_tpu_torch.monitor import device, work_ledger

    ms = {False: [], True: []}
    try:
        for i in range(turns):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                device.telemetry().enabled = on
                work_ledger.ledger().enabled = on
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[on].append((time.perf_counter() - t0) * 1e3)
    finally:
        device.telemetry().enabled = True
        work_ledger.ledger().enabled = True
    off, on = statistics.median(ms[False]), statistics.median(ms[True])
    return dict(off=off, on=on, diff_us=(on - off) * 1e3,
                share=(on - off) / off, samples=ms,
                means=[statistics.fmean(ms[False]), statistics.fmean(ms[True])])


def micro_us(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def phase12a_er100k(mods, solver, ls, ps, me, p4, fresh: bool) -> None:
    """The telemetry plane at er100k on [11a]'s solver (its `Counters`):
    the build ledger (one build a source in a fresh `_build/`, none after
    the warm mark of [2]), host reads per cold and hot `compute_routes`,
    each cost row of the single-root, warm and batched paths and of a KSP
    call against the kernels line's count of the same call, the HBM
    gauges against torch's allocator, the efficiency join, and the
    telemetry's cost: [4]'s solve and a hot `compute_routes` with its
    flags off and on, in turns."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.monitor import compile_ledger, device

    relax, election_ops, ksp_ops, edge_ops = mods
    t_start = time.perf_counter()
    led = compile_ledger.ledger()
    builds, loads = led.builds(), led.loads()
    if fresh and builds != {s: 1 for s in SOURCES}:
        fail(f"[12] builds in a fresh _build/: {builds}, one a source wanted")
    if not set(SOURCES) <= set(builds) | set(loads):
        fail(f"[12] builds {builds}, loads {loads}: a source is missing")
    if led.builds_since_warm():
        fail(f"[12] builds after the warm mark: {led.builds_since_warm()}")
    counters = solver.counters

    # ---- host reads per cold and hot compute_routes ------------------------
    reads = {}
    for tag, cap in (("cold", 0), ("fill", 8), ("hot", 8)):
        solver.trim_caches(cap)
        r0 = led.transfers()
        solver.compute_routes(ls, ps, me)
        r1 = led.transfers()
        reads[tag] = (r1[0] - r0[0], r1[1] - r0[1])
    if not all(n for n, _b in reads.values()):
        fail(f"[12] host reads per compute_routes {reads}: none counted")

    # ---- the cost rows against the kernels line's count -------------------
    rows = {}
    rows["batched_sssp_split_rib"] = row_vs_spy(
        mods, "batched_sssp_split_rib", lambda: solver.solve(ls, me),
        "er100k solve")
    _rdb, art = solver.compute_routes(ls, ps, me, return_artifact=True)
    rng = np.random.default_rng(12)
    pairs, old_dbs = flap_round(ls, rng, 16, 16)
    got = []
    rows["batched_sssp_split_warm_rib"] = row_vs_spy(
        mods, "batched_sssp_split_warm_rib",
        lambda: got.append(solver.warm_compute_routes(
            art, ls, ps, me, pairs, set(), _rdb, 0.25)), "er100k warm")
    if got[0] is None:
        fail("[12] the warm path declined the flap")
    revert_round(ls, old_dbs)
    csr = ls.to_csr()
    roots = np.arange(TELEMETRY_B, dtype=np.int32)
    dense = TorchSpfSolver(device=DEVICE, use_dense=True, counters=counters)
    edge = TorchSpfSolver(device=DEVICE, use_dense=False, counters=counters)
    for fn, s in (("batched_sssp_split", solver),
                  ("batched_sssp_dense", dense), ("batched_sssp", edge)):
        rows[fn] = row_vs_spy(mods, fn, lambda s=s: s._solve_dist(csr, roots),
                              f"er100k {fn} B {TELEMETRY_B}")
    dense.use_pallas = True  # the same tables; the row of one sweep
    device.telemetry().reset()
    dense._solve_dist(csr, roots)
    rows["_relax_once"] = once = device.kernel_rows()["_relax_once"]
    dense.use_pallas = False
    full = rows["batched_sssp_dense"]
    if once.bytes_accessed * full.launches != full.bytes_accessed:
        fail(f"[12] _relax_once {once.bytes_accessed:.0f} B x "
             f"{full.launches} sweeps != batched_sssp_dense "
             f"{full.bytes_accessed:.0f} B")
    my_id = csr.name_to_id[me]
    t = dense._device_arrays(csr, "dense")
    blocked = (t["over"][t["nbr"].long()] & (t["nbr"] != my_id)).contiguous()
    dests = torch.arange(1, 1 + TELEMETRY_B, dtype=torch.int32, device=DEVICE)
    rows["_ksp_edge_disjoint_dense_jit"] = row_vs_spy(
        mods, "_ksp_edge_disjoint_dense_jit",
        lambda: ksp_ops.ksp_edge_disjoint_dense(
            t["nbr"], t["wgt"], blocked, my_id, dests, k=2,
            max_hops=csr.padded_nodes - 1, to_host=True),
        "er100k KSP")
    device.telemetry().reset()
    dense.solve(ls, me)
    rows["first_hop_matrix"] = device.kernel_rows()["first_hop_matrix"]
    for fn, row in rows.items():
        log(f"[12a] cost row {fn}: {row.bytes_accessed:.0f} B, "
            f"{row.flops:.0f} integer ops, {row.launches} launches "
            f"({', '.join(row.sources) or 'torch ops'}), args "
            f"{row.arg_bytes} B, outs {row.out_bytes} B, code "
            f"{row.code_bytes} B, shape {row.shapes}, span {row.span} "
            f"(complete {row.span_complete}); least time "
            f"{bound(row.bytes_accessed, row.flops)[0] * 1e3:.3f} us")
    # the join needs the rows and the spans of one solver: the split RIB's
    device.telemetry().reset()
    solver.solve(ls, me)
    for r in device.efficiency_rows(device.kernel_rows(), counters.snapshot()):
        log(f"[12a] efficiency {r['fn']}: span {r['span']} p50 "
            f"{r['span_p50_ms']} ms over {r['span_count']} samples, "
            f"achieved {r['achieved_gbs']} GB/s of least bytes, "
            f"{r['achieved_gflops']} G integer ops/s")
    in_use, peak, limit = check_hbm(counters, "er100k")

    # ---- the telemetry's cost ------------------------------------------------
    s4, ls4 = p4["solver"], p4["ls"]
    s4.solve(ls4, "node-0")
    launches = s4.last_solve_stats["relax_launches"]
    solve_t = telemetry_turns(lambda: s4.solve(ls4, "node-0"),
                              TELEMETRY_TURNS[0])
    hot_t = telemetry_turns(lambda: solver.compute_routes(ls, ps, me),
                            TELEMETRY_TURNS[1])
    scratch_tel, key = device.DeviceTelemetry(), (1, 2, 3)
    with scratch_tel.observe("probe", key):
        pass
    probe_us = micro_us(lambda: scratch_tel.observe("probe", key), 20_000)
    scratch = compile_ledger.CompileLedger()
    transfer_us = micro_us(lambda: scratch.record_transfer(64), 20_000)
    hbm_us = micro_us(lambda: device.sample_hbm(counters), 2_000)
    sink_us = micro_us(device.sink, 200_000)
    scratch_led = type(solver.work_ledger)()
    commit_us = micro_us(lambda: scratch_led.commit("election", 9, 3), 20_000)
    # what the telemetry adds to one call, from the costs above: a solve
    # probes once, counts one transfer and checks the sink at each relax
    # launch; a hot RIB adds two HBM samples (its two spans) and a commit
    solve_acc = probe_us + transfer_us + launches * sink_us
    hot_acc = solve_acc + 2 * hbm_us + commit_us
    log(f"[12a] builds {builds} (fresh _build/: {fresh}), loads {loads}, "
        f"seconds {led.build_seconds()}; none after the warm mark; host "
        f"reads (reads, bytes) per compute_routes: cold {reads['cold']}, "
        f"filling {reads['fill']}, hot {reads['hot']}")
    log(f"[12a] HBM gauges == torch's allocator: in use {in_use} B, peak "
        f"{peak} B, limit {limit} B")
    for tag, tt, acc in (("[4] solve", solve_t, solve_acc),
                         ("[11a] hot compute_routes", hot_t, hot_acc)):
        log(f"[12a] telemetry cost on {tag}, flags off / on in turns: p50 "
            f"{tt['off']:.3f} / {tt['on']:.3f} ms ({tt['diff_us']:.1f} us, "
            f"{tt['share']:.4%}), mean {tt['means'][0]:.3f} / "
            f"{tt['means'][1]:.3f} ms; by the per-call costs below "
            f"{acc:.2f} us ({acc / 1e3 / tt['off']:.4%} of the off p50); "
            f"samples off / on "
            f"{[[round(x, 3) for x in v] for v in tt['samples'].values()]}")
    log(f"[12a] per call: a steady observe() probe {probe_us:.3f} us, "
        f"record_transfer {transfer_us:.3f} us, a sink check {sink_us:.3f} "
        f"us ({launches} a solve), sample_hbm {hbm_us:.3f} us, a work "
        f"commit {commit_us:.3f} us; [12a] "
        f"{time.perf_counter() - t_start:.1f} s; card "
        f"{smi('name,power.limit')}")


def phase12b_config2(mods, solver, ls, ps, me) -> None:
    """The same at config 2 on [11b]'s solver: the split RIB's row on the
    generic kernel and the election's at 20 000 slots against the
    kernels line's count of one hot `compute_routes`, the efficiency
    join, the HBM gauges."""
    from openr_tpu_torch.monitor import device

    t_start = time.perf_counter()
    solver.trim_caches(8)
    solver.compute_routes(ls, ps, me)
    device.telemetry().reset()
    with LaunchWork(*mods) as spy:
        solver.compute_routes(ls, ps, me)
        torch.cuda.synchronize()
    rows = device.kernel_rows()
    if set(rows) != {"batched_sssp_split_rib", "_elect_seg"}:
        fail(f"[12] config 2: cost rows {sorted(rows)}")
    total = [sum(getattr(r, f) for r in rows.values())
             for f in ("bytes_accessed", "flops", "launches")]
    if total != [spy.bytes, spy.ops, spy.launches]:
        fail(f"[12] config 2: the rows hold {total} (bytes, ops, launches), "
             f"the kernels line's count {[spy.bytes, spy.ops, spy.launches]}")
    for r in device.efficiency_rows(rows, solver.counters.snapshot()):
        log(f"[12b] cost row {r['fn']}: {r['bytes_accessed']:.0f} B, "
            f"{r['flops']:.0f} integer ops, {r['launches']} launches, shape "
            f"{r['shapes']}; span {r['span']} p50 {r['span_p50_ms']} ms: "
            f"achieved {r['achieved_gbs']} GB/s of least bytes")
    in_use, peak, limit = check_hbm(solver.counters, "config 2")
    log(f"[12b] HBM gauges == torch's allocator: in use {in_use} B, peak "
        f"{peak} B, limit {limit} B; the rows' sum == the kernels line's "
        f"count; {time.perf_counter() - t_start:.1f} s")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="csrc/ of another checkout: time its relax, "
                    "election, KSP and edge kernels beside this checkout's, "
                    "in turns")
    ap.add_argument("--only",
                    choices=("3", "8", "13", "14", "15", "16", "17", "18"),
                    default=None,
                    help="run the build and phase 3, phase 8 (a, b, d), "
                    "phase 14, phase 15, phase 16, phase 17 or phase 18 "
                    "alone, or "
                    "phase 10a and phase 13 (no result line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    import faulthandler

    faulthandler.dump_traceback_later(
        max(1.0, RUN_BUDGET_S - (time.perf_counter() - T_START)), exit=True)
    card = smi("name,power.limit")
    if not card:
        fail("nvidia-smi could not read the card's name and power limit")
    log(f"[1] device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")

    # ---- phase 2: build ------------------------------------------------
    from openr_tpu_torch.ops import cuda_build, relax, rib_epilogue, split_loop
    from openr_tpu_torch.ops import edge_relax as edge_ops
    from openr_tpu_torch.ops import election as election_ops
    from openr_tpu_torch.ops import ksp as ksp_ops

    from openr_tpu_torch.monitor import compile_ledger

    fresh = not any(cuda_build.BUILD_DIR.glob("lib*.so"))
    mods = (relax, election_ops, ksp_ops, edge_ops)
    warm_states = None if args.only else start_warm_states()
    old_libs = build_all(cuda_build, mods + (split_loop, rib_epilogue),
                         args.old)
    compile_ledger.mark_warm()  # no build after this ([12] checks)
    lib = relax._lib()
    grid = (1, 2, 4, 6, 8, 10, 12, 16, 24, 32, 48, 64, 128, 256, 512, 1024)
    bad = [(w, b) for w in grid for b in grid
           if bool(lib.openr_relax_vec_shape(w, b))
           != (relax.design_for(w, b) == "vec")
           or lib.openr_relax_generic_np(w, b) != relax.generic_np(w, b)]
    if bad:
        fail(f"C dispatch and design_for / generic_np disagree at {bad}")

    dev = torch.device(DEVICE)
    if args.only in ("15", "16", "17", "18"):
        dict(zip(("15", "16", "17", "18"),
                 (phase15, phase16, phase17, phase18)))[args.only]()
        log(f"[time] host seconds by phase: "
            f"{ {k: round(v, 1) for k, v in PHASE_S.items()} }")
        return
    if args.only:
        from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
        from openr_tpu_torch.utils.topogen import erdos_renyi_lsdb

        ls, _ps, csr = erdos_renyi_lsdb(100_000, avg_degree=20, seed=0,
                                        max_metric=64)
        if args.only == "3":
            worst_r, cases = phase3_random(relax, dev)
            log(f"[3] kernels vs plain, random tables: {cases} cases, max "
                f"|diff| {worst_r}")
            if any(worst_r.values()):
                fail(f"relax kernels disagree with relax_rows_ref ({worst_r})")
            solver = TorchSpfSolver(device=DEVICE)
            main_path_calls(relax, solver, ls, solver._device_arrays(csr),
                            old_libs)
            return
        if args.only == "8":
            phase8a_kernels(election_ops, ksp_ops, csr)
            phase8b_config4(ksp_ops, old_libs.get("ksp"))
            phase8d_config4_ref(ksp_ops, old_libs.get("ksp"))
            return
        if args.only == "13":
            phase10a_edge(edge_ops)
            phase13_sharded(relax, edge_ops, csr, (
                np.arange(CONFIG3_B) % csr.num_nodes).astype(np.int32),
                sweep_k=True)
            return
        solver = TorchSpfSolver(device=DEVICE)
        tables = solver._device_arrays(csr)
        phase14_loop(relax, split_loop, rib_epilogue, solver, ls, tables)
        return
    # ---- phase 3a: kernels vs plain on random tables ---------------------
    worst_r, cases = phase3_random(relax, dev)
    log(f"[3] kernels vs plain, random tables: {cases} cases, max |diff| "
        f"{worst_r} (dist, changed, row_flag, rows_changed)")
    if any(worst_r.values()):
        fail(f"relax kernels disagree with relax_rows_ref ({worst_r})")

    # ---- phase 4 set-up: the 100k LSDB and its device tables -------------
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.utils.topogen import erdos_renyi_lsdb

    p5_states = warm_states()  # before any host wall is timed
    warm_states = None
    t0 = time.perf_counter()
    ls, ps, csr = erdos_renyi_lsdb(
        100_000, avg_degree=20, seed=0, max_metric=64
    )
    solver = TorchSpfSolver(device=DEVICE)
    tables = solver._device_arrays(csr)
    torch.cuda.synchronize()
    vp = tables["vp"]
    w_base = tables["base_nbr"].shape[1]
    ov_shape = tuple(tables["ov_nbr"].shape)
    log(f"[4] LSDB: {csr.num_nodes} nodes, {int(csr.num_edges)} directed "
        f"edges, vp {vp}, W {tables['base_nbr'].shape[1]}, overflow "
        f"{tuple(tables['ov_nbr'].shape)} with "
        f"{int((tables['ov_ids'] != vp - 1).sum().item())} live rows, "
        f"set-up {time.perf_counter() - t0:.1f} s")

    # ---- phase 3b: both designs at the main path's calls ---------------
    timing, worst_m = main_path_calls(relax, solver, ls, tables, old_libs)

    # ---- phase 4: the main path, counts from 0 -----------------------------
    from torch.profiler import ProfilerActivity, profile

    relax.reset_launches()
    split_loop.reset_launches()
    rib_epilogue.reset_launches()
    # [3b] left a captured program: drop it, so that the warm-up solve
    # runs eagerly and its kernels are launched by their wrappers; the
    # later solves replay its graphs, which no wrapper counts
    solver._programs.clear()
    run_stats = []  # every solve's and RIB's stats in the counted run
    solver.solve(ls, "node-0")  # warm-up
    run_stats.append(dict(solver.last_solve_stats))
    solve_ms, solve_stats = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        solved = solver.solve(ls, "node-0")
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        solve_stats.append(dict(solver.last_solve_stats))
    run_stats += solve_stats
    st = dict(solver.last_solve_stats)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.solve(ls, "node-0")
        torch.cuda.synchronize()
    prof_st = dict(solver.last_solve_stats)
    run_stats.append(prof_st)
    k_us, k_n = kernel_device_us(prof, tuple(relax.KERNEL_NAMES.values()))
    # each of the loop's kernels as CUPTI saw it in that replayed solve
    loop_cupti = {k: kernel_device_us(prof, (nm,))[1] for k, nm in dict(
        split_loop.KERNEL_NAMES, epilogue=rib_epilogue.KERNEL_NAME).items()
        if k != "exit"}
    solver.compute_routes(ls, ps, "node-0")  # warm-up
    run_stats.append(dict(solver.last_solve_stats))
    rib_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        rdb = solver.compute_routes(ls, ps, "node-0")
        rib_ms.append((time.perf_counter() - t0) * 1e3)
        run_stats.append(dict(solver.last_solve_stats))
    torch.cuda.synchronize()
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    # the split program's kernels (the sharded loops' exit is [13]'s)
    loop_launches = {k: n for k, n in split_loop.LAUNCHES.items()
                     if k != "exit"} | dict(epilogue=rib_epilogue.LAUNCHES)
    # the blocks the counted run replayed as a graph (a run with graph
    # nodes replayed each of its blocks), read from each call's stats
    graph_replays = sum(x["replays"] for x in run_stats
                        if x.get("graph_nodes"))
    for k, n in loop_launches.items():
        if n == 0:
            fail(f"the main path launched the loop's {k} kernel no time "
                 f"({loop_launches})")
    # the eager blocks' steps (the warm-up solve's): a snapshot (with the
    # tail's mark), two compactions and one decision each
    prog4 = next(p for p in solver._programs._progs.values() if not p.warm)
    eager_steps = prog4.steps * sum(x["replays"] for x in run_stats
                                    if not x.get("graph_nodes"))
    want = dict(snap_mark=eager_steps, compact=2 * eager_steps,
                ctl=eager_steps)
    if {k: loop_launches[k] for k in want} != want:
        fail(f"[4] the loop's wrapper counts {loop_launches}, not {want} "
             f"({eager_steps} eager steps)")
    idle4, span4 = trace_idle_share(lambda: solver.solve(ls, "node-0"),
                                    "spf:batched_solve")
    b = solved[1].device_tensor.shape[1]
    designs = path_designs(relax, tables, b)
    for d in designs:
        if launches[d] == 0:
            fail(f"the main path launched the {d} relax kernel no time")
    check_solve(csr, solved, rdb, cols=3, tag="100k")
    solve_p50 = statistics.median(solve_ms)
    rib_p50 = statistics.median(rib_ms)
    n_routes = len(rdb.unicast_routes)
    log(f"[4] solve p50 {solve_p50:.3f} ms (samples "
        f"{[round(x, 3) for x in solve_ms]}); full RIB p50 {rib_p50:.3f} ms "
        f"(samples {[round(x, 3) for x in rib_ms]}); routes {n_routes} "
        f"unicast + {len(rdb.mpls_routes)} mpls; routes/s "
        f"{n_routes / (rib_p50 / 1e3):.0f}")
    log(f"[4] per solve: sweeps {st['sweeps']}, tail rounds "
        f"{st['tail_rounds']}, spilled {st['spilled']}, host syncs "
        f"{st['host_syncs']}, replays {st['replays']}, steps "
        f"{st['steps']}, useful relax launches {st['relax_launches']}, "
        f"graph nodes {st['graph_nodes']}; over the 5 timed solves: host "
        f"syncs {[x['host_syncs'] for x in solve_stats]}, steps "
        f"{[x['steps'] for x in solve_stats]}, sweeps "
        f"{[x['sweeps'] for x in solve_stats]}, tail rounds "
        f"{[x['tail_rounds'] for x in solve_stats]}; the loop's and the "
        f"epilogue's launches by their wrappers (solves + RIBs; the "
        f"warm-up solve's eager blocks and every epilogue) "
        f"{loop_launches}, beside {graph_replays} replayed blocks of "
        f"{st['graph_nodes']} graph nodes; CUPTI's count of each in the "
        f"profiled solve {loop_cupti}; device-idle share of one traced solve "
        f"{'not measured' if idle4 is None else round(idle4, 4)} over its "
        f"{span4:.3f} ms span (profiling.trace)")
    if k_n:
        log(f"[4] relax kernel on the main path (CUPTI, one profiled solve "
            f"of {prof_st['sweeps']} sweeps / {prof_st['tail_rounds']} tail "
            f"rounds, {prof_st['relax_launches']} launches that did work): "
            f"{k_n} launches (every launch of the replayed block, the "
            f"guarded no-ops included), {k_us:.1f} us in all, "
            f"{k_us / k_n:.2f} us per launch")
    else:
        log("[4] relax kernel on the main path (CUPTI): not measured "
            "(the profiler saw no relax kernel)")
    log(f"[4] main-path relax launches by design by the wrappers (solves "
        f"+ RIBs; replayed blocks not counted): "
        f"{launches}; designs of its shapes {designs}; scipy root+2 "
        "neighbor columns and first hops: ok")
    phase4_hub(relax, old_libs)

    # ---- phase 5: the link-flap warm path ------------------------------
    p5 = phase5_warm(relax, (vp, w_base, ov_shape), p5_states)
    del p5_states  # [11] gets the states from p5; the CSR goes here
    warm_launches = p5["launches"]
    # ---- phase 11a: the rebuild sequence Decision runs, on [5]'s states --
    phase11_er100k(mods, p5.pop("states"), dict(solver=solver, ls=ls), fresh)

    # ---- phase 6: overloads + LFA ----------------------------------------
    phase6()

    # ---- phase 7: the gather probe ---------------------------------------
    probe = phase7_probe(relax, old_libs)

    # ---- phase 8: election and KSP kernels, config 4, election at scale --
    p8a = phase8a_kernels(election_ops, ksp_ops, csr)
    p8b = phase8b_config4(ksp_ops, old_libs.get("ksp"))
    p8c = phase8c_election(election_ops, solver, ls, csr, old_libs)
    p8d = phase8d_config4_ref(ksp_ops, old_libs.get("ksp"))

    # ---- phase 9: BASELINE config 2 at full width -----------------------
    p9 = phase9_config2(relax, election_ops, old_libs)

    # ---- phase 10: the batched multi-root paths, config 3, fleet ---------
    p10a = phase10a_edge(edge_ops)
    p10b = phase10b_config3(relax, edge_ops, ls, ps, csr, rdb)
    p10c = phase10c_kernels_at_config3(relax, edge_ops, csr, p10b["roots"],
                                       old_libs.get("edge_relax"),
                                       p10b["rows"]["edge"]["p50_ms"])
    phase10d_all_sources(edge_ops)
    p10e = phase10e_fleet(relax, edge_ops, p9)
    phase10f_hub(edge_ops)

    # ---- phase 11b: the same on config 2's states, and the hook's cost --
    phase11_config2(mods, p9, p10e)

    # ---- phase 13: the sharded solve at config 3's width ------------------
    p13 = phase13_sharded(relax, edge_ops, csr, p10b["roots"])

    # ---- phase 14: the split loop on the card and the RIB epilogue -------
    p14 = phase14_loop(relax, split_loop, rib_epilogue, solver, ls, tables)

    # ---- phase 15: the port's Decision on the card, configs 5 and 2 ------
    p15 = phase15(p9)

    # ---- phase 16: the port's KvStore feeding the Decision, configs 5, 2 -
    phase16(p15)

    # ---- phase 17: node N's route pipeline, a link change in, routes out -
    phase17(p9)

    # ---- phase 18: BASELINE config 1, a fat tree of port nodes in process -
    # the earlier phases' objects (config 2's states, ~millions) leave
    # the collector's scans, so that its full collections, which stop
    # every node's event loop, see the cluster's heap alone
    gc.collect()
    gc.freeze()
    p18 = phase18()
    gc.unfreeze()
    l18 = p18["launches"]

    kernels = []
    # vec: the er100k dense chunk; generic: config 2's, its main path
    for design, d, name, n_launch, worst in (
        ("vec", timing["dense"], relax.KERNEL_NAMES["vec"], launches["vec"],
         max(worst_r["vec"], worst_m["vec"])),
        ("generic", p9["calls"]["dense"], relax.KERNEL_NAMES["generic"],
         p9["generic_launches"],
         max(worst_r["generic"], worst_m["generic"], p9["worst"])),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "openr_tpu_torch/csrc/relax.cu",
            "replaces": "openr_tpu/ops/spf_pallas.py:90",
            "launches": n_launch,
            # [18]'s run, counted from 0 around it
            "config1_launches": l18["relax"][design],
            "max_abs_err": worst,
            "ms": d[design]["us"] / 1e3,
            "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_us"] / 1e3,
            "bound_by": d["bound_by"],
            "library_ms": None,
            "timed_by": d[design]["timed_by"],
            **({"old_ms": d[f"old {design}"]["us"] / 1e3}
               if f"old {design}" in d else {}),
        })
    for design, fn, line in (("generic", "sweep_b1", 81),
                             ("vec", "sweep_b2", 102)):
        row = probe[fn]
        kernels.append({
            "name": f"{relax.KERNEL_NAMES[design]} (probe {fn})",
            "route": "cuda",
            "source": "openr_tpu_torch/csrc/relax.cu",
            "replaces": f"benchmarks/probe_pallas_gather.py:{line}",
            "launches": probe["launches"][design],
            "max_abs_err": row["max_abs_err"],
            "ms": row["us"] / 1e3,
            "plain_ms": probe["plain_ms"],
            "bound_ms": probe["bound_ms"],
            "bound_by": probe["bound_by"],
            "library_ms": None,
            "timed_by": "cupti",  # probe_gather raises without a launch
        })
    worst8 = p8a["worst"]
    kernels.append({
        "name": election_ops.KERNEL_NAME,
        "route": "cuda",
        "source": "openr_tpu_torch/csrc/election.cu",
        "replaces": "openr_tpu/ops/election.py:32",
        "launches": p8c["launches"] + p9["elect_launches"],
        "max_abs_err": max(worst8["elect"], p8c["err"], p9["elect"]["err"]),
        "ms": p8c["us"] / 1e3,
        "plain_ms": p8c["plain_ms"],
        "bound_ms": p8c["bound_ms"],
        "bound_by": p8c["bound_by"],
        "library_ms": p8c["lib_ms"],
        "timed_by": p8c["timed_by"],
    })
    for step in ("sssp", "walk"):
        row = p8b[step]
        kernels.append({
            "name": ksp_ops.KERNEL_NAMES[step],
            "route": "cuda",
            "source": "openr_tpu_torch/csrc/ksp.cu",
            "replaces": "openr_tpu/ops/ksp.py:57",
            "launches": p8b["launches"][step],
            "max_abs_err": max(worst8[step], row["err"]),
            "ms": row["us"] / 1e3,
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1],
            "library_ms": None,
            "timed_by": row["timed_by"],
            **({"passes": row["passes"], "plain_sweeps": row["sweeps"],
                "config4_10k_ms": p8d["sssp"]["us"] / 1e3,
                "config4_10k_bound_ms": p8d["sssp"]["bound"][0],
                "config4_10k_passes": p8d["sssp"]["passes"],
                "config4_10k_plain_sweeps": p8d["sssp"]["sweeps"],
                "config4_10k_launches": p8d["launches"]["sssp"],
                **({"old_ms": row["old"]["us"] / 1e3,
                    "config4_10k_old_ms": p8d["sssp"]["old"]["us"] / 1e3}
                   if row["old"] else {})}
               if step == "sssp" else {}),
        })
    dense3 = p10c["dense"]
    kernels.append({
        "name": f"{relax.KERNEL_NAMES[dense3['design']]} (config 3 dense "
                "sweep)",
        "route": "cuda",
        "source": "openr_tpu_torch/csrc/relax.cu",
        "replaces": "openr_tpu/ops/spf_pallas.py:90",
        "launches": p10b["dense_launches"],
        "max_abs_err": dense3["err"],
        "ms": dense3["us"] / 1e3,
        "plain_ms": dense3["plain_ms"],
        "bound_ms": dense3["bound_ms"],
        "bound_by": dense3["bound_by"],
        "library_ms": None,
        "timed_by": dense3["timed_by"],
    })
    for step, row_key, line in (("round", "fix", 86), ("init", "init", 73)):
        row = p10c[row_key]
        kernels.append({
            "name": edge_ops.KERNEL_NAMES[step],
            "route": "cuda",
            "source": "openr_tpu_torch/csrc/edge_relax.cu",
            "replaces": f"openr_tpu/ops/spf.py:{line}",
            "launches": p10b["edge_launches"][step],
            "max_abs_err": max(p10a["worst"], row["err"]),
            "ms": row["us"] / 1e3,
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "timed_by": row["timed_by"],
        })
    t14 = p14["a"]["timing"]
    for kind, fn, line in (
            ("snap_mark", "batched_sssp_split", "393,414"),
            ("compact", "_compact_ids", 250),
            ("ctl", "batched_sssp_split", 383),
            ("epilogue", "batched_sssp_split_rib", 524)):
        row = t14[kind]
        kname = (rib_epilogue.KERNEL_NAME if kind == "epilogue"
                 else split_loop.KERNEL_NAMES[kind])
        entry = {
            "name": kname,
            "route": "cuda",
            "source": ("openr_tpu_torch/csrc/rib_epilogue.cu"
                       if kind == "epilogue"
                       else "openr_tpu_torch/csrc/split_loop.cu"),
            "replaces": f"openr_tpu/ops/spf_split.py:{line} ({fn})",
            # by the wrappers in [4]'s run: the warm-up solve's eager
            # blocks (and every epilogue); the replayed blocks beside it
            "launches": loop_launches[kind],
            "config1_launches": (l18["rib_epilogue"] if kind == "epilogue"
                                 else l18["split_loop"][kind]),
            "graph_replays": graph_replays,
            "cupti_launches_one_solve": loop_cupti[kind],
            "max_abs_err": row["err"],
            "ms": row["us"] / 1e3,
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["lib_ms"],
            "timed_by": row["timed_by"],
        }
        # the other timed calls of the same kernel ([14a]), each with
        # its bound: a dense step's snapshot; the epilogue with LFA and
        # at B = 128 (hub102)
        for other in [k for k in t14 if k != kind and k.startswith(kind)]:
            tag = other[len(kind) + 1:]
            entry[f"{tag}_ms"] = t14[other]["us"] / 1e3
            entry[f"{tag}_bound_ms"] = t14[other]["bound_ms"]
        if kind == "epilogue":  # the dense and edge RIBs' ([10b])
            e10 = p10b["epilogue"]
            entry["dense_edge_rib_launches"] = e10["dense"] + e10["edge"]
            for lfa, row in e10["timing"].items():
                entry[f"vp131072_{lfa}_ms"] = row["us"] / 1e3
                entry[f"vp131072_{lfa}_bound_ms"] = row["bound_ms"]
        kernels.append(entry)
    # J's loops ([13]): the guarded one-round kernel H and the exit, at
    # the 4x2 mesh's shapes; launches over the meshes' runs
    t13 = p13["timing"]
    for name, source, line, row, launches, extra in (
            (f"{edge_ops.KERNEL_NAMES['round']} (guarded round)",
             "edge_relax.cu", "openr_tpu/parallel/sharded_spf.py:69 "
             "(_local_sssp's round in its while_loop, :95)", t13["round"],
             p13["launches"]["round_guarded"], {}),
            (split_loop.KERNEL_NAMES["exit"], "split_loop.cu",
             "openr_tpu/parallel/sharded_spf.py:82,84,173,175 (the "
             "while_loops' changed and cond)", t13["exit_split"],
             p13["launches"]["exit"],
             {"edge_ms": t13["exit_edge"]["us"] / 1e3,
              "edge_bound_ms": t13["exit_edge"]["bound_ms"],
              "edge_done_ms": t13["exit_edge"]["done_us"] / 1e3})):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"openr_tpu_torch/csrc/{source}",
            "replaces": line,
            "launches": launches,
            "max_abs_err": t13["round"]["err"],
            "ms": row["us"] / 1e3,
            "done_ms": row["done_us"] / 1e3,
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "timed_by": row["timed_by"],
            **extra,
        })
    log(f"[5] warm-path relax launches by design: {warm_launches}")
    log(f"[time] host seconds by phase (each line's wall since the line "
        f"before): { {k: round(v, 1) for k, v in PHASE_S.items()} }; "
        f"{time.perf_counter() - T_START:.1f} s since the imports")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


# ----------------------------------------------------------- phase 13

#: [13]'s meshes: (label, sources, graph, through a NCCL group)
MESHES = (("1x1", 1, 1, False), ("4x2", 4, 2, False), ("2x4", 2, 4, False),
          ("nccl 4x2", 4, 2, True))


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def j_counts() -> dict:
    """The launch counts [13] reads: kernel A's, kernel H's init and
    guarded round, and the sharded loops' exit."""
    from openr_tpu_torch.ops import edge_relax, relax, split_loop

    return dict(relax=relax.LAUNCHES, init=edge_relax.LAUNCHES["init"],
                round_guarded=edge_relax.LAUNCHES_GUARDED,
                exit=split_loop.LAUNCHES["exit"])


def timed_dist(solver, csr, roots, reps: int = 3):
    """(dist, wall ms of `reps` calls after a warm-up, the last call's
    stats, relax launches, host syncs of the ledger, every call's stats)
    of `solver._solve_dist(csr, roots)`, counted from before the
    warm-up."""
    from openr_tpu_torch.monitor import compile_ledger
    from openr_tpu_torch.ops import relax

    led = compile_ledger.ledger()
    relax0 = relax.LAUNCHES
    syncs0 = led.host_syncs
    d = solver._solve_dist(csr, roots)  # warm-up: tables and their parts
    torch.cuda.synchronize()
    times, calls = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        d = solver._solve_dist(csr, roots)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        calls.append(dict(solver.last_solve_stats))
    return (d, times, dict(solver.last_solve_stats), relax.LAUNCHES - relax0,
            led.host_syncs - syncs0, calls)


def sharded_edge_run(sharded_sssp_padded, mesh, args, roots_t, v, want,
                     tag: str, reps: int = 3) -> dict:
    """`sharded_sssp_padded` on config 3's edge arrays, `reps` calls:
    equal to kernel H's `batched_sssp` (`want`), else the run fails."""
    from openr_tpu_torch.monitor import compile_ledger

    led = compile_ledger.ledger()
    c0 = j_counts()
    syncs0 = led.host_syncs
    times, index_ms, calls = [], [], []
    for _ in range(reps):
        st: dict = {}
        t0 = time.perf_counter()
        got = sharded_sssp_padded(*args, roots_t, mesh, v, stats=st)
        full = got.full(roots_t.device)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        index_ms.append(st["index_ms"])
        calls.append(st)
        if not torch.equal(full, want):
            bad = int((full != want).sum().item())
            fail(f"phase 13: {tag} sharded edge solve differs from "
                 f"batched_sssp at {bad} entries")
    c1 = j_counts()
    launches = {k: c1[k] - c0[k] for k in ("init", "round_guarded", "exit")}
    if not all(launches.values()):
        fail(f"phase 13: {tag} edge launches {launches}: a kernel of the "
             "path was launched no time")
    return dict(times=times, index_ms=index_ms, rounds=st["rounds"],
                launches=launches, syncs=led.host_syncs - syncs0,
                calls=calls)


def j_bounds(edge_ops, csr, args, roots_t, dist, tables) -> dict:
    """The least time of J's two functions at config 3 on this card
    (`monitor/device.py` `bound`): the integer work of `fix_work` (one
    relaxation, four operations, of each usable edge out of each entry
    the result reaches), against the bytes of the inputs read once and
    the result written once: for the edge version the init and the
    fixpoint's count (`init_work` + `fix_work`), for the split version
    the split tables, the roots and the [vp, B] result."""
    from openr_tpu_torch.monitor import device

    src, dst, met, blk = args
    v, b = csr.padded_nodes, roots_t.shape[0]
    index = edge_ops.device_edge_index(src, dst, met, v)
    tile = edge_ops.tile_cols(b)
    ib, io = edge_ops.init_work(index, v, b, tile, roots_t)
    fb, fo = edge_ops.fix_work(src, blk, index, v, dist)
    t_bytes = sum(int(tables[k].nbytes) for k in (
        "base_nbr", "base_wgt", "ov_ids", "ov_nbr", "ov_wgt", "over"))
    s_bytes = t_bytes + b * 4 + tables["vp"] * b * 4
    return dict(edge=device.bound(ib + fb, io + fo), edge_bytes=ib + fb,
                split=device.bound(s_bytes, fo), split_bytes=s_bytes,
                ops=fo)


class noop_block:
    """Within the block, every sharded solve runs one more block after
    its loop has ended, with every row done (its launches no-ops, its
    exchanges moving unchanged rows), twice: timed by the host wall to
    its end, then in a profile. `got` gains the wall (ms), the device
    time of its kernels (CUPTI, µs, in all and by name) and K. The
    result must stay the solve's: the equality checks after it test the
    guards."""

    def __init__(self):
        from openr_tpu_torch.parallel import sharded_spf

        self.mod, self.got = sharded_spf, []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        real = self.keep = self.mod._run_blocks

        def wrapped(ctls, step):
            out = real(ctls, step)
            block = self.mod.BLOCK
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(block):
                for i in range(len(ctls)):
                    step(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(block):
                    for i in range(len(ctls)):
                        step(i)
                torch.cuda.synchronize()
            by = {nm: kernel_device_us(prof, (nm,)) for nm in (
                "relax_vec_kernel", "relax_generic_kernel",
                "edge_relax_kernel", "row_exit_kernel")}
            self.got.append(dict(block=block, rows=len(ctls), wall_ms=wall,
                                 device_us=kernel_device_us(prof, ("",))[0],
                                 by={k: v for k, v in by.items() if v[1]}))
            return out

        self.mod._run_blocks = wrapped
        return self

    def __exit__(self, *exc):
        self.mod._run_blocks = self.keep


def exit_vs_twin(split_loop, shape, g) -> int:
    """`row_exit_kernel` against `row_exit_ref` on seeded [shape] buffers
    (nothing fell, one entry fell, at the cap, done; copy off and on):
    max |diff| of prev and the control block."""
    worst = 0
    base = torch.randint(0, 1 << 20, shape, generator=g, device=DEVICE,
                         dtype=torch.int32)
    for case in ("still", "fell", "cap", "done"):
        for copy in (False, True):
            prev = base.clone()
            cur = base.clone()
            if case != "still":
                i = int(torch.randint(0, base.numel(), (1,), generator=g,
                                      device=DEVICE))
                cur.view(-1)[i] -= 1
                cur.view(-1)[-1] -= 3  # a lone element past the int4s
            ctl = split_loop.new_ctl(split_loop.NET, 0, 0, 9, DEVICE)
            ctl[split_loop.IT] = 8 if case == "cap" else 2
            if case == "done":
                ctl[split_loop.PHASE] = split_loop.DONE
            p2, c2 = prev.clone(), ctl.clone()
            split_loop.row_exit(cur, prev, ctl, 1 << split_loop.NET, copy)
            split_loop.row_exit_ref(cur, p2, c2, 1 << split_loop.NET, copy)
            torch.cuda.synchronize()
            worst = max(worst, max_diff([(prev, p2), (ctl, c2)]))
    return worst


def guarded_round_at(edge_ops, split_loop, sl, v, b, tag) -> dict:
    """The guarded one-round `edge_relax_kernel` on one edge slice `sl`
    (src, dst, metric, blocked, index) at [v, b]: live and done against
    the twin (a done launch writes neither out nor changed), timed live
    and done (CUPTI) beside its bound and the twin's time."""
    from openr_tpu_torch.monitor import device

    src, dst, met, blk, index = sl
    g = torch.Generator(device=DEVICE).manual_seed(13)
    cur = torch.randint(0, 5000, (v, b), generator=g, device=DEVICE,
                        dtype=torch.int32)
    cur[torch.rand((v, b), generator=g, device=DEVICE) < 0.3] = INF
    live = split_loop.new_ctl(split_loop.NET, 0, 0, v, DEVICE)
    done = live.clone()
    done[split_loop.PHASE] = split_loop.DONE
    mask = 1 << split_loop.NET
    scratch = edge_ops.fix_scratch(v, cur.device)
    outs = {}
    for name, ctl in (("live", live), ("done", done)):
        out = torch.full_like(cur, -7)
        ch = torch.full((1,), 5, dtype=torch.int32, device=DEVICE)
        edge_ops.edge_round(cur, out, src, dst, met, blk, index.row_start,
                            ch, index=index, ctl=ctl, phase_mask=mask,
                            scratch=scratch)
        outs[name] = (out, ch)
    ref = torch.empty_like(cur)
    ref_ch = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    edge_ops.edge_round_ref(cur, ref, src, dst, met, blk, ref_ch)
    torch.cuda.synchronize()
    err = max_diff([(outs["live"][0], ref), (outs["live"][1], ref_ch),
                    (outs["done"][0], torch.full_like(cur, -7)),
                    (outs["done"][1], torch.full_like(ref_ch, 5))])
    if err:
        fail(f"[{tag}] the guarded edge round differs from its twin by {err}")
    out = torch.empty_like(cur)
    times = {}
    for name, ctl in (("live", live), ("done", done)):
        times[name] = kernel_us(
            lambda ctl=ctl: edge_ops.edge_round(
                cur, out, src, dst, met, blk, index.row_start, None,
                index=index, ctl=ctl, phase_mask=mask, scratch=scratch),
            lambda: None, edge_ops.KERNEL_NAMES["round"])
    nbytes, ops, _g = edge_ops.round_work(src, blk, index, v, b)
    bms, by = device.bound(nbytes, ops)
    plain_ms = cuda_ms(lambda: edge_ops.edge_round_ref(
        cur, ref, src, dst, met, blk, ref_ch))
    log(f"[{tag}] guarded edge_relax_kernel, one round on an edge slice of "
        f"{int(src.shape[0])} slots at [{v}, {b}]: live "
        f"{times['live'][0]:.2f} us ({times['live'][1]}), done "
        f"{times['done'][0]:.2f} us ({times['done'][1]}); equal to its twin "
        f"live, and done it wrote neither out nor changed; bound "
        f"{bms * 1e3:.2f} us by {by} ({nbytes} B), share "
        f"{bms * 1e3 / times['live'][0]:.3f}; plain twin {plain_ms:.3f} ms; "
        f"card {smi('name,power.limit')}")
    return dict(us=times["live"][0], timed_by=times["live"][1],
                done_us=times["done"][0], err=err, bound_ms=bms, bound_by=by,
                plain_ms=plain_ms)


def exit_at(split_loop, shape, copy: bool, tag: str) -> dict:
    """`row_exit_kernel` at a [13] call's shape: live (one entry fell,
    the control block restored before each launch) and done, timed
    (CUPTI) beside its bound and its twin's time."""
    from openr_tpu_torch.monitor import device

    g = torch.Generator(device=DEVICE).manual_seed(17)
    prev = torch.randint(0, 1 << 20, shape, generator=g, device=DEVICE,
                         dtype=torch.int32)
    cur = prev.clone()
    cur.view(-1)[cur.numel() // 2] -= 1
    keep = prev.clone()
    ctl0 = split_loop.new_ctl(split_loop.NET, 0, 0, 1 << 20, DEVICE)
    ctl = ctl0.clone()
    done = ctl0.clone()
    done[split_loop.PHASE] = split_loop.DONE
    mask = 1 << split_loop.NET

    def restore():
        ctl.copy_(ctl0)
        if copy:
            prev.copy_(keep)

    live_us, how = kernel_us(
        lambda: split_loop.row_exit(cur, prev, ctl, mask, copy), restore,
        split_loop.KERNEL_NAMES["exit"])
    done_us, _how = kernel_us(
        lambda: split_loop.row_exit(cur, prev, done, mask, copy),
        lambda: None, split_loop.KERNEL_NAMES["exit"])
    restore()
    p2, c2 = prev.clone(), ctl.clone()
    plain_ms = cuda_ms(lambda: (restore(), split_loop.row_exit_ref(
        cur, p2, c2, mask, copy), c2.copy_(ctl0)))
    bms, by = device.bound(*split_loop.exit_work(cur.numel(), copy))
    log(f"[{tag}] row_exit_kernel at {tuple(shape)} (copy {copy}): live "
        f"{live_us:.2f} us ({how}), done {done_us:.2f} us; bound "
        f"{bms * 1e3:.2f} us by {by}, share {bms * 1e3 / live_us:.3f}; "
        f"plain twin {plain_ms:.3f} ms; card {smi('name,power.limit')}")
    return dict(us=live_us, timed_by=how, done_us=done_us, bound_ms=bms,
                bound_by=by, plain_ms=plain_ms)


def phase13_sharded(relax, edge_ops, csr, roots,
                    sweep_k: bool = False) -> dict:
    """[13] (see the module docstring); with `sweep_k` (`--only 13`),
    the 4x2 mesh's calls at each K of BLOCK_SWEEP too."""
    import os

    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.ops import split_loop
    from openr_tpu_torch.ops.spf import build_blocked
    from openr_tpu_torch.parallel import (
        distributed,
        make_mesh,
        sharded_spf,
        sharded_sssp_padded,
    )

    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    pos = torch.device(DEVICE)  # every position of every mesh
    n = csr.num_nodes
    k_default = sharded_spf.BLOCK
    torch.cuda.synchronize()
    relax.reset_launches()
    edge_ops.reset_launches()
    split_loop.reset_launches()
    plain = TorchSpfSolver(device=DEVICE)
    ref, t_plain, st_plain, n_plain, sync_plain, _c = timed_dist(
        plain, csr, roots)
    p50_plain = statistics.median(t_plain)
    log(f"[13] config 3 unmeshed split: p50 {p50_plain:.3f} ms (samples "
        f"{[round(x, 3) for x in t_plain]}); sweeps {st_plain['sweeps']}, "
        f"relax launches by the wrapper {n_plain} in 4 calls (the first "
        f"eager, then replays), host syncs {sync_plain} in 4 "
        f"calls; card {card}")
    tables = plain._device_arrays(csr)
    del plain
    blocked = build_blocked(csr.edge_metric, csr.edge_src,
                            csr.node_overloaded)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE) for a in (
        csr.edge_src, csr.edge_dst, csr.edge_metric, blocked)]
    roots_t = torch.from_numpy(roots).to(DEVICE)
    v = csr.padded_nodes
    want_edge = edge_ops.batched_sssp(*args, roots_t, v)
    jb = j_bounds(edge_ops, csr, args, roots_t, want_edge, tables)
    log(f"[13] J's least time at config 3 on this card: the split version "
        f"{jb['split'][0] * 1e3:.2f} us by {jb['split'][1]} "
        f"({jb['split_bytes']} B, {jb['ops']} integer ops), the edge version "
        f"{jb['edge'][0] * 1e3:.2f} us by {jb['edge'][1]} "
        f"({jb['edge_bytes']} B); no single PyTorch call computes either")

    # ---- the index on the card: slice 0 of 4x2, against NumPy's ----------
    half = int(args[0].shape[0]) // 2
    sl = [a[:half].contiguous() for a in args]
    host = [a.cpu().numpy() for a in sl[:3]]
    t0 = time.perf_counter()
    np_index = edge_ops.edge_index(*host, v)
    np_ms = (time.perf_counter() - t0) * 1e3
    edge_ops.device_edge_index(*sl[:3], v)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_index = edge_ops.device_edge_index(*sl[:3], v)
    torch.cuda.synchronize()
    dev_ms = (time.perf_counter() - t0) * 1e3
    for name, a, b in zip(edge_ops.EdgeIndex._fields, np_index, dev_index):
        if not np.array_equal(a, b.cpu().numpy()):
            fail(f"[13] the index built on the card differs from NumPy's in "
                 f"{name}")
    log(f"[13] an edge slice's index ({half} slots, {len(np_index.seg_node)}"
        f" segments): built on the card {dev_ms:.3f} ms (one host read), "
        f"NumPy on the host {np_ms:.3f} ms; every field equal")

    # ---- the kernels of J's loops at its main path's shapes --------------
    g = torch.Generator(device=DEVICE).manual_seed(11)
    bs = len(roots) // 4
    exit_err = max(exit_vs_twin(split_loop, (4096, 12), g),
                   exit_vs_twin(split_loop, (tables["vp"], bs), g))
    if exit_err:
        fail(f"[13] row_exit_kernel differs from its twin by {exit_err}")
    log(f"[13] row_exit_kernel vs row_exit_ref: nothing fell, one fell, "
        f"the cap, done; copy off and on; at [4096, 12] and "
        f"[{tables['vp']}, {bs}]: equal")
    timing = dict(
        exit_split=exit_at(split_loop, (tables["vp"], bs), True, "13"),
        exit_edge=exit_at(split_loop, (v, bs), False, "13"),
        round=guarded_round_at(
            edge_ops, split_loop,
            (*sl, edge_ops.device_edge_index(*sl[:3], v)), v, bs, "13"))
    timing["round"]["err"] = max(timing["round"]["err"], exit_err)
    c_path = j_counts()  # the path's run starts here: counts from here

    env = dict(OPENR_COORDINATOR=f"127.0.0.1:{free_port()}",
               OPENR_NUM_PROCESSES="1", OPENR_PROCESS_ID="0")
    per_mesh = {}
    try:
        for label, s_n, g_n, nccl in MESHES:
            if nccl:
                os.environ.update(env)
                if not distributed.initialize():
                    fail("phase 13: distributed.initialize() did not start "
                         "the process group")
                mesh = distributed.global_mesh(
                    n_graph=g_n, local_devices=[pos] * (s_n * g_n))
                if mesh.groups is None or len(mesh.groups) != s_n:
                    fail(f"phase 13: global_mesh made {mesh}, no groups")
            else:
                mesh = make_mesh(s_n, g_n, devices=[pos] * (s_n * g_n))
            solver = TorchSpfSolver(device=DEVICE, mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            d, times, st, n_relax, syncs, calls = timed_dist(solver, csr,
                                                             roots)
            peak = torch.cuda.max_memory_allocated()
            if not n_relax:
                fail(f"phase 13: mesh {label} launched the relax kernel no "
                     "time")
            if st.get("mesh") != dict(mesh.shape):
                fail(f"phase 13: mesh {label} did not take the sharded "
                     f"solve ({st})")
            with noop_block() as nb:  # one call more, a no-op block after
                d2 = solver._solve_dist(csr, roots)
            for got in (d, d2):
                if not torch.equal(got[:n], ref[:n]):
                    bad = int((got[:n] != ref[:n]).sum().item())
                    fail(f"phase 13: mesh {label} differs from the unmeshed "
                         f"split solve at {bad} entries")
            k = st["block"]
            limit = -(-st["sweeps"] // k) + 1
            if any(c["host_syncs"] != c["replays"] or c["host_syncs"] > limit
                   for c in calls):
                fail(f"phase 13: mesh {label} split host syncs "
                     f"{[c['host_syncs'] for c in calls]}, replays "
                     f"{[c['replays'] for c in calls]}: more than "
                     f"ceil({st['sweeps']} / {k}) + 1")
            rows = solver.last_shard_rows
            if len(rows) != s_n * g_n:
                fail(f"phase 13: mesh {label} has {len(rows)} shard rows")
            log(f"[13] mesh {label}: shard rows " + "; ".join(
                f"{r['device']} {r['platform']} cols {r['index'][1]} "
                f"{r['shard_bytes']} B" for r in rows))
            noop = nb.got[-1]
            log(f"[13] mesh {label} split: p50 "
                f"{statistics.median(times):.3f} ms (samples "
                f"{[round(x, 3) for x in times]}) beside the unmeshed "
                f"{p50_plain:.3f} ms; K {k}, sweeps {st['sweeps']} (rows "
                f"{st['row_trips']}), blocks and host syncs per call "
                f"{[c['replays'] for c in calls]} / "
                f"{[c['host_syncs'] for c in calls]} (ledger {syncs} in 4 "
                f"calls); relax launches {n_relax} in 4 calls "
                f"({st['relax_launches']} in the last); a block of {k} "
                f"sweeps with every row done: {noop['wall_ms']:.3f} ms host "
                f"wall, {noop['device_us']:.1f} us of kernels "
                f"({ {a: (round(b[0], 1), b[1]) for a, b in noop['by'].items()} }"
                f"), {noop['wall_ms'] / k:.3f} ms a no-op sweep; peak device "
                f"memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} "
                f"over the {base / 2**20:.1f} held before); equal to the "
                f"unmeshed split on {n} x {len(roots)}; card {card}")
            per_mesh[label] = dict(split_p50=statistics.median(times),
                                   sweeps=st["sweeps"], k=k,
                                   syncs=[c["host_syncs"] for c in calls],
                                   noop_sweep_ms=noop["wall_ms"] / k)
            del solver, d, d2
            torch.cuda.reset_peak_memory_stats()
            er = sharded_edge_run(sharded_sssp_padded, mesh, args, roots_t,
                                  v, want_edge, label)
            with noop_block() as nb:  # checked equal after its no-op block
                sharded_edge_run(sharded_sssp_padded, mesh, args, roots_t, v,
                                 want_edge, label, reps=1)
            rounds = er["rounds"]
            limit = -(-rounds // k) + 1
            if any(c["host_syncs"] != c["replays"] or c["host_syncs"] > limit
                   for c in er["calls"]):
                fail(f"phase 13: mesh {label} edge host syncs per call "
                     f"{[c['host_syncs'] for c in er['calls']]}: more than "
                     f"ceil({rounds} / {k}) + 1")
            noop = nb.got[-1]
            log(f"[13] mesh {label} edge (sharded_sssp_padded): p50 "
                f"{statistics.median(er['times']):.3f} ms (samples "
                f"{[round(x, 3) for x in er['times']]}; of which the "
                f"slice indexes built on the card "
                f"{[round(x, 3) for x in er['index_ms']]} ms, beside "
                f"{np_ms:.3f} ms for one NumPy build of a 4x2 slice's), K "
                f"{k}, rounds {rounds} (rows {er['calls'][-1]['row_trips']}),"
                f" blocks and host syncs per call "
                f"{[c['replays'] for c in er['calls']]} / "
                f"{[c['host_syncs'] for c in er['calls']]} (ledger "
                f"{er['syncs']} in 3 calls); launches {er['launches']} in 3 "
                f"calls; a block of {k} rounds with every row done: "
                f"{noop['wall_ms']:.3f} ms host wall, "
                f"{noop['device_us']:.1f} us of kernels "
                f"({ {a: (round(b[0], 1), b[1]) for a, b in noop['by'].items()} }"
                f"), {noop['wall_ms'] / k:.3f} ms a no-op round; peak device "
                f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
                f"equal to batched_sssp on {v} x {len(roots)} (after the "
                f"no-op block); card {card}")
            per_mesh[label].update(
                edge_p50=statistics.median(er["times"]), rounds=rounds,
                edge_syncs=[c["host_syncs"] for c in er["calls"]],
                index_ms=er["index_ms"], noop_round_ms=noop["wall_ms"] / k)
            if label == "4x2" and sweep_k:
                per_mesh["k_sweep"] = block_sweep(
                    sharded_spf, sharded_sssp_padded, mesh, csr, roots, ref,
                    args, roots_t, v, want_edge)
    finally:
        distributed.shutdown()
        for key in env:
            os.environ.pop(key, None)
    c_end = j_counts()
    launches = {k: c_end[k] - c_path[k] for k in c_path}
    if not all(launches.values()):
        fail(f"phase 13: launches {launches} over the meshes: a kernel of "
             "the path was launched no time")
    if sharded_spf.BLOCK != k_default:
        fail("phase 13: the block sweep left sharded_spf.BLOCK changed")
    log(f"[13] launches over the meshes' runs (counts from before the "
        f"first mesh): {launches}; {time.perf_counter() - t_phase:.1f} s in "
        "all; the positions share one card: a correctness path for the "
        "sharding and the collectives, no multi-card speed")
    return dict(launches=launches, timing=timing, meshes=per_mesh,
                index=dict(card_ms=dev_ms, numpy_ms=np_ms))


#: [13]: the blocks of K sweeps or rounds tried at config 3 on the 4x2 mesh
BLOCK_SWEEP = (1, 2, 4, 8, 16, 32)


def block_sweep(sharded_spf, sharded_sssp_padded, mesh, csr, roots, ref,
                args, roots_t, v, want_edge) -> dict:
    """The 4x2 mesh's split and edge calls at each K of BLOCK_SWEEP (3
    calls each after a warm-up, results equal): the p50s K is chosen
    from."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    keep = sharded_spf.BLOCK
    out = {}
    n = csr.num_nodes
    try:
        for k in BLOCK_SWEEP:
            sharded_spf.BLOCK = k
            solver = TorchSpfSolver(device=DEVICE, mesh=mesh)
            d, times, st, _n, _s, calls = timed_dist(solver, csr, roots)
            if not torch.equal(d[:n], ref[:n]):
                fail(f"phase 13: K {k}: the meshed split differs")
            er = sharded_edge_run(sharded_sssp_padded, mesh, args, roots_t,
                                  v, want_edge, f"K {k}")
            out[k] = dict(split=statistics.median(times),
                          split_syncs=calls[-1]["host_syncs"],
                          edge=statistics.median(er["times"]),
                          edge_syncs=er["calls"][-1]["host_syncs"])
            del solver, d
    finally:
        sharded_spf.BLOCK = keep
    log("[13] 4x2 p50 by K (split ms / host syncs, edge ms / host syncs): "
        + "; ".join(f"K {k}: {r['split']:.3f} / {r['split_syncs']}, "
                    f"{r['edge']:.3f} / {r['edge_syncs']}"
                    for k, r in out.items())
        + f"; the default K {keep}; card {smi('name,power.limit')}")
    return out


def phase6() -> None:
    """Overloaded nodes + LFA on a small WAN-like graph."""
    from dataclasses import replace

    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from openr_tpu_torch.decision.linkstate import LinkState
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.utils.topogen import wan_like

    adj, _pfx = wan_like(300, seed=5)
    over_names = {"node-3", "node-7", "node-120"}
    ls = LinkState()
    for db in adj:
        if db.this_node_name in over_names:
            db = replace(db, is_overloaded=True)
        ls.update_adjacency_db(db)
    me = "node-3"  # an overloaded root: its own out-edges stay usable
    solver = TorchSpfSolver(device=DEVICE, enable_lfa=True)
    csr, dist, fh, nbr_ids, lfa = solver.solve(ls, me)
    n = csr.num_nodes
    e = csr.num_edges
    my_id = csr.name_to_id[me]
    src, dst = csr.edge_src[:e], csr.edge_dst[:e]
    w = csr.edge_metric[:e].astype(np.float64)
    over = csr.node_overloaded[:n]

    def col(root):
        keep = ~over[src] | (src == root)  # overloaded: no transit
        g = csr_matrix((w[keep], (src[keep], dst[keep])), shape=(n, n))
        d = dijkstra(g, directed=True, indices=[root])[0]
        return np.where(np.isinf(d), INF, d).astype(np.int64)

    roots = [my_id] + list(nbr_ids)
    ref = np.stack([col(r) for r in roots])  # [1+N, n]
    got = np.asarray(dist)[:n, : len(roots)].T.astype(np.int64)
    if not np.array_equal(got, ref):
        fail("phase 6: distances disagree with scipy dijkstra")
    d_root, d_n = ref[0], ref[1:]
    met = np.array([min(x[1] for x in csr.details(my_id, j)) for j in nbr_ids])
    ids = np.arange(n)
    allowed = ~over[np.array(nbr_ids)][:, None] | (
        ids[None, :] == np.array(nbr_ids)[:, None]
    )
    reach = (d_root < INF)[None, :] & (d_n < INF)
    fh_ref = reach & (met[:, None] + d_n == d_root[None, :]) & allowed
    n_to_root = d_n[:, my_id]
    lfa_ref = (
        reach & (n_to_root < INF)[:, None]
        & (d_n < np.minimum(n_to_root[:, None] + d_root[None, :], INF))
        & allowed
    )
    k = len(nbr_ids)
    if not np.array_equal(fh[:k, :n], fh_ref):
        fail("phase 6: first-hop bits disagree with the recomputation")
    if not np.array_equal(lfa[:k, :n], lfa_ref):
        fail("phase 6: LFA bits disagree with the recomputation")
    if fh[k:].any() or lfa[k:].any():
        fail("phase 6: padding neighbor rows carry bits")
    log(f"[6] overloads+LFA: {n} nodes, {len(over_names)} overloaded "
        f"(root among them), {k} neighbors; fh bits {int(fh.sum())}, "
        f"lfa bits {int(lfa.sum())}: distances, fh and LFA exact")


# ----------------------------------------------------------- phase 14

#: [14]'s whole-program cases on a 20 000-node ER (its CPU twin runs in
#: seconds): (label, solve knobs, LFA, overload share, steps a block)
LOOP_CASES = (
    ("cold", {}, False, 0.0, None),
    ("cold K=1", {}, False, 0.0, 1),
    ("spill", dict(tail_cap=256, tail_rounds_cap=4), False, 0.0, None),
    ("long tail", dict(tail_threshold=20_000, tail_cap=20_480,
                       tail_rounds_cap=512), True, 0.0, 64),
    ("overloads+LFA", {}, True, 0.02, None),
)
LOOP_N = 20_000
#: frontier rows of [14]'s timed tail step (a tail round's at er100k)
MARK_ROWS = 300
#: [14a]'s epilogue shapes beside er100k's, the CPU tests' (`tests/
#: test_torch_rib_epilogue.py` SHAPES): B, with N 0, 1 and B - 1
#: neighbors, on vp / 8 odd (129) and even
EPI_B = (8, 16, 32, 64, 128)
EPI_VP = (1032, 4096)


def trace_idle_share(fn, span: str) -> tuple[float | None, float]:
    """(device-idle share, span ms) of one call of `fn` traced with the
    port's `profiling.trace`: 1 - the union of the card's kernel and copy
    intervals inside the `span` annotation over the span's length, read
    from the exported Chrome trace. None where the trace holds no device
    event inside the span."""
    from openr_tpu_torch.monitor.profiling import trace

    out = Path(tempfile.mkdtemp(prefix="trace_"))
    try:
        with trace(str(out)):
            fn()
            torch.cuda.synchronize()
        files = sorted(out.glob("*.json"))
        if not files:
            fail(f"profiling.trace wrote no trace into {out}")
        events = json.loads(files[-1].read_text()).get("traceEvents", [])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    spans = [e for e in events if e.get("name") == span and "dur" in e]
    if not spans:
        fail(f"the trace holds no {span!r} span")
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    dev = sorted(
        (max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
        and "dur" in e and e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    if not dev:
        return None, (t1 - t0) / 1e3
    busy, cur_a, cur_b = 0.0, *dev[0]
    for a, b in dev[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return 1.0 - busy / (t1 - t0), (t1 - t0) / 1e3


def epilogue_case(g, vp: int, b: int, n: int, holes: bool) -> tuple:
    """A seeded [vp, b] distance matrix on the card whose root column is
    the least of its first neighbors' columns plus their metrics on most
    rows (so first hops hold), each neighbor at 0 on its own row, with n
    neighbor arrays (11 real, the rest the dead slot's padding); `holes`
    adds INF destinations, INF cells, an INF column and INF rows.
    Returns (dist, metric, ids, over, my_id), `rib_buffer`'s arguments
    before `with_lfa`."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=DEVICE)

    real = min(n, 11)
    ids = torch.full((n,), vp - 1, dtype=torch.int32, device=DEVICE)
    ids[:real] = torch.randperm(vp - 1, generator=g, device=DEVICE)[:real].to(
        torch.int32)
    met = torch.full((n,), (1 << 30) - 1, dtype=torch.int32, device=DEVICE)
    met[:real] = ints(1, 12, (real,)).to(torch.int32)
    over = torch.ones(n, dtype=torch.bool, device=DEVICE)
    over[:real] = torch.rand(real, generator=g, device=DEVICE) < 0.4
    d = ints(0, 60, (vp, b))
    if real:
        best = (d[:, 1:1 + real] + met[:real].long()).min(dim=1).values
        keep = torch.rand(vp, generator=g, device=DEVICE) < 0.8
        d[:, 0] = torch.where(keep, best, ints(0, 80, (vp,)))
        d[ids[:real].long(), 1 + torch.arange(real, device=DEVICE)] = 0
    my_id = int(ints(0, vp - 1, (1,)))
    d[my_id, 0] = 0
    if holes:
        d[torch.rand(vp, generator=g, device=DEVICE) < 0.1, 0] = INF
        d[torch.rand((vp, b), generator=g, device=DEVICE) < 0.05] = INF
        d[:, min(3, b - 1)] = INF
        d[torch.randperm(vp, generator=g, device=DEVICE)[:30]] = INF
    return d.to(torch.int32), met, ids, over, my_id


def epilogue_timed(dist, nbr, tag: str) -> dict:
    """`rib_epilogue_kernel` on a solve's distances and neighbor arrays
    (`rib_arrays`), LFA off and on: equal to its twin, then timed (CUPTI)
    beside its bound and the twin's time."""
    from openr_tpu_torch.ops import rib_epilogue

    out = {}
    for with_lfa in (False, True):
        args = (dist, nbr["metric"], nbr["ids"], nbr["over"], nbr["my_id"],
                with_lfa)
        err = max_diff([(rib_epilogue.rib_buffer(*args),
                         rib_epilogue.rib_buffer_ref(*args))])
        if err:
            fail(f"[{tag}] rib_epilogue_kernel differs from its twin by {err}")
        us, how = kernel_us(lambda: rib_epilogue.rib_buffer(*args),
                            lambda: None, rib_epilogue.KERNEL_NAME)
        work = rib_epilogue.epilogue_work(*dist.shape, nbr["ids"].shape[0],
                                          with_lfa)
        bms, by = bound(*work)
        plain_ms = cuda_ms(lambda: rib_epilogue.rib_buffer_ref(*args))
        out["lfa" if with_lfa else "off"] = dict(
            us=us, timed_by=how, bound_ms=bms, bound_by=by, plain_ms=plain_ms)
        log(f"[{tag}] rib_epilogue_kernel at {tuple(dist.shape)} (N "
            f"{nbr['ids'].shape[0]}, LFA {'on' if with_lfa else 'off'}): "
            f"{us:.3f} us ({how}), equal to the twin; bound {bms * 1e3:.3f} "
            f"us by {by} ({work[0]} B), share {bms * 1e3 / us:.3f}; plain "
            f"twin {plain_ms:.4f} ms; card {smi('name,power.limit')}")
    return out


def rib_arrays(solver, csr, solved, me: str):
    """(the solve's distances on the card, the epilogue's neighbor
    arrays as the solver pads them) for `solved`, a `solve` from `me`."""
    dist = solved[1].device_tensor
    my_id = csr.name_to_id[me]
    nbr_ids = solved[3]
    roots, ids, met, over = solver._rib_pad_arrays(
        csr, my_id, nbr_ids,
        np.array([min(x[1] for x in csr.details(my_id, j)) for j in nbr_ids],
                 np.int32), dist.shape[1])
    return dist, dict(
        roots=torch.from_numpy(roots).to(DEVICE),
        ids=torch.from_numpy(ids).to(DEVICE),
        metric=torch.from_numpy(met).to(DEVICE),
        over=torch.from_numpy(over).to(DEVICE), my_id=my_id)


def loop_ctl(split_loop, phase, **words):
    ctl = split_loop.new_ctl(phase, 1024, 64, 1 << 20, DEVICE)
    for k, v in words.items():
        ctl[getattr(split_loop, k)] = v
    return ctl


#: the tail's decision rows (`tests/test_torch_split_loop.py` DECISIONS,
#: stage 1): control words before a frontier compaction with `decide`,
#: RAW_FRONT given as the number of flags set
DECIDE_ROWS = (dict(RAW_FRONT=0), dict(RAW_FRONT=3, IT=5),
               dict(RAW_FRONT=3, IT=64), dict(RAW_FRONT=0, SPILL=1, IT=2))


def compact_call(sl, kernel: bool, flags, out, ctl, mask, count_slot,
                 raw_slot, dead, clear, decide, ws) -> None:
    """One compaction by the kernel (on workspace `ws`) or by its twin."""
    if kernel:
        sl.flag_compact(flags, out, ctl, mask, count_slot, raw_slot, dead,
                        clear, decide=decide, ws=ws)
    else:
        sl.flag_compact_ref(flags, out, ctl, mask, count_slot, raw_slot,
                            dead, clear, decide)


def compaction_cases(vp: int, cap: int, g, t: int) -> list:
    """[14a]'s compaction inputs: (label, flags, control words, decide)."""
    def flagged(n, pos, vals=None):
        f = torch.zeros(n, dtype=torch.int32, device=DEVICE)
        pos = torch.as_tensor(pos, device=DEVICE).long()
        f[pos] = 1 if vals is None else vals
        return f

    cases = []
    for marks in (0, 1, cap, cap + 1, 3000, 50_000, vp):
        pick = torch.randperm(vp, generator=g, device=DEVICE)[:marks]
        vals = 1 + torch.randint(0, 5, (pick.numel(),), generator=g,
                                 device=DEVICE, dtype=torch.int32)
        cases.append((f"{marks} marks", flagged(vp, pick, vals), {}, False))
    cases.append(("dead slot", flagged(vp, [3, 17, vp - 1]), {}, False))
    cases.append(("ragged length", flagged(vp - 5, [vp - 8, vp - 7, vp - 6]),
                  {}, False))
    edges = [x for x in (0, t - 1, t, 2 * t - 1, vp - 1) if x < vp]
    cases.append((f"tile edges of {t}", flagged(vp, edges), {}, False))
    for n in (1, 1000, 4099, vp - 5):  # n < T, n = 1, not a multiple of 4
        cases.append((f"all {n} set", flagged(n, torch.arange(n)), {},
                      False))
    for raw in (cap - 1, cap, cap + 1):  # spread over every tile
        pos = torch.linspace(0, vp - 1, raw, device=DEVICE).long()
        cases.append((f"raw {raw} spread", flagged(vp, pos), {}, False))
    for words in DECIDE_ROWS:
        w = dict(words)
        raw = w.pop("RAW_FRONT")
        pos = torch.linspace(0, vp - 1, raw, device=DEVICE).long()
        cases.append((f"decide {words}", flagged(vp, pos), w, True))
    pos = torch.linspace(0, vp - 1, cap + 1, device=DEVICE).long()
    cases.append(("decide, its own spill", flagged(vp, pos), dict(IT=1),
                  True))
    return cases


def compact_vs_twin(sl, flags, cap, words, clear, decide, ws) -> int:
    """Max |diff| of (out, ctl, flags) between the kernel and its twin on
    copies of the same inputs; fails if the kernel leaves `ws` non-zero."""
    res = []
    for kernel in (True, False):
        f = flags.clone()
        out = torch.full((cap,), 7, dtype=torch.int32, device=DEVICE)
        ctl = loop_ctl(sl, sl.TAIL, **words)
        compact_call(sl, kernel, f, out, ctl, sl.M_TAIL, sl.N_FRONT,
                     sl.RAW_FRONT, flags.shape[0] - 1, clear, decide, ws)
        res.append(torch.cat([out, ctl, f]).long())
    torch.cuda.synchronize()
    if bool(ws.any()):
        fail("[14] flag_compact_kernel left its workspace non-zero: "
             f"{ws.nonzero().reshape(-1).tolist()[:8]}")
    return int((res[0] - res[1]).abs().max())


def compact_guarded(sl, flags, cap, phase, ws, label) -> None:
    """A launch in another phase than its mask's touches nothing: not
    out, flags, ctl or the workspace."""
    f = flags.clone()
    out = torch.full((cap,), 7, dtype=torch.int32, device=DEVICE)
    ctl = loop_ctl(sl, phase, IT=3)
    ws_before = ws.clone()
    sl.flag_compact(f, out, ctl, sl.M_TAIL, sl.N_FRONT, sl.RAW_FRONT,
                    flags.shape[0] - 1, True, decide=True, ws=ws)
    if not (bool((out == 7).all()) and torch.equal(f, flags)
            and torch.equal(ctl, loop_ctl(sl, phase, IT=3))
            and torch.equal(ws, ws_before)):
        fail(f"[14] flag_compact_kernel ({label}, phase {phase}): a "
             "guarded launch wrote")


def compact_self_reset(sl, vp, cap, g, ws, launches: int = 1000,
                       replays: int = 100) -> int:
    """`launches` compactions back to back on one workspace, each with
    its own flags (densities from none to past the cap), clear, decide
    and phase varying, then each equal to its twin; then the same
    sequence, with the copies that restore its inputs, captured once as a
    CUDA graph and replayed `replays` times: equal again, and the
    workspace zero after each. Returns the max |diff|."""
    dens = torch.rand(launches, generator=g, device=DEVICE) * 0.12
    dens[::50] = 0.0
    src = (torch.rand(launches, vp, generator=g, device=DEVICE)
           < dens[:, None]).to(torch.int32)
    src *= torch.randint(1, 4, (launches, vp), generator=g, device=DEVICE,
                         dtype=torch.int32)
    phases = [sl.DENSE if i % 7 == 3 else sl.TAIL for i in range(launches)]
    ctl0 = torch.stack([loop_ctl(sl, ph, IT=i % 70)
                        for i, ph in enumerate(phases)])
    dead = vp - 1

    def run(kernel, flags, outs, ctls):
        for i in range(launches):
            compact_call(sl, kernel, flags[i], outs[i], ctls[i], sl.M_TAIL,
                         sl.N_FRONT, sl.RAW_FRONT, dead, i % 2 == 0,
                         i % 3 == 0, ws)

    def fresh():
        return (src.clone(), torch.full((launches, cap), 7, dtype=torch.int32,
                                        device=DEVICE), ctl0.clone())

    want = fresh()
    run(False, *want)
    got = fresh()
    run(True, *got)
    torch.cuda.synchronize()
    worst = max(int((a.long() - b.long()).abs().max())
                for a, b in zip(got, want))
    if bool(ws.any()):
        fail("[14] the compaction's workspace is not zero after "
             f"{launches} launches")
    flags, outs, ctls = got
    graph = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        with torch.cuda.graph(graph, stream=s):
            flags.copy_(src)
            outs.fill_(7)
            ctls.copy_(ctl0)
            run(True, flags, outs, ctls)
    torch.cuda.current_stream().wait_stream(s)
    for _ in range(replays):
        graph.replay()
    torch.cuda.synchronize()
    worst = max([worst] + [int((a.long() - b.long()).abs().max())
                           for a, b in zip(got, want)])
    if bool(ws.any()):
        fail(f"[14] the compaction's workspace is not zero after {replays} "
             "replays of the captured sequence")
    log(f"[14] flag_compact_kernel: {launches} launches back to back on one "
        f"workspace (clear / decide / guarded varying, {int((src != 0).sum(dim=1).min())} to "
        f"{int((src != 0).sum(dim=1).max())} flags set) equal to the twin, "
        f"then the sequence as one CUDA graph replayed {replays} times: max "
        f"|diff| {worst}, the workspace zero after both")
    del graph
    return worst


def phase14a_kernels(relax, split_loop, rib_epilogue, tables, dist,
                     nbr, hub) -> dict:
    """The loop's kernels and the epilogue against their twins on the card
    at er100k's shapes (the solve's tables, its distances `dist` and its
    neighbor arrays `nbr`), and on random inputs; each timed (CUPTI)
    with its bound, its plain twin, and for the compaction
    `torch.nonzero` on the same flags: the snapshot with the mark at a
    tail step of `MARK_ROWS` frontier rows and at a dense step, the
    epilogue LFA off and on at er100k and at hub102's B = 128 (`hub`:
    its distances and neighbor arrays)."""
    from openr_tpu_torch.monitor.device import bound

    sl = split_loop
    vp, b = dist.shape
    dead, cap = vp - 1, 8192
    g = torch.Generator(device=DEVICE).manual_seed(14)
    worst = {k: 0 for k in ("snap_mark", "compact", "ctl", "relax",
                            "epilogue")}

    def differ(a, b_):
        return int((a.long() - b_.long()).abs().max().item()) if a.numel() \
            else 0

    # ---- the compaction: every case, the workspace zero after each
    # launch, and each guarded launch touching nothing
    ws = sl.compact_ws(vp, DEVICE)
    cases = compaction_cases(vp, cap, g, sl.COMPACT_TILE)
    n_cases = 0
    for label, flags, words, decide in cases:
        for clear in (False, True):
            err = compact_vs_twin(sl, flags, cap, words, clear, decide, ws)
            worst["compact"] = max(worst["compact"], err)
            n_cases += 1
        for phase in (sl.DONE, sl.DENSE, sl.NET):
            compact_guarded(sl, flags, cap, phase, ws, label)
    log(f"[14] flag_compact_kernel vs twin: {n_cases} cases ({len(cases)} "
        f"inputs x clear off/on, tiles of {sl.COMPACT_TILE}), max |diff| "
        f"{worst['compact']}; every guarded launch (DONE, DENSE, NET) left "
        "out, flags, ctl and the workspace as they were")
    worst["compact"] = max(worst["compact"],
                           compact_self_reset(sl, vp, cap, g, ws))
    # ---- the snapshot with the tail's mark, on the solve's out-neighbor
    # table: every phase, cold and warm, frontiers of 0, 1, 500 and cap
    # rows, `mark` holding earlier flags
    out_nbr = tables["out_nbr"]
    n_sm = 0
    for n_front in (0, 1, 500, min(cap, vp - 1)):
        frontier = torch.full((cap,), dead, dtype=torch.int32, device=DEVICE)
        frontier[:n_front] = torch.randperm(
            vp - 1, generator=g, device=DEVICE)[:n_front].to(torch.int32)
        for phase in (sl.DONE, sl.DENSE, sl.TAIL, sl.NET):
            d = torch.randint(0, 100, (vp, b), generator=g, device=DEVICE,
                              dtype=torch.int32)
            m0 = (torch.rand(vp, generator=g, device=DEVICE) < 0.01).to(
                torch.int32)
            for warm in (False, True):
                res = []
                for fn in (sl.snap_mark, sl.snap_mark_ref):
                    s_ = torch.zeros_like(d)
                    rf = torch.ones(vp, dtype=torch.int32, device=DEVICE)
                    m = m0.clone()
                    ctl = loop_ctl(sl, phase, N_FRONT=n_front,
                                   ROWS_CHANGED=9)
                    fn(d, s_, rf, frontier, out_nbr, m, ctl, sl.M_ALL, warm,
                       dead)
                    res.append(torch.cat([s_.reshape(-1), rf, m, ctl]))
                worst["snap_mark"] = max(worst["snap_mark"], differ(*res))
                n_sm += 1
    rng = np.random.default_rng(14)
    for _ in range(400):
        words = {k: int(rng.integers(0, 4)) for k in (
            "IT", "ROWS_CHANGED", "RAW_FRONT", "SPILL")}
        words["SPILL"] = int(words["SPILL"] == 3)
        phase, stage = int(rng.integers(0, 4)), int(rng.integers(0, 2))
        ctls = []
        for kernel in (True, False):
            ctl = loop_ctl(sl, phase, **words)
            ctl[sl.THRESHOLD], ctl[sl.ROUNDS_CAP], ctl[sl.IT_CAP] = 1, 2, 3
            if stage == 0:
                (sl.split_ctl if kernel else sl.split_ctl_ref)(ctl, sl.M_ALL)
            else:  # the tail's decision: a frontier of RAW_FRONT flags
                flags = torch.zeros(vp, dtype=torch.int32, device=DEVICE)
                flags[:words["RAW_FRONT"]] = 1
                out = torch.empty(cap, dtype=torch.int32, device=DEVICE)
                compact_call(sl, kernel, flags, out, ctl, sl.M_TAIL,
                             sl.N_FRONT, sl.RAW_FRONT, dead, False, True,
                             ws)
            ctls.append(ctl)
        worst["ctl"] = max(worst["ctl"], differ(*ctls))
    # ---- kernel A under the guard, a tail call with a live count
    roots = nbr["roots"]
    rows = torch.full((cap,), dead, dtype=torch.int32, device=DEVICE)
    live = torch.unique(torch.randint(0, vp - 1, (3000,), generator=g,
                                      device=DEVICE)).to(torch.int32)
    rows[: live.numel()] = live
    bump = torch.randint(0, 200, dist.shape, generator=g, device=DEVICE,
                         dtype=torch.int32)
    din = torch.clamp_max(dist + bump, INF).contiguous()
    for phase in (sl.TAIL, sl.DENSE):
        for n_live in (0, 1, live.numel() // 2, live.numel()):
            res = []
            for fn in (relax.relax_rows, relax.relax_rows_ref):
                out = din.clone()
                rf = torch.zeros(vp, dtype=torch.int32, device=DEVICE)
                ctl = loop_ctl(sl, phase, N_ROWS=n_live)
                fn(din, out, tables["base_nbr"], tables["base_wgt"], roots,
                   src_rows=rows, dst_rows=rows, row_flag=rf,
                   rows_changed=ctl[sl.ROWS_CHANGED:sl.ROWS_CHANGED + 1],
                   ctl=ctl, phase_mask=sl.M_TAIL,
                   n_live=ctl[sl.N_ROWS:sl.N_ROWS + 1])
                res.append(torch.cat([out.reshape(-1), rf, ctl]))
            worst["relax"] = max(worst["relax"], differ(*res))
    # ---- the epilogue: the solve's distances, and INF rows / columns;
    # then the CPU tests' shapes
    rand = dist.clone()
    rand[torch.randperm(vp, generator=g, device=DEVICE)[:5000]] = INF
    rand[:, 5] = INF
    for dd in (dist, rand):
        for with_lfa in (False, True):
            for over in (nbr["over"], ~nbr["over"]):
                bufs = [fn(dd, nbr["metric"], nbr["ids"], over, nbr["my_id"],
                           with_lfa)
                        for fn in (rib_epilogue.rib_buffer,
                                   rib_epilogue.rib_buffer_ref)]
                worst["epilogue"] = max(worst["epilogue"], differ(*bufs))
    n_epi = 0
    for eb in EPI_B:
        for n in sorted({0, 1, eb - 1}):
            for evp in EPI_VP:
                for holes in (False, True):
                    args = epilogue_case(g, evp, eb, n, holes)
                    for with_lfa in (False, True):
                        for flip in (False, True):
                            a_ = list(args)
                            if flip:
                                a_[3] = ~a_[3]
                            bufs = [fn(*a_, with_lfa) for fn in (
                                rib_epilogue.rib_buffer,
                                rib_epilogue.rib_buffer_ref)]
                            worst["epilogue"] = max(worst["epilogue"],
                                                    differ(*bufs))
                            n_epi += 1
    if any(worst.values()):
        fail(f"[14] the loop's kernels disagree with their twins: {worst}")

    # ---- timing at the main path's shapes, with bounds
    timing = {}
    flags = torch.zeros(vp, dtype=torch.int32, device=DEVICE)
    flags[torch.randperm(vp, generator=g, device=DEVICE)[:2000]] = 1
    out = torch.empty(cap, dtype=torch.int32, device=DEVICE)
    ctl_t = loop_ctl(sl, sl.TAIL, N_FRONT=MARK_ROWS)
    ctl_d = loop_ctl(sl, sl.DENSE, N_FRONT=MARK_ROWS)
    ctl_g = loop_ctl(sl, sl.DONE, N_FRONT=MARK_ROWS)
    frontier = torch.nonzero(flags).reshape(-1)[:cap].to(torch.int32)
    frontier = torch.cat([frontier, torch.full(
        (cap - frontier.numel(),), dead, dtype=torch.int32, device=DEVICE)])
    mark = torch.zeros(vp, dtype=torch.int32, device=DEVICE)
    snap_buf = torch.empty_like(dist)
    rf = torch.zeros(vp, dtype=torch.int32, device=DEVICE)
    live_slots = int((out_nbr[frontier[:MARK_ROWS].long()] != dead).sum())
    snap_w = sl.snap_work(dist.numel(), vp)
    mark_w = sl.mark_work(MARK_ROWS, out_nbr.shape[1], live_slots, False)

    def snap_mark_at(fn, ctl):
        return lambda: fn(dist, snap_buf, rf, frontier, out_nbr, mark, ctl,
                          sl.M_ALL, False, dead)

    def epilogue_at(d, nb, with_lfa):
        args = (d, nb["metric"], nb["ids"], nb["over"], nb["my_id"],
                with_lfa)
        return (lambda: rib_epilogue.rib_buffer(*args),
                lambda: rib_epilogue.rib_buffer_ref(*args),
                rib_epilogue.epilogue_work(*d.shape, nb["ids"].shape[0],
                                           with_lfa), None)

    calls = {
        "snap_mark": (snap_mark_at(sl.snap_mark, ctl_t),
                      snap_mark_at(sl.snap_mark_ref, ctl_t),
                      (snap_w[0] + mark_w[0], snap_w[1] + mark_w[1]), None),
        "snap_mark_dense": (snap_mark_at(sl.snap_mark, ctl_d),
                            snap_mark_at(sl.snap_mark_ref, ctl_d), snap_w,
                            None),
        # the loop done: a no-op step's guarded launch, no work
        "snap_mark_guarded": (snap_mark_at(sl.snap_mark, ctl_g),
                              snap_mark_at(sl.snap_mark_ref, ctl_g), (0, 0),
                              None),
        "compact": (
            lambda: sl.flag_compact(flags, out, ctl_t, sl.M_TAIL, sl.N_ROWS,
                                    sl.RAW_ROWS, dead, False, ws=ws),
            lambda: sl.flag_compact_ref(flags, out, ctl_t, sl.M_TAIL,
                                        sl.N_ROWS, sl.RAW_ROWS, dead, False),
            sl.compact_work(vp, cap, 2000, False),
            lambda: torch.nonzero(flags)),
        "ctl": (
            lambda: sl.split_ctl(ctl_t, sl.M_DENSE),
            lambda: sl.split_ctl_ref(ctl_t, sl.M_DENSE),
            sl.ctl_work(), None),
        "epilogue": epilogue_at(dist, nbr, False),
        "epilogue_lfa": epilogue_at(dist, nbr, True),
        "epilogue_b128": epilogue_at(hub["dist"], hub["nbr"], False),
        "epilogue_b128_lfa": epilogue_at(hub["dist"], hub["nbr"], True),
    }
    # each timed call's kernel: the key it starts with
    base = {k: next(b for b in ("snap_mark", "compact", "ctl", "epilogue")
                    if k.startswith(b)) for k in calls}
    names = {k: (rib_epilogue.KERNEL_NAME if base[k] == "epilogue"
                 else sl.KERNEL_NAMES[base[k]]) for k in calls}
    shapes = {k: (f"{tuple(hub['dist'].shape)}, hub102" if "b128" in k
                  else f"{vp} x {b}") for k in calls}
    notes = dict(snap_mark=f"tail step, {MARK_ROWS} frontier rows",
                 snap_mark_dense="dense step",
                 snap_mark_guarded="the loop done: a guarded launch",
                 epilogue="LFA off",
                 epilogue_lfa="LFA on", epilogue_b128="LFA off",
                 epilogue_b128_lfa="LFA on")
    ctl_save = ctl_t.clone()
    card = smi("name,power.limit")
    for kind, (launch, plain, work, lib) in calls.items():
        restore = (lambda: ctl_t.copy_(ctl_save)) if kind == "ctl" else (
            lambda: None)
        us, how = kernel_us(launch, restore, names[kind])
        ctl_t.copy_(ctl_save)
        plain_ms = cuda_ms(plain)
        ctl_t.copy_(ctl_save)
        lib_ms = cuda_ms(lib) if lib is not None else None
        bms, by = bound(*work)
        timing[kind] = dict(us=us, timed_by=how, plain_ms=plain_ms,
                            lib_ms=lib_ms, bound_ms=bms, bound_by=by,
                            err=worst[base[kind]])
        extra = ""
        if kind.startswith("epilogue"):  # the count before: all of dist
            d_ = hub["dist"] if "b128" in kind else dist
            whole = (work[0] + 4 * d_.numel()
                     - 32 * rib_epilogue.row_sectors(*d_.shape,
                                                     d_.shape[1]))
            wms, _ = bound(whole, work[1])
            timing[kind]["whole_bound_ms"] = wms
            extra = (f"; against the whole matrix ({whole} B) "
                     f"{wms * 1e3:.3f} us, share {wms * 1e3 / us:.3f}")
        log(f"[14] {names[kind]} at {shapes[kind]}"
            + (f" ({notes[kind]})" if kind in notes else "")
            + f": {us:.3f} us ({how}); bound {bms * 1e3:.3f} us by {by} "
            f"({work[0]} B, {work[1]} ops), share {bms * 1e3 / us:.3f}"
            + extra + f"; plain twin {plain_ms:.4f} ms"
            + (f"; torch.nonzero {lib_ms:.4f} ms" if lib_ms is not None
               else "") + f"; card {card}")
    log(f"[14] kernels vs twins on the card: max |diff| {worst} (compaction "
        "at 0, 1, cap, cap + 1 marks and more, tile edges, short and ragged "
        "lengths, cap - 1 / cap / cap + 1 over every tile, the dead slot, "
        "clear off/on, the tail's decision, guarded, 1 000 launches and a "
        f"graph replayed 100 times on one workspace; {n_sm} snapshot-and-"
        "mark cases: every phase, cold and warm, frontiers of 0, 1, 500 "
        "and cap rows; decisions in every phase; kernel A under the guard; "
        "epilogue on the solve's and INF-holed distances, LFA off/on, "
        f"overloads flipped, and {n_epi} cases at B {EPI_B}, N 0 / 1 / "
        f"B - 1, vp {EPI_VP} (vp / 8 odd and even), INF rows and columns "
        "off/on, LFA off/on, overloads flipped)")
    return dict(worst=worst, timing=timing)


def loop_problem(n: int, over_share: float, seed: int = 3):
    """A seeded ER graph of `n` nodes as split tables on the card and the
    CPU, a root with its neighbors, and the RIB's neighbor arrays."""
    from openr_tpu_torch.convert import split_tables_from_numpy
    from openr_tpu_torch.ops.spf_split import build_split_tables
    from openr_tpu_torch.utils.topogen import erdos_renyi_csr

    es, ed, em, _vp, nn, e = erdos_renyi_csr(n, avg_degree=20, seed=seed,
                                             max_metric=64)
    t = build_split_tables(es, ed, em, nn)
    vp = t["vp"]
    rng = np.random.default_rng(seed)
    over = np.zeros(vp, bool)
    if over_share:
        over[:nn] = rng.random(nn) < over_share
    root = 0
    nbrs = np.unique(ed[:e][es[:e] == root])
    b = 8
    while b < 1 + len(nbrs):
        b <<= 1
    roots = np.full(b, root, np.int32)
    roots[1:1 + len(nbrs)] = nbrs
    ids = np.full(b - 1, vp - 1, np.int32)
    ids[:len(nbrs)] = nbrs
    met = np.full(b - 1, (1 << 30) - 1, np.int32)
    met[:len(nbrs)] = [em[:e][(es[:e] == root) & (ed[:e] == j)].min()
                       for j in nbrs]
    nover = np.ones(b - 1, bool)
    nover[:len(nbrs)] = over[nbrs]
    host = (roots, met, ids, nover)
    return {dev: (split_tables_from_numpy(t, over, dev),
                  [torch.from_numpy(x).to(dev) for x in host])
            for dev in ("cpu", DEVICE)}, over.any()


def phase14b_program(split_loop) -> dict:
    """The whole guarded program on the card (eager, then replayed from
    its CUDA graphs) against the CPU twins' distances and buffer, cold
    and warm, on `LOOP_CASES`."""
    from openr_tpu_torch.ops import spf_split

    out = {}
    for label, knobs, lfa, over_share, steps in LOOP_CASES:
        probs, has_over = loop_problem(LOOP_N, over_share)
        res = {}
        for dev, (tables, (roots, met, ids, nover)) in probs.items():
            progs = (spf_split.ProgramCache(steps=steps) if dev != "cpu"
                     else None)
            runs = []
            for _ in range(2 if progs is not None else 1):
                st = {}
                d, buf = spf_split.batched_sssp_split_rib(
                    tables, roots, met, ids, nover, int(roots[0]),
                    has_overloads=bool(has_over), with_lfa=lfa, stats=st,
                    programs=progs, **knobs)
                runs.append((d.cpu(), buf.cpu(), st))
            res[dev] = runs
        (dc, bc, stc), = res["cpu"]
        for i, (dg, bg, stg) in enumerate(res[DEVICE]):
            if not (torch.equal(dc, dg) and torch.equal(bc, bg)):
                fail(f"[14] program {label} (run {i}, "
                     f"{'graph' if i else 'eager'}): the card's distances "
                     "or buffer differ from the CPU twins'")
            if stg["host_syncs"] != stg["replays"]:
                fail(f"[14] program {label}: host syncs {stg}")
        out[label] = dict(cpu=stc, eager=res[DEVICE][0][2],
                          graph=res[DEVICE][1][2])
        log(f"[14] program {label}: card == CPU twins (dist and buffer), "
            f"eager {res[DEVICE][0][2]}, graph {res[DEVICE][1][2]}, CPU "
            f"{stc}")
    # warm: a cold solve, a cone of INF cells (the seeds: their rows),
    # then the warm program; a dense cone spills at entry
    probs, _ = loop_problem(LOOP_N, 0.0)
    for share in (0.0005, 0.02):
        res = {}
        for dev, (tables, (roots, met, ids, nover)) in probs.items():
            cold = spf_split.batched_sssp_split(tables, roots)
            vp, b = cold.shape
            rng = np.random.default_rng(41)  # one cone on both devices
            cone = torch.from_numpy(rng.random((vp, b)) < share).to(dev)
            cone[roots.long(), torch.arange(b, device=dev)] = False
            cone[vp - 1] = False
            dist0 = torch.where(cone, INF, cold)
            seed = cone.any(dim=1)
            progs = spf_split.ProgramCache() if dev != "cpu" else None
            runs = []
            for _ in range(2 if progs is not None else 1):
                st = {}
                d, buf = spf_split.batched_sssp_split_warm_rib(
                    tables, roots, met, ids, nover, dist0, seed, stats=st,
                    programs=progs)
                runs.append((d.cpu(), buf.cpu(), st, cold.cpu()))
            res[dev] = runs
        (dc, bc, stc, cold_c), = res["cpu"]
        for i, (dg, bg, stg, _c) in enumerate(res[DEVICE]):
            if not (torch.equal(dc, dg) and torch.equal(bc, bg)
                    and torch.equal(dc, cold_c)):
                fail(f"[14] warm program, cone {share} (run {i}): the "
                     "card's distances or buffer differ from the CPU "
                     "twins' or the cold solve's")
        log(f"[14] warm program, cone share {share}: card == CPU twins == "
            f"cold, eager {res[DEVICE][0][2]}, graph {res[DEVICE][1][2]}, "
            f"CPU {stc}")
        out[f"warm {share}"] = dict(cpu=stc, graph=res[DEVICE][1][2])
    return out


def events_us(fn, reps: int) -> float:
    """Mean µs of `fn()` between two CUDA events over `reps` calls, after
    one."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps * 1e3


def replay_kernels(replay, names, attempts: int = 3) -> int:
    """The kernels CUPTI saw in one call of `replay` (the most over
    `attempts` profiles: CUPTI may drop launches)."""
    from torch.profiler import ProfilerActivity, profile

    seen = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            replay()
            torch.cuda.synchronize()
        seen = max(seen, kernel_device_us(prof, names)[1])
    return seen


def phase14c_replay(solver, ls, split_loop) -> dict:
    """At er100k through the solver: the cost of a replayed block's
    no-op steps (the graph replayed once more with the loop done), the
    block's kernels as its capture recorded them (`graph_nodes`) against
    a step's launches and as CUPTI counts them, the
    solve's host syncs, replays and steps, and the device-idle share of
    one traced solve (`profiling.trace`)."""
    from openr_tpu_torch.ops import relax
    from openr_tpu_torch.ops.spf_split import SplitProgram

    for _ in range(2):  # a program new here captures on its second run
        solver.solve(ls, "node-0")
    progs = [p for p in solver._programs._progs.values()
             if isinstance(p, SplitProgram) and not p.warm]
    prog = progs[-1]
    if prog._graphs is None:
        fail("[14] the solver's program was not captured")
    st = dict(solver.last_solve_stats)
    noop_us = events_us(prog._graphs[1].replay, 10)  # ctl says done
    nodes = st["graph_nodes"]  # the kernels the wrappers recorded
    want = prog.steps * (prog.gs + prog.STEP_LAUNCHES)
    if nodes != want:
        fail(f"[14] the block's capture recorded {nodes} kernels, not "
             f"{prog.steps} steps x (gs {prog.gs} + {prog.STEP_LAUNCHES}) "
             f"= {want}")
    seen = replay_kernels(prog._graphs[1].replay, tuple(
        relax.KERNEL_NAMES.values()) + tuple(split_loop.KERNEL_NAMES.values()))
    if seen > nodes:
        fail(f"[14] CUPTI saw {seen} kernels in a replayed block of "
             f"{nodes} graph nodes")
    log(f"[14] er100k: graph nodes per block {nodes}, as the capture "
        f"recorded them ({prog.steps} steps of gs {prog.gs} + "
        f"{prog.STEP_LAUNCHES} launches); CUPTI's kernels in one replayed "
        f"block {seen}")
    idle, span_ms = trace_idle_share(lambda: solver.solve(ls, "node-0"),
                                     "spf:batched_solve")
    noop_steps = prog.steps * st["replays"] - st["steps"]
    log(f"[14] er100k: {st['steps']} useful steps in {st['replays']} "
        f"replayed block(s) of {prog.steps} ({st['graph_nodes']} graph "
        f"nodes), host syncs {st['host_syncs']}; a block replayed with the "
        f"loop done {noop_us:.1f} us ({noop_us / prog.steps:.2f} us a "
        f"no-op step), so this solve's {noop_steps} no-op steps cost "
        f"~{noop_us / prog.steps * noop_steps:.1f} us; device-idle share "
        f"of one traced solve "
        f"{'not measured' if idle is None else round(idle, 4)} over its "
        f"{span_ms:.3f} ms span; card {smi('name,power.limit')}")
    return dict(noop_us=noop_us, idle=idle, span_ms=span_ms, stats=st,
                nodes=nodes, cupti_nodes=seen)


def phase14_loop(relax, split_loop, rib_epilogue, solver, ls, tables):
    """[14]: the loop's kernels and the epilogue against their twins and
    timed, the whole program against the CPU twins, the replay's cost."""
    from openr_tpu_torch import LinkState, TorchSpfSolver
    from openr_tpu_torch.utils.topogen import hub_and_spoke

    t0 = time.perf_counter()
    solved = solver.solve(ls, "node-0")
    dist, nbr = rib_arrays(solver, solved[0], solved, "node-0")
    hub_ls = LinkState()  # hub102: B = 128
    for db in hub_and_spoke(hubs=2, spokes=100)[0]:
        hub_ls.update_adjacency_db(db)
    hub_solver = TorchSpfSolver(device=DEVICE)
    hub_solved = hub_solver.solve(hub_ls, "node-0")
    hub_dist, hub_nbr = rib_arrays(hub_solver, hub_solved[0], hub_solved,
                                   "node-0")
    hub = dict(dist=hub_dist, nbr=hub_nbr)
    p14a = phase14a_kernels(relax, split_loop, rib_epilogue, tables, dist,
                            nbr, hub)
    p14b = phase14b_program(split_loop)
    p14c = phase14c_replay(solver, ls, split_loop)
    log(f"[14] done in {time.perf_counter() - t0:.1f} s")
    return dict(a=p14a, b=p14b, c=p14c)


# ----------------------------------------------------------- phase 15

#: BASELINE config 5 ("1k link flaps/s through Decision", BASELINE.md) as
#: `benchmarks/bench_churn.py:279-281` builds it: `fat_tree(32,
#: metric=10)`, 1 280 nodes, root node-0; the step protocol's flaps a
#: cycle, its timed cycles after its warm-up cycles, and the cycles after
#: them that each run on a new thread; the live protocol's rate
#: (flaps/s), burst and seconds (one flap a burst traced)
CONFIG5 = dict(k=32, nodes=1280, flaps=40, cycles=30, warmup=5, fresh=5,
               rate=1000, burst=10, live_s=5.0)
#: [15b]: the metric flaps of config 2's topology-delta rebuild
#: (aggregation -> ToR links outside the root's pod, lowered from 10 to
#: 5) and the ramp /32s withdrawn and re-added
DECISION2_FLAPS = 32
DECISION2_PREFIXES = 100


def adj_publication(dbs, version: int):
    """One Publication of `adj:<node>` keys, each value the canonical
    wire bytes of the node's AdjacencyDatabase."""
    from openr_tpu_torch.common.constants import adj_key
    from openr_tpu_torch.types.kvstore import Publication, Value
    from openr_tpu_torch.types.serde import to_wire

    return Publication(key_vals={
        adj_key(db.this_node_name): Value(
            version=version, originator_id=db.this_node_name,
            value=to_wire(db)).with_hash()
        for db in dbs})


def prefix_publication(items, version: int):
    """One Publication of per-prefix keys for (node, PrefixEntry) pairs."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA, prefix_key
    from openr_tpu_torch.types import PrefixDatabase
    from openr_tpu_torch.types.kvstore import Publication, Value
    from openr_tpu_torch.types.serde import to_wire

    return Publication(key_vals={
        prefix_key(node, DEFAULT_AREA, e.prefix.prefix): Value(
            version=version, originator_id=node,
            value=to_wire(PrefixDatabase(this_node_name=node,
                                         prefix_entries=(e,)))).with_hash()
        for node, e in items})


def prefix_items(ps) -> list:
    """Every (node, PrefixEntry) of a PrefixState."""
    return [(node, e) for per in ps.prefixes.values()
            for node, e in per.items()]


def decision_for(me: str, device=None, **dcfg):
    """A port Decision for `me` on `device` (default: DEVICE), its
    publications queue and a reader of its RouteUpdates."""
    from openr_tpu_torch.config import Config
    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.messaging import ReplicateQueue
    from openr_tpu_torch.monitor import Counters

    cfg = Config.default(me)
    for k, v in dcfg.items():
        setattr(cfg.node.decision, k, v)
    pubs = ReplicateQueue(name="pubs")
    routes = ReplicateQueue(name="routes")
    reader = routes.get_reader()
    d = Decision(cfg, pubs.get_reader(), routes, counters=Counters(),
                 device=DEVICE if device is None else device)
    return d, pubs, reader


def feed(d) -> int:
    """Hand what the publications queue holds to the Decision, as its
    publication loop does; returns the publications taken."""
    n = 0
    while d.pub_reader.qsize():
        d.process_publication(d.pub_reader.get_nowait())
        n += 1
    return n


def transfer_counts() -> tuple[int, int]:
    """(host syncs, host reads) of the port's transfer ledger so far."""
    from openr_tpu_torch.monitor import compile_ledger

    led = compile_ledger.ledger()
    return led.host_syncs, led.transfers()[0]


class SolverSpy:
    """Wraps a Decision's solver calls: each records its worker thread,
    the thread's current CUDA device and the host syncs and reads it
    made, so that a rebuild's own counts can be held to its solver's. A
    warm call records too whether it refused (returned None: the
    Decision then solves in full), whether one of its changed edges
    leaves the root, and the solver's warm stats it set."""

    NAMES = ("compute_routes", "warm_compute_routes",
             "assemble_prefix_routes")

    def __init__(self, solver):
        import threading

        self.calls: list[dict] = []  # thread: the worker's name (unique
        # per executor, where idents of ended threads are reused)
        for name in self.NAMES:
            inner = getattr(solver, name)

            def wrapped(*a, _inner=inner, _name=name, **kw):
                stats0 = solver.last_warm_stats
                s0, r0 = transfer_counts()
                out = _inner(*a, **kw)
                s1, r1 = transfer_counts()
                call = dict(
                    name=_name, thread=threading.current_thread().name,
                    device=(torch.cuda.current_device()
                            if solver.device.type == "cuda" else None),
                    syncs=s1 - s0, reads=r1 - r0)
                if _name == "warm_compute_routes":
                    # (art, ls, ps, my_node, edge_pairs, ..., max_frac)
                    call.update(
                        refused=out is None, pairs=len(a[4]),
                        why=None if out is not None else warm_refusal(
                            solver, a[0], a[1], a[3], a[4], a[7]),
                        warm=(None if solver.last_warm_stats is stats0
                              else dict(solver.last_warm_stats)))
                self.calls.append(call)
                return out

            setattr(solver, name, wrapped)


def warm_refusal(solver, art, ls, me: str, pairs, max_frac: float) -> str:
    """Why `warm_compute_routes` refused, by its own tests in its order
    (the last, a cone walk over its cell budget, by elimination)."""
    from openr_tpu_torch.decision.spf_backend import LazyDist

    csr = ls.to_csr()
    solved = art.solved
    if solver.enable_lfa or solved is None or solved[4] is not None \
            or not isinstance(solved[1], LazyDist):
        return "no warmable artifact"
    if csr.base_version != solved[0].base_version:
        return "structural change"
    if solver._pick_table(csr) != "split" \
            or solved[1].shape[0] != solver.solve_vp(csr):
        return "not the split tables"
    ids = [(csr.name_to_id.get(u), csr.name_to_id.get(v)) for u, v in pairs]
    if any(u is None or v is None for u, v in ids):
        return "unknown endpoint"
    if any(u == csr.name_to_id[me] for u, _v in ids):
        return "a changed edge at the root"
    old = solved[0]
    n = sum(1 for u, v in ids if (u, v) in csr.edge_index and int(
        old.edge_metric[csr.edge_index[(u, v)]]) != int(
            csr.edge_metric[csr.edge_index[(u, v)]]))
    if n > max(16, int(max_frac * max(csr.num_edges, 1))):
        return f"{n} changed edges, over the share"
    return f"the cone walk over its cell budget ({n} changed edges)"


def new_worker(loop) -> None:
    """A fresh one-thread default executor: the next `to_thread` of the
    Decision runs on a thread that has never touched the card."""
    from concurrent.futures import ThreadPoolExecutor

    old = getattr(loop, "_default_executor", None)
    loop.set_default_executor(ThreadPoolExecutor(max_workers=1))
    if old is not None:
        old.shutdown(wait=False)


async def timed_rebuild(d, spy, tag: str, fresh_thread: bool = True) -> dict:
    """One synchronous rebuild, on a new worker thread unless
    `fresh_thread` is False (then on the loop's executor's, as a running
    Decision's are); its wall, path, split, the warm stats, decode tiers,
    and host syncs and reads, failing if they are not its solver calls'
    own."""
    if fresh_thread:
        new_worker(asyncio.get_running_loop())
    n_calls = len(spy.calls)
    tiers0 = dict(d.decode_stats)
    s0, r0 = transfer_counts()
    await d._rebuild_routes()
    s1, r1 = transfer_counts()
    calls = spy.calls[n_calls:]
    own = (sum(c["syncs"] for c in calls), sum(c["reads"] for c in calls))
    if (s1 - s0, r1 - r0) != own:
        fail(f"[15] {tag}: the rebuild made {s1 - s0} host syncs and "
             f"{r1 - r0} reads, its solver calls {own}")
    devs = {c["device"] for c in calls}
    if d.device.type == "cuda" and devs - {d.device.index}:
        fail(f"[15] {tag}: solver calls ran with current device {devs}, "
             f"the Decision's is {d.device}")
    warm = {}
    if d._rebuild_path == "topo_delta":
        warm = dict(d.solver.last_warm_stats,
                    region=d._rebuild_warm_region)
    return dict(ms=d._last_spf_ms, path=d._rebuild_path, warm=warm,
                syncs=s1 - s0, reads=r1 - r0,
                threads={c["thread"] for c in calls},
                split=dict(d.last_breakdown_ms),
                tiers={k: v - tiers0[k] for k, v in d.decode_stats.items()})


def drain_updates(reader) -> list:
    return [reader.get_nowait() for _ in range(reader.qsize())]


def update_is_diff(updates: list, old, new, tag: str) -> None:
    """The Decision's RouteUpdates of one rebuild (none, or one) equal
    `diff_route_dbs` of two independently solved RIBs."""
    from openr_tpu_torch.types.routes import diff_route_dbs

    want = diff_route_dbs(old, new)
    if not updates:
        if not want.empty():
            fail(f"[15] {tag}: no RouteUpdate, the diff of fresh RIBs has "
                 f"{len(want.unicast_to_update)} updates")
        return
    (got,) = updates
    if (got.unicast_to_update != want.unicast_to_update
            or sorted(got.unicast_to_delete) != sorted(want.unicast_to_delete)
            or got.mpls_to_update != want.mpls_to_update
            or sorted(got.mpls_to_delete) != sorted(want.mpls_to_delete)):
        fail(f"[15] {tag}: the RouteUpdate differs from the diff of fresh "
             "RIBs")


def rib_is(d, rdb, tag: str) -> None:
    if (d.rib.unicast_routes != rdb.unicast_routes
            or d.rib.mpls_routes != rdb.mpls_routes):
        fail(f"[15] {tag}: the Decision's RIB differs")


def flap_pubs(rng, dbs: list, n: int, versions: dict,
              src: dict | None = None) -> list:
    """`n` seeded metric flaps as publications (bench_churn's pregen: a
    random node, one of its adjacencies, a metric in 1..63), encoded
    before the clock starts, as the flapping routers would send them.
    With `src`, each publication's AdjacencyDatabase is kept there under
    the publication's id."""
    import dataclasses

    out = []
    for _ in range(n):
        i = int(rng.integers(0, len(dbs)))
        db = dbs[i]
        k = int(rng.integers(0, len(db.adjacencies)))
        adjs = list(db.adjacencies)
        adjs[k] = dataclasses.replace(adjs[k],
                                      metric=int(rng.integers(1, 64)))
        db = dataclasses.replace(db, adjacencies=tuple(adjs))
        dbs[i] = db
        versions[db.this_node_name] += 1
        out.append(adj_publication([db], versions[db.this_node_name]))
        if src is not None:
            src[id(out[-1])] = db
    return out


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def warm_p50s(rows) -> dict:
    """p50 of the warm stats' host ms and region over topology-delta
    rebuilds."""
    keys = ("cone_walk_ms", "solve_ms", "assembly_ms", "region",
            "cone_cells", "changes")
    warm = [r["warm"] for r in rows if r["warm"]]
    return {k: round(statistics.median(w.get(k, 0) for w in warm), 3)
            for k in keys} if warm else {}


def phase15a_step(adj, pfx, me: str) -> dict:
    """Config 5's step protocol: 40 flaps a cycle through the queue, one
    synchronous rebuild. The cold rebuild and the warm-up cycles each run
    on a new worker thread, the timed cycles on the loop's executor's
    thread (as a running Decision's do), then `fresh` more cycles on new
    threads again; every cycle's RIB against a fresh card solver's, the
    update against the diff of fresh RIBs, the CPU path's RIB at the
    first and last cycle."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    c5 = CONFIG5
    dbs = list(adj)
    d, pubs, reader = decision_for(me)
    spy = SolverSpy(d.solver)
    versions = {db.this_node_name: 1 for db in dbs}
    rng = np.random.default_rng(20260505)
    n_cycles = c5["warmup"] + c5["cycles"] + c5["fresh"]
    t0 = time.perf_counter()
    cycles = [flap_pubs(rng, dbs, c5["flaps"], versions)
              for _ in range(n_cycles)]
    enc_s = time.perf_counter() - t0
    rows, cpu_checks = [], 0

    def fresh_rib():
        ls, ps = d.link_states[DEFAULT_AREA], d.prefix_states[DEFAULT_AREA]
        return ls, ps, TorchSpfSolver(device=DEVICE).compute_routes(
            ls, ps, me)

    def on_new_thread(i: int) -> bool:
        return i < c5["warmup"] or i >= c5["warmup"] + c5["cycles"]

    async def body():
        nonlocal cpu_checks
        # the unflapped fabric (`dbs` already holds every pregenerated
        # flap), as bench_churn publishes it before its flaps
        pubs.push(adj_publication(list(adj), 1))
        pubs.push(prefix_publication(
            [(db.this_node_name, e) for db in pfx
             for e in db.prefix_entries], 1))
        feed(d)
        cold = await timed_rebuild(d, spy, "15a cold")
        _ls, _ps, prev = fresh_rib()
        rib_is(d, prev, "15a cold vs a fresh solver")
        drain_updates(reader)
        for i, cyc in enumerate(cycles):
            for pub in cyc:
                pubs.push(pub)
            feed(d)
            row = await timed_rebuild(d, spy, f"15a cycle {i}",
                                      fresh_thread=on_new_thread(i))
            ls, ps, fresh = fresh_rib()
            rib_is(d, fresh, f"15a cycle {i} vs a fresh card solver")
            update_is_diff(drain_updates(reader), prev, fresh,
                           f"15a cycle {i}")
            if i in (0, n_cycles - 1):
                cpu = TorchSpfSolver(device="cpu").compute_routes(ls, ps, me)
                rib_is(d, cpu, f"15a cycle {i} vs the CPU path")
                cpu_checks += 1
            prev = fresh
            rows.append(row)
        return cold

    cold = asyncio.run(body())
    timed = rows[c5["warmup"]:c5["warmup"] + c5["cycles"]]
    fresh_rows = [cold, *rows[:c5["warmup"]],
                  *rows[c5["warmup"] + c5["cycles"]:]]
    ms = [r["ms"] for r in timed]
    fresh_ms = [r["ms"] for r in fresh_rows[1 + c5["warmup"]:]]
    paths = {}
    for r in timed:
        paths[r["path"]] = paths.get(r["path"], 0) + 1
    by_path = {}
    for r in rows:
        b = by_path.setdefault(r["path"], dict(syncs=set(), reads=set()))
        b["syncs"].add(r["syncs"])
        b["reads"].add(r["reads"])
    new_threads = [r["threads"] for r in fresh_rows]
    threads = set().union(*new_threads)
    timed_threads = set().union(*(r["threads"] for r in timed))
    tiers = {k: sum(r["tiers"][k] for r in timed) for k in d.decode_stats}
    split = {k: round(statistics.median(r["split"].get(k, 0.0)
                                        for r in timed), 3)
             for k in timed[0]["split"]}
    log(f"[15a] config 5 step: fat_tree({c5['k']}, metric=10), "
        f"{len(d.link_states['0'].nodes)} nodes, root {me}; cold rebuild "
        f"{cold['ms']:.3f} ms; {c5['cycles']} cycles of {c5['flaps']} flaps "
        f"after {c5['warmup']}: recompute p50 {statistics.median(ms):.3f} "
        f"ms, p99 {percentile(ms, 99):.3f} ms (host wall of the rebuild, "
        f"decode to update, on the executor's one thread); then "
        f"{c5['fresh']} cycles each on a new thread: p50 "
        f"{statistics.median(fresh_ms):.3f} ms; paths {paths}; p50 split "
        f"(ms) {split}; p50 of the warm stats {warm_p50s(timed)}; decode "
        f"tiers {tiers}; host syncs / reads a rebuild by path "
        f"{ {p: {k: sorted(v) for k, v in b.items()} for p, b in by_path.items()} } "
        f"(each the solver calls' own); {len(threads)} new threads for "
        f"{len(fresh_rows)} rebuilds asked to run on one (the first "
        f"captured the CUDA graphs), {len(timed_threads)} for the timed "
        f"cycles; every RIB == a fresh card solver's, every update == the "
        f"diff of fresh RIBs, {cpu_checks} RIBs == the CPU path's; flaps "
        f"encoded in {enc_s:.1f} s; card {smi('name,power.limit')}")
    if len(threads) < len(fresh_rows) or any(len(t) != 1
                                             for t in new_threads):
        fail(f"[15a] {len(threads)} worker threads for {len(fresh_rows)} "
             "rebuilds: a new thread each was asked for")
    return dict(p50=statistics.median(ms), p99=percentile(ms, 99),
                paths=paths, tiers=tiers)


def phase15a_live(adj, pfx, me: str) -> dict:
    """Config 5's live protocol: the Decision started (its publication
    loop, the default debounce), 1 000 flaps/s in bursts of 10 for 5 s
    pushed into its queue, the first flap of each burst traced;
    flap -> RouteUpdate from the perf events of the updates it pushed."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA
    from openr_tpu_torch.common.tasks import guard_task, reap
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.messaging import QueueClosedError
    from openr_tpu_torch.monitor import perf

    c5 = CONFIG5
    dbs = list(adj)
    d, pubs, reader = decision_for(me)
    versions = {db.this_node_name: 1 for db in dbs}
    rng = np.random.default_rng(7)
    n_max = int(c5["rate"] * c5["live_s"] * 1.2) + 100
    pregen = flap_pubs(rng, dbs, n_max, versions)
    lat, orders, updates, rebuilds = [], set(), [], []

    async def body():
        await d.start()
        pubs.push(adj_publication(list(adj), 1))
        pubs.push(prefix_publication(
            [(db.this_node_name, e) for db in pfx
             for e in db.prefix_entries], 1))
        await asyncio.wait_for(d.rib_computed.wait(), 120)

        async def drain():
            while True:
                try:
                    upd = await reader.get()
                except QueueClosedError:
                    return
                updates.append(upd)
                for pe in upd.perf_events:
                    names = tuple(pe.names())
                    orders.add(names)
                    sent = [e.ts_ns for e in pe.events
                            if e.event == perf.ROUTE_UPDATE_SENT]
                    lat.append((sent[-1] - pe.events[0].ts_ns) / 1e6)

        drainer = guard_task(asyncio.ensure_future(drain()), owner="15a")
        # the baselines once the first RIB's debounce is idle: from here
        # every fire of the debounce is one rebuild, or one that raised
        t_idle = time.perf_counter()
        while d.debounce.pending and time.perf_counter() - t_idle < 30:
            await asyncio.sleep(0.005)
        runs0, fires0 = d._spf_runs, d.debounce.fires
        seen_runs = [runs0]

        def sample():
            """One recompute sample a rebuild seen (bench_churn's way)."""
            if d._spf_runs != seen_runs[0]:
                seen_runs[0] = d._spf_runs
                rebuilds.append(dict(ms=d._last_spf_ms, path=d._rebuild_path,
                                     split=dict(d.last_breakdown_ms)))

        n = 0
        interval = c5["burst"] / c5["rate"]
        next_send = time.perf_counter()
        stop = next_send + c5["live_s"]
        while time.perf_counter() < stop and n < n_max:
            for j in range(c5["burst"]):
                if j == 0:
                    pregen[n].perf_events = perf.PerfEvents.start(
                        perf.KVSTORE_FLOODED, node="flap")
                pubs.push(pregen[n])
                n += 1
            sample()
            next_send += interval
            await asyncio.sleep(max(0.0, next_send - time.perf_counter()))
        t_end = time.perf_counter()
        # quiescence: the last window's rebuild done, nothing buffered
        while time.perf_counter() - t_end < 30:
            await asyncio.sleep(0.05)
            sample()
            if (not d.debounce.pending and not d._pending_kvs
                    and not d.pub_reader.qsize()):
                break
        runs = d._spf_runs - runs0
        fires = d.debounce.fires - fires0
        await d.stop()
        pubs.close()
        await reap(drainer)
        return n, runs, fires

    n, runs, fires = asyncio.run(body())
    failed = int(d.counters.get(f"{d.name}.task_exceptions"))
    if failed or fires != runs:
        fail(f"[15a] live: {fires} debounce fires, {runs} rebuilds done, "
             f"{failed} rebuilds raised")
    ls, ps = d.link_states[DEFAULT_AREA], d.prefix_states[DEFAULT_AREA]
    rib_is(d, TorchSpfSolver(device=DEVICE).compute_routes(ls, ps, me),
           "15a live: the final RIB vs a fresh card solver")
    want = (perf.KVSTORE_FLOODED, perf.DECISION_RECEIVED,
            perf.DECISION_DEBOUNCED)
    tail = {perf.REBUILD_FULL, perf.REBUILD_TOPO_DELTA,
            perf.REBUILD_PREFIX_ONLY}
    for o in orders:
        if (o[:3] != want or o[3] not in tail
                or o[4:] != (perf.SPF_SOLVE_DONE, perf.ROUTE_UPDATE_SENT)):
            fail(f"[15a] live: a trace's markers {o}")
    if not lat or runs == 0:
        fail(f"[15a] live: {len(lat)} traced flaps reached an update in "
             f"{runs} rebuilds")
    c = d.counters
    paths = {p: int(c.get(f"decision.rebuild.{p}"))
             for p in ("full", "topo_delta", "prefix_only")}
    r_ms = [r["ms"] for r in rebuilds]
    split = {k: round(statistics.median(r["split"].get(k, 0.0)
                                        for r in rebuilds), 3)
             for k in rebuilds[0]["split"]} if rebuilds else {}
    log(f"[15a] config 5 live: {n} flaps in {c5['live_s']} s "
        f"({c5['rate']}/s in bursts of {c5['burst']}), default debounce "
        f"({d.config.node.decision.debounce_min_ms}, "
        f"{d.config.node.decision.debounce_max_ms}) ms: {runs} rebuilds "
        f"of {fires} debounce fires, 0 raised "
        f"{paths}, {n / runs:.1f} flaps coalesced a rebuild, {len(updates)} "
        f"updates; flap -> RouteUpdate p50 {statistics.median(lat):.3f} ms, "
        f"p99 {percentile(lat, 99):.3f} ms over {len(lat)} traced flaps "
        f"(perf events, KVSTORE_FLOODED to ROUTE_UPDATE_SENT); rebuild p50 "
        f"{statistics.median(r_ms):.3f} ms, p99 {percentile(r_ms, 99):.3f} "
        f"ms over {len(r_ms)} sampled, p50 split (ms) {split}; decode tiers "
        f"{d.decode_stats}; markers in stage order; final RIB == a fresh "
        f"card solver's; card {smi('name,power.limit')}")
    return dict(p50=statistics.median(lat), p99=percentile(lat, 99),
                coalesced=n / runs)


def phase15_other_card(adj, pfx, me: str) -> None:
    """Where the machine has a second card, a Decision on cuda:1 rebuilt
    from new worker threads; else says so."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[15a] one card ({n}): the Decision on a card other than the "
            "default was not run")
        return
    from openr_tpu_torch.common.constants import DEFAULT_AREA
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    dbs = list(adj)
    d, pubs, reader = decision_for(me, device="cuda:1")
    spy = SolverSpy(d.solver)
    versions = {db.this_node_name: 1 for db in dbs}
    rng = np.random.default_rng(11)

    async def body():
        pubs.push(adj_publication(dbs, 1))
        pubs.push(prefix_publication(
            [(db.this_node_name, e) for db in pfx
             for e in db.prefix_entries], 1))
        for i in range(4):
            if i:
                for pub in flap_pubs(rng, dbs, 8, versions):
                    pubs.push(pub)
            feed(d)
            await timed_rebuild(d, spy, f"15a cuda:1 rebuild {i}")
            ls, ps = d.link_states[DEFAULT_AREA], d.prefix_states[DEFAULT_AREA]
            rib_is(d, TorchSpfSolver(device="cuda:1").compute_routes(
                ls, ps, me), f"15a cuda:1 rebuild {i}")

    asyncio.run(body())
    log(f"[15a] on cuda:1 of {n} cards: 4 rebuilds on new worker threads, "
        f"solver calls on device {sorted({c['device'] for c in spy.calls})}, "
        f"RIBs == a fresh solver's on cuda:1")


def phase15b_config2(ls2, ps2, want=None, k: int = CONFIG2["k"]) -> dict:
    """Config 2 at full width through the Decision from node-2025 (the
    first aggregation switch of `fat_tree(k)`): every
    adjacency and prefix as a publication; the cold rebuild (its RIB
    equal to `want`, [9]'s, where given, and a separate card solver's);
    32 metric flaps down (a topology-delta rebuild) and back up (the
    path the warm gate picks); 100 ramp /32s withdrawn, then re-added
    (two prefix-only rebuilds); each update equal to the diff of the
    separate solver's RIBs."""
    import dataclasses

    from openr_tpu_torch.common.constants import DEFAULT_AREA, prefix_key
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.types.kvstore import Publication

    half = k // 2
    me = f"node-{half * half}"  # the first aggregation switch
    t0 = time.perf_counter()
    dbs = [ls2.adjacency_db(n) for n in ls2.nodes]
    items = prefix_items(ps2)
    adj_pub = adj_publication(dbs, 1)
    pfx_pub = prefix_publication(items, 1)
    enc_s = time.perf_counter() - t0
    d, pubs, reader = decision_for(me)
    spy = SolverSpy(d.solver)
    ref = TorchSpfSolver(device=DEVICE)
    rows = {}
    # ToRs follow the cores and aggregation switches; the root's pod
    tor0 = half * half + k * half
    my_pod = (int(me.split("-")[1]) - half * half) // half
    rng = np.random.default_rng(2025)

    def pick_flaps():
        """DECISION2_FLAPS distinct aggregation -> ToR links outside the
        root's pod, lowered from 10 to 5, as new AdjacencyDatabases (and
        the old ones): half from each pod's aggregation switch of the
        root's index (those change the root's routes to the ToR), half
        from any of its aggregation switches. Lowered, because a raised
        link in a uniform fabric puts most of the graph in the warm
        start's cone (past its cell budget: a full rebuild, which the
        revert measures)."""
        lsd = d.link_states[DEFAULT_AREA]
        chosen, seen = {}, set()
        while len(seen) < DECISION2_FLAPS:
            pod = int(rng.integers(0, k))
            if pod == my_pod:
                continue
            j = 0 if len(seen) < DECISION2_FLAPS // 2 else int(
                rng.integers(0, half))
            agg = f"node-{half * half + pod * half + j}"
            db = chosen.get(agg) or lsd.adjacency_db(agg)
            downs = [i for i, a in enumerate(db.adjacencies)
                     if int(a.other_node_name.split("-")[1]) >= tor0]
            i = downs[int(rng.integers(0, len(downs)))]
            if (agg, i) in seen:
                continue
            seen.add((agg, i))
            adjs = list(db.adjacencies)
            adjs[i] = dataclasses.replace(adjs[i], metric=adjs[i].metric - 5)
            chosen[agg] = dataclasses.replace(db, adjacencies=tuple(adjs))
        return list(chosen.values()), [lsd.adjacency_db(a) for a in chosen]

    async def body():
        pubs.push(adj_pub)
        pubs.push(pfx_pub)
        feed(d)
        rows["cold"] = await timed_rebuild(d, spy, "15b cold")
        t1 = time.perf_counter()
        ls, ps = d.link_states[DEFAULT_AREA], d.prefix_states[DEFAULT_AREA]
        prev = ref.compute_routes(ls, ps, me)
        ref_ms = (time.perf_counter() - t1) * 1e3
        rib_is(d, prev, "15b cold vs a separate card solver")
        if want is not None:
            rib_is(d, want, "15b cold vs [9]'s RIB")
        drain_updates(reader)
        # 32 metric flaps down (a topology-delta rebuild), then back up
        flapped, olds = pick_flaps()
        for step, dbs_v in (("flaps", (flapped, 2)), ("revert", (olds, 3))):
            pubs.push(adj_publication(*dbs_v))
            feed(d)
            rows[step] = await timed_rebuild(d, spy, f"15b {step}")
            cur = ref.compute_routes(ls, ps, me)
            rib_is(d, cur, f"15b {step}")
            update_is_diff(drain_updates(reader), prev, cur, f"15b {step}")
            prev = cur
        # 100 ramp /32s of one advertiser each: withdrawn, then re-added
        picked = [(p, next(iter(per.items()))) for p, per in ps.prefixes.items()
                  if p.prefix.startswith("16.") and len(per) == 1]
        picked = picked[:DECISION2_PREFIXES]
        for step, pub in (
                ("withdraw", Publication(expired_keys=[
                    prefix_key(node, DEFAULT_AREA, p.prefix)
                    for p, (node, _e) in picked])),
                ("re-add", prefix_publication(
                    [ne for _p, ne in picked], 2))):
            pubs.push(pub)
            feed(d)
            rows[step] = await timed_rebuild(d, spy, f"15b {step}")
            cur = ref.compute_routes(ls, ps, me)
            rib_is(d, cur, f"15b {step}")
            update_is_diff(drain_updates(reader), prev, cur, f"15b {step}")
            prev = cur
        return ref_ms

    ref_ms = asyncio.run(body())
    want_paths = dict(cold="full", flaps="topo_delta", withdraw="prefix_only")
    want_paths["re-add"] = "prefix_only"
    got_paths = {k2: r["path"] for k2, r in rows.items() if k2 != "revert"}
    if got_paths != want_paths:
        fail(f"[15b] rebuild paths {got_paths}, expected {want_paths}")
    s = d.solver
    for step, r in rows.items():
        log(f"[15b] config 2 from {me}, {step}: rebuild {r['ms']:.3f} ms "
            f"({r['path']}); split (ms) "
            f"{ {k2: round(v, 3) for k2, v in r['split'].items()} }; host "
            f"syncs {r['syncs']}, reads {r['reads']} (the solver calls' "
            f"own); decode tiers {r['tiers']}"
            + (f"; warm stats {r['warm']}" if r["warm"] else ""))
    log(f"[15b] {len(dbs)} adjacency and {len(items)} prefix keys encoded "
        f"in {enc_s:.1f} s; the separate card solver's cold compute_routes "
        f"{ref_ms:.1f} ms; last_phase_ms of the Decision's solver (its "
        f"last full assembly) { {k2: round(v, 3) for k2, v in s.last_phase_ms.items()} }; "
        f"last_solve_stats {s.last_solve_stats}; last_warm_stats "
        f"{ {k2: v for k2, v in s.last_warm_stats.items() if not k2.endswith('_ms')} }; "
        f"{len(d.rib.unicast_routes)} unicast + {len(d.rib.mpls_routes)} "
        f"mpls routes; every RIB == the separate solver's"
        + (" and the cold one == [9]'s" if want is not None else "")
        + f"; every update == the diff of its RIBs; card "
        f"{smi('name,power.limit')}")
    return rows


def phase15(p9=None, k2: int = CONFIG2["k"],
            n_ramp: int = CONFIG2["n_ramp"]) -> dict:
    """[15]: the port's Decision on the card, config 5 (step and live)
    and config 2 (from node-2025, [9]'s states and RIB where given, else
    `config2_states(k2, n_ramp)`)."""
    from openr_tpu_torch.utils.topogen import fat_tree

    t0 = time.perf_counter()
    adj, pfx = fat_tree(CONFIG5["k"], metric=10)
    if len(adj) != CONFIG5["nodes"]:
        fail(f"[15a] fat_tree({CONFIG5['k']}) has {len(adj)} nodes")
    me = adj[0].this_node_name
    step = phase15a_step(adj, pfx, me)
    live = phase15a_live(adj, pfx, me)
    phase15_other_card(*fat_tree(8, metric=10), "node-0")
    if p9 is None:
        ls2, ps2 = config2_states(k2, n_ramp)
        want = None
    else:
        ls2, ps2 = p9["states"]
        want = p9["ribs"].get(f"node-{(k2 // 2) ** 2}")
    rows = phase15b_config2(ls2, ps2, want, k2)
    log(f"[15] done in {time.perf_counter() - t0:.1f} s")
    return dict(step=step, live=live, config2=rows)



# ----------------------------------------------------------- phase 16

#: [16]: store F's node name (it stands for every other node of the
#: fabric), the single flaps rebuilt without and under a RibPolicy, and
#: the short policy TTL left to expire
KV_FABRIC = "fabric"
KV_POLICY_FLAPS = 10
KV_POLICY_TTL_S = 2.0


#: the Decision's markers after N's KVSTORE_FLOODED on a live trace
LIVE_TAILS = {("DECISION_RECEIVED", "DECISION_DEBOUNCED", r,
               "SPF_SOLVE_DONE", "ROUTE_UPDATE_SENT")
              for r in ("REBUILD_FULL", "REBUILD_TOPO_DELTA",
                        "REBUILD_PREFIX_ONLY")}


def kv_pair(me: str):
    """[16]'s two stores in one process over `InProcKvTransport(codec=
    "bin")`: F (`KV_FABRIC`) and N, `me`'s own, whose publications feed
    the port's Decision on the card, its first rebuild gated on N's
    initial sync. Returns (F, N, the Decision, a reader of its
    RouteUpdates); built inside the running loop."""
    from openr_tpu_torch.config import Config
    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.kvstore import InProcKvTransport, KvStore
    from openr_tpu_torch.messaging import ReplicateQueue
    from openr_tpu_torch.monitor import Counters

    t = InProcKvTransport(codec="bin")
    f = KvStore(Config.default(KV_FABRIC), t, ReplicateQueue(name="f"),
                counters=Counters())
    n_pubs = ReplicateQueue(name="n")
    n = KvStore(Config.default(me), t, n_pubs, counters=Counters())
    t.register(KV_FABRIC, f)
    t.register(me, n)
    routes = ReplicateQueue(name="routes")
    reader = routes.get_reader()
    d = Decision(Config.default(me), n_pubs.get_reader(), routes,
                 counters=Counters(), device=DEVICE,
                 initial_sync_event=n.initial_sync_done)
    return f, n, d, reader


def set_on(store, pub, perf_events=None) -> dict:
    """Every key of `pub` written with the store's `set_key` (as the
    originating node's LinkMonitor or PrefixManager writes it), the
    first with `perf_events`; returns key -> version."""
    for i, (k, v) in enumerate(pub.key_vals.items()):
        store.set_key(pub.area, k, v, perf_events=None if i else perf_events)
    return {k: v.version for k, v in pub.key_vals.items()}


async def arrived(n, want: dict, tag: str, timeout: float = 120.0) -> None:
    """Until N holds every key of `want` at its version or later."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA

    t0 = time.perf_counter()
    while not all((v := n.get_key(DEFAULT_AREA, k)) is not None
                  and v.version >= ver for k, ver in want.items()):
        if time.perf_counter() - t0 > timeout:
            fail(f"[16] {tag}: the floods did not reach N in {timeout} s")
        await asyncio.sleep(0.001)


def stores_hold(f, n, pubs, tag: str, phase: str = "16") -> None:
    """F and N each hold, for every key of `pubs` (the last publication
    of a key wins), the generator's Value: its version, originator, hash
    and bytes."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA

    want = {}
    for pub in pubs:
        want.update(pub.key_vals)
    for name, store in ((KV_FABRIC, f), ("N", n)):
        kv = store.dbs[DEFAULT_AREA].kv
        bad = [k for k, v in want.items() if (g := kv.get(k)) is None
               or (g.version, g.originator_id, g.hash, g.value)
               != (v.version, v.originator_id, v.hash, v.value)]
        if bad:
            fail(f"[{phase}] {tag}: {len(bad)} of {len(want)} keys on {name} "
                 f"differ from the generator's values, e.g. {bad[0]}")


class GenLsdb:
    """The LSDB of the generator's own AdjacencyDatabases and prefix
    entries, kept beside the stores: each flap's database is applied as
    it is set on F, never decoded from a store or the Decision."""

    def __init__(self, adj, pfx_items, src: dict):
        from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
        from openr_tpu_torch.types import PrefixDatabase

        self.src = src
        self.ls, self.ps = LinkState(), PrefixState()
        for db in adj:
            self.ls.update_adjacency_db(db)
        for node, e in pfx_items:
            self.ps.update_prefix_db(PrefixDatabase(
                this_node_name=node, prefix_entries=(e,)))

    def flapped(self, pub) -> None:
        self.ls.update_adjacency_db(self.src[id(pub)])

    def rib(self, me: str):
        """A fresh card solver's RIB of the generator's LSDB."""
        from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

        return TorchSpfSolver(device=DEVICE).compute_routes(
            self.ls.snapshot(), self.ps.snapshot(), me)

    def lsdb_is(self, d, pubs, tag: str) -> None:
        """The Decision's AdjacencyDatabase of each node `pubs` flapped
        equals the generator's."""
        from openr_tpu_torch.common.constants import DEFAULT_AREA

        ls = d.link_states[DEFAULT_AREA]
        for pub in pubs:
            node = self.src[id(pub)].this_node_name
            if ls.adjacency_db(node) != self.ls.adjacency_db(node):
                fail(f"[16] {tag}: the Decision's adjacencies of {node} "
                     "differ from the generator's")


async def synced(f, n, me: str, tag: str, timeout: float = 600.0) -> float:
    """Peer F and N both ways; until N's initial sync is done and both
    stores hold the same keys (the 3-way sync sends N's own back).
    Returns the wall in ms."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA
    from openr_tpu_torch.kvstore.kvstore import PeerSpec

    t0 = time.perf_counter()
    n.add_peer_sync(PeerSpec(node_name=KV_FABRIC))
    f.add_peer_sync(PeerSpec(node_name=me))
    fdb, ndb = f.dbs[DEFAULT_AREA], n.dbs[DEFAULT_AREA]
    while not (n.initial_sync_done.is_set() and len(ndb.kv) == len(fdb.kv)
               and ndb.store_hash() == fdb.store_hash()):
        if time.perf_counter() - t0 > timeout:
            fail(f"[16] {tag}: N's full sync did not finish in {timeout} s "
                 f"({len(ndb.kv)} of {len(fdb.kv)} keys)")
        await asyncio.sleep(0.005)
    return (time.perf_counter() - t0) * 1e3


async def quiet(d, runs0: int, tag: str, timeout: float = 60.0) -> None:
    """Until a running Decision finished a rebuild after `runs0` and has
    nothing buffered or pending."""
    t0 = time.perf_counter()
    while not (d._spf_runs > runs0 and not d.debounce.pending
               and not d._pending_kvs and not d.pub_reader.qsize()):
        if time.perf_counter() - t0 > timeout:
            fail(f"[16] {tag}: no finished rebuild in {timeout} s")
        await asyncio.sleep(0.002)


def path_launches(relax, split_loop, rib_epilogue, election_ops) -> dict:
    return dict(relax=dict(relax.LAUNCHES_BY_DESIGN),
                split_loop=dict(split_loop.LAUNCHES),
                rib_epilogue=rib_epilogue.LAUNCHES,
                election=election_ops.LAUNCHES)


def reset_path_launches(*mods) -> None:
    for m in mods:
        m.reset_launches()


def kv_counts(f, n) -> dict:
    """F's flood counters and N's receive side ([16]'s flood layer)."""
    fc, nc = f.counters, n.counters
    out = {k: int(fc.get(f"kvstore.{k}")) for k in (
        "floods_sent", "floods_held", "flood_keys_coalesced",
        "floods_rate_limited", "flood_encodes", "flood_bytes",
        "full_syncs", "full_syncs_served", "full_sync_keys_sent")}
    out["n_floods_received"] = int(nc.get("kvstore.floods_received"))
    out["n_full_syncs"] = int(nc.get("kvstore.full_syncs"))
    for c, k in ((fc, "flood_encode_ms"), (nc, "flood_decode_ms"),
                 (fc, "flood_fanout_ms")):
        st = c.stats.get(f"kvstore.{k}")
        if st is not None and st.count:
            out[f"{k}_avg"] = round(st.avg, 4)
    return out


def config5_policy(adj, me: str, ttl_s: float):
    """[16a]'s RibPolicy at config 5's core root: weights 3 and 2 on the
    uplinks to pods 0 and 1 and 0 on pod 2's (a next hop dropped) for
    the cores' loopbacks in 10.0.0.0/25, and every next hop of
    10.0.0.200/32 at 0 (the route removed)."""
    from openr_tpu_torch.policy import RibPolicy, RibPolicyStatement

    nbrs = [a.other_node_name for a in next(
        db for db in adj if db.this_node_name == me).adjacencies]
    return RibPolicy(statements=(
        RibPolicyStatement(name="drop", match_prefixes=("10.0.0.200/32",),
                           default_weight=0),
        RibPolicyStatement(name="cores", match_prefixes=("10.0.0.0/25",),
                           neighbor_to_weight={nbrs[0]: 3, nbrs[1]: 2,
                                               nbrs[2]: 0}),
    ), ttl_secs=ttl_s)


def policy_applied(policy, rdb):
    """`rdb` with `policy` applied (a copy: the policy rewrites its
    route dicts)."""
    from openr_tpu_torch.types.routes import RouteDatabase

    out = RouteDatabase(this_node_name=rdb.this_node_name)
    out.unicast_routes = dict(rdb.unicast_routes)
    out.mpls_routes = dict(rdb.mpls_routes)
    policy.apply(out)
    return out


def phase16a_config5(adj, pfx, me: str, mods, p15=None) -> dict:
    """[16a] (see the module docstring): config 5 through KvStore. The
    step cycles are [15a]'s flaps (its seed, from the same unflapped
    topology), so that each rebuild does [15a]'s work; the live flaps are drawn with
    [15a]'s live seed from the topology the step left. `p15`: [15]'s
    result, printed beside."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA
    from openr_tpu_torch.common.tasks import guard_task, reap
    from openr_tpu_torch.messaging import QueueClosedError
    from openr_tpu_torch.monitor import perf
    from openr_tpu_torch.types import IpPrefix

    c5 = CONFIG5
    dbs = list(adj)
    versions = {db.this_node_name: 1 for db in dbs}
    rng = np.random.default_rng(20260505)  # [15a]'s step seed
    t_enc = time.perf_counter()
    src: dict = {}
    cycles = [flap_pubs(rng, dbs, c5["flaps"], versions, src)
              for _ in range(c5["warmup"] + c5["cycles"])]
    n_max = int(c5["rate"] * c5["live_s"] * 1.2) + 100
    rng = np.random.default_rng(7)  # [15a]'s live seed
    live = flap_pubs(rng, dbs, n_max, versions, src)
    singles = flap_pubs(rng, dbs, 2 * KV_POLICY_FLAPS, versions, src)
    gen = GenLsdb(adj, [(db.this_node_name, e) for db in pfx
                        for e in db.prefix_entries], src)
    others = [db for db in adj if db.this_node_name != me]
    own = [db for db in adj if db.this_node_name == me]
    f_pubs = [adj_publication(others, 1), prefix_publication(
        [(db.this_node_name, e) for db in pfx if db.this_node_name != me
         for e in db.prefix_entries], 1)]
    n_pubs = [adj_publication(own, 1), prefix_publication(
        [(db.this_node_name, e) for db in pfx if db.this_node_name == me
         for e in db.prefix_entries], 1)]
    enc_s = time.perf_counter() - t_enc
    out = {}

    async def body():
        f, n, d, reader = kv_pair(me)
        spy = SolverSpy(d.solver)
        for pub in f_pubs:
            set_on(f, pub)
        for pub in n_pubs:
            set_on(n, pub)
        await f.start()
        await n.start()
        out["sync_ms"] = await synced(f, n, me, "16a")
        out["keys"] = len(n.dbs[DEFAULT_AREA].kv)
        stores_hold(f, n, f_pubs + n_pubs, "16a full sync")
        feed(d)
        reset_path_launches(*mods)
        cold = await timed_rebuild(d, spy, "16a cold")
        out["launches"] = path_launches(*mods)

        def fresh_rib():
            return gen.rib(me)

        prev = fresh_rib()
        rib_is(d, prev, "16a cold vs a fresh card solver of the generator's "
               "LSDB")
        drain_updates(reader)
        rows = []
        # step: 40 flaps a cycle set on F, flooded into N, one rebuild
        for i, cyc in enumerate(cycles):
            want = {}
            for pub in cyc:
                want.update(set_on(f, pub))
                gen.flapped(pub)
            await arrived(n, want, f"16a cycle {i}")
            stores_hold(f, n, cyc, f"16a cycle {i}")
            feed(d)
            rows.append(await timed_rebuild(
                d, spy, f"16a cycle {i}", fresh_thread=i < c5["warmup"]))
            gen.lsdb_is(d, cyc, f"16a cycle {i}")
            cur = fresh_rib()
            rib_is(d, cur, f"16a cycle {i} vs a fresh card solver of the "
                   "generator's LSDB")
            update_is_diff(drain_updates(reader), prev, cur, f"16a cycle {i}")
            prev = cur
        out["step_rows"] = rows[c5["warmup"]:]
        out["cold"] = cold
        out["kv_step"] = kv_counts(f, n)
        # live: the Decision started, 1 000 flaps/s on F in bursts of 10
        await d.start()
        traces, updates = [], []

        async def drain():
            while True:
                try:
                    upd = await reader.get()
                except QueueClosedError:
                    return
                updates.append(upd)
                traces.extend([(e.event, e.node, e.ts_ns) for e in pe.events]
                              for pe in upd.perf_events)

        drainer = guard_task(asyncio.ensure_future(drain()), owner="16a")
        fires0, runs0 = d.debounce.fires, d._spf_runs
        kv0 = kv_counts(f, n)
        seen, samples = [runs0], []
        n_sent, interval = 0, c5["burst"] / c5["rate"]
        next_send = time.perf_counter()
        stop = next_send + c5["live_s"]
        while time.perf_counter() < stop and n_sent < n_max:
            for j in range(c5["burst"]):
                pe = (perf.PerfEvents.start(perf.ADJ_DB_UPDATED,
                                            node=KV_FABRIC) if j == 0
                      else None)
                set_on(f, live[n_sent], perf_events=pe)
                gen.flapped(live[n_sent])
                n_sent += 1
            if d._spf_runs != seen[0]:
                seen[0] = d._spf_runs
                samples.append(d._last_spf_ms)
            next_send += interval
            await asyncio.sleep(max(0.0, next_send - time.perf_counter()))
        want = {}
        for pub in live[:n_sent]:
            want.update({k: v.version for k, v in pub.key_vals.items()})
        await arrived(n, want, "16a live")
        stores_hold(f, n, live[:n_sent], "16a live")
        await quiet(d, runs0, "16a live")
        await asyncio.sleep(0.05)
        await reap(drainer)
        kv1 = kv_counts(f, n)
        out["live"] = dict(
            n=n_sent, runs=d._spf_runs - runs0,
            fires=d.debounce.fires - fires0, traces=traces,
            updates=len(updates), samples=samples,
            kv={k: v - kv0.get(k, 0) for k, v in kv1.items()
                if isinstance(v, int)})
        gen.lsdb_is(d, live[:n_sent], "16a live")
        rib_is(d, fresh_rib(), "16a live: the final RIB vs a fresh solver "
               "of the generator's LSDB")
        # single flaps without, then under a RibPolicy; then its TTL
        reader2 = d.route_updates.get_reader()
        prev = fresh_rib()
        dropped = IpPrefix.make("10.0.0.200/32")
        pol_rows = {"none": [], "policy": []}

        async def single(pub, tag, policy):
            nonlocal prev
            runs = d._spf_runs
            want = set_on(f, pub)
            gen.flapped(pub)
            await arrived(n, want, tag)
            stores_hold(f, n, [pub], tag)
            await quiet(d, runs, tag)
            gen.lsdb_is(d, [pub], tag)
            cur = fresh_rib()
            if policy is not None:
                cur = policy_applied(policy, cur)
            rib_is(d, cur, f"{tag} vs a fresh card solver's"
                   + (" with the policy" if policy is not None else ""))
            update_is_diff(drain_updates(reader2), prev, cur, tag)
            prev = cur
            return dict(ms=d._last_spf_ms, path=d._rebuild_path)

        for i in range(KV_POLICY_FLAPS):
            pol_rows["none"].append(await single(
                singles[i], f"16a flap {i}", None))
        pol = config5_policy(adj, me, 3600.0)
        runs = d._spf_runs
        d.set_rib_policy(pol)
        await quiet(d, runs, "16a policy install")
        cur = policy_applied(pol, fresh_rib())
        rib_is(d, cur, "16a policy install vs a fresh solve with it")
        update_is_diff(drain_updates(reader2), prev, cur, "16a policy install")
        prev = cur
        if dropped in d.rib.unicast_routes:
            fail("[16a] the policy's dropped route is in the RIB")
        install = dict(ms=d._last_spf_ms, path=d._rebuild_path)
        for i in range(KV_POLICY_FLAPS):
            pol_rows["policy"].append(await single(
                singles[KV_POLICY_FLAPS + i], f"16a flap {i} under the policy",
                pol))
        # a short-lived policy replaces it, and expires
        short = config5_policy(adj, me, KV_POLICY_TTL_S)
        runs = d._spf_runs
        t_set = time.perf_counter()
        d.set_rib_policy(short)
        await quiet(d, runs, "16a short policy")
        cur = policy_applied(short, fresh_rib())
        rib_is(d, cur, "16a short policy vs a fresh solve with it")
        update_is_diff(drain_updates(reader2), prev, cur, "16a short policy")
        prev = cur
        runs = d._spf_runs
        await quiet(d, runs, "16a policy expiry", timeout=KV_POLICY_TTL_S + 30)
        expiry_ms = (time.perf_counter() - t_set) * 1e3
        if d.get_rib_policy() is not None:
            fail("[16a] the policy outlived its TTL")
        cur = fresh_rib()
        rib_is(d, cur, "16a after the expiry vs a fresh solve")
        if dropped not in d.rib.unicast_routes:
            fail("[16a] the dropped route did not come back")
        update_is_diff(drain_updates(reader2), prev, cur, "16a expiry")
        out["policy"] = dict(rows=pol_rows, install=install,
                             expiry=dict(ms=d._last_spf_ms,
                                         path=d._rebuild_path,
                                         since_set_ms=expiry_ms))
        kcfg = f.config.node.kvstore
        out["limit"] = (kcfg.flood_rate_msgs_per_sec,
                        kcfg.flood_rate_burst_size)
        out["started"] = dict(runs=d._spf_runs - runs0,
                              fires=d.debounce.fires - fires0)
        out["failed"] = int(d.counters.get(f"{d.name}.task_exceptions"))
        out["kv"] = kv_counts(f, n)
        await d.stop()
        await n.stop()
        await f.stop()

    asyncio.run(body())
    st = out["started"]
    if out["failed"] or st["fires"] != st["runs"]:
        fail(f"[16a] {st['fires']} debounce fires, {st['runs']} rebuilds "
             f"done, {out['failed']} rebuilds raised")
    lv = out["live"]
    lat, merged = [], 0
    for ev in lv["traces"]:
        names = [e for e, _nd, _t in ev]
        i_n = next((i for i, (e, nd, _t) in enumerate(ev)
                    if (e, nd) == (perf.KVSTORE_FLOODED, me)), None)
        # F's origin and flood stamps (more than one flap's where floods
        # coalesced), N's flood stamp, then the Decision's chain
        if (i_n is None or names[0] != perf.ADJ_DB_UPDATED
                or any(e not in (perf.ADJ_DB_UPDATED, perf.KVSTORE_FLOODED)
                       or nd != KV_FABRIC for e, nd, _t in ev[:i_n])
                or tuple(names[i_n + 1:]) not in LIVE_TAILS):
            fail(f"[16a] live: a trace's markers {names}")
        merged += names[:i_n].count(perf.ADJ_DB_UPDATED) > 1
        lat.append((ev[-1][2] - ev[0][2]) / 1e6)
    if not lat or lv["runs"] == 0:
        fail(f"[16a] live: {len(lat)} traced flaps reached an update in "
             f"{lv['runs']} rebuilds")
    la = out["launches"]
    if not (la["relax"]["vec"] and la["rib_epilogue"]
            and all(la["split_loop"][k]
                    for k in ("snap_mark", "compact", "ctl"))):
        fail(f"[16a] the cold rebuild's kernel launches {la}")
    pol = out["policy"]
    bad = [r["path"] for r in pol["rows"]["policy"] if r["path"] != "full"]
    if bad or pol["install"]["path"] != "full":
        fail(f"[16a] rebuilds under the policy took {bad}")
    ms = [r["ms"] for r in out["step_rows"]]
    paths = {}
    for r in out["step_rows"]:
        paths[r["path"]] = paths.get(r["path"], 0) + 1
    p_none = [r["ms"] for r in pol["rows"]["none"]]
    p_pol = [r["ms"] for r in pol["rows"]["policy"]]
    fl = (f"p50 {p15['live']['p50']:.3f} ms, p99 "
          f"{p15['live']['p99']:.3f} ms" if p15 else "not run (--only 16)")
    fs = (f"p50 {p15['step']['p50']:.3f} ms, p99 "
          f"{p15['step']['p99']:.3f} ms" if p15 else "not run (--only 16)")
    log(f"[16a] config 5 through KvStore: fat_tree({c5['k']}, metric=10), "
        f"{out['keys']} keys, root {me}; F (every other node's keys) and N "
        f"over InProcKvTransport(codec='bin'); N's full sync from F "
        f"{out['sync_ms']:.1f} ms; cold rebuild {out['cold']['ms']:.3f} ms, "
        f"its launches {la}; step: {c5['cycles']} cycles of {c5['flaps']} "
        f"flaps set on F after {c5['warmup']}: recompute p50 "
        f"{statistics.median(ms):.3f} ms, p99 {percentile(ms, 99):.3f} ms "
        f"([15a]'s on the same flaps, pushed straight into the Decision's "
        f"queue: {fs}), paths {paths}, p50 of the warm stats "
        f"{warm_p50s(out['step_rows'])}; flood counters after the step "
        f"{out['kv_step']}; every RIB == a fresh card solver's, every "
        f"update == the diff of fresh RIBs; publications encoded in "
        f"{enc_s:.1f} s; card {smi('name,power.limit')}")
    log(f"[16a] config 5 live through KvStore: {lv['n']} flaps set on F in "
        f"{c5['live_s']} s ({c5['rate']}/s in bursts of {c5['burst']}), "
        f"{lv['runs']} rebuilds, {lv['n'] / lv['runs']:.1f} flaps a "
        f"rebuild, {lv['updates']} updates; flap -> RouteUpdate (F's set_key "
        f"to ROUTE_UPDATE_SENT) p50 {statistics.median(lat):.3f} ms, p99 "
        f"{percentile(lat, 99):.3f} ms over {len(lat)} traces ({merged} "
        f"of them two or more traced flaps coalesced into one flood); [15a]'s "
        f"(pushed straight into the Decision's queue): {fl}; rebuild p50 "
        f"{statistics.median(lv['samples']):.3f} ms over "
        f"{len(lv['samples'])} sampled; F -> N floods in the window "
        f"{lv['kv']} (F's limit {out['limit'][0]} msgs/s, burst "
        f"{out['limit'][1]}); card "
        f"{smi('name,power.limit')}")
    log(f"[16a] RibPolicy at {me}: {KV_POLICY_FLAPS} single flaps without "
        f"it: recompute p50 {statistics.median(p_none):.3f} ms, paths "
        f"{sorted({r['path'] for r in pol['rows']['none']})}; installed: "
        f"{pol['install']['ms']:.3f} ms ({pol['install']['path']}); "
        f"{KV_POLICY_FLAPS} flaps under it: p50 "
        f"{statistics.median(p_pol):.3f} ms, all full; a {KV_POLICY_TTL_S} s "
        f"policy: its expiry's rebuild {pol['expiry']['ms']:.3f} ms "
        f"({pol['expiry']['path']}) "
        f"{pol['expiry']['since_set_ms']:.0f} ms after it was set; every "
        f"RIB == a fresh solve's (with the policy applied while one is "
        f"installed), every update == their diff; {st['fires']} debounce "
        f"fires, {st['runs']} rebuilds, 0 raised; flood counters "
        f"{out['kv']}")
    return dict(step_p50=statistics.median(ms),
                live_p50=statistics.median(lat), live_p99=percentile(lat, 99),
                policy_p50=statistics.median(p_pol),
                none_p50=statistics.median(p_none))


def phase16(p15=None) -> dict:
    """[16]: the port's KvStore feeding its Decision on the card at
    config 5 (config 2's start-up through KvStore runs in [17b]'s node)."""
    from openr_tpu_torch.ops import election as election_ops
    from openr_tpu_torch.ops import relax, rib_epilogue, split_loop
    from openr_tpu_torch.utils.topogen import fat_tree

    mods = (relax, split_loop, rib_epilogue, election_ops)
    t0 = time.perf_counter()
    adj, pfx = fat_tree(CONFIG5["k"], metric=10)
    a = phase16a_config5(adj, pfx, adj[0].this_node_name, mods,
                         p15=p15)
    log(f"[16] done in {time.perf_counter() - t0:.1f} s")
    return dict(config5=a)



# ----------------------------------------------------------- phase 17

#: [17]: node N's aggregate, advertised once this many programmed routes
#: of its block support it; its own links changed and reverted; the
#: program passes failed on purpose; config 2's ramp /32s withdrawn
NODE_AGGREGATE = "10.0.0.0/8"
NODE_AGG_SUPPORT = 64
NODE_OWN_LINKS = 10
NODE_FAILS = 3
NODE_RAMP = 100


def timed_handler(before_sync=None):
    """A `MockFibHandler` that records each call: (method, routes or
    keys, host ms, succeeded), and counts the calls in flight.
    `before_sync` runs once, at the first `sync_fib`."""
    from openr_tpu_torch.fib import MockFibHandler

    class Timed(MockFibHandler):
        def __init__(self):
            super().__init__()
            self.calls: list[tuple[str, int, float, bool]] = []
            self.before_sync = before_sync
            self.in_flight = 0

    for m in ("add_unicast_routes", "delete_unicast_routes",
              "add_mpls_routes", "delete_mpls_routes", "sync_fib",
              "sync_mpls_fib"):
        async def call(self, client_id, arg, _m=m):
            if _m == "sync_fib" and self.before_sync is not None:
                self.before_sync()
                self.before_sync = None
            t0, ok = time.perf_counter(), False
            self.in_flight += 1
            try:
                await getattr(MockFibHandler, _m)(self, client_id, arg)
                ok = True
            finally:
                self.in_flight -= 1
                self.calls.append((_m, len(arg),
                                   (time.perf_counter() - t0) * 1e3, ok))

        setattr(Timed, m, call)
    return Timed()


def fabric_for(me_db):
    """Store F (`KV_FABRIC`, every node's keys but N's) on a transport
    where each of N's neighbours is F: N's KvStore peers with its
    neighbours (LinkMonitor's PeerEvents) and full-syncs with each of
    them against F. The neighbours stand for hosts of their own, so what
    they would do there is not charged to N's process twice: N's floods
    reach F over its first neighbour's session, and over the others'
    they are encoded (once a publication, as for every session) and
    counted, not delivered (those neighbours hold what F holds); a
    full sync's answer is F's, computed once for each pair of store
    hashes (N's, F's) and handed to every neighbour asking with that
    pair (the answer depends on the two stores alone). Returns
    (transport, F)."""
    from openr_tpu_torch.config import Config
    from openr_tpu_torch.kvstore import InProcKvTransport, KvStore
    from openr_tpu_torch.kvstore.transport import _InProcSession, pub_wire_bin
    from openr_tpu_torch.messaging import ReplicateQueue
    from openr_tpu_torch.monitor import Counters

    class NeighbourSession(_InProcSession):
        async def full_sync(self, area, sender_id, digest, store_hash=None):
            t = self._t
            key = (area, store_hash, digest is None,
                   self._peer().dbs[area].store_hash())
            out = t.answers.get(key)
            if out is None:
                out = await super().full_sync(area, sender_id, digest,
                                              store_hash)
                if len(t.answers) > 64:
                    t.answers.clear()
                t.answers[key] = out
            else:
                t.reused += 1
            return dict(out)

        async def flood(self, pub) -> int:
            if self.peer_id == self._t.primary:
                return await super().flood(pub)
            await asyncio.sleep(0)
            self._t.copies += 1
            return len(pub_wire_bin(pub, self.counters))

    class FabricTransport(InProcKvTransport):
        def __init__(self):
            super().__init__(codec="bin")
            self.copies = self.reused = 0
            self.answers: dict = {}
            self.neighbours: set[str] = set()
            self.primary = ""

        async def connect(self, peer_id, endpoint, counters=None):
            s = await super().connect(peer_id, endpoint, counters)
            if peer_id in self.neighbours:
                return NeighbourSession(self, peer_id, counters=counters)
            return s

    t = FabricTransport()
    f = KvStore(Config.default(KV_FABRIC), t, ReplicateQueue(name="f"),
                counters=Counters())
    t.register(KV_FABRIC, f)
    for a in me_db.adjacencies:
        t.register(a.other_node_name, f)
    t.neighbours = {a.other_node_name for a in me_db.adjacencies}
    t.primary = me_db.adjacencies[0].other_node_name
    return t, f


class FirstRebuild(asyncio.Event):
    """The Decision's RIB_COMPUTED gate, which also keeps the first
    rebuild's wall, path and split as it opens (a later rebuild may have
    run by the time a waiter wakes)."""

    def __init__(self, decision, out: dict):
        super().__init__()
        self.decision, self.out = decision, out

    def set(self) -> None:
        if not self.is_set():
            d = self.decision
            self.out.update(ms=d._last_spf_ms, path=d._rebuild_path,
                            split=dict(d.last_breakdown_ms))
        super().set()


#: [17]'s Spark timers: the defaults, but a hold time of a minute, so
#: that the event loop's stalls at config 2's start-up (the digests of
#: ~70 000 keys for each of 90 neighbours, run on the loop) expire no
#: neighbour
NODE_SPARK = dict(hold_time_ms=60_000, graceful_restart_time_ms=60_000)


def node_config(me: str, me_db, loopback):
    """N's config: SR on with the generator's node label, the loopback
    and `NODE_AGGREGATE` (gated on `NODE_AGG_SUPPORT` programmed routes)
    originated, no initial sync by the grace alone (N has no peer until
    LinkMonitor's first PeerEvent), the watchdog off (not part of the
    port yet)."""
    from openr_tpu_torch.config import (Config, KvstoreConfig, NodeConfig,
                                        OriginatedPrefix,
                                        SegmentRoutingConfig, SparkConfig,
                                        WatchdogConfig)

    return Config(NodeConfig(
        node_name=me,
        spark=SparkConfig(**NODE_SPARK),
        kvstore=KvstoreConfig(initial_sync_grace_s=3600.0),
        watchdog=WatchdogConfig(enable=False),
        segment_routing=SegmentRoutingConfig(
            enable=True, node_segment_label=me_db.node_label),
        originated_prefixes=(
            OriginatedPrefix(prefix=str(loopback)),
            OriginatedPrefix(prefix=NODE_AGGREGATE,
                             minimum_supporting_routes=NODE_AGG_SUPPORT))))


def speakers_for(me_db, io_for, kvstore_port: int = 0) -> list:
    """N's neighbours as Spark speakers: one a neighbour, named as the
    generator names it, on the far end of each of N's links
    (`io_for(name)` gives its packet I/O); each advertises
    `kvstore_port` (0: peered in process, by name). Returns (Spark,
    interface) pairs."""
    from openr_tpu_torch.config import Config, NodeConfig, SparkConfig
    from openr_tpu_torch.messaging import ReplicateQueue
    from openr_tpu_torch.spark import Spark

    out = []
    for a in me_db.adjacencies:
        nbr = a.other_node_name
        out.append((Spark(Config(NodeConfig(
            node_name=nbr, spark=SparkConfig(**NODE_SPARK))),
            io_for(nbr), ReplicateQueue(name=f"{nbr}.nbr"),
            kvstore_port=kvstore_port), a.other_if_name))
    return out


def node_n(me: str, me_db, transport, loopback, others: list,
           before_sync=None):
    """Node N: the port's `OpenrNode` on the card (`device=None`), its
    neighbours' Sparks on one `MockIoHub` with N's (linked over the
    generator's interfaces), Fib on a timed `MockFibHandler`, the
    Decision's RIB_COMPUTED gate keeping the first rebuild's wall, N's
    other prefixes (`others`) one API event. Returns (N, speakers)."""
    from openr_tpu_torch.node import OpenrNode
    from openr_tpu_torch.prefixmgr import (PrefixEvent, PrefixEventType,
                                           PrefixSource)
    from openr_tpu_torch.spark import MockIoHub

    hub = MockIoHub()
    for a in me_db.adjacencies:
        hub.link(me, a.if_name, a.other_node_name, a.other_if_name)
    node = OpenrNode(node_config(me, me_db, loopback), hub.io_for(me),
                     transport, fib_handler=timed_handler(before_sync),
                     device=None if DEVICE == "cuda" else DEVICE)
    transport.register(me, node.kvstore)
    node.me_db, node.first_rebuild, node.traces_seen = me_db, {}, 0
    node.decision.rib_computed = FirstRebuild(node.decision,
                                              node.first_rebuild)
    if others:
        node.prefix_events.push(PrefixEvent(
            type=PrefixEventType.ADD_PREFIXES, source=PrefixSource.API,
            entries=tuple(others)))
    return node, speakers_for(me_db, hub.io_for)


def neighbors_up(node) -> None:
    """Each link's metric pinned to the generator's through LinkMonitor's
    override, as an operator would (LinkMonitor's own metric is 1 a
    hop), then N's interfaces up: LinkMonitor runs Spark on them, and
    each neighbour found is a traced NEIGHBOR_UP."""
    from openr_tpu_torch.types.events import InterfaceEvent, InterfaceInfo

    adjs = node.me_db.adjacencies
    for a in adjs:
        node.linkmonitor.set_link_metric(a.if_name, a.metric)
    node.interface_events.push(InterfaceEvent(
        interfaces=[InterfaceInfo(name=a.if_name) for a in adjs]))


def node_busy(node, f) -> bool:
    """O(1) checks: a queue of N's holds an item, a debounce is pending,
    Fib has a pass due, under way or traces to stamp, or a flood to or
    from F is waiting in a pending buffer."""
    d, fib = node.decision, node.fib
    qs = [node.queues[k] for k in (
        "neighbor_events", "interface_events", "peer_events", "kvstore_pubs",
        "prefix_events", "route_updates", "fib_updates")]
    return bool(
        any(r.qsize() for qu in qs for r in qu.readers)
        or node.linkmonitor._advertise_debounce.pending
        or d.debounce.pending or d._pending_kvs
        or fib._dirty.is_set() or fib._pending_perf
        or node.fib_handler.in_flight
        or any(p.pending_keys or p.pending_expired
               for st in (f, node.kvstore) for p in st.peers.values()))


def node_table(node) -> tuple[dict, dict]:
    from openr_tpu_torch.fib import CLIENT_ID_OPENR

    h = node.fib_handler
    return (dict(h.unicast.get(CLIENT_ID_OPENR, {})),
            dict(h.mpls.get(CLIENT_ID_OPENR, {})))


def node_traces(node) -> list:
    """The traces Monitor completed since the last call (from its ring:
    the newest MAX_PERF_TRACES), each [(marker, node, ns)]."""
    ring = list(node.monitor.perf_traces)
    total = int(node.counters.get("monitor.perf_traces"))
    n = min(total - node.traces_seen, len(ring))
    node.traces_seen = total
    return [[(e.event, e.node, e.ts_ns) for e in t.events]
            for t in ring[len(ring) - n:]] if n > 0 else []


async def start_node(node, speakers) -> None:
    for sp, ifn in speakers:
        await sp.start()
        sp.add_interface(ifn)
    await node.start()


async def stop_node(node, speakers) -> None:
    await node.stop()
    for sp, _ifn in speakers:
        await sp.stop()


async def node_quiet(node, f, tag: str, timeout: float = 300.0,
                     traces: int = 0) -> float:
    """Until N is idle (queues drained, no debounce pending, Fib
    converged) and F and N hold the same keys. The O(table) checks
    (Fib's `pending_changes`, the stores' hashes) stay off the loop
    while a window is measured: first `traces` more traces reach
    Monitor, and N's O(1) checks (`node_busy`) hold for three 5 ms
    polls; only then the O(table) checks, and after each that fails
    the wait before the next doubles (to 160 ms). Returns the wall in
    ms."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA

    t0 = time.perf_counter()
    calm, backoff = 0, 0.005
    fdb, ndb = f.dbs[DEFAULT_AREA], node.kvstore.dbs[DEFAULT_AREA]
    want = node.traces_seen + traces
    while True:
        if time.perf_counter() - t0 > timeout:
            fail(f"[17] {tag}: N did not settle in {timeout} s (busy "
                 f"{node_busy(node, f)}, traces "
                 f"{int(node.counters.get('monitor.perf_traces'))} of "
                 f"{want}, F {len(fdb.kv)} keys, N {len(ndb.kv)})")
        if int(node.counters.get("monitor.perf_traces")) < want \
                or node_busy(node, f):
            calm = 0
        else:
            calm += 1
        if calm >= 3:
            if len(fdb.kv) == len(ndb.kv) \
                    and node.fib.pending_changes()["converged"] \
                    and fdb.store_hash() == ndb.store_hash():
                return (time.perf_counter() - t0) * 1e3
            calm = 0
            await asyncio.sleep(backoff)
            backoff = min(2 * backoff, 0.16)
        await asyncio.sleep(0.005)


class NodeLsdb:
    """The generator's LSDB with N's own AdjacencyDatabase replaced by
    LinkMonitor's and N's prefixes by what its PrefixManager advertises:
    each flap applied as it is set on F, never read back from a store or
    the Decision. `ls` / `ps` may be shared states (config 2's), then
    `restore` puts back what was replaced."""

    def __init__(self, ls, ps, me: str, src: dict):
        self.ls, self.ps, self.me, self.src = ls, ps, me, src
        self.orig_db = ls.adjacency_db(me)
        self.orig_items = [(nd, e) for nd, e in prefix_items(ps) if nd == me]
        self.own_pfx: dict = {}

    def flapped(self, pub) -> None:
        self.ls.update_adjacency_db(self.src[id(pub)])

    def set_own(self, node) -> None:
        """N's databases as its LinkMonitor and PrefixManager hold them."""
        from openr_tpu_torch.common.constants import DEFAULT_AREA
        from openr_tpu_torch.types import PrefixDatabase

        self.ls.update_adjacency_db(
            node.linkmonitor.build_adjacency_db(DEFAULT_AREA))
        adv = node.prefixmgr.get_advertised()
        for p, e in adv.items():
            if self.own_pfx.get(p) != e:
                self.ps.update_prefix_db(PrefixDatabase(
                    this_node_name=self.me, prefix_entries=(e,)))
        for p in [p for p in self.own_pfx if p not in adv]:
            self.ps.update_prefix_db(PrefixDatabase(
                this_node_name=self.me, delete_prefix=True,
                prefix_entries=(self.own_pfx[p],)))
        self.own_pfx = dict(adv)

    def restore(self) -> None:
        from openr_tpu_torch.types import PrefixDatabase

        self.ls.update_adjacency_db(self.orig_db)
        for p, e in self.own_pfx.items():
            self.ps.update_prefix_db(PrefixDatabase(
                this_node_name=self.me, delete_prefix=True,
                prefix_entries=(e,)))
        for nd, e in self.orig_items:
            self.ps.update_prefix_db(PrefixDatabase(
                this_node_name=nd, prefix_entries=(e,)))

    def rib(self):
        """A fresh card solver's RIB of this LSDB."""
        from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

        return TorchSpfSolver(device=DEVICE).compute_routes(
            self.ls.snapshot(), self.ps.snapshot(), self.me)


def table_is(node, rdb, tag: str) -> tuple[int, int]:
    """N's handler holds exactly `rdb` converted: every unicast and MPLS
    route, equal; returns the counts."""
    uni, mpls = node_table(node)
    want_u = {p: e.to_unicast_route() for p, e in rdb.unicast_routes.items()}
    want_m = {lb: e.to_mpls_route() for lb, e in rdb.mpls_routes.items()}
    if uni != want_u or mpls != want_m:
        bad = [str(p) for p in want_u.keys() | uni.keys()
               if want_u.get(p) != uni.get(p)]
        badm = [lb for lb in want_m.keys() | mpls.keys()
                if want_m.get(lb) != mpls.get(lb)]
        fail(f"[17] {tag}: the handler's table differs from the converted "
             f"RIB of a fresh card solve: {len(bad)} unicast (e.g. "
             f"{bad[:3]}), {len(badm)} mpls (e.g. {badm[:3]})")
    return len(uni), len(mpls)


def trace_ms(ev, marker: str) -> float | None:
    """ms from a trace's first marker to its last `marker`."""
    ts = [t for e, _n, t in ev if e == marker]
    return (ts[-1] - ev[0][2]) / 1e6 if ts else None


async def loop_lag(stop: list, out: list) -> None:
    """How late the event loop wakes a 1 ms sleep, while `stop` is
    empty: Fib and PrefixManager run on this loop, the rebuilds on
    workers."""
    while not stop:
        t0 = time.perf_counter()
        await asyncio.sleep(0.001)
        out.append((time.perf_counter() - t0) * 1e3 - 1.0)


async def node_up(node, speakers, f, tag: str) -> dict:
    """N and its neighbours' Sparks started; F pushes its keys to N (F's
    session to N); then N's interfaces come up: LinkMonitor runs Spark on
    them, the neighbours are found, and LinkMonitor's PeerEvents peer N's
    store with each (F, registered under each neighbour's name) and its
    adj:<N> floods to F. The walls of every neighbour in LinkMonitor,
    KVSTORE_SYNCED, RIB_COMPUTED and FIB_SYNCED from the interfaces coming
    up."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA
    from openr_tpu_torch.kvstore.kvstore import PeerSpec

    out = {}
    await start_node(node, speakers)
    t0 = time.perf_counter()
    f.add_peer_sync(PeerSpec(node_name=node.name))
    fdb, ndb = f.dbs[DEFAULT_AREA], node.kvstore.dbs[DEFAULT_AREA]
    while not all(k in ndb.kv for k in fdb.kv):
        if time.perf_counter() - t0 > 600:
            fail(f"[17] {tag}: F's push to N did not finish")
        await asyncio.sleep(0.005)
    out["push_ms"] = (time.perf_counter() - t0) * 1e3
    out["keys"] = len(ndb.kv)
    out["peers"] = len(node.me_db.adjacencies)
    t1 = time.perf_counter()
    neighbors_up(node)
    n_adj = len(node.me_db.adjacencies)
    while len(node.linkmonitor.adjacencies) < n_adj:
        if time.perf_counter() - t1 > 600:
            fail(f"[17] {tag}: Spark found {len(node.linkmonitor.adjacencies)}"
                 f" of N's {n_adj} neighbours")
        await asyncio.sleep(0.005)
    out["discovered_ms"] = (time.perf_counter() - t1) * 1e3
    for name, gate in (("kvstore_synced", node.kvstore.initial_sync_done),
                       ("rib_computed", node.decision.rib_computed),
                       ("fib_synced", node.fib.synced)):
        try:
            await asyncio.wait_for(gate.wait(), 900)
        except asyncio.TimeoutError:
            fail(f"[17] {tag}: the {name} gate did not pass")
        out[name + "_ms"] = (time.perf_counter() - t1) * 1e3
    out["cold"] = node.first_rebuild
    out["quiet_ms"] = await node_quiet(node, f, tag)
    out["rebuilds"] = node.decision._spf_runs
    return out


def sync_row(node) -> dict:
    """The first full sync: the handler's sync calls (routes, ms) and
    Fib's longest pass of the start-up (its full sync)."""
    calls = [c for c in node.fib_handler.calls if c[0].startswith("sync")]
    st = node.counters.stats.get("fib.program_ms")
    return dict(unicast=calls[0][1], mpls=calls[1][1],
                handler_ms=round(calls[0][2] + calls[1][2], 3),
                pass_ms=None if st is None else round(st.max, 3))


def phase17a_config5(adj, pfx, me: str, mods) -> dict:
    """[17a] (see the module docstring): node N at config 5's core."""
    import dataclasses

    from openr_tpu_torch.common.constants import DEFAULT_AREA, prefix_key
    from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
    from openr_tpu_torch.monitor import perf
    from openr_tpu_torch.types import IpPrefix, PrefixDatabase
    from openr_tpu_torch.types.serde import from_wire

    c5 = CONFIG5
    dbs = list(adj)
    versions = {db.this_node_name: 1 for db in dbs}
    me_db = next(db for db in adj if db.this_node_name == me)
    src: dict = {}
    # the fabric's flaps, drawn with [16a]'s seeds among every node but
    # N (N's own database is LinkMonitor's), from the unflapped fabric
    others = [db for db in dbs if db.this_node_name != me]
    f_adj = list(others)
    rng = np.random.default_rng(20260505)
    cycles = [flap_pubs(rng, others, c5["flaps"], versions, src)
              for _ in range(c5["warmup"] + c5["cycles"])]
    rng = np.random.default_rng(7)
    n_max = int(c5["rate"] * c5["live_s"] * 1.2) + 100
    live = flap_pubs(rng, others, n_max, versions, src)
    fails = flap_pubs(rng, others, c5["flaps"], versions, src)
    picks = [me_db.adjacencies[int(i)] for i in rng.choice(
        len(me_db.adjacencies), NODE_OWN_LINKS, replace=False)]
    own_metrics = [int(rng.integers(11, 64)) for _ in picks]
    ls, ps = LinkState(), PrefixState()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    gen = NodeLsdb(ls, ps, me, src)
    loopback = next(db for db in pfx if db.this_node_name == me)\
        .prefix_entries[0].prefix
    out = {}

    async def body():
        t, f = fabric_for(me_db)
        for pub in (adj_publication(f_adj, 1), prefix_publication(
                [(db.this_node_name, e) for db in pfx
                 if db.this_node_name != me for e in db.prefix_entries], 1)):
            set_on(f, pub)
        agg_key = prefix_key(me, DEFAULT_AREA, NODE_AGGREGATE)
        agg_before = []
        node, speakers = node_n(me, me_db, t, loopback, [], before_sync=(
            lambda: agg_before.append(
                f.get_key(DEFAULT_AREA, agg_key) is None
                and node.kvstore.get_key(DEFAULT_AREA, agg_key) is None)))
        spy = SolverSpy(node.decision.solver)
        d = node.decision
        await f.start()
        reset_path_launches(*mods)
        out["up"] = await node_up(node, speakers, f, "17a start-up")
        out["launches"] = path_launches(*mods)
        out["sync"] = sync_row(node)
        v = f.get_key(DEFAULT_AREA, agg_key)
        if agg_before != [True] or v is None or from_wire(
                v.value, PrefixDatabase).delete_prefix:
            fail(f"[17a] the gated aggregate: absent before Fib's sync "
                 f"{agg_before}, in F after it {v is not None}")
        gen.set_own(node)
        out["table"] = table_is(node, gen.rib(), "17a start-up")
        out["startup_traces"] = node_traces(node)
        out["adjacencies"] = node.linkmonitor.build_adjacency_db(
            DEFAULT_AREA).adjacencies
        # step: 40 flaps a cycle set on F, one traced
        rows = []
        for i, cyc in enumerate(cycles):
            runs0, w0 = d._spf_runs, node.route_updates.num_writes
            pe = perf.PerfEvents.start(perf.ADJ_DB_UPDATED, node=KV_FABRIC)
            for j, pub in enumerate(cyc):
                set_on(f, pub, perf_events=None if j else pe)
                gen.flapped(pub)
            await node_quiet(node, f, f"17a cycle {i}")
            table_is(node, gen.rib(), f"17a cycle {i}")
            tr = [ev for ev in node_traces(node)
                  if ev[0][:2] == (perf.ADJ_DB_UPDATED, KV_FABRIC)]
            rows.append(dict(ms=d._last_spf_ms, path=d._rebuild_path,
                             runs=d._spf_runs - runs0,
                             pushed=node.route_updates.num_writes - w0,
                             fib=[trace_ms(ev, perf.FIB_PROGRAMMED)
                                  for ev in tr],
                             sent=[trace_ms(ev, perf.ROUTE_UPDATE_SENT)
                                   for ev in tr]))
        out["step"] = rows[c5["warmup"]:]
        # live: 1 000 flaps/s on F in bursts of 10, each burst's first
        # traced; the loop's lag sampled meanwhile
        runs0, fires0 = d._spf_runs, d.debounce.fires
        lag, stop = [], []
        lagger = asyncio.ensure_future(loop_lag(stop, lag))
        n_sent, interval = 0, c5["burst"] / c5["rate"]
        next_send = time.perf_counter()
        t_live = time.monotonic_ns()
        end = next_send + c5["live_s"]
        while time.perf_counter() < end and n_sent < n_max:
            for j in range(c5["burst"]):
                pe = (perf.PerfEvents.start(perf.ADJ_DB_UPDATED,
                                            node=KV_FABRIC) if j == 0
                      else None)
                set_on(f, live[n_sent], perf_events=pe)
                gen.flapped(live[n_sent])
                n_sent += 1
            next_send += interval
            await asyncio.sleep(max(0.0, next_send - time.perf_counter()))
        await node_quiet(node, f, "17a live")
        stop.append(1)
        await lagger
        table_is(node, gen.rib(), "17a live")
        done = int(node.counters.get("monitor.perf_traces"))
        tr = [ev for ev in node_traces(node)
              if ev[0][:2] == (perf.ADJ_DB_UPDATED, KV_FABRIC)
              and ev[0][2] >= t_live]
        out["live"] = dict(
            n=n_sent, runs=d._spf_runs - runs0,
            fires=d.debounce.fires - fires0, ring=len(tr),
            completed=done, lag=lag,
            fib=[trace_ms(ev, perf.FIB_PROGRAMMED) for ev in tr],
            sent=[trace_ms(ev, perf.ROUTE_UPDATE_SENT) for ev in tr])
        # N's own links, one at a time, through LinkMonitor, and back
        lm, own = node.linkmonitor, []
        for a, m in zip(picks, own_metrics):
            for metric in (m, a.metric):
                runs0 = d._spf_runs
                # set_link_metric carries no trace (an operator's call,
                # as in the JAX package): start one where LinkMonitor
                # merges its neighbour events' traces
                lm._pending_perf = perf.PerfEvents.start(
                    perf.ADJ_DB_UPDATED, node=me)
                lm.set_link_metric(a.if_name, metric)
                await node_quiet(node, f, f"17a own link {a.if_name}",
                                 traces=1)
                gen.set_own(node)
                table_is(node, gen.rib(), f"17a own link {a.if_name} "
                         f"metric {metric}")
                tr = [ev for ev in node_traces(node)
                      if ev[0][:2] == (perf.ADJ_DB_UPDATED, me)]
                if len(tr) != 1:
                    fail(f"[17a] own link {a.if_name}: {len(tr)} traces")
                own.append(dict(ms=d._last_spf_ms, path=d._rebuild_path,
                                runs=d._spf_runs - runs0,
                                fib=trace_ms(tr[0], perf.FIB_PROGRAMMED),
                                names=[e for e, _n, _t in tr[0]]))
        out["own"] = own
        # a RibPolicy ([16a]'s) installed, then removed: the programmed
        # table follows the policy's RIB and comes back
        pol_rows = []
        for pol in (config5_policy(adj, me, 3600.0), None):
            runs0 = d._spf_runs
            d.set_rib_policy(pol)
            await node_quiet(node, f, "17a RibPolicy")
            rdb = gen.rib()
            table_is(node, rdb if pol is None else policy_applied(pol, rdb),
                     "17a RibPolicy " + ("installed" if pol else "removed"))
            uni, _m = node_table(node)
            held = IpPrefix.make("10.0.0.200/32")
            pol_rows.append(dict(ms=d._last_spf_ms, path=d._rebuild_path,
                                 runs=d._spf_runs - runs0,
                                 held=held in uni,
                                 solved=held in rdb.unicast_routes))
        out["policy"] = pol_rows
        # failures: the next NODE_FAILS handler calls fail
        h, c = node.fib_handler, node.counters
        fails0, syncs0 = c.get("fib.program_fail"), h.sync_count
        h.fail_next_n = NODE_FAILS
        pe = perf.PerfEvents.start(perf.ADJ_DB_UPDATED, node=KV_FABRIC)
        for j, pub in enumerate(fails):
            set_on(f, pub, perf_events=None if j else pe)
            gen.flapped(pub)
        await node_quiet(node, f, "17a failures", traces=1)
        pend = node.fib.pending_changes()
        tr = [ev for ev in node_traces(node)
              if ev[0][:2] == (perf.ADJ_DB_UPDATED, KV_FABRIC)]
        out["fails"] = dict(failed=int(c.get("fib.program_fail") - fails0),
                            syncs=h.sync_count - syncs0,
                            converged=pend["converged"], traces=len(tr),
                            fib=trace_ms(tr[0], perf.FIB_PROGRAMMED)
                            if tr else None,
                            streak=int(c.get("fib.program_fail_streak")))
        table_is(node, gen.rib(), "17a after the failures")
        out["calls"] = spy.calls
        out["copies"] = (t.copies, t.reused)
        out["fib"] = {k: c.get(f"fib.{k}") for k in (
            "program_ok", "program_fail", "program_batches",
            "routes_programmed", "program_scan_routes",
            "perf_traces_completed")}
        st = c.stats.get("fib.program_batch_size")
        out["batch_max"] = st.max if st is not None else None
        out["failed"] = int(c.get(f"{d.name}.task_exceptions"))
        out["samples"] = len(node.monitor.events)
        await stop_node(node, speakers)
        await f.stop()

    asyncio.run(body())
    return check17a(out, mods)


def calls_on_card(calls, tag: str) -> dict:
    """Every solver call of the rebuilds ran with the card current, and
    every solve that computed read its result back from it. A warm call
    that refused is followed by a full solve, which read; one that did
    not may read nothing only where none of its edges changed metric (the
    solver's reuse branch: `changes` 0). Returns the counts: solves,
    refused warm calls by their reason, reused ones and their edge
    pairs."""
    solves = [c for c in calls if c["name"] != "assemble_prefix_routes"]
    bad = [c for c in calls if c["device"] is None]
    refused, reused = [], []
    for i, c in enumerate(solves):
        if c.get("refused"):
            nxt = solves[i + 1] if i + 1 < len(solves) else None
            if nxt is None or nxt["name"] != "compute_routes" \
                    or not nxt["syncs"] + nxt["reads"]:
                bad.append(c)
            refused.append(c)
        elif c["syncs"] + c["reads"]:
            continue
        elif c["name"] == "compute_routes":
            bad.append(c)
        elif c["warm"] is not None and c["warm"].get("changes") == 0:
            reused.append(c)
        else:
            bad.append(c)
    if bad or not solves:
        fail(f"[17] {tag}: solver calls off the card {bad[:3]} "
             f"({len(solves)} solves)")
    why: dict = {}
    for c in refused:
        why[c["why"]] = why.get(c["why"], 0) + 1
    return dict(solves=len(solves), refused=len(refused), why=why,
                reused=len(reused),
                reused_pairs=sorted(c["pairs"] for c in reused))


def p50(xs) -> float:
    return statistics.median(xs) if xs else float("nan")


def p99(xs) -> float:
    return percentile(xs, 99) if xs else float("nan")


def check17a(out: dict, mods) -> dict:
    """[17a]'s lines, then its gates (every reading printed before a
    failing gate stops the run)."""
    from openr_tpu_torch.monitor import perf

    c5 = CONFIG5
    bad = []
    la = out["launches"]
    if not (la["relax"]["vec"] and la["rib_epilogue"]
            and all(la["split_loop"][k]
                    for k in ("snap_mark", "compact", "ctl"))):
        bad.append(f"the start-up's kernel launches {la}")
    solves = calls_on_card(out["calls"], "17a")
    if out["failed"]:
        bad.append(f"{out['failed']} rebuilds raised")
    want = [perf.NEIGHBOR_EVENT, perf.ADJ_DB_UPDATED, perf.KVSTORE_FLOODED,
            perf.DECISION_RECEIVED, perf.DECISION_DEBOUNCED,
            perf.REBUILD_FULL, perf.SPF_SOLVE_DONE, perf.ROUTE_UPDATE_SENT,
            perf.FIB_PROGRAMMED]
    # LinkMonitor merges the neighbour events' traces that one
    # advertisement covers, in timestamp order: each (marker, node) pair
    # counted once
    if not any([e for e, _n in dict.fromkeys((e, n) for e, n, _t in ev)]
               == want for ev in out["startup_traces"]):
        bad.append(f"no start-up trace with the markers {want}: "
                   f"{[[e for e, _n, _t in ev] for ev in out['startup_traces']]}")
    step = out["step"]
    ms = [r["ms"] for r in step]
    fib = [x for r in step for x in r["fib"] if x is not None]
    runs = [r["runs"] for r in step]
    # a cycle whose rebuild changed no route ends its trace at the
    # Decision (no RouteUpdate); every other reaches FIB_PROGRAMMED
    still = sum(1 for r in step if not r["pushed"])
    lost = [i for i, r in enumerate(step) if r["pushed"] and not r["fib"]]
    paths = {}
    for r in step:
        paths[r["path"]] = paths.get(r["path"], 0) + 1
    lv = out["live"]
    lat = [x for x in lv["fib"] if x is not None]
    sent = [x for x, y in zip(lv["sent"], lv["fib"]) if y is not None]
    if not lat or lost:
        bad.append(f"traced flaps reached FIB_PROGRAMMED: live {len(lat)}, "
                   f"step cycles with an update and no trace {lost}")
    fl = out["fails"]
    if fl["failed"] != NODE_FAILS or not fl["syncs"] or not fl["converged"] \
            or fl["traces"] != 1 or fl["streak"]:
        bad.append(f"the failures window {fl}")
    own = out["own"]
    own_paths = {}
    for r in own:
        own_paths[r["path"]] = own_paths.get(r["path"], 0) + 1
    up, sy = out["up"], out["sync"]
    lag = sorted(lv["lag"])
    card = smi("name,power.limit")
    log(f"[17a] node N (the port's OpenrNode, device=None) at config 5's "
        f"core node-0 (fat_tree({c5['k']}, metric=10)), its {up['peers']} "
        f"neighbours Spark speakers on one MockIoHub (hold time "
        f"{NODE_SPARK['hold_time_ms']} ms), each link's metric set to the "
        f"generator's 10 by LinkMonitor's override as an operator would "
        f"(LinkMonitor's own is 1 a hop): F pushed "
        f"{up['keys']} keys to N in {up['push_ms']:.1f} ms; from N's "
        f"interfaces coming up every neighbour found by Spark "
        f"{up['discovered_ms']:.1f} ms, KVSTORE_SYNCED "
        f"{up['kvstore_synced_ms']:.1f} ms "
        f"(N's KvStore peered with its {up['peers']} neighbours), "
        f"RIB_COMPUTED {up['rib_computed_ms']:.1f} ms, FIB_SYNCED "
        f"{up['fib_synced_ms']:.1f} ms, quiet after {up['quiet_ms']:.1f} "
        f"ms; the first rebuild {up['cold']['ms']:.3f} ms "
        f"({up['cold']['path']}; {up['rebuilds']} rebuilds by the quiet), "
        f"the start-up's launches {la}; FULL_SYNC "
        f"{sy['unicast']} unicast + {sy['mpls']} mpls routes, the handler's "
        f"sync calls {sy['handler_ms']} ms, Fib's pass {sy['pass_ms']} ms; "
        f"the table == a fresh card solve's converted RIB "
        f"({out['table'][0]} + {out['table'][1]}); aggregate "
        f"{NODE_AGGREGATE} absent before the sync, in F after; card {card}")
    log(f"[17a] step: {c5['cycles']} cycles of {c5['flaps']} flaps set on F "
        f"after {c5['warmup']}: rebuilds a cycle {sorted(set(runs))} "
        f"({still} cycles changed no route: their traces end at the "
        f"Decision), "
        f"recompute p50 {p50(ms):.3f} ms, p99 "
        f"{p99(ms):.3f} ms, paths {paths}; flap -> "
        f"FIB_PROGRAMMED p50 {p50(fib):.3f} ms, p99 "
        f"{p99(fib):.3f} ms; every table == a fresh card solve's "
        f"converted RIB; card {card}")
    log(f"[17a] live: {lv['n']} flaps set on F in {c5['live_s']} s "
        f"({c5['rate']}/s in bursts of {c5['burst']}), {lv['runs']} rebuilds "
        f"({lv['fires']} debounce fires); flap -> FIB_PROGRAMMED p50 "
        f"{p50(lat):.3f} ms, p99 {p99(lat):.3f} ms, "
        f"flap -> ROUTE_UPDATE_SENT on the same traces p50 "
        f"{p50(sent):.3f} ms, p99 {p99(sent):.3f} "
        f"ms, over {len(lat)} traces in Monitor's ring ({lv['completed']} "
        f"completed in all); event-loop lag p50 "
        f"{p50(lag):.3f} ms, p99 {p99(lag):.3f} "
        f"ms, max {max(lag, default=float('nan')):.3f} ms over {len(lag)} "
        f"samples; the final "
        f"table == a fresh card solve's; card {card}")
    pol = out["policy"]
    if pol[0]["held"] or pol[1]["held"] != pol[1]["solved"]:
        bad.append(f"the policy's dropped route: {pol}")
    own_fib = [r["fib"] for r in own]
    log(f"[17a] own links: {NODE_OWN_LINKS} of node-0's link metrics "
        f"changed through LinkMonitor.set_link_metric and reverted: "
        f"ADJ_DB_UPDATED -> FIB_PROGRAMMED p50 "
        f"{p50(own_fib):.3f} ms, max {max(own_fib, default=float('nan')):.3f} ms; "
        f"recompute p50 {p50([r['ms'] for r in own]):.3f} ms; "
        f"paths {own_paths}; markers {own[0]['names']}; every table == a "
        f"fresh card solve's; [16a]'s RibPolicy installed: rebuild "
        f"{pol[0]['ms']:.3f} ms ({pol[0]['path']}), the table == the "
        f"policy on a fresh solve (10.0.0.200/32 withdrawn), removed: "
        f"{pol[1]['ms']:.3f} ms ({pol[1]['path']}), the table == a fresh "
        f"solve's")
    log(f"[17a] failures: {fl['failed']} failed handler calls, "
        f"{fl['syncs']} full resyncs after them, the trace completed once "
        f"after {fl['fib']} ms, converged; Fib over [17a] {out['fib']} "
        f"(largest batch {out['batch_max']}); N's floods to its neighbours "
        f"other than F's session, encoded and counted, and full-sync "
        f"answers handed on: {out['copies']}; "
        f"{solves['solves']} solver calls, every one on the card: "
        f"{solves['refused']} warm calls refused, each followed by a full "
        f"solve (by reason {solves['why']}), {solves['reused']} warm "
        f"calls reused the cached solve with no edge metric changed "
        f"(edge pairs in each {solves['reused_pairs']}); "
        f"{out['samples']} log samples in Monitor")
    if bad:
        fail("[17a] " + "; ".join(bad))
    return dict(step_p50=p50(ms), step_fib_p50=p50(fib), live_p50=p50(lat),
                live_p99=p99(lat), own_p50=p50(own_fib),
                adjacencies=out["adjacencies"])


def phase17b_config2(ls2, ps2, mods, want=None,
                     k: int = CONFIG2["k"]) -> dict:
    """[17b] (see the module docstring): node N at config 2's
    aggregation switch node-2025."""
    from openr_tpu_torch.common.constants import DEFAULT_AREA, prefix_key
    from openr_tpu_torch.monitor import perf
    from openr_tpu_torch.types import PrefixDatabase
    from openr_tpu_torch.types.kvstore import Value
    from openr_tpu_torch.types.serde import to_wire

    half = k // 2
    me = f"node-{half * half}"
    t0 = time.perf_counter()
    me_db = ls2.adjacency_db(me)
    dbs = [ls2.adjacency_db(nd) for nd in ls2.nodes if nd != me]
    items = prefix_items(ps2)
    own_items = [e for nd, e in items if nd == me]
    loopback = next(e.prefix for e in own_items
                    if e.prefix.prefix.startswith("10."))
    f_pubs = [adj_publication(dbs, 1),
              prefix_publication([ne for ne in items if ne[0] != me], 1)]
    ramp = [(p, next(iter(per.items()))) for p, per in ps2.prefixes.items()
            if p.prefix.startswith("16.") and len(per) == 1
            and me not in per][:NODE_RAMP]
    enc_s = time.perf_counter() - t0
    gen = NodeLsdb(ls2, ps2, me, {})
    out = {}

    def ramp_pub(version: int, delete: bool, traced: bool):
        """The ramp /32s as their originators write them on F: their
        databases at `version`, tombstones with `delete`."""
        for i, (p, (nd, e)) in enumerate(ramp):
            pe = (perf.PerfEvents.start(perf.ADJ_DB_UPDATED, node=KV_FABRIC)
                  if traced and i == 0 else None)
            yield (prefix_key(nd, DEFAULT_AREA, p.prefix), Value(
                version=version, originator_id=nd, value=to_wire(
                    PrefixDatabase(this_node_name=nd, prefix_entries=(e,),
                                   delete_prefix=delete))).with_hash(), pe)

    async def body():
        t, f = fabric_for(me_db)
        t1 = time.perf_counter()
        for pub in f_pubs:
            set_on(f, pub)
        out["load_ms"] = (time.perf_counter() - t1) * 1e3
        node, speakers = node_n(me, me_db, t, loopback,
                                [e for e in own_items if e.prefix != loopback])
        spy = SolverSpy(node.decision.solver)
        d = node.decision
        await f.start()
        reset_path_launches(*mods)
        with GcClock() as g:
            out["up"] = await node_up(node, speakers, f, "17b start-up")
        out["gc_ms"] = g.ms
        out["launches"] = path_launches(*mods)
        out["sync"] = sync_row(node)
        stores_hold(f, node.kvstore, f_pubs, "17b start-up's full sync",
                    phase="17b")
        gen.set_own(node)
        t2 = time.perf_counter()
        ref = gen.rib()
        out["ref_ms"] = (time.perf_counter() - t2) * 1e3
        out["table"] = table_is(node, ref, "17b start-up vs a separate card "
                                "solve")
        if want is not None:
            uni, _m = node_table(node)
            if uni != {p: e.to_unicast_route()
                       for p, e in want.unicast_routes.items()}:
                fail("[17b] the handler's unicast table differs from [9]'s "
                     "RIB converted")
        # the ramp's windows start just after a periodic full resync of
        # Fib's (every sync_interval_s, 60 s), so that none falls in them
        syncs0, t3 = node.fib_handler.sync_count, time.perf_counter()
        while node.fib_handler.sync_count == syncs0:
            if time.perf_counter() - t3 > 90:
                fail("[17b] no periodic full resync of Fib's in 90 s")
            await asyncio.sleep(0.05)
        out["resync_wait_ms"] = (time.perf_counter() - t3) * 1e3
        await node_quiet(node, f, "17b the resync")
        node_traces(node)
        start_u, start_m = node_table(node)
        rows = {}
        for step, version, delete in (("withdraw", 2, True),
                                      ("re-add", 3, False)):
            runs0, calls0 = d._spf_runs, len(node.fib_handler.calls)
            for key, val, pe in ramp_pub(version, delete, True):
                f.set_key(DEFAULT_AREA, key, val, perf_events=pe)
            await node_quiet(node, f, f"17b {step}", traces=1)
            uni, mpls = node_table(node)
            gone = {p for p, _x in ramp}
            want_u = ({p: r for p, r in start_u.items() if p not in gone}
                      if delete else start_u)
            if uni != want_u or mpls != start_m:
                fail(f"[17b] {step}: the table is not the start-up table "
                     f"{'less' if delete else 'with'} the {len(ramp)} ramp "
                     "/32s")
            tr = [ev for ev in node_traces(node)
                  if ev[0][:2] == (perf.ADJ_DB_UPDATED, KV_FABRIC)]
            rows[step] = dict(
                ms=d._last_spf_ms, path=d._rebuild_path,
                runs=d._spf_runs - runs0,
                calls=[c[:2] for c in node.fib_handler.calls[calls0:]],
                fib=trace_ms(tr[0], perf.FIB_PROGRAMMED) if tr else None,
                sent=trace_ms(tr[0], perf.ROUTE_UPDATE_SENT) if tr else None)
        out["ramp"] = rows
        out["calls"] = spy.calls
        out["copies"] = (t.copies, t.reused)
        out["failed"] = int(node.counters.get(f"{d.name}.task_exceptions"))
        await stop_node(node, speakers)
        await f.stop()

    try:
        asyncio.run(body())
    finally:
        gen.restore()
    la = out["launches"]
    if not (la["relax"]["generic"] and la["election"] and la["rib_epilogue"]):
        fail(f"[17b] the start-up's kernel launches {la}")
    solves = calls_on_card(out["calls"], "17b")
    if out["failed"]:
        fail(f"[17b] {out['failed']} rebuilds raised")
    for step, r in out["ramp"].items():
        kind = ("delete_unicast_routes" if step == "withdraw"
                else "add_unicast_routes")
        if r["path"] != "prefix_only" or r["runs"] != 1 or r["fib"] is None \
                or r["calls"] != [(kind, len(ramp))]:
            fail(f"[17b] {step}: {r}")
    up, sy = out["up"], out["sync"]
    c = up["cold"]
    log(f"[17b] node N (the port's OpenrNode) at config 2's node-2025 "
        f"({len(me_db.adjacencies)} neighbours, Spark speakers on one "
        f"MockIoHub, the links' metrics set by LinkMonitor's override): F "
        f"loaded with {up['keys']} keys in "
        f"{out['load_ms']:.1f} ms, pushed to N in {up['push_ms']:.1f} ms; "
        f"from N's interfaces coming up every neighbour found "
        f"{up['discovered_ms']:.1f} ms, KVSTORE_SYNCED "
        f"{up['kvstore_synced_ms']:.1f} ms, RIB_COMPUTED "
        f"{up['rib_computed_ms']:.1f} ms, FIB_SYNCED "
        f"{up['fib_synced_ms']:.1f} ms ({out['gc_ms']:.1f} ms in the "
        f"collector), quiet after {up['quiet_ms']:.1f} ms; the first "
        f"rebuild {c['ms']:.3f} ms ({c['path']}; {up['rebuilds']} rebuilds "
        f"by the quiet), split "
        f"(ms) { {k2: round(v, 3) for k2, v in c['split'].items()} }; "
        f"launches {la}; FULL_SYNC {sy['unicast']} unicast + {sy['mpls']} "
        f"mpls routes, the handler's sync calls {sy['handler_ms']} ms, "
        f"Fib's pass {sy['pass_ms']} ms; F's and N's stores hold the "
        f"generator's Values of F's {sum(len(p.key_vals) for p in f_pubs)} "
        f"keys; table == a separate card solve's "
        f"converted RIB ({out['ref_ms']:.1f} ms)"
        + (" and the unicast table == [9]'s" if want is not None else "")
        + f"; publications encoded in {enc_s:.1f} s; card "
        f"{smi('name,power.limit')}")
    for step, r in out["ramp"].items():
        log(f"[17b] {len(ramp)} ramp /32s {step} on F: rebuild "
            f"{r['ms']:.3f} ms ({r['path']}), handler calls {r['calls']} "
            f"(the windows opened after a periodic full resync of Fib's, "
            f"awaited {out['resync_wait_ms']:.1f} ms), "
            f"flap -> ROUTE_UPDATE_SENT {r['sent']:.3f} ms, -> "
            f"FIB_PROGRAMMED {r['fib']:.3f} ms")
    log(f"[17b] {solves['solves']} solver calls, every one on the card "
        f"({solves['refused']} refused warm calls, {solves['reused']} "
        f"reused); N's floods to its "
        f"neighbours other than F's session, encoded and counted, and "
        f"full-sync answers handed on: {out['copies']}")
    return out


def compute_apps() -> list:
    """The (pid, used memory) rows `nvidia-smi --query-compute-apps`
    lists: one a context on the card. In a sandbox of its own the pids
    may be masked (all 1); the rows still count the contexts."""
    res = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return [tuple(x.strip() for x in line.split(",", 1))
            for line in res.stdout.strip().splitlines() if "," in line]


def holds_context(pid: int, before: list, during: list) -> bool:
    """`pid` holds a context on the card: listed by its pid where the
    list names this process by its own, else one more context than
    before it started."""
    pids = {int(p) for p, _m in during if p.isdigit()}
    if os.getpid() in pids:
        return pid in pids
    return len(during) == len(before) + 1


def adjacency_shape(adjs) -> tuple:
    """What Spark and LinkMonitor decide of N's adjacencies: each
    neighbour with its two interfaces, its overload and weight, and the
    set of adjacency labels (given in the order the neighbours came up)."""
    return (sorted((a.other_node_name, a.if_name, a.other_if_name,
                    a.is_overloaded, a.weight) for a in adjs),
            sorted(a.adj_label for a in adjs))


#: the metric [17c] sets on the daemon's interfaces over ctrl: config 5's
NODE_METRIC = 10


async def ctrl_lsdb(call):
    """The LSDB a node reports over ctrl: its Decision's adjacency DBs and
    its store's prefix DBs, as the port's LinkState and PrefixState."""
    from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
    from openr_tpu_torch.kvstore.kvstore import value_from_json
    from openr_tpu_torch.types import AdjacencyDatabase, PrefixDatabase
    from openr_tpu_torch.types.serde import from_jsonable, from_wire_auto

    adj = await call("get_decision_adjacency_dbs")
    kv = await call("dump_kvstore", {"prefix": "prefix:"})
    ls, ps = LinkState(), PrefixState()
    for dbs in adj.values():
        for db in dbs:
            ls.update_adjacency_db(from_jsonable(db, AdjacencyDatabase))
    for raw in kv["key_vals"].values():
        ps.update_prefix_db(from_wire_auto(value_from_json(raw).value,
                                           PrefixDatabase))
    return ls, ps


def json_tables(rdb) -> tuple[dict, dict]:
    """A RouteDatabase as ctrl encodes a programmed table: unicast routes
    by destination and MPLS routes by label."""
    from openr_tpu_torch.ctrl.server import _mpls_json, _unicast_json

    return ({str(p): _unicast_json(e.to_unicast_route())
             for p, e in rdb.unicast_routes.items()},
            {e.label: _mpls_json(e.to_mpls_route())
             for e in rdb.mpls_routes.values()})


async def daemon_over_ctrl(port: int, me: str, me_db, rc, log_tail) -> dict:
    """[17c]'s ctrl half (see the module docstring); `rc()` is the
    daemon's exit code or None while it runs."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.rpc import RpcClient

    cli = RpcClient("127.0.0.1", port)
    await cli.connect()
    walls: dict = {}

    async def call(method, params=None):
        t0 = time.perf_counter()
        r = await cli.call(method, params or {}, timeout=120.0)
        walls.setdefault(method, []).append((time.perf_counter() - t0) * 1e3)
        return r

    solver = TorchSpfSolver(device=DEVICE)
    out: dict = {}
    try:
        st = await call("get_initialization_status")
        if not st["INITIALIZED"]:
            fail(f"[17c] over ctrl, the daemon is not INITIALIZED: {st}")
        ifaces = await call("get_interfaces")
        names = sorted(i["name"] for i in ifaces["interfaces"])
        if names != sorted(a.if_name for a in me_db.adjacencies):
            fail(f"[17c] the daemon's interfaces over ctrl {names}")
        t_metric = time.perf_counter()
        for ifn in names:
            await call("set_interface_metric",
                       {"interface": ifn, "metric": NODE_METRIC})
        polls = 0
        while True:
            if rc() is not None:
                fail(f"[17c] the daemon exited {rc()} after the metric "
                     f"change; its log ends: {log_tail()}")
            polls += 1
            ls, ps = await ctrl_lsdb(call)
            mine = ls.adjacency_db(me)
            if mine is not None and len(mine.adjacencies) == len(
                    me_db.adjacencies) and all(
                    a.metric == NODE_METRIC for a in mine.adjacencies):
                got = await call("get_route_db_programmed")
                got_u = {r["dest"]: r for r in got["unicast_routes"]}
                got_m = {r["top_label"]: r for r in got["mpls_routes"]}
                t0 = time.perf_counter()
                want_u, want_m = json_tables(
                    solver.compute_routes(ls, ps, me))
                out.setdefault("solve_ms", []).append(
                    (time.perf_counter() - t0) * 1e3)
                if got_u == want_u and got_m == want_m:
                    break
            if time.perf_counter() - t_metric > 180:
                fail(f"[17c] 180 s after the metric change the daemon's "
                     f"table over ctrl does not equal a fresh card solve of "
                     f"the LSDB it reports ({polls} reads)")
            await asyncio.sleep(0.1)
        out["metric_ms"] = (time.perf_counter() - t_metric) * 1e3
        out["polls"] = polls
        out["routes"] = (len(got_u), len(got_m))
        out["adjacencies"] = mine.adjacencies
        orc = await call("check_fib_oracle")
        if not orc["pass"] or orc["oracle_unicast"] != \
                orc["programmed_unicast"]:
            fail(f"[17c] check_fib_oracle: {orc}")
        out["oracle"] = orc
        tel = await call("get_device_telemetry")
        rows = [r for r in tel["kernels"] if r["launches"] > 0]
        if not rows:
            fail(f"[17c] get_device_telemetry lists no kernel row with a "
                 f"launch: {tel['kernels']}")
        out["telemetry"] = {r["fn"]: (r["launches"], r["sources"])
                            for r in rows}
        val = await call("validate")
        if not val["pass"]:
            fail(f"[17c] validate: {val}")
        out["checks"] = [c["name"] for c in val["checks"]]
    finally:
        await cli.close()
    out["walls_ms"] = {k: round(statistics.median(v), 3)
                       for k, v in walls.items()}
    out["calls"] = {k: len(v) for k, v in walls.items()}
    return out


def phase17c_daemon(adj, pfx, me: str, want_adjs) -> dict:
    """[17c] (see the module docstring): `python -m openr_tpu_torch` as
    node-0 of config 5, its neighbours' Sparks on UDP in this process and
    the fabric's store F behind an `RpcServer`."""
    import dataclasses
    import signal

    from openr_tpu_torch.common.constants import (DEFAULT_AREA, adj_key,
                                                  prefix_key)
    from openr_tpu_torch.config import Config, UdpInterfaceConfig
    from openr_tpu_torch.kvstore import KvStore, TcpKvTransport
    from openr_tpu_torch.kvstore.kvstore import PeerSpec
    from openr_tpu_torch.messaging import ReplicateQueue
    from openr_tpu_torch.monitor import Counters
    from openr_tpu_torch.rpc import RpcClient, RpcServer
    from openr_tpu_torch.spark import UdpIoProvider
    from openr_tpu_torch.types import AdjacencyDatabase, PrefixDatabase
    from openr_tpu_torch.types.kvstore import Value
    from openr_tpu_torch.types.serde import from_wire, to_wire

    me_db = next(db for db in adj if db.this_node_name == me)
    others = [db for db in adj if db.this_node_name != me]
    loopback = next(db for db in pfx if db.this_node_name == me)\
        .prefix_entries[0].prefix
    run_dir = Path(tempfile.mkdtemp(prefix="daemon_"))
    ready_path = run_dir / "ready.json"
    n_adj = len(me_db.adjacencies)

    def log_tail() -> str:
        path = run_dir / "daemon.log"
        return path.read_text()[-2000:] if path.exists() else ""
    out = {}

    async def wait_for(cond, tag: str, timeout: float = 300.0) -> float:
        t0 = time.perf_counter()
        while not cond():
            if proc.returncode is not None:
                fail(f"[17c] the daemon exited {proc.returncode} while "
                     f"waiting for {tag}; its log ends: {log_tail()}")
            if time.perf_counter() - t0 > timeout:
                fail(f"[17c] {tag}: not within {timeout} s; the daemon's "
                     f"log ends: {log_tail()}")
            await asyncio.sleep(0.01)
        return (time.perf_counter() - t_launch) * 1e3

    async def n_holds(kv_port: int, key: str, version: int) -> bool:
        """N's store holds `key` at `version`, read by a full sync with an
        empty digest against N's listener."""
        c = RpcClient("127.0.0.1", kv_port)
        await c.connect()
        try:
            r = await c.call("kv.fullSync", {"area": DEFAULT_AREA,
                                             "sender": KV_FABRIC,
                                             "digest": {}}, timeout=60.0)
        finally:
            await c.close()
        v = (r.get("key_vals") or {}).get(key)
        return v is not None and v.get("version") == version

    async def body():
        nonlocal proc, t_launch
        f = KvStore(Config.default(KV_FABRIC), TcpKvTransport(),
                    ReplicateQueue(name="f"), counters=Counters())
        for pub in (adj_publication(others, 1), prefix_publication(
                [(db.this_node_name, e) for db in pfx
                 if db.this_node_name != me for e in db.prefix_entries], 1)):
            set_on(f, pub)
        server = RpcServer(f"{KV_FABRIC}.kv")
        f.register_rpc(server)
        f_port = await server.start("127.0.0.1", 0)
        await f.start()
        ios: dict = {}

        def io_for(name):
            ios[name] = UdpIoProvider()
            return ios[name]

        speakers = speakers_for(me_db, io_for, kvstore_port=f_port)
        spk_port = {}
        for (_sp, ifn), a in zip(speakers, me_db.adjacencies):
            spk_port[a.if_name] = await ios[a.other_node_name].add_interface(
                ifn, 0)
        cfg = node_config(me, me_db, loopback)
        cfg = Config(dataclasses.replace(
            cfg.node, kvstore_port=0, ctrl_port=0,
            udp_interfaces=tuple(UdpInterfaceConfig(
                a.if_name, 0, "127.0.0.1", spk_port[a.if_name])
                for a in me_db.adjacencies)))
        (run_dir / "n.json").write_text(cfg.to_json())
        out["apps_before"] = compute_apps()
        started = []
        try:
            with open(run_dir / "daemon.log", "wb") as lf:
                t_launch = time.perf_counter()
                proc = await asyncio.create_subprocess_exec(
                    sys.executable, "-m", "openr_tpu_torch", "--config",
                    str(run_dir / "n.json"), "--ready-file", str(ready_path),
                    "--log-level", "WARNING", "--device", DEVICE,
                    cwd=str(Path(__file__).resolve().parent),
                    stdout=lf, stderr=lf)
            out["ready_ms"] = await wait_for(ready_path.exists,
                                             "OPENR_READY", 300.0)
            ready = json.loads(ready_path.read_text())
            if "error" in ready or ready["pid"] != proc.pid \
                    or not isinstance(ready["ctrl_port"], int) \
                    or ready["ctrl_port"] <= 0 \
                    or set(ready["udp_ports"]) != set(spk_port):
                fail(f"[17c] the ready file {ready}")
            out["ready"] = ready
            for (sp, ifn), a in zip(speakers, me_db.adjacencies):
                ios[a.other_node_name].set_peer(
                    ifn, ("127.0.0.1", ready["udp_ports"][a.if_name]))
                await sp.start()
                started.append(sp)
                sp.add_interface(ifn)
            f.add_peer_sync(PeerSpec(node_name=me, endpoint=(
                "127.0.0.1", ready["kvstore_port"])))

            def n_adj_db():
                v = f.get_key(DEFAULT_AREA, adj_key(me))
                return None if v is None else from_wire(v.value,
                                                        AdjacencyDatabase)

            out["adj_ms"] = await wait_for(
                lambda: (db := n_adj_db()) is not None
                and len(db.adjacencies) == n_adj, f"adj:{me} in F")
            out["adjacencies"] = n_adj_db().adjacencies
            agg_key = prefix_key(me, DEFAULT_AREA, NODE_AGGREGATE)

            def agg_in_f():
                v = f.get_key(DEFAULT_AREA, agg_key)
                return v is not None and not from_wire(
                    v.value, PrefixDatabase).delete_prefix

            out["agg_ms"] = await wait_for(agg_in_f, "the aggregate in F")
            out["ctrl"] = await daemon_over_ctrl(
                ready["ctrl_port"], me, me_db, lambda: proc.returncode,
                log_tail)
            loop = asyncio.get_running_loop()
            out["apps"] = [await loop.run_in_executor(None, compute_apps)]
            # one flap set on F, flooded to N over F's session to N's
            # listener
            db = others[0]
            flapped = dataclasses.replace(db, adjacencies=(dataclasses.replace(
                db.adjacencies[0], metric=db.adjacencies[0].metric + 7),
                *db.adjacencies[1:]))
            t_flap = time.perf_counter()
            f.set_key(DEFAULT_AREA, adj_key(db.this_node_name), Value(
                version=2, originator_id=db.this_node_name,
                value=to_wire(flapped)).with_hash())
            while not await n_holds(ready["kvstore_port"],
                                    adj_key(db.this_node_name), 2):
                if time.perf_counter() - t_flap > 120:
                    fail("[17c] the flap set on F did not reach N")
                await asyncio.sleep(0.05)
            out["flap_ms"] = (time.perf_counter() - t_flap) * 1e3
            out["f_peers"] = sorted(n for _a, n in f.peers)
            # two more samples of the card's contexts, the last 0.5 s
            # later, so that another process's context appearing at one
            # moment does not pass for the daemon's
            out["apps"].append(await loop.run_in_executor(None, compute_apps))
            await asyncio.sleep(0.5)
            out["apps"].append(await loop.run_in_executor(None, compute_apps))
            proc.send_signal(signal.SIGTERM)
            t_term = time.perf_counter()
            try:
                out["rc"] = await asyncio.wait_for(proc.wait(), 120)
            except asyncio.TimeoutError:
                fail("[17c] the daemon did not exit within 120 s of SIGTERM")
            out["term_ms"] = (time.perf_counter() - t_term) * 1e3
            out["apps_after"] = compute_apps()
        finally:
            if proc is not None and proc.returncode is None:
                proc.kill()
                await proc.wait()
            for sp in started:
                await sp.stop()
            for io in ios.values():
                io.close()
            await f.stop()
            await server.stop()

    proc, t_launch = None, 0.0
    asyncio.run(body())
    shutil.rmtree(run_dir, ignore_errors=True)
    got, want = adjacency_shape(out["adjacencies"]), adjacency_shape(want_adjs)
    ctl = out["ctrl"]
    metrics = sorted({a.metric for a in ctl["adjacencies"]})
    got_c = sorted((a.other_node_name, a.if_name, a.metric)
                   for a in ctl["adjacencies"])
    want_c = sorted((a.other_node_name, a.if_name, a.metric)
                    for a in want_adjs)
    pid = out["ready"]["pid"]
    seen = all(holds_context(pid, out["apps_before"], apps)
               for apps in out["apps"])
    bad = []
    if got != want:
        bad.append(f"N's adjacencies {got} differ from [17a]'s {want}")
    if got_c != want_c or adjacency_shape(ctl["adjacencies"]) != want:
        bad.append(f"N's adjacencies over ctrl {got_c} differ from "
                   f"[17a]'s {want_c}")
    if DEVICE == "cuda" and not seen:
        bad.append(f"the daemon (pid {pid}) holds no context on the card "
                   f"in every sample ({out['apps']})")
    if out["rc"] != 0:
        bad.append(f"SIGTERM: exit {out['rc']}")
    log(f"[17c] python -m openr_tpu_torch as {me} of config 5, "
        f"{n_adj} udp_interfaces on port 0, its neighbours {n_adj} Spark "
        f"speakers on UdpIoProvider in this process advertising F's "
        f"listener: from the launch OPENR_READY {out['ready_ms']:.1f} ms, "
        f"adj:{me} in F over TCP {out['adj_ms']:.1f} ms, the aggregate "
        f"{NODE_AGGREGATE} (originated after Fib programmed "
        f"{NODE_AGG_SUPPORT} supporting routes the Decision solved on the "
        f"card) in F {out['agg_ms']:.1f} ms; the daemon's pid {pid} "
        f"{'holds' if seen else 'does not hold'} a context on the card "
        f"(nvidia-smi compute apps (pid, memory) before the launch "
        f"{out['apps_before']}, with the daemon up (3 samples, after the "
        f"aggregate, after the flap and 0.5 s later) {out['apps']}, after "
        f"its exit {out['apps_after']}); its {n_adj} adjacencies in F "
        f"== [17a]'s (neighbours, interfaces, labels). Over ctrl (port "
        f"{out['ready']['ctrl_port']}): INITIALIZED; set_interface_metric "
        f"{NODE_METRIC} on its {n_adj} interfaces, then its table "
        f"({ctl['routes'][0]} unicast + {ctl['routes'][1]} mpls routes) "
        f"equal to a fresh card solve of the LSDB it reports "
        f"{ctl['metric_ms']:.1f} ms after the change ({ctl['polls']} reads; "
        f"the fresh solves {[round(x, 1) for x in ctl['solve_ms']]} ms); "
        f"its adjacencies over ctrl == [17a]'s with metric {metrics}; "
        f"check_fib_oracle {ctl['oracle']['oracle_unicast']} oracle == "
        f"{ctl['oracle']['programmed_unicast']} programmed; device "
        f"telemetry rows with launches {ctl['telemetry']}; validate pass "
        f"({len(ctl['checks'])} checks); each call's median wall (ms) "
        f"{ctl['walls_ms']} over {ctl['calls']} calls. One flap set on F "
        f"reached N's store over "
        f"F's session to N's listener in {out['flap_ms']:.1f} ms (F's "
        f"peers {out['f_peers']}); SIGTERM: exit {out['rc']} in "
        f"{out['term_ms']:.1f} ms; card {smi('name,power.limit')}")
    if bad:
        fail("[17c] " + "; ".join(bad))
    return dict(ready_ms=out["ready_ms"], adj_ms=out["adj_ms"],
                agg_ms=out["agg_ms"], flap_ms=out["flap_ms"],
                metric_ms=ctl["metric_ms"], walls_ms=ctl["walls_ms"])


def phase17(p9=None, k2: int = CONFIG2["k"],
            n_ramp: int = CONFIG2["n_ramp"]) -> dict:
    """[17]: node N's route pipeline on the card, config 5 and config 2
    ([9]'s states and RIB where given, else `config2_states(k2,
    n_ramp)`)."""
    from openr_tpu_torch.ops import election as election_ops
    from openr_tpu_torch.ops import relax, rib_epilogue, split_loop
    from openr_tpu_torch.utils.topogen import fat_tree

    mods = (relax, split_loop, rib_epilogue, election_ops)
    t0 = time.perf_counter()
    adj, pfx = fat_tree(CONFIG5["k"], metric=10)
    a = phase17a_config5(adj, pfx, adj[0].this_node_name, mods)
    c = phase17c_daemon(adj, pfx, adj[0].this_node_name, a.pop("adjacencies"))
    if p9 is None:
        ls2, ps2 = config2_states(k2, n_ramp)
        want = None
    else:
        ls2, ps2 = p9["states"]
        want = p9["ribs"].get(f"node-{(k2 // 2) ** 2}")
    b = phase17b_config2(ls2, ps2, mods, want, k2)
    log(f"[17] done in {time.perf_counter() - t0:.1f} s")
    return dict(config5=a, config2=b, daemon=c)


# ----------------------------------------------------------- phase 18

#: [18]: BASELINE config 1 (`BASELINE.md`: a ~100-node 3-tier fat tree,
#: single-area SPF, RIB diff against the oracle 0) as fat_tree(6): 45
#: nodes, 108 links. One process and one event loop carry every node's
#: Spark, KvStore and Decision. At fat_tree(10) (125 nodes, 500 links)
#: that loop saturates with the emulator's scaled Spark timers, in the
#: JAX package's emulator on its host oracle as in the port's: the loop
#: runs seconds late, hold timers expire and adjacencies flap for as
#: long as the run lasts (`tools/emulator_scale.py`). fat_tree(8) (80
#: nodes) converges on a fast host in 57-76 s and on a slower one not in
#: 180 s, the same way; fat_tree(6) is the largest k-ary fat tree that
#: converges within the emulator CLI's own timeout on either. A cluster
#: of processes is the path to 125 nodes
CONFIG1_K = 6
#: the seeded storm [18] runs after the cold start
CONFIG1_STORM = dict(seed=22, duration_s=3.0, n_flaps=8, n_crashes=2,
                     n_partitions=1, graceful_crashes=None)


class CaptureClock:
    """Times every `SplitProgram._capture` while open: each capture's
    wall and thread, and the most that overlapped."""

    def __init__(self):
        import threading

        from openr_tpu_torch.ops.spf_split import SplitProgram

        self.rows: list = []
        self.live = self.peak = 0
        self._lock = threading.Lock()
        self._cls = SplitProgram
        self._inner = SplitProgram._capture
        clock = self

        def timed(prog):
            with clock._lock:
                clock.live += 1
                clock.peak = max(clock.peak, clock.live)
            t0 = time.perf_counter()
            try:
                return clock._inner(prog)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                with clock._lock:
                    clock.live -= 1
                    clock.rows.append(ms)

        SplitProgram._capture = timed

    def close(self) -> dict:
        self._cls._capture = self._inner
        xs = sorted(self.rows)
        return dict(n=len(xs), peak_overlap=self.peak,
                    p50_ms=round(p50(xs), 2) if xs else None,
                    max_ms=round(xs[-1], 2) if xs else None,
                    total_s=round(sum(xs) / 1e3, 2))


def rebuild_summary(rebuilds: list, nodes) -> dict:
    """Every node's rebuilds so far: count and wall per node, and the
    slowest rebuild's split."""
    per: dict = {}
    for name, ms, path, _n in rebuilds:
        per.setdefault(name, []).append(ms)
    walls = sorted(ms for _n, ms, _p, _r in rebuilds)
    slow = max(nodes, key=lambda n: nodes[n].decision._last_spf_ms)
    return dict(rebuilds=len(rebuilds),
                per_node_p50=p50([len(v) for v in per.values()]) if per
                else 0, wall_p50_ms=round(p50(walls), 1) if walls else None,
                wall_max_ms=round(walls[-1], 1) if walls else None,
                slowest=(slow, {k: round(v, 1) for k, v in
                                nodes[slow].decision.last_breakdown_ms.items()}))


class CardSpy:
    """Wraps one node's solver: each solve and warm call records the
    worker thread's current CUDA device, whether it solved (a node not
    yet in its own LSDB has nothing to solve), its wall, and the solver's
    own stats of that call (its host syncs; per solver, so another node's
    concurrent rebuild cannot move them) and how long it waited for the
    card's lock."""

    def __init__(self, node, calls: list):
        solver = node.decision.solver

        def wrap(name):
            inner = getattr(solver, name)

            def wrapped(*a, **kw):
                n0, w0 = solver.solve_count, solver.warm_solves
                st0 = (solver.last_warm_stats, solver.last_solve_stats)
                t0 = time.perf_counter()
                out = inner(*a, **kw)
                ms = (time.perf_counter() - t0) * 1e3
                solved = (solver.warm_solves > w0
                          if name == "warm_compute_routes"
                          else solver.solve_count > n0)
                st = (solver.last_warm_stats if name == "warm_compute_routes"
                      else solver.last_solve_stats)
                calls.append(dict(
                    node=node.name, name=name,
                    device=(torch.cuda.current_device()
                            if solver.device.type == "cuda" else None),
                    want=solver.device.index, refused=out is None,
                    solved=solved, ms=ms,
                    syncs=(int(st.get("host_syncs", 0)) if solved and all(
                        st is not x for x in st0) else 0),
                    wait_ms=solver.last_card_wait_ms))
                return out

            setattr(solver, name, wrapped)

        for name in ("compute_routes", "warm_compute_routes"):
            wrap(name)


def rebuild_recorder(node, rows: list) -> None:
    """Records every completed rebuild of `node`'s Decision: its wall
    (the Decision's `_last_spf_ms`, decode to diff), its path and its
    unicast route count."""
    d = node.decision
    inner = d.debounce.fn

    async def recorded():
        runs = d._spf_runs
        await inner()
        if d._spf_runs > runs:
            rows.append((node.name, d._last_spf_ms, d._rebuild_path,
                         len(d.rib.unicast_routes)))

    d.debounce.fn = recorded


def check_card_calls(calls: list, nodes: dict) -> dict:
    """[18]: every node's Decision is on the card backend, and every
    solver call ran with its card current; every call that solved read
    its result back (host syncs). Returns the counts."""
    bad = [n for n, node in nodes.items()
           if node.decision.backend != "card"
           or node.decision.solver is None
           or node.decision.solver.device.type != torch.device(DEVICE).type]
    if bad:
        fail(f"[18] nodes off the card backend: {bad[:5]}")
    off = [c for c in calls if DEVICE == "cuda" and c["device"] != c["want"]]
    unread = [c for c in calls if c["solved"] and not c["syncs"]]
    if off or unread or not calls:
        fail(f"[18] solver calls off the card {off[:3]}, full solves that "
             f"read nothing {unread[:3]} ({len(calls)} calls)")
    return dict(calls=len(calls),
                full=sum(c["name"] == "compute_routes" and c["solved"]
                         for c in calls),
                unsolved=sum(c["name"] == "compute_routes"
                             and not c["solved"] for c in calls),
                warm=sum(c["name"] == "warm_compute_routes"
                         and not c["refused"] for c in calls),
                refused=sum(c["refused"] for c in calls))


def tables_fresh(cluster, names, tag: str) -> dict:
    """Each named node's programmed table equals a fresh card solve of its
    own LinkState and PrefixState."""
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    solver = TorchSpfSolver(device=DEVICE)
    out = {}
    for name in names:
        node = cluster.nodes[name]
        dec = node.decision
        area = next(iter(dec.link_states))
        rdb = solver.compute_routes(dec.link_states[area].snapshot(),
                                    dec.prefix_states[area].snapshot(), name)
        uni, mpls = node_table(node)
        want_u = {p: e.to_unicast_route()
                  for p, e in rdb.unicast_routes.items()}
        want_m = {lb: e.to_mpls_route() for lb, e in rdb.mpls_routes.items()}
        if uni != want_u or mpls != want_m:
            diff = [str(p) for p in want_u.keys() | uni.keys()
                    if want_u.get(p) != uni.get(p)]
            fail(f"[18] {tag}: {name}'s table differs from a fresh card "
                 f"solve of its LinkState: {len(diff)} unicast, e.g. "
                 f"{diff[:3]}")
        out[name] = (len(uni), len(mpls))
    return out


def phase18(k: int = CONFIG1_K) -> dict:
    """[18] (see the module docstring)."""
    from openr_tpu_torch.emulator import (ChaosPlan, Cluster, check_cluster,
                                          run_schedule, scaled_spark,
                                          wait_quiescent)
    from openr_tpu_torch.ops import election as election_ops
    from openr_tpu_torch.ops import relax, rib_epilogue, split_loop
    from openr_tpu_torch.utils.topogen import edges_of, fat_tree

    t_phase = time.perf_counter()
    mods = (relax, split_loop, rib_epilogue, election_ops)
    adj, _pfx = fat_tree(k)
    edges = edges_of(adj)
    names = [db.this_node_name for db in adj]
    half = k // 2
    n_core, n_agg = half * half, k * half
    picks = (names[0], names[n_core], names[n_core + n_agg])
    hold_s = scaled_spark(len(names)).hold_time_ms / 1e3
    conv_timeout = max(60.0, 36 * hold_s)  # the emulator CLI's
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    reset_path_launches(*mods)
    calls: list = []
    rebuilds: list = []
    out: dict = {}
    caps = CaptureClock()

    async def body():
        c = Cluster.from_edges(edges, device=None if DEVICE == "cuda"
                               else DEVICE)
        if sorted(c.nodes) != sorted(names) or len(c.links) != len(edges):
            fail(f"[18] the cluster has {len(c.nodes)} nodes and "
                 f"{len(c.links)} links")
        for node in c.nodes.values():
            CardSpy(node, calls)
            rebuild_recorder(node, rebuilds)
        restart = c.restart_node
        restarted = {}

        async def restart_node(name):
            await restart(name)
            node = c.nodes[name]
            restarted[name] = node.decision.solver
            CardSpy(node, calls)
            rebuild_recorder(node, rebuilds)

        c.restart_node = restart_node
        first: dict = {"rib": {}, "fib": {}}
        loop = asyncio.get_running_loop()
        t0 = loop.time()

        async def gates():
            next_log = 5.0
            while True:
                now = loop.time() - t0
                for n, node in list(c.nodes.items()):
                    if node.decision.rib_computed.is_set():
                        first["rib"].setdefault(n, now)
                    if node.fib.synced.is_set():
                        first["fib"].setdefault(n, now)
                if now >= next_log:
                    next_log += 5.0
                    routes = [len(x.fib.programmed_unicast)
                              for x in c.nodes.values()]
                    log(f"[18] +{now:.1f} s: {sum(x.initialized for x in c.nodes.values())}"
                        f" of {len(c.nodes)} nodes initialized, routes "
                        f"min {min(routes)} p50 {p50(sorted(routes)):.0f}, "
                        f"{len(rebuilds)} rebuilds, {len(calls)} solver "
                        f"calls, {len(caps.rows)} captures ({caps.live} "
                        f"running)")
                await asyncio.sleep(0.005)

        solvers0 = {n: node.decision.solver for n, node in c.nodes.items()}
        await c.start()
        watch = asyncio.ensure_future(gates())
        try:
            try:
                await c.wait_converged(timeout=conv_timeout)
            except TimeoutError as e:
                out["failed"] = (f"[18] cold start, {conv_timeout:.0f} s: "
                                 f"{e}; rebuilds {rebuild_summary(rebuilds, c.nodes)}"
                                 f"; captures {caps.close()}")
                return
            out["cold_ms"] = (loop.time() - t0) * 1e3
            out["cold_rebuilds"] = len(rebuilds)
            t1 = loop.time()
            await wait_quiescent(c, timeout_s=conv_timeout,
                                 context="[18] cold start")
            out["quiesce_ms"] = (loop.time() - t1) * 1e3
            t1 = loop.time()
            v = check_cluster(c)
            out["check_ms"] = (loop.time() - t1) * 1e3
            if v:
                fail(f"[18] check_cluster after the cold start: "
                     f"{[str(x) for x in v[:8]]}")
            out["tables"] = tables_fresh(c, picks, "cold start")
            out["spf_runs"] = sorted(
                int(node.counters.get("decision.spf_runs"))
                for node in c.nodes.values())
            out["cold_calls"] = check_card_calls(calls, c.nodes)
            if DEVICE == "cuda":
                out["smi_mib"] = smi("memory.used")
            plan = ChaosPlan(CONFIG1_STORM["seed"])
            events = plan.build_storm(
                edges, names, **{k_: v_ for k_, v_ in CONFIG1_STORM.items()
                                 if k_ != "seed"})
            out["hash"] = plan.schedule_hash()
            out["events"] = [(e.at_s, e.kind, e.target) for e in events]
            n_rb = len(rebuilds)
            t1 = loop.time()
            await run_schedule(c, plan)
            out["storm_ms"] = (loop.time() - t1) * 1e3
            await wait_quiescent(c, timeout_s=max(120.0, conv_timeout),
                                 context=plan.replay_hint())
            out["storm_quiet_ms"] = (loop.time() - t1) * 1e3
            out["storm_rebuilds"] = len(rebuilds) - n_rb
            v = check_cluster(c)
            if v:
                fail(f"[18] check_cluster after the storm "
                     f"({plan.replay_hint()}): {[str(x) for x in v[:8]]}")
            crashed = sorted({e.target[0] for e in events
                              if e.kind == "crash"})
            if sorted(restarted) != crashed:
                fail(f"[18] restarted {sorted(restarted)}, crashed {crashed}")
            for n in crashed:
                s_new = c.nodes[n].decision.solver
                if s_new is solvers0[n] or s_new is not restarted[n] \
                        or s_new.device.type != torch.device(DEVICE).type:
                    fail(f"[18] {n} restarted without a new solver on the "
                         f"card")
            out["crashed"] = crashed
            out["storm_tables"] = tables_fresh(c, picks, "after the storm")
            out["calls"] = check_card_calls(calls, c.nodes)
            out["routes"] = sorted({len(node.fib.programmed_unicast)
                                    for node in c.nodes.values()})
            if out["routes"] != [len(names) - 1]:
                fail(f"[18] programmed route counts {out['routes']}")
        finally:
            watch.cancel()
            await c.stop()
        out["rib_spread"] = first["rib"]
        out["fib_spread"] = first["fib"]

    asyncio.run(body())
    if "failed" in out:
        fail(out["failed"])
    out["captures"] = caps.close()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    launches = path_launches(*mods)
    out["launches"] = launches
    loop_n = dict(launches["split_loop"])
    for kname in ("snap_mark", "compact", "ctl"):
        if not loop_n.get(kname):
            fail(f"[18] the split loop's {kname} kernel was launched no "
                 f"time ({launches})")
    if not launches["rib_epilogue"]:
        fail(f"[18] the epilogue was launched no time ({launches})")
    if not sum(launches["relax"].values()):
        fail(f"[18] no relax kernel was launched ({launches})")
    peak = (torch.cuda.max_memory_allocated() - mem0
            if DEVICE == "cuda" else 0)
    rb_ms = [r[1] for r in rebuilds]
    # config 1's full SPF: the solver's full solves (`compute_routes`
    # calls that solved), host CSR build and route assembly included,
    # less the wait for the card's lock, which is read apart
    full = [c_ for c_ in calls
            if c_["name"] == "compute_routes" and c_["solved"]]
    spf_ms = sorted(c_["ms"] - c_["wait_ms"] for c_ in full)
    wait_ms = sorted(c_["wait_ms"] for c_ in full)
    routes = [r[3] for r in rebuilds]
    p50_ms, p99_ms = p50(spf_ms), p99(spf_ms)

    def spread(d):
        xs = sorted(d.values())
        return (round(xs[0] * 1e3, 1), round(p50(xs) * 1e3, 1),
                round(xs[-1] * 1e3, 1)) if xs else None

    runs = out["spf_runs"]
    paths: dict = {}
    for r in rebuilds:
        paths[r[2]] = paths.get(r[2], 0) + 1
    log(f"[18] BASELINE config 1: fat_tree({k}), {len(names)} port nodes "
        f"({n_core} cores, {n_agg} aggregation, {len(names) - n_core - n_agg}"
        f" ToR), {len(edges)} links, every Decision on the card (hold "
        f"{hold_s:.3f} s, converge timeout {conv_timeout:.0f} s): cold "
        f"convergence {out['cold_ms']:.1f} ms (every node INITIALIZED with "
        f"{len(names) - 1} routes; {out['cold_rebuilds']} rebuilds), "
        f"RIB_COMPUTED min/p50/max {spread(out['rib_spread'])} ms and "
        f"FIB_SYNCED {spread(out['fib_spread'])} ms from the start; "
        f"quiescent {out['quiesce_ms']:.1f} ms later, check_cluster clean "
        f"({out['check_ms']:.1f} ms, {len(names)} FIBs against the oracle); "
        f"tables of {list(picks)} == fresh card solves {out['tables']}; "
        f"rebuilds per node p50 {p50(runs):.0f} max {runs[-1]}; solver "
        f"calls {out['cold_calls']} with the card current; split-program "
        f"captures {out['captures']}")
    log(f"[18] storm ChaosPlan(seed={CONFIG1_STORM['seed']}) "
        f"schedule_hash {out['hash']}: {len(out['events'])} events "
        f"(crashes {out['crashed']}), run {out['storm_ms']:.1f} ms, "
        f"quiescent {out['storm_quiet_ms']:.1f} ms from its start "
        f"({out['storm_rebuilds']} rebuilds), check_cluster clean, the "
        f"restarted nodes on new card solvers, tables {out['storm_tables']} "
        f"== fresh card solves; full SPF ({len(spf_ms)} full solves): "
        f"p50 {p50_ms:.3f} ms p99 {p99_ms:.3f} ms, routes/s "
        f"{statistics.median(routes) / (p50_ms / 1e3):.0f} "
        f"({statistics.median(routes):.0f} routes a RIB over the p50), "
        f"besides the card lock's wait p50 {p50(wait_ms):.3f} ms p99 "
        f"{p99(wait_ms):.3f} ms total {sum(wait_ms) / 1e3:.2f} s; every "
        f"rebuild ({len(rb_ms)}, paths {paths}, decode to diff, the "
        f"worker's queue included) p50 {p50(sorted(rb_ms)):.3f} ms p99 "
        f"{p99(sorted(rb_ms)):.3f} ms; "
        f"solver calls {out['calls']}; launches from 0 around the phase "
        f"{launches}; peak device memory {peak / 2**20:.1f} MiB above the "
        f"phase's start, nvidia-smi used {out.get('smi_mib')} with the "
        f"cluster up; card {smi('name,power.limit')}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, cold_ms=out["cold_ms"],
                p50_ms=p50_ms, p99_ms=p99_ms)


if __name__ == "__main__":
    main()
