"""Multi-node in-process emulator (the port's copy of
`openr_tpu/emulator/`): `Cluster` runs N complete `OpenrNode`s in one
process, Spark over `MockIoHub` links, KvStore peering over
`InProcKvTransport` and routes into per-node `MockFibHandler`s, each
node's Decision solving on the card unless the caller asks for the CPU.
`chaos` makes fault storms seeded and replayable; `invariants` checks a
quiesced cluster, every FIB against the port's host oracle.
`python -m openr_tpu_torch.emulator` runs one from the command line.

Not part of the port yet: the multi-process cluster and the soak
(`procs.py`, `proc_invariants.py`, `soak.py`), and the convergence and
flood-trace reports (`convergence.py`, `tracing.py`).
"""

from openr_tpu_torch.emulator.chaos import (  # noqa: F401
    ChaosEvent,
    ChaosFibHandler,
    ChaosIoHub,
    ChaosKvTransport,
    ChaosPlan,
    FibFaults,
    KvFaults,
    LinkFaults,
    run_schedule,
)
from openr_tpu_torch.emulator.cluster import (  # noqa: F401
    Cluster,
    ClusterNodeSpec,
    LinkSpec,
    scaled_spark,
)
from openr_tpu_torch.emulator.invariants import (  # noqa: F401
    Violation,
    assert_invariants,
    check_cluster,
    dump_flight_recorders,
    wait_quiescent,
)
