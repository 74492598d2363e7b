"""Put the port behind a Decision: `attach(decision, route_types,
network_types)` builds a `TorchSpfSolver` from the Decision's own config
and sets it, wrapped in a `DecisionAdapter`, as the Decision's solver.

    from openr_tpu.types import network, routes
    from openr_tpu_torch.decision import hook

    hook.attach(decision, routes, network)               # on the card
    hook.attach(decision, routes, network, device="cpu")

A Decision branches on its solver attribute (`_tpu`) being set, not on
its class, so a Decision built with the "cpu" backend then rebuilds
through the port.

The port's telemetry reaches the Decision's counters at every rebuild
edge (the end of each `compute_routes`, `warm_compute_routes` and
`assemble_prefix_routes`): the build and transfer ledger (`cuda.builds.*`,
`cuda.transfers.*`), the kernel cost rows (`cuda.kernel.<fn>.*`), the HBM
gauges (`device.<i>.hbm_*`) and the solver's work ledger (`work.*`). The
Decision's own exports run after the adapter's and write the `jax.*`
names; `device.<i>.hbm_*` are the only shared names, and the JAX sampler
writes none without a JAX accelerator. Pass `work_ledger` (the JAX
package's `openr_tpu.monitor.work_ledger` module) to make the solver's
`election` rounds land in the ledger the Decision, ctrl `get_work_ledger`
and the soak invariant read, and `device_telemetry` (its
`openr_tpu.monitor.device` module) to make ctrl `get_device_telemetry`
answer from the port's cost rows and HBM gauges: `attach` points that
module's `kernel_rows`, `sample_hbm` and `telemetry` at the port's
`monitor/device.py` functions of the same names and shapes (the port's
`KernelCostRow` has the reference's field names, so ctrl's join reads
it), and `DecisionAdapter.detach` puts the module's own back. A Decision configured with `mesh_sources >
0` gets a meshed solver, as the reference builds one, over `mesh_devices`
(default: every CUDA device). The hook is duck-typed: the port imports nothing of
the Decision's package, and the caller hands in the modules whose
`RouteDatabase`, `RibEntry`, `RibMplsEntry`, `NexthopGroup`, `NextHop`,
`MplsAction` and `MplsActionType` the Decision compares. Every route the
adapter returns is built from those classes, field by field: the port's
own classes never compare equal to them.
"""

from __future__ import annotations

from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.monitor import device as telemetry


def solver_for(dcfg, device=None, counters=None, mesh_devices=None,
               work_ledger=None) -> TorchSpfSolver:
    """The `TorchSpfSolver` a `DecisionConfig` asks for: the table knobs,
    LFA, KSP paths, `native_rib`, the mesh of `mesh_sources` x
    `mesh_graph` positions over `mesh_devices` (default: every CUDA
    device) when `mesh_sources > 0`, and `counters`. `device=None` is
    the current CUDA card. `work_ledger`, anything with `commit(stage,
    touched, delta)` and `export_to(counters)`, receives the solver's
    work rounds (default: the port's process ledger). `native_rib="on"`
    raises ValueError, and a mesh larger than `mesh_devices`
    ValueError. `attach` and the port's own Decision both build their
    solver here."""
    mesh = None
    if dcfg.mesh_sources > 0:
        from openr_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_sources=dcfg.mesh_sources,
                         n_graph=dcfg.mesh_graph, devices=mesh_devices)
    return TorchSpfSolver(
        device=device,
        use_dense=dcfg.use_dense_kernel,
        use_pallas=dcfg.use_pallas_kernel,
        enable_lfa=dcfg.enable_lfa,
        ksp_k=dcfg.ksp_paths,
        kernel_impl=dcfg.spf_kernel,
        native_rib=dcfg.native_rib,
        mesh=mesh,
        counters=counters,
        work_ledger=work_ledger,
    )


def attach(decision, route_types, network_types, device=None,
           work_ledger=None, device_telemetry=None, mesh_devices=None):
    """Build the solver from `decision.config.node.decision` with
    `solver_for` (and the Decision's counters), set the adapter as
    `decision._tpu` and return it. `device_telemetry`, a module whose
    `kernel_rows`, `sample_hbm` and `telemetry` ctrl reads, gets the
    port's stand-ins until `detach()`."""
    solver = solver_for(decision.config.node.decision, device,
                        decision.counters, mesh_devices, work_ledger)
    adapter = DecisionAdapter(solver, route_types, network_types)
    if device_telemetry is not None:
        adapter.install_telemetry(device_telemetry)
    decision._tpu = adapter
    return adapter


class RouteConverter:
    """The port's routes as objects of the caller's route classes.

    Entries and nexthop tuples are memoised by the identity of the port
    object, and the memo holds that object, so an id is never reused
    while it is a key: an entry the solver's caches hand back again maps
    to the same converted object, and one port `NexthopGroup` to one
    group of the caller's. Past `cap` objects the memo starts afresh.
    Behind the caller's Decision, keys (prefixes) and `best_entry` are
    the caller's own objects already and pass through. Given
    `topology_types` (the module with the caller's `PrefixEntry`,
    `PrefixMetrics`, `ForwardingType` and `ForwardingAlgorithm`), they
    are the port's and are converted too, prefixes by value (the port's
    own Decision: `update` converts its RouteUpdates)."""

    def __init__(self, route_types, network_types, cap: int = 1 << 20,
                 topology_types=None):
        self.routes = route_types
        self.network = network_types
        self.topology = topology_types
        self.cap = cap
        self._memo: dict[int, tuple] = {}
        # MplsAction and IpPrefix by value: the next hops of one label
        # share one action
        self._actions: dict = {}
        self._prefixes: dict = {}

    def __len__(self) -> int:
        return len(self._memo)

    def clear(self) -> None:
        self._memo.clear()
        self._actions.clear()
        self._prefixes.clear()

    def _remember(self, obj, got):
        if len(self._memo) >= self.cap:
            self.clear()
        self._memo[id(obj)] = (obj, got)
        return got

    def prefix(self, p):
        if self.topology is None:
            return p
        got = self._prefixes.get(p.prefix)
        if got is None:
            got = self._prefixes[p.prefix] = self.network.IpPrefix(
                prefix=p.prefix)
        return got

    def prefix_entry(self, e):
        """A route's `best_entry` (a PrefixEntry, or None)."""
        if self.topology is None or e is None:
            return e
        got = self._memo.get(id(e))
        if got is not None:
            return got[1]
        t, m = self.topology, e.metrics
        return self._remember(e, t.PrefixEntry(
            prefix=self.prefix(e.prefix),
            metrics=t.PrefixMetrics(
                path_preference=m.path_preference,
                source_preference=m.source_preference,
                distance=m.distance,
            ),
            forwarding_type=t.ForwardingType(int(e.forwarding_type)),
            forwarding_algorithm=t.ForwardingAlgorithm(
                int(e.forwarding_algorithm)),
            tags=tuple(e.tags),
            area_stack=tuple(e.area_stack),
            weight=e.weight,
            min_nexthop=e.min_nexthop,
        ))

    def action(self, a):
        key = (int(a.action), a.swap_label, tuple(a.push_labels))
        got = self._actions.get(key)
        if got is None:
            n = self.network
            got = self._actions[key] = n.MplsAction(
                action=n.MplsActionType(key[0]), swap_label=key[1],
                push_labels=key[2],
            )
        return got

    def nexthop(self, nh):
        a = nh.mpls_action
        return self.network.NextHop(
            address=nh.address,
            if_name=nh.if_name,
            metric=nh.metric,
            weight=nh.weight,
            mpls_action=None if a is None else self.action(a),
            area=nh.area,
            neighbor_node=nh.neighbor_node,
        )

    def nexthops(self, nhs):
        """A nexthop tuple; an interned group stays a group."""
        got = self._memo.get(id(nhs))
        if got is not None:
            return got[1]
        conv = tuple(self.nexthop(nh) for nh in nhs)
        gid = getattr(nhs, "gid", None)
        if gid is not None:
            conv = self.routes.NexthopGroup(conv, gid=gid)
        return self._remember(nhs, conv)

    def entry(self, e):
        got = self._memo.get(id(e))
        if got is not None:
            return got[1]
        return self._remember(e, self.routes.RibEntry(
            prefix=self.prefix(e.prefix),
            nexthops=self.nexthops(e.nexthops),
            best_node=e.best_node,
            best_nodes=tuple(e.best_nodes),
            best_entry=self.prefix_entry(e.best_entry),
            igp_cost=e.igp_cost,
            backup_nexthops=self.nexthops(e.backup_nexthops),
        ))

    def mpls_entry(self, e):
        got = self._memo.get(id(e))
        if got is not None:
            return got[1]
        return self._remember(e, self.routes.RibMplsEntry(
            label=e.label, nexthops=self.nexthops(e.nexthops)
        ))

    def route_db(self, rdb):
        out = self.routes.RouteDatabase(this_node_name=rdb.this_node_name)
        entry, mpls_entry = self.entry, self.mpls_entry
        prefix = self.prefix
        out.unicast_routes = {
            prefix(p): entry(e) for p, e in rdb.unicast_routes.items()
        }
        out.mpls_routes = {
            label: mpls_entry(e) for label, e in rdb.mpls_routes.items()
        }
        return out

    def update(self, upd):
        """A RouteUpdate of the caller's class (its perf traces stay
        behind: they do not take part in its equality)."""
        r = self.routes
        return r.RouteUpdate(
            type=r.RouteUpdateType(int(upd.type)),
            unicast_to_update={self.prefix(p): self.entry(e)
                               for p, e in upd.unicast_to_update.items()},
            unicast_to_delete=[self.prefix(p)
                               for p in upd.unicast_to_delete],
            mpls_to_update={label: self.mpls_entry(e)
                            for label, e in upd.mpls_to_update.items()},
            mpls_to_delete=list(upd.mpls_to_delete),
        )


class DecisionAdapter:
    """What a Decision reads of its solver, served by a `TorchSpfSolver`
    with the routes converted at the boundary. Artifacts pass through
    unconverted: only the port reads them."""

    def __init__(self, solver: TorchSpfSolver, route_types, network_types):
        self.solver = solver
        self.convert = RouteConverter(route_types, network_types)
        # (module, its functions that `install_telemetry` replaced)
        self._displaced = None

    #: the functions of the caller's telemetry module ctrl reads
    TELEMETRY_NAMES = ("kernel_rows", "sample_hbm", "telemetry")

    def install_telemetry(self, module) -> None:
        """Point `module`'s `kernel_rows`, `sample_hbm` and `telemetry`
        at the port's, keeping what they were for `detach`."""
        if self._displaced is not None:
            raise RuntimeError("install_telemetry: already installed")
        self._displaced = (module, {
            n: getattr(module, n) for n in self.TELEMETRY_NAMES})
        for n in self.TELEMETRY_NAMES:
            setattr(module, n, getattr(telemetry, n))

    def detach(self) -> None:
        """Give the telemetry module `attach` was handed its own
        functions back (adapters attached to one module detach in the
        reverse order)."""
        if self._displaced is not None:
            module, saved = self._displaced
            for n, fn in saved.items():
                setattr(module, n, fn)
            self._displaced = None

    # the solver's counters and stats, as the Decision exports them
    @property
    def dev_cache_stats(self) -> dict:
        return self.solver.dev_cache_stats

    @property
    def spf_kernel_stats(self) -> dict:
        return self.solver.spf_kernel_stats

    @property
    def elect_stats(self) -> dict:
        return self.solver.elect_stats

    @property
    def last_phase_ms(self) -> dict:
        return self.solver.last_phase_ms

    @property
    def _nh_intern(self):
        return self.solver._nh_intern

    @property
    def solve_count(self) -> int:
        return self.solver.solve_count

    @property
    def last_shard_rows(self) -> list[dict]:
        return self.solver.last_shard_rows

    def export_telemetry(self) -> None:
        """The port's ledgers, cost rows and HBM gauges into the
        solver's counters (the Decision's): the rebuild edge."""
        counters = self.solver.counters
        if counters is None:
            return
        compile_ledger.export_to(counters)
        telemetry.export_to(counters)
        telemetry.sample_hbm(counters)
        self.solver.work_ledger.export_to(counters)

    def device_telemetry(self) -> dict:
        """What ctrl `get_device_telemetry` returns, from the port's
        planes: the cost rows joined with the counters' span stats, the
        HBM rows, whether the gauges are live, and the shard rows."""
        counters = self.solver.counters
        snap = counters.snapshot() if counters is not None else {}
        return {
            "kernels": telemetry.efficiency_rows(telemetry.kernel_rows(),
                                                 snap),
            "devices": telemetry.sample_hbm() or [],
            "hbm_available": bool(telemetry.telemetry().hbm_available),
            "shards": list(self.last_shard_rows),
        }

    def compute_routes(self, ls, ps, my_node: str,
                       return_artifact: bool = False):
        res = self.solver.compute_routes(
            ls, ps, my_node, return_artifact=return_artifact
        )
        self.export_telemetry()
        if return_artifact:
            return self.convert.route_db(res[0]), res[1]
        return self.convert.route_db(res)

    def assemble_prefix_routes(self, art, ps, prefixes) -> dict:
        entries = self.solver.assemble_prefix_routes(art, ps, prefixes)
        self.export_telemetry()
        return {p: self.convert.entry(e) for p, e in entries.items()}

    def warm_compute_routes(self, art, ls, ps, my_node: str, edge_pairs,
                            prefix_dirt, cached_rdb, max_frac: float):
        """The port's warm rebuild. It copies `cached_rdb`'s tables (the
        caller's classes already) and writes only the touched prefixes
        and labels, so only those are converted: the boundary costs
        O(delta), not O(routes)."""
        got = self.solver.warm_compute_routes(
            art, ls, ps, my_node, edge_pairs, prefix_dirt, cached_rdb,
            max_frac,
        )
        self.export_telemetry()
        if got is None:
            return None
        rdb, art2, touched, touched_labels, region = got
        out = self.convert.routes.RouteDatabase(
            this_node_name=rdb.this_node_name
        )
        out.unicast_routes = rdb.unicast_routes
        out.mpls_routes = rdb.mpls_routes
        for table, keys, conv in (
            (out.unicast_routes, touched, self.convert.entry),
            (out.mpls_routes, touched_labels, self.convert.mpls_entry),
        ):
            for k in keys:
                e = table.get(k)
                if e is not None:
                    table[k] = conv(e)
        return out, art2, touched, touched_labels, region

    def trim_caches(self, fingerprint_cap: int = 8) -> None:
        self.solver.trim_caches(fingerprint_cap)
        self.convert.clear()
