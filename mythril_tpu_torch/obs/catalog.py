"""The metric catalog: every registry metric name lives HERE.

The ``metric_names`` lint rule (scripts/lint.py) enforces two
invariants over the whole tree:

1. instruments are constructed only in this module — call sites import
   the instrument objects below instead of minting name strings;
2. names are snake_case with a unit suffix: ``_s`` (seconds),
   ``_bytes``, or ``_total`` (dimensionless count/state).

Rates and ratios (warm-cache rate, solver hit rate) are *not* stored —
``myth top`` and dashboards derive them from the counters, so the
catalog stays restatable and the suffix rule stays honest.

Pull collectors for the pre-existing stats surfaces (solver cache,
circuit breaker, scheduler/coordinator/journal/result-cache) are also
defined here so their exposition names stay in the one catalog module;
the owning modules keep their ``stats()`` dicts as thin views of the
same state.
"""

from mythril_tpu_torch.obs import metrics as _m
from mythril_tpu_torch.obs import trace as _trace

REGISTRY = _m.REGISTRY

# -- round loop (laser/tpu/backend.py, service/lanes.py) ---------------

# one observation per phase occurrence; the phase label matches the
# tracer's thread-row taxonomy (docs/OBSERVABILITY.md)
ROUND_PHASE_S = REGISTRY.histogram(
    "myth_round_phase_s",
    "wall time of one round-loop phase occurrence",
    labelnames=("phase",),
)
DEVICE_ROUNDS_TOTAL = REGISTRY.counter(
    "myth_device_rounds_total", "device rounds executed"
)
DEVICE_STEPS_TOTAL = REGISTRY.counter(
    "myth_device_steps_total", "device lane-steps retired"
)
DEVICE_SLICES_TOTAL = REGISTRY.counter(
    "myth_device_slices_total", "jitted step-kernel slices dispatched"
)
SOLVER_BATCHES_TOTAL = REGISTRY.counter(
    "myth_solver_batches_total",
    "device feasibility kernel batches dispatched",
)
# real blast volume, accumulated at CNF-compile time (solver_jax
# .check_batch): the denominator of the stage-3 rewrite pass's clause
# reduction claim (docs/REWRITE_PASS.md) — compare against a
# MYTHRIL_TPU_REWRITE=0 run of the same issue set
CNF_VARS_TOTAL = REGISTRY.counter(
    "myth_cnf_vars_total", "CNF variables blasted for device dispatch"
)
CNF_CLAUSES_TOTAL = REGISTRY.counter(
    "myth_cnf_clauses_total", "CNF clauses blasted for device dispatch"
)

# -- in-loop solve + resident storage plane (laser/tpu/inloop_solve.py,
#    engine.py keccak storage addressing, backend._run_device_fused) ---

INLOOP_UNSAT_KILLS_TOTAL = REGISTRY.counter(
    "myth_inloop_unsat_kills_total",
    "must-UNSAT forks killed inside the fused while_loop (no lift, no "
    "host solve; subsumed by host verdicts per docs/SOLVER.md)",
)
STORAGE_DEVICE_RESOLVED_TOTAL = REGISTRY.counter(
    "myth_storage_device_resolved_total",
    "symbolic keccak-rooted storage keys resolved into the device "
    "storage plane instead of freeze-trapping the lane",
)

# -- fused mesh path (laser/tpu/mesh.py, backend._run_mesh_fused) ------

# last observed running-lane count per shard, set from the fused info
# vector after every mesh super-round (no extra device fetch)
MESH_FRONTIER_OCCUPANCY = REGISTRY.gauge(
    "myth_mesh_frontier_occupancy_total",
    "running lanes resident on one mesh shard after the last super-round",
    labelnames=("shard",),
)
MESH_STEAL_EVENTS_TOTAL = REGISTRY.counter(
    "myth_mesh_steal_events_total",
    "ICI work-steal exchanges fired between fused mesh rounds",
)
MESH_STEAL_LANES_TOTAL = REGISTRY.counter(
    "myth_mesh_steal_lanes_total",
    "lanes moved across shards by ICI work-steal exchanges",
)

# -- robustness (robustness/retry.py, faults.py, checkpoint.py) --------

DEVICE_RETRIES_TOTAL = REGISTRY.counter(
    "myth_device_retries_total", "device round attempts retried"
)
DEGRADED_ROUNDS_TOTAL = REGISTRY.counter(
    "myth_degraded_rounds_total",
    "rounds completed on the host degrade path",
)
FAULTS_INJECTED_TOTAL = REGISTRY.counter(
    "myth_faults_injected_total",
    "planned faults fired by the injection harness",
    labelnames=("seam",),
)
CHECKPOINTS_TOTAL = REGISTRY.counter(
    "myth_checkpoints_total", "frontier checkpoints journaled"
)
CHECKPOINT_OVERHEAD_S = REGISTRY.counter(
    "myth_checkpoint_overhead_s", "cumulative checkpoint serialization time"
)

# -- static pass + hook gating (analysis/) -----------------------------

STATIC_PASS_S = REGISTRY.counter(
    "myth_static_pass_s", "cumulative static pre-analysis wall time"
)
TAINT_PASS_S = REGISTRY.counter(
    "myth_taint_pass_s", "cumulative taint/dataflow stage wall time"
)
STATIC_CONTRACTS_TOTAL = REGISTRY.counter(
    "myth_static_contracts_total", "contracts statically analyzed"
)
STATIC_CACHE_HITS_TOTAL = REGISTRY.counter(
    "myth_static_cache_hits_total", "static-analysis memo hits"
)
HOOK_DISPATCHES_TOTAL = REGISTRY.counter(
    "myth_hook_dispatches_total", "detection-module hook dispatches"
)
HOOK_SKIPPED_TOTAL = REGISTRY.counter(
    "myth_hook_skipped_total", "hook dispatches skipped by the static gate"
)
MODULE_EXEC_S = REGISTRY.counter(
    "myth_module_exec_s",
    "cumulative POST detection-module execute() wall time",
    labelnames=("module",),
)

# -- obs self-accounting ----------------------------------------------

TRACE_DROPPED_TOTAL = REGISTRY.counter(
    "myth_trace_dropped_total", "trace events dropped by the ring buffer"
)

# -- fleet gateway (fleet/gateway.py) ----------------------------------

# The gateway is device-free and must stay that way at RUNTIME too:
# rendering the shared REGISTRY pulls the solver collector, whose
# sampler imports the laser stack. The gateway therefore owns a
# SEPARATE registry — its instruments still live here (metric_names
# lint rule), and its `metrics` op serves this registry's exposition
# alongside the per-worker texts it aggregates.
GATEWAY_REGISTRY = _m.MetricsRegistry()

GATEWAY_REQUESTS_TOTAL = GATEWAY_REGISTRY.counter(
    "myth_gateway_requests_total",
    "requests handled by the fleet gateway",
    labelnames=("op",),
)
GATEWAY_SHED_TOTAL = GATEWAY_REGISTRY.counter(
    "myth_gateway_shed_total", "submissions shed by QoS admission"
)
GATEWAY_WORKER_DEATHS_TOTAL = GATEWAY_REGISTRY.counter(
    "myth_gateway_worker_deaths_total", "worker-death detections"
)
GATEWAY_REROUTES_TOTAL = GATEWAY_REGISTRY.counter(
    "myth_gateway_reroutes_total",
    "jobs re-routed to a surviving worker after a death",
)
GATEWAY_STREAM_EVENTS_TOTAL = GATEWAY_REGISTRY.counter(
    "myth_gateway_stream_events_total",
    "watch stream events forwarded to clients",
)
GATEWAY_WORKERS_ALIVE = GATEWAY_REGISTRY.gauge(
    "myth_gateway_workers_alive_total", "workers currently routable"
)

# -- durable store (fleet/store.py), sampled in the WORKER process -----


def make_store_collector(cache):
    """Sample fn for one DurableResultCache; registered under the keyed
    slot ``"fleet_store"`` so a worker restart replaces, not doubles."""

    def _store_samples():
        st = cache.stats()
        store = st["store"]
        return [
            ("myth_store_records_total", (), store["records"]),
            ("myth_store_appends_total", (), store["appends"]),
            ("myth_store_replayed_total", (), store["replayed"]),
            ("myth_store_refreshes_total", (), store["refreshes"]),
            ("myth_store_checkpoints_total", (), store["checkpoints"]),
            ("myth_store_torn_records_total", (), store["torn_records"]),
            ("myth_store_disk_bytes", (), store["disk_bytes"]),
            (
                "myth_store_cross_process_hits_total",
                (),
                st["cross_process_hits"],
            ),
        ]

    return _store_samples


def register_store(cache) -> None:
    REGISTRY.register_collector("fleet_store", make_store_collector(cache))


# -- pull collectors for the pre-existing stats surfaces ---------------

def _solver_samples():
    from mythril_tpu_torch.laser.cuda import solver_cache

    snap = solver_cache.GLOBAL.snapshot()
    return [
        ("myth_solver_queries_total", (), snap["queries"]),
        ("myth_solver_hits_total", (("kind", "exact"),), snap["hits_exact"]),
        ("myth_solver_hits_total", (("kind", "alpha"),), snap["hits_alpha"]),
        (
            "myth_solver_hits_total",
            (("kind", "subsume"),),
            snap["hits_subsume"],
        ),
        ("myth_solver_device_decided_total", (), snap["device_decided"]),
        ("myth_solver_host_decided_total", (), snap["host_decided"]),
        ("myth_solver_unknown_total", (), snap["unknown"]),
        (
            "myth_solver_async_total",
            (("state", "submitted"),),
            snap["async_submitted"],
        ),
        (
            "myth_solver_async_total",
            (("state", "completed"),),
            snap["async_completed"],
        ),
        (
            "myth_solver_async_total",
            (("state", "dropped"),),
            snap["async_dropped"],
        ),
        (
            "myth_solver_static_unsat_seeds_total",
            (),
            snap["static_unsat_seeds"],
        ),
        ("myth_solver_round_batches_total", (), snap["round_batches"]),
        ("myth_solver_pending_total", (), snap["pending"]),
        ("myth_solver_time_s", (), snap["time_s"]),
        # stage-3 rewrite pass (docs/REWRITE_PASS.md)
        (
            "myth_solver_rewrite_discharged_total",
            (),
            snap["rewrite_discharged"],
        ),
        (
            "myth_solver_assumption_reuse_total",
            (),
            snap["assumption_reuse"],
        ),
        ("myth_solver_core_minimized_total", (), snap["core_minimized"]),
        ("myth_solver_rewrite_time_s", (), snap["rewrite_time_s"]),
        # in-loop clause pool (laser/tpu/inloop_solve.py)
        (
            "myth_solver_inloop_pool_builds_total",
            (),
            snap["inloop_pool_builds"],
        ),
        (
            "myth_solver_inloop_pool_clauses_total",
            (),
            snap["inloop_pool_clauses"],
        ),
        (
            "myth_solver_rewrite_bits_total",
            (("stage", "before"),),
            snap["rewrite_bits_before"],
        ),
        (
            "myth_solver_rewrite_bits_total",
            (("stage", "after"),),
            snap["rewrite_bits_after"],
        ),
    ]


def _robustness_samples():
    from mythril_tpu_torch.robustness import retry

    return [
        ("myth_breaker_trips_total", (), retry.BREAKER.trips),
        ("myth_breaker_open_total", (), 1.0 if retry.BREAKER.open else 0.0),
        ("myth_trace_dropped_total", (), float(_trace.TRACER.dropped)),
    ]


def make_service_collector(service):
    """Sample fn for one AnalysisService (scheduler/lanes/journal/cache).

    Registered under the keyed slot ``"service"`` so a fresh service
    instance (tests, restarts) replaces the previous collector instead
    of double-emitting."""

    def _service_samples():
        st = service.stats()
        cache = st["cache"]
        return [
            ("myth_jobs_total", (("state", "submitted"),), st["jobs_submitted"]),
            ("myth_jobs_total", (("state", "done"),), st["jobs_done"]),
            ("myth_jobs_total", (("state", "failed"),), st["jobs_failed"]),
            (
                "myth_jobs_total",
                (("state", "cancelled"),),
                st["jobs_cancelled"],
            ),
            ("myth_jobs_total", (("state", "retried"),), st["jobs_retried"]),
            ("myth_queue_depth_total", (), st["queued"]),
            ("myth_rounds_total", (), st["rounds"]),
            ("myth_shared_rounds_total", (), st["shared_rounds"]),
            ("myth_resident_jobs_peak_total", (), st["max_resident_jobs"]),
            ("myth_result_cache_entries_total", (), cache["entries"]),
            ("myth_result_cache_hits_total", (), cache["hits"]),
            ("myth_result_cache_misses_total", (), cache["misses"]),
            ("myth_quarantined_jobs_total", (), st["quarantined_jobs"]),
            (
                "myth_solver_memo_entries_total",
                (),
                cache["solver_memo_entries"],
            ),
            (
                "myth_solver_memo_evictions_total",
                (("kind", "entry"),),
                cache["solver_memo_evictions"],
            ),
            (
                "myth_solver_memo_evictions_total",
                (("kind", "verdict"),),
                cache["solver_verdict_evictions"],
            ),
        ]

    return _service_samples


def register_default_collectors() -> None:
    REGISTRY.register_collector("solver", _solver_samples)
    REGISTRY.register_collector("robustness", _robustness_samples)


def register_service(service) -> None:
    REGISTRY.register_collector("service", make_service_collector(service))


register_default_collectors()
