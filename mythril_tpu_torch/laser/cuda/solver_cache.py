"""Solver acceleration layer: constraint dedup between the engine and the
solvers (docs/SOLVER.md).

Forked sibling lanes share long constraint prefixes, so the frontier's
feasibility queries are dominated by near-duplicates — the classic
incrementality observation of modern SMT engines. This module sits
between the round loop (laser/cuda/backend.filter_feasible) and the two
actual deciders (the batched device kernel in laser/cuda/solver.py and the host
incremental CDCL core) and removes redundant solves three ways:

  1. verdict memoization — every decided constraint set is recorded
     under two keys: the exact key (frozenset of hash-consed term uids;
     structural equality IS identity, so this can never false-hit) and
     an alpha-canonical key (order-insensitive, variable-renaming-
     normalized digest) so the same shape re-queried next round, next
     transaction, or next job resubmission is answered from the table.
     UNKNOWN verdicts are memoized too: re-solving a set that already
     exhausted the device budget AND the host quick budget is pure
     waste (measured: BECToken's deep instances return 100% unknown).
  2. prefix subsumption — a superset of an already-UNSAT set is UNSAT
     without any solve (monotonicity of conjunction). Children extend
     their parent's constraint list append-only, so a late UNSAT
     verdict (e.g. from the async pool) prunes the whole descendant
     subtree on the next round. SAT never transfers to supersets; SAT
     entries are only reused on exact or alpha-equal keys.
  3. warm-started device solves — a SAT verdict's named-symbol model is
     cached under the lane's path-prefix fingerprint (symtape
     .path_fingerprint, attached at lift time by the bridge); children
     pass the nearest ancestor model down to the WalkSAT kernel as a
     decision-phase hint. Hints affect performance only, never
     soundness (the device solver verifies every SAT witness).

Whatever stays UNKNOWN after the device dispatch and the inline quick
host check goes to a bounded ASYNC fallback pool of host CDCL workers
(one private IncrementalCore per worker thread — the process-global
core is not safe for concurrent entry). The round loop proceeds
optimistically (unknown counts as possible, exactly the semantics of
Constraints.is_possible); pool results fold back into the memo table
where subsumption turns them into prunes. Pool entries carry the
owning job's deadline and cancel event (service/scheduler.py): a
cancelled or expired job's pending queries are dropped at dequeue
time, never solved.

The alpha key is structure-only (stable across processes), so the
multi-tenant service exports/imports it per code hash
(service/cache.ResultCache.{get,put}_solver_memo) and resubmissions of
a popular contract start with a warm verdict table. Exact keys are
uid-based and never exported: uids are process-local.
"""

import hashlib
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch import obs
from mythril_tpu_torch.analysis import rewrite_pass as _rw
from mythril_tpu_torch.obs import catalog as _cat
from mythril_tpu_torch.robustness import faults
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.solver import pysat
from mythril_tpu_torch.smt.solver.bitblast import BlastError
from mythril_tpu_torch.smt.solver.incremental import IncrementalCore, get_core
from mythril_tpu_torch.smt.terms import Term

log = logging.getLogger(__name__)

SAT = pysat.SAT
UNSAT = pysat.UNSAT
UNKNOWN = pysat.UNKNOWN

# inline quick host check budget: mirrors Constraints.FEASIBILITY_BUDGET_MS
# (the cost this layer replaces), NOT imported to avoid a laser.evm dep.
HOST_BUDGET_MS = 100
# async pool: per-query budget is deliberately larger than the inline
# budget — the pool exists to resolve exactly the instances the quick
# budget could not, off the round loop's critical path.
FALLBACK_TIMEOUT_MS = 4000
FALLBACK_WORKERS = 2
FALLBACK_QUEUE_MAX = 128

# alpha-canonicalization is linear in the constraint DAG, but a frontier
# of pathological lanes should not burn host time hashing; past this many
# nodes a set is memoized by exact uid key only.
ALPHA_NODE_CAP = 20_000

_NAMED_OPS = ("var", "boolvar", "array_var", "apply")

# ops whose semantics are argument-order-insensitive. The constructors
# canonicalize SOME of these by uid (bool_eq, bool_iff) — but uids are
# creation-order artifacts, so two alpha-equivalent sets built along
# different histories (notably: rewritten forms, which mint constants
# lazily) can store commutative args in different orders. The digest
# treats their children as a multiset instead, so those sets still
# share a key. Sound: permuting a commutative op's arguments is an
# equivalence, so a digest collision by design is still alpha-equal.
_COMMUTATIVE_OPS = frozenset(
    ("eq", "iff", "band", "bor", "add", "mul", "and", "or", "xor")
)

_U64 = (1 << 64) - 1


def _mix64(h: int, v: int) -> int:
    """One round of a splitmix-style 64-bit mix."""
    h = ((h ^ (v & _U64)) * 0xBF58476D1CE4E5B9) & _U64
    return h ^ (h >> 29)


# ---------------------------------------------------------------------------
# canonical (alpha) fingerprints
# ---------------------------------------------------------------------------

# uid -> blind hash. uids are monotonic and never reused (terms._mk), so a
# bounded LRU can only false-miss, never false-hit.
_blind_memo: "OrderedDict[int, int]" = OrderedDict()
_BLIND_MEMO_MAX = 1 << 16
_blind_lock = threading.Lock()


def _op_tag(t: Term) -> Tuple:
    """The node's identity with symbol names blanked: alpha-equivalent
    terms get identical tags. Non-name params (array domains, extract
    bounds, constants) stay — they are structure, not naming."""
    if t.op in _NAMED_OPS:
        return (t.op, t.sort, t.size) + tuple(t.params[1:])
    return (t.op, t.sort, t.size) + tuple(t.params)


def _blind_hash(root: Term) -> int:
    """Bottom-up 64-bit hash of a term with variable names blanked
    (iterative over the DAG; memoized process-wide by uid)."""
    with _blind_lock:
        cached = _blind_memo.get(root.uid)
    if cached is not None:
        return cached
    stack = [(root, False)]
    local: Dict[int, int] = {}
    while stack:
        t, expanded = stack.pop()
        if t.uid in local:
            continue
        with _blind_lock:
            hit = _blind_memo.get(t.uid)
        if hit is not None:
            local[t.uid] = hit
            continue
        if not expanded:
            stack.append((t, True))
            stack.extend((a, False) for a in t.args)
            continue
        h = _mix64(0x9E3779B97F4A7C15, hash(_op_tag(t)))
        if t.op in _COMMUTATIVE_OPS:
            acc = 0
            for a in t.args:
                acc = (acc + _mix64(h, local[a.uid])) & _U64
            h = _mix64(h, acc)
        else:
            for a in t.args:
                h = _mix64(h, local[a.uid])
        local[t.uid] = h
        with _blind_lock:
            _blind_memo[t.uid] = h
            while len(_blind_memo) > _BLIND_MEMO_MAX:
                _blind_memo.popitem(last=False)
    return local[root.uid]


def _collect_nodes(roots: Sequence[Term], cap: int) -> Optional[List[Term]]:
    """Reverse-topological node list of the forest (parents before a
    node only after the node — i.e. post-order de-duplicated); None if
    the DAG exceeds ``cap`` nodes."""
    out: List[Term] = []
    seen = set()
    stack = [(t, False) for t in roots]
    while stack:
        t, expanded = stack.pop()
        if expanded:
            out.append(t)
            continue
        if t.uid in seen:
            continue
        seen.add(t.uid)
        if len(seen) > cap:
            return None
        stack.append((t, True))
        stack.extend((a, False) for a in t.args)
    return out


def canonical_fingerprint(raw_terms: Sequence[Term]) -> Optional[bytes]:
    """Order-insensitive, rename-insensitive digest of a constraint set.

    Two sets with the same digest are literally equal up to a renaming
    of their free symbols (the final step re-serializes every term with
    canonical variable indices, so a digest collision between
    non-alpha-equivalent sets would require a hash collision) — and
    alpha-equivalent sets share satisfiability, so verdicts transfer.

    Canonical variable indices come from sorting symbols on a blind
    occurrence-context signature (one Weisfeiler-Leman-style round:
    bottom-up blind hash + top-down folded ancestor context).
    Symmetric variables can tie — ties are broken by traversal order,
    which may differ between renamings of a symmetric set, costing a
    cache MISS, never a wrong hit.

    Returns None when the set is too large to canonicalize cheaply.
    """
    roots = []
    seen_roots = set()
    for t in raw_terms:
        if t is terms.TRUE:
            continue
        if t.uid not in seen_roots:
            seen_roots.add(t.uid)
            roots.append(t)
    roots.sort(key=lambda t: t.uid)
    nodes = _collect_nodes(roots, ALPHA_NODE_CAP)
    if nodes is None:
        return None

    # top-down folded ancestor context: ctx(node) = sum over parent
    # edges of mix(ctx(parent), parent tag, arg position). Roots seed
    # with their blind hash (identical across renamings). Processing in
    # reverse post-order guarantees parents are finished first.
    ctx: Dict[int, int] = {}
    for r in roots:
        bh = _blind_hash(r)
        ctx[r.uid] = (ctx.get(r.uid, 0) + bh) & _U64
    for t in reversed(nodes):
        base = ctx.get(t.uid, 0)
        if not t.args:
            continue
        tag = hash(_op_tag(t))
        commutative = t.op in _COMMUTATIVE_OPS
        for i, a in enumerate(t.args):
            # commutative parents give every child the same positional
            # context: the stored arg order is a uid artifact
            edge = _mix64(_mix64(base, tag), 0 if commutative else i)
            ctx[a.uid] = (ctx.get(a.uid, 0) + edge) & _U64

    # canonical index per named symbol, ordered by (signature, kind)
    named = [t for t in nodes if t.op in _NAMED_OPS]
    named.sort(key=lambda t: (ctx.get(t.uid, 0), _op_tag(t)))
    index = {t.uid: i for i, t in enumerate(named)}

    # final serialization with names replaced by canonical indices;
    # per-node digests memoized per call (linear over the DAG)
    digests: Dict[int, bytes] = {}
    for t in nodes:
        h = hashlib.blake2b(digest_size=16)
        if t.op in _NAMED_OPS:
            h.update(repr((t.op, t.sort, t.size, index[t.uid]) + tuple(t.params[1:])).encode())
        else:
            h.update(repr(_op_tag(t)).encode())
        if t.op in _COMMUTATIVE_OPS:
            for d in sorted(digests[a.uid] for a in t.args):
                h.update(d)
        else:
            for a in t.args:
                h.update(digests[a.uid])
        digests[t.uid] = h.digest()

    final = hashlib.blake2b(digest_size=16)
    for d in sorted(digests[r.uid] for r in roots):
        final.update(d)
    return final.digest()


# ---------------------------------------------------------------------------
# host checks
# ---------------------------------------------------------------------------


def _host_check(
    raw_terms: Sequence[Term],
    timeout_ms: int,
    core: Optional[IncrementalCore] = None,
) -> int:
    """One budgeted host CDCL feasibility check over raw terms.

    ``core=None`` uses the process-global incremental core (single-
    threaded callers only: service invariant I2). Pool workers pass
    their private per-thread core."""
    faults.fire(faults.HOST_SOLVE)
    if any(t is terms.FALSE for t in raw_terms):
        return UNSAT
    concrete = [t for t in raw_terms if t is not terms.TRUE]
    if not concrete:
        return SAT
    if core is None:
        core = get_core()
    else:
        core._maybe_recycle()
    lits: List[int] = []
    rws: List[Term] = []
    try:
        for t in concrete:
            lit, rw = core.lower(t)
            lits.append(lit)
            rws.append(rw)
    except BlastError:
        return UNKNOWN
    return core.solve_checked(lits, rws, timeout_ms=timeout_ms)


# ---------------------------------------------------------------------------
# per-job context (set by the service scheduler around job execution)
# ---------------------------------------------------------------------------

_JOB_CTX = threading.local()


def set_job_context(deadline: Optional[float] = None, cancel_event=None) -> None:
    """Tag this thread's subsequent fallback submissions with the owning
    job's deadline (absolute time.time()) and cancel event, so the pool
    can drop them when the job dies (satellite: no leaked queries)."""
    _JOB_CTX.deadline = deadline
    _JOB_CTX.cancel_event = cancel_event


def clear_job_context() -> None:
    _JOB_CTX.deadline = None
    _JOB_CTX.cancel_event = None


def _job_context() -> Tuple[Optional[float], Optional[object]]:
    return (
        getattr(_JOB_CTX, "deadline", None),
        getattr(_JOB_CTX, "cancel_event", None),
    )


# ---------------------------------------------------------------------------
# async host fallback pool
# ---------------------------------------------------------------------------


class _FallbackJob:
    __slots__ = ("key", "raw_terms", "deadline", "cancel_event")

    def __init__(self, key, raw_terms, deadline, cancel_event):
        self.key = key
        self.raw_terms = raw_terms
        self.deadline = deadline
        self.cancel_event = cancel_event

    def dead(self) -> bool:
        if self.cancel_event is not None and self.cancel_event.is_set():
            return True
        return self.deadline is not None and time.time() > self.deadline


class FallbackPool:
    """Bounded thread pool resolving hard (UNKNOWN) instances off the
    round loop's critical path. Each worker owns a private
    IncrementalCore — the process-global core must never be entered
    concurrently. Results fold into the owning SolverCache."""

    def __init__(
        self,
        cache: "SolverCache",
        workers: int = FALLBACK_WORKERS,
        queue_max: int = FALLBACK_QUEUE_MAX,
        timeout_ms: int = FALLBACK_TIMEOUT_MS,
        autostart: bool = True,
    ):
        self.cache = cache
        self.workers = workers
        self.queue_max = queue_max
        self.timeout_ms = timeout_ms
        self.autostart = autostart
        self._queue: "deque[_FallbackJob]" = deque()
        self._inflight_keys = set()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._threads: List[threading.Thread] = []
        self._spawned = 0  # lifetime spawn count (thread names, tests)
        self._tls = threading.local()
        # p95 source: in-flight depth sampled at every submit/complete
        self._inflight_samples: "deque[int]" = deque(maxlen=1024)

    # -- submission -----------------------------------------------------

    def submit(self, key, raw_terms, deadline=None, cancel_event=None) -> bool:
        """Queue one hard instance; False when dropped (full queue,
        duplicate in-flight key, or already-dead job)."""
        job = _FallbackJob(key, tuple(raw_terms), deadline, cancel_event)
        if job.dead():
            self.cache._count("async_dropped")
            return False
        with self._lock:
            if len(self._queue) >= self.queue_max or key in self._inflight_keys:
                return False
            self._inflight_keys.add(key)
            self._queue.append(job)
            self._inflight_samples.append(len(self._inflight_keys))
            self._wake.notify()
        self.cache._count("async_submitted")
        if self.autostart:
            self._ensure_threads()
        return True

    def _ensure_threads(self) -> None:
        """Keep the worker complement full: prune dead threads (a worker
        CAN die — injected or real) and respawn up to ``workers``."""
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            while len(self._threads) < self.workers:
                self._spawned += 1
                t = threading.Thread(
                    target=self._worker_loop,
                    name="solver-fallback-%d" % self._spawned,
                    daemon=True,
                )
                self._threads.append(t)
                t.start()

    # -- processing -----------------------------------------------------

    def _core(self) -> IncrementalCore:
        core = getattr(self._tls, "core", None)
        if core is None:
            core = IncrementalCore()
            self._tls.core = core
        return core

    def process_once(self, block: bool = False, timeout: float = 0.5) -> bool:
        """Pop and resolve one queued instance on the CALLING thread
        (workers loop on this; tests call it directly for determinism).
        Returns False when the queue stayed empty."""
        with self._lock:
            if not self._queue and block:
                self._wake.wait(timeout)
            if not self._queue:
                return False
            job = self._queue.popleft()
        try:
            # the worker-death seam fires INSIDE the try: the in-flight
            # key is released by the finally either way, so the dropped
            # query can be resubmitted to a surviving/respawned worker
            faults.fire(faults.FALLBACK_WORKER)
            if job.dead():
                self.cache._count("async_dropped")
                return True
            t0 = time.monotonic()
            try:
                code = _host_check(job.raw_terms, self.timeout_ms, self._core())
            except Exception as e:
                # a faulted solve settles as UNKNOWN and records NOTHING
                # (code below): the memo must never remember a failure
                log.warning("fallback solve failed: %s", e)
                code = UNKNOWN
            self.cache._add_time(time.monotonic() - t0)
            if code != UNKNOWN:
                self.cache.record(job.raw_terms, code, key=job.key)
                if code == UNSAT and _rw.enabled():
                    # pool workers own their core: minimization is safe
                    # off the round loop too, and a late-arriving short
                    # core still prunes the descendant subtree
                    self.cache._minimize_and_seed(job.raw_terms, self._core())
            self.cache._count("async_completed")
        finally:
            with self._lock:
                self._inflight_keys.discard(job.key)
                self._inflight_samples.append(len(self._inflight_keys))
        return True

    def _worker_loop(self) -> None:
        while True:
            try:
                self.process_once(block=True)
            except faults.WorkerDeath as e:
                # a dead worker does not keep polling: exit the thread;
                # the next submit()'s _ensure_threads respawns the slot
                log.warning("fallback worker exiting: %s", e)
                return
            except Exception as e:  # pragma: no cover - defensive
                log.warning("fallback worker error (continuing): %s", e)

    def drain(self, timeout: float = 10.0) -> None:
        """Block until the queue and in-flight set are empty (tests,
        end-of-job flush)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.autostart and self._threads:
                with self._lock:
                    idle = not self._queue and not self._inflight_keys
                if idle:
                    return
                time.sleep(0.01)
            else:
                if not self.process_once():
                    return

    # -- stats ----------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def inflight_p95(self) -> int:
        with self._lock:
            samples = sorted(self._inflight_samples)
        if not samples:
            return 0
        return samples[min(len(samples) - 1, (len(samples) * 95) // 100)]


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

# sentinel: _lookup did not attempt alpha canonicalization (distinct
# from None, which means it was attempted and the set is too large)
_NO_DIGEST = object()

_STAT_KEYS = (
    "queries",
    "hits_exact",
    "hits_alpha",
    "hits_subsume",
    "device_decided",
    "host_decided",
    "unknown",
    "async_submitted",
    "async_completed",
    "async_dropped",
    "static_unsat_seeds",
    # decide_batch invocations that carried a non-empty frontier: with
    # the fused megakernel one invocation covers a whole K-round
    # super-round, so queries/round_batches exposes the dispatch
    # batching the fusion buys (the solver seam)
    "round_batches",
    # stage-3 rewrite pass (analysis/rewrite_pass, docs/REWRITE_PASS.md)
    "rewrite_discharged",  # sets decided by rewrite/interval discharge
    "assumption_reuse",  # sets answered SAT by ancestor-witness replay
    "core_minimized",  # UNSAT verdicts whose prefix core was shortened
    # in-loop solve pool (laser/cuda/inloop_solve.py)
    "inloop_pool_builds",  # clause pools compiled for the fused loop
    "inloop_pool_clauses",  # last pool's clause count (assigned, not summed)
)


class SolverCache:
    """Verdict memo + model store + subsumption index (module docstring)."""

    def __init__(
        self,
        max_entries: int = 8192,
        max_unsat: int = 256,
        max_models: int = 1024,
    ):
        self.max_entries = max_entries
        self.max_unsat = max_unsat
        self.max_models = max_models
        self._lock = threading.RLock()
        # frozenset(uid) -> SAT/UNSAT/UNKNOWN
        self._exact: "OrderedDict[frozenset, int]" = OrderedDict()
        # alpha digest -> SAT/UNSAT (UNKNOWN is process-local: never alpha)
        self._alpha: "OrderedDict[bytes, int]" = OrderedDict()
        # UNSAT uid-sets for superset subsumption
        self._unsat_sets: "OrderedDict[frozenset, None]" = OrderedDict()
        # path-fp or frozenset -> named-symbol model dict (hints only)
        self._models: "OrderedDict[object, dict]" = OrderedDict()
        self._stats = {k: 0 for k in _STAT_KEYS}
        self._time_s = 0.0
        # stage-3 rewrite accounting: wall time inside rewrite_set and
        # the bit-width-weighted DAG sizes before/after (the CNF-variable
        # proxy backing the bench's cnf_vars_saved_pct)
        self._rewrite_time_s = 0.0
        self._rw_bits_before = 0
        self._rw_bits_after = 0
        # term uid -> (h1, h2, sign): the device-literal identity of a
        # path-condition term, registered by bridge.lane_constraints at
        # lift time (symtape.node_hash is content-addressed, so the
        # SAME condition re-lowered in a later round or a sibling lane
        # hashes identically). Backs build_inloop_pool — only sets
        # whose every member has a registered literal can be compiled
        # into in-loop clauses.
        self._term_lits: "OrderedDict[int, Tuple[int, int, bool]]" = (
            OrderedDict()
        )
        self.max_term_lits = 8192
        self.pool: Optional[FallbackPool] = None

    # -- internals ------------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    def _add_time(self, dt: float) -> None:
        with self._lock:
            self._time_s += dt

    @staticmethod
    def _key_of(raw_terms: Sequence[Term]) -> frozenset:
        return frozenset(t.uid for t in raw_terms if t is not terms.TRUE)

    def _get_pool(self) -> FallbackPool:
        with self._lock:
            if self.pool is None:
                self.pool = FallbackPool(self)
            return self.pool

    # -- lookup / record ------------------------------------------------

    def lookup(self, raw_terms: Sequence[Term]) -> Tuple[Optional[int], frozenset]:
        """(verdict or None, exact key). Checks: trivial, exact key,
        UNSAT-superset subsumption, alpha key (promoting alpha hits to
        the exact table)."""
        code, key, _digest = self._lookup(raw_terms)
        return code, key

    def _lookup(self, raw_terms: Sequence[Term]):
        """lookup plus the alpha digest IF one was computed (None =
        computed but uncanonicalizable, _NO_DIGEST = not attempted).
        decide_batch threads the digest into record() so a set is
        alpha-hashed at most once per decision."""
        if any(t is terms.FALSE for t in raw_terms):
            return UNSAT, frozenset(), _NO_DIGEST
        key = self._key_of(raw_terms)
        if not key:
            return SAT, key, _NO_DIGEST
        with self._lock:
            code = self._exact.get(key)
            if code is not None:
                self._exact.move_to_end(key)
                self._stats["hits_exact"] += 1
                return code, key, _NO_DIGEST
            for fs in self._unsat_sets:
                if fs <= key:
                    self._stats["hits_subsume"] += 1
                    self._promote(key, UNSAT)
                    return UNSAT, key, _NO_DIGEST
            alpha_live = bool(self._alpha)
        # an empty alpha table cannot hit: skip the O(DAG) digest work
        # entirely (the common case on a fresh analysis — record() fills
        # the table only with decided verdicts)
        if not alpha_live:
            return None, key, _NO_DIGEST
        digest = canonical_fingerprint(raw_terms)
        if digest is not None:
            with self._lock:
                code = self._alpha.get(digest)
                if code is not None:
                    self._alpha.move_to_end(digest)
                    self._stats["hits_alpha"] += 1
                    self._promote(key, code)
                    return code, key, digest
        return None, key, digest

    def _promote(self, key: frozenset, code: int) -> None:
        """Install a derived verdict in the exact table (lock held)."""
        self._exact[key] = code
        self._exact.move_to_end(key)
        while len(self._exact) > self.max_entries:
            self._exact.popitem(last=False)

    def record(
        self,
        raw_terms: Sequence[Term],
        code: int,
        key: Optional[frozenset] = None,
        model: Optional[dict] = None,
        path_fp: Optional[int] = None,
        digest=None,
    ) -> None:
        """Fold one verdict (and optionally its model) into the tables.
        ``digest`` forwards an alpha digest already computed by
        _lookup (pass _NO_DIGEST-sentinel-free values only)."""
        if key is None:
            key = self._key_of(raw_terms)
        if not key:
            return
        if code in (SAT, UNSAT):
            if digest is None:
                digest = canonical_fingerprint(raw_terms)
        else:
            digest = None
        with self._lock:
            self._exact[key] = code
            self._exact.move_to_end(key)
            while len(self._exact) > self.max_entries:
                self._exact.popitem(last=False)
            if digest is not None:
                self._alpha[digest] = code
                self._alpha.move_to_end(digest)
                while len(self._alpha) > self.max_entries:
                    self._alpha.popitem(last=False)
            if code == UNSAT:
                self._unsat_sets[key] = None
                self._unsat_sets.move_to_end(key)
                while len(self._unsat_sets) > self.max_unsat:
                    self._unsat_sets.popitem(last=False)
            if code == SAT and model:
                self._models[key] = model
                if path_fp is not None:
                    self._models[path_fp] = model
                while len(self._models) > self.max_models:
                    self._models.popitem(last=False)

    def model_hint(self, prefix_fps) -> Optional[dict]:
        """The nearest-ancestor cached model for a lane's path-prefix
        fingerprint chain (warm-start hint; staleness is harmless)."""
        if not prefix_fps:
            return None
        with self._lock:
            for fp in reversed(prefix_fps):
                model = self._models.get(fp)
                if model is not None:
                    return model
        return None

    # -- in-loop solve pool ------------------------------------

    def note_path_literal(self, uid: int, h1: int, h2: int, sign: bool) -> None:
        """Register a path-condition term's device-literal identity.

        Called by the bridge at lift time for every path entry it turns
        into a host constraint: ``uid`` is the hash-consed term uid the
        memo/subsumption tables key on, ``(h1, h2)`` the symtape content
        hash of the underlying word, ``sign`` the branch direction
        (True asserts word != 0). Idempotent; bounded LRU."""
        with self._lock:
            self._term_lits[uid] = (int(h1), int(h2), bool(sign))
            self._term_lits.move_to_end(uid)
            while len(self._term_lits) > self.max_term_lits:
                self._term_lits.popitem(last=False)

    def build_inloop_pool(self, max_vars=None, max_clauses=None, max_width=None):
        """Compile the recorded must-UNSAT sets into the fixed-shape
        in-loop CNF pool (inloop_solve.InloopPool).

        Every emitted clause is the negation of one ``_unsat_sets``
        entry — a constraint set a HOST decider proved UNSAT — whose
        members all have registered device literals, so a device kill
        against this pool is subsumed by a host verdict by
        construction (docs/SOLVER.md verdict-authority contract). Sets
        wider than ``max_width`` or touching unregistered terms are
        skipped (they stay host-only); most-recent facts win the fixed
        clause budget. Always returns a FULL-CAPACITY pool (unused
        clause slots inert) so the megakernel sees one stable shape;
        with no usable facts the kernel's syntactic R1/R3 rules still
        fire."""
        from mythril_tpu_torch.laser.cuda import inloop_solve

        if max_vars is None:
            max_vars = inloop_solve.POOL_VARS
        if max_clauses is None:
            max_clauses = inloop_solve.POOL_CLAUSES
        if max_width is None:
            max_width = inloop_solve.POOL_WIDTH
        with self._lock:
            unsat_sets = list(self._unsat_sets)
            lits = dict(self._term_lits)
        var_index: Dict[Tuple[int, int], int] = {}
        clauses: List[List[Tuple[int, bool]]] = []
        for fs in reversed(unsat_sets):  # most recent first
            if len(clauses) >= max_clauses:
                break
            if not 0 < len(fs) <= max_width:
                continue
            entry = [lits.get(uid) for uid in fs]
            if any(e is None for e in entry):
                continue
            # distinct terms can share a word with opposite signs; both
            # map onto ONE var with literal polarity = sign
            need = {(h1, h2) for (h1, h2, _sign) in entry}
            new = [v for v in need if v not in var_index]
            if len(var_index) + len(new) > max_vars:
                continue
            for v in new:
                var_index[v] = len(var_index)
            clauses.append(
                [(var_index[(h1, h2)], sign) for (h1, h2, sign) in entry]
            )
        with self._lock:
            self._stats["inloop_pool_builds"] += 1
            self._stats["inloop_pool_clauses"] = len(clauses)
        # ALWAYS full-capacity shapes: the pool feeds a static-shape
        # megakernel argument, so a content-sized pool would force an
        # XLA recompile the moment the first fact lands mid-analysis.
        # Unused slots are inert (lit_used False -> clause inactive).
        V, C, W = max_vars, max_clauses, max_width
        var_h1 = [0] * V
        var_h2 = [0] * V
        for (h1, h2), i in var_index.items():
            var_h1[i] = h1
            var_h2[i] = h2
        lit_var = [[0] * W for _ in range(C)]
        lit_neg = [[False] * W for _ in range(C)]
        lit_used = [[False] * W for _ in range(C)]
        for ci, clause in enumerate(clauses):
            for wi, (vi, sign) in enumerate(clause):
                lit_var[ci][wi] = vi
                # the UNSAT set asserted (word == sign); the clause is
                # its negation, so the literal wants the opposite:
                # sign True  -> literal satisfied when word == 0
                lit_neg[ci][wi] = sign
                lit_used[ci][wi] = True
        # host tensors: the backend pins the pool on the card once per
        # super-round (transfer.pool_to_device)
        return inloop_solve.make_pool(
            var_h1, var_h2, lit_var, lit_neg, lit_used, device="cpu"
        )

    # -- the round-loop entry point --------------------------------------

    def decide_batch(
        self,
        sets: Sequence[Sequence[Term]],
        use_device: bool = True,
        flips: int = 384,
        hints: Optional[Sequence] = None,
        host_fallback: bool = True,
        static_unsat: Optional[Sequence[bool]] = None,
        interval_seeds: Optional[Sequence] = None,
        device="cuda",
    ) -> List[Optional[bool]]:
        """Decide a frontier of constraint sets: memo -> device batch ->
        inline quick host check -> async pool.

        Returns True (feasible) / False (infeasible) / None (unknown —
        the caller should treat the lane as possible; the async pool
        may fold an UNSAT in later, which subsumption then applies to
        the lane's descendants). ``host_fallback=False`` stops after
        the device dispatch (the lazy-screen triage path: unknown parks
        go to settlement, not to the host).
        ``device`` is where the device batch runs (the backend passes its
        DEVICE).

        ``static_unsat[i]`` marks sets the static taint pass proved
        contradictory (a MUST branch-verdict conflicting with the lane's
        recorded branch sign): they short-circuit to False without any
        solve, and the UNSAT is recorded so subsumption prunes the
        lane's descendants too.

        ``interval_seeds[i]`` optionally maps term uids of set ``i`` to
        MUST value intervals from the static fact planes (the bridge
        attaches them from StaticAnalysis.cond_intervals). They feed the
        stage-3 rewrite pass, which runs over every undecided set ahead
        of the memo lookup (MYTHRIL_TPU_REWRITE=0 disables it): all
        downstream keys — exact, alpha, subsumption — are computed over
        the REWRITTEN forms, so canonicalization itself widens the memo's
        reach. A set the rewrite/interval engine decides outright never
        touches a solver; its single-term false core is recorded as a
        maximal subsumption seed, and structurally-proven cores feed the
        process-global known-unsat facts the bridge prunes on. Before a
        solve, a cached ancestor witness is replayed against the
        rewritten set (assume.try_witness): a concrete satisfying
        assignment answers SAT with zero blasting.

        Host economics: when the device DID run, its residue goes to
        the ASYNC pool only (and only in service mode — see _pool_armed)
        — a blocking 100 ms host check per unknown was measured to
        dominate round wall time on unknown-heavy workloads (BECStress:
        ~100% of deep instances), and the round loop treating unknown
        as possible is exactly Constraints.is_possible semantics with
        settlement re-solving authoritatively before any report. The
        inline quick check runs only when the device did NOT run
        (pre-warmup / sub-floor frontiers): there it is the only
        pruning the frontier gets."""
        from mythril_tpu_torch.laser.cuda import solver
        from mythril_tpu_torch.laser.cuda import _build

        t0 = time.monotonic()
        n = len(sets)
        _span = obs.TRACER.begin("decide_batch", tid="solve", n=n)
        self._count("queries", n)
        if n:
            self._count("round_batches")
        verdicts: List[Optional[bool]] = [None] * n
        keys: List[Optional[frozenset]] = [None] * n
        digests: List[object] = [_NO_DIGEST] * n
        decided = [False] * n
        pending: List[int] = []
        # work[i] is what actually gets keyed and solved: the rewritten
        # residual when the stage-3 pass is on, the raw set otherwise.
        # Rewriting is deterministic and memoized, so the same raw set
        # re-rewrites to the identical (hash-consed) residual next round
        # and the exact/alpha/subsumption keys stay stable.
        work: List[Sequence[Term]] = list(sets)
        rewriting = _rw.enabled()
        for i, cs in enumerate(sets):
            if static_unsat is not None and static_unsat[i]:
                # statically proven contradiction: no lookup, no solve;
                # record the UNSAT so supersets subsume without re-proof
                verdicts[i] = False
                decided[i] = True
                self._count("static_unsat_seeds")
                self.record(cs, UNSAT)
                continue
            if rewriting:
                seeds_i = (
                    interval_seeds[i] if interval_seeds is not None else None
                )
                rt0 = time.monotonic()
                try:
                    oc = _rw.rewrite_set(cs, seeds=seeds_i)
                except Exception as e:  # pragma: no cover - defensive
                    # the rewrite must never be the reason a set fails
                    # to reach a solver: fall back to the raw terms
                    log.warning("rewrite_set failed (raw terms used): %s", e)
                    oc = None
                with self._lock:
                    self._rewrite_time_s += time.monotonic() - rt0
                    if oc is not None:
                        self._rw_bits_before += oc.bits_before
                        self._rw_bits_after += oc.bits_after
                if oc is not None:
                    work[i] = list(oc.terms)
                    if oc.verdict is False:
                        verdicts[i] = False
                        decided[i] = True
                        self._count("rewrite_discharged")
                        # the singleton core is a MAXIMAL subsumption
                        # seed: any superset of {core} is UNSAT
                        if oc.false_core is not None:
                            self.record((oc.false_core,), UNSAT)
                            if oc.core_is_structural:
                                for t in (oc.false_core, oc.false_source):
                                    if t is not None and t is not terms.FALSE:
                                        _rw.note_unsat_term(t)
                        continue
                    if oc.verdict is True:
                        verdicts[i] = True
                        decided[i] = True
                        self._count("rewrite_discharged")
                        continue
            code, key, digest = self._lookup(work[i])
            keys[i] = key
            digests[i] = digest
            if code is None:
                if rewriting and hints is not None and hints[i]:
                    # assumption reuse: the parent's cached witness is a
                    # total assignment; if it concretely satisfies every
                    # rewritten member, the child is SAT with that very
                    # model — no blast, no solve
                    model = self.model_hint(hints[i])
                    if model is not None and _rw.try_witness(work[i], model):
                        verdicts[i] = True
                        decided[i] = True
                        self._count("assumption_reuse")
                        self.record(
                            work[i],
                            SAT,
                            key=key,
                            model=model,
                            path_fp=hints[i][-1],
                            digest=self._digest_or_none(digest),
                        )
                        continue
                pending.append(i)
                continue
            decided[i] = True
            if code == SAT:
                verdicts[i] = True
            elif code == UNSAT:
                verdicts[i] = False
            # cached UNKNOWN: stay None, but do NOT re-solve (the whole
            # point: this set already exhausted both budgets)

        # device_ok distinguishes "the device ran and left residue"
        # (optimistic + async is correct) from "the dispatch FAILED"
        # (the residue was never solved: degrade to the inline host
        # path, and above all write no UNKNOWN memos for it — a fault
        # is not an exhausted budget)
        device_ok = True
        if use_device and pending:
            sub = [work[i] for i in pending]
            warm = None
            if hints is not None:
                warm = [self.model_hint(hints[i]) for i in pending]
            dev_models: List[Optional[dict]] = [None] * len(sub)
            _cat.SOLVER_BATCHES_TOTAL.inc()
            try:
                with obs.TRACER.span("solver_batch", tid="solve", n=len(sub)):
                    out = solver.feasibility_batch(
                        sub, flips=flips, models=warm, return_models=True,
                        device=device,
                    )
            except TypeError:
                # narrower legacy signature (test doubles)
                try:
                    out = solver.feasibility_batch(sub, flips=flips)
                except Exception as e:  # pragma: no cover - device degrade
                    _build.reraise_kernel_fault(e)
                    log.warning("device feasibility batch failed: %s", e)
                    device_ok = False
                    out = [None] * len(sub)
            except Exception as e:
                # a failed kernel is a fault of the port, never a host run
                _build.reraise_kernel_fault(e)
                log.warning("device feasibility batch failed: %s", e)
                device_ok = False
                out = [None] * len(sub)
            if isinstance(out, tuple):
                dev_verdicts, dev_models = out
            else:
                dev_verdicts = out
            for j, i in enumerate(pending):
                v = dev_verdicts[j]
                if v is None:
                    continue
                verdicts[i] = v
                decided[i] = True
                self._count("device_decided")
                fp = None
                if hints is not None and hints[i]:
                    fp = hints[i][-1]
                self.record(
                    work[i],
                    SAT if v else UNSAT,
                    key=keys[i],
                    model=dev_models[j],
                    path_fp=fp,
                    digest=self._digest_or_none(digests[i]),
                )
            pending = [i for i in pending if not decided[i]]

        if host_fallback and pending:
            deadline, cancel_event = _job_context()
            pool_armed = self._pool_armed(cancel_event, deadline)
            for i in pending:
                if use_device and device_ok:
                    # device residue: optimistic + async (see docstring)
                    self._count("unknown")
                    self.record(work[i], UNKNOWN, key=keys[i])
                    if pool_armed:
                        self._get_pool().submit(
                            keys[i],
                            work[i],
                            deadline=deadline,
                            cancel_event=cancel_event,
                        )
                    continue
                try:
                    code = _host_check(work[i], HOST_BUDGET_MS)
                except Exception as e:
                    # faulted host check: stay optimistic (None verdict)
                    # and record NOTHING — no UNKNOWN memo may remember
                    # a failure as if both budgets had been spent
                    log.warning("host check failed (no memo written): %s", e)
                    continue
                if code == SAT:
                    verdicts[i] = True
                    self._count("host_decided")
                    self.record(
                        work[i], SAT, key=keys[i],
                        digest=self._digest_or_none(digests[i]),
                    )
                elif code == UNSAT:
                    verdicts[i] = False
                    self._count("host_decided")
                    self.record(
                        work[i], UNSAT, key=keys[i],
                        digest=self._digest_or_none(digests[i]),
                    )
                    if rewriting:
                        self._minimize_and_seed(work[i], get_core())
                else:
                    self._count("unknown")
                    self.record(work[i], UNKNOWN, key=keys[i])
                    if pool_armed:
                        self._get_pool().submit(
                            keys[i],
                            work[i],
                            deadline=deadline,
                            cancel_event=cancel_event,
                        )
        self._add_time(time.monotonic() - t0)
        obs.TRACER.end(_span)
        return verdicts

    @staticmethod
    def _digest_or_none(digest) -> Optional[bytes]:
        return None if digest is _NO_DIGEST else digest

    def _minimize_and_seed(self, raw_terms: Sequence[Term], core) -> None:
        """Shrink a fresh host UNSAT to its shortest prefix core and
        feed it back: a shorter UNSAT set subsumes strictly more
        supersets, and a single-term core (host-proven, hence holding
        for every assignment) becomes a global known-unsat prune fact.
        Best-effort: probes ride the warm core under assumptions and
        any failure leaves the already-recorded full verdict intact."""
        try:
            prefix = _rw.minimize_unsat_prefix(core, raw_terms)
        except Exception as e:  # pragma: no cover - defensive
            log.warning("unsat core minimization failed: %s", e)
            return
        if prefix is None:
            return
        concrete = sum(1 for t in raw_terms if t is not terms.TRUE)
        if len(prefix) < concrete:
            self._count("core_minimized")
            self.record(prefix, UNSAT)
        if len(prefix) == 1:
            _rw.note_unsat_term(prefix[0])

    def _pool_armed(self, cancel_event, deadline) -> bool:
        """The async pool engages only in SERVICE mode (a job context is
        installed, or a pool was armed explicitly). A lone CLI/bench
        analysis must not spawn host CDCL worker threads: the solver is
        pure Python, so workers contend with the round loop for the GIL
        and were measured to starve it outright on CPU backends."""
        return (
            self.pool is not None
            or cancel_event is not None
            or deadline is not None
        )

    # -- cross-job memo sharing (service/cache.py) -----------------------

    def export_memo(self, limit: int = 4096) -> Dict[bytes, int]:
        """The most recent decided alpha entries (structure-keyed —
        stable across processes and resubmissions)."""
        with self._lock:
            items = list(self._alpha.items())
        return dict(items[-limit:])

    def seed_memo(self, memo: Optional[Dict[bytes, int]]) -> None:
        if not memo:
            return
        with self._lock:
            for digest, code in memo.items():
                if code in (SAT, UNSAT) and digest not in self._alpha:
                    self._alpha[digest] = code
            while len(self._alpha) > self.max_entries:
                self._alpha.popitem(last=False)

    # -- stats ----------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._stats)
            out["time_s"] = self._time_s
            out["rewrite_time_s"] = self._rewrite_time_s
            out["rewrite_bits_before"] = self._rw_bits_before
            out["rewrite_bits_after"] = self._rw_bits_after
        pool = self.pool
        if pool is not None:
            out["inflight_p95"] = pool.inflight_p95()
            out["pending"] = pool.pending()
        else:
            out["inflight_p95"] = 0
            out["pending"] = 0
        out["hits"] = out["hits_exact"] + out["hits_alpha"] + out["hits_subsume"]
        return out

    def stats(self) -> Dict[str, float]:
        return self.snapshot()

    def hit_rate(self) -> float:
        s = self.snapshot()
        return (s["hits"] / s["queries"]) if s["queries"] else 0.0

    def reset(self) -> None:
        with self._lock:
            self._exact.clear()
            self._alpha.clear()
            self._unsat_sets.clear()
            self._models.clear()
            self._term_lits.clear()
            self._stats = {k: 0 for k in _STAT_KEYS}
            self._time_s = 0.0
            self._rewrite_time_s = 0.0
            self._rw_bits_before = 0
            self._rw_bits_after = 0
            pool = self.pool
        if pool is not None:
            with pool._lock:
                pool._queue.clear()
                pool._inflight_keys.clear()
                pool._inflight_samples.clear()


GLOBAL = SolverCache()


def warm_device(constraint_sets, flips: Optional[int] = None, device="cuda") -> None:
    """Run one device solver batch (backend warmup passthrough, keeping
    direct solver calls inside this boundary)."""
    from mythril_tpu_torch.laser.cuda import solver

    solver.check_batch(constraint_sets, flips=flips, device=device)


def reset_for_tests() -> None:
    # NOTE: the process-global incremental host core is deliberately NOT
    # reset here — conftest calls this per test, and re-blasting every
    # test from a cold core multiplies suite wall time. Callers that
    # need verdict determinism against a loaded core (the A/B bench
    # arms, the rewrite-pass property tests) reset get_core() themselves.
    GLOBAL.reset()
    clear_job_context()
    _rw.reset_for_tests()
