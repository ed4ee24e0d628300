"""Deterministic, env-gated fault injection at the pipeline's seams.

Production SMT-backed pipelines treat solver timeouts and device
failures as routine inputs, not exceptions; to test that posture the
failure modes themselves must be reproducible. This harness fires
classified exceptions at NAMED seams — the places where the host loop
hands work to something that can actually die:

  ``device_round``      one batched device round (robustness/retry.py
                        guard around backend._run_device)
  ``transfer_up``       host -> device upload (transfer.batch_to_device,
                        entered via bridge.finish)
  ``transfer_down``     device -> host download (transfer.batch_to_host)
  ``solver_batch``      one batched device SAT dispatch
                        (solver_jax.check_batch)
  ``host_solve``        one budgeted host CDCL check
                        (solver_cache._host_check)
  ``fallback_worker``   one FallbackPool work item
                        (solver_cache.FallbackPool.process_once)
  ``scheduler_worker``  one scheduler job attempt
                        (service/scheduler.py _run_attempt)

Spec syntax (``MYTHRIL_TPU_FAULTS`` or :func:`configure`)::

    [seed=N;]seam=kind[:opt,...][;seam=kind[:opt,...]]...

with per-rule options ``p=<float>`` (fire probability per hit, default
1.0), ``n=<int>`` (stop after N fires, default unlimited),
``after=<int>`` (skip the first N hits), ``match=<substr>`` (fire only
when the call site's context string contains the substring — e.g. a job
name). Example::

    MYTHRIL_TPU_FAULTS="seed=7;device_round=oom:n=1;host_solve=timeout:p=0.5"

Firing is deterministic: each rule draws from its own RNG seeded from
``(seed, seam, kind)``, so the same spec over the same call sequence
fires at the same hits. With the variable unset the harness costs one
module-level attribute read per seam crossing.

Fault kinds and the exceptions they raise (every instance carries
``.seam`` and ``.kind`` so handlers and error reports can classify):

  ``oom``           :class:`DeviceOOM` — XLA RESOURCE_EXHAUSTED shape
  ``error``         :class:`DeviceRuntimeFault` — generic XLA runtime
  ``timeout``       :class:`InjectedTimeout`
  ``worker_death``  :class:`WorkerDeath` — kills a pool worker thread
  ``garbage``       :class:`GarbageModel` — undecodable model bytes
  ``crash``         :class:`InjectedCrash` — unexpected worker exception
"""

import logging
import os
import random
import zlib
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

ENV_VAR = "MYTHRIL_TPU_FAULTS"

DEVICE_ROUND = "device_round"
TRANSFER_UP = "transfer_up"
TRANSFER_DOWN = "transfer_down"
SOLVER_BATCH = "solver_batch"
HOST_SOLVE = "host_solve"
FALLBACK_WORKER = "fallback_worker"
SCHEDULER_WORKER = "scheduler_worker"

SEAMS = (
    DEVICE_ROUND,
    TRANSFER_UP,
    TRANSFER_DOWN,
    SOLVER_BATCH,
    HOST_SOLVE,
    FALLBACK_WORKER,
    SCHEDULER_WORKER,
)


class FaultSpecError(ValueError):
    """The MYTHRIL_TPU_FAULTS spec is malformed."""


class InjectedFault(RuntimeError):
    """Base of every injected exception; carries the seam it fired at."""

    def __init__(self, message: str, seam: str = "?", kind: str = "?"):
        super().__init__(message)
        self.seam = seam
        self.kind = kind


class DeviceOOM(InjectedFault):
    """Injected device allocation failure (XLA RESOURCE_EXHAUSTED)."""


class DeviceRuntimeFault(InjectedFault):
    """Injected generic XLA runtime error."""


class InjectedTimeout(InjectedFault):
    """Injected timeout (hung tunnel / hung solve)."""


class WorkerDeath(InjectedFault):
    """Injected worker-thread death: the catching loop must EXIT (a real
    dead worker does not keep polling) and the pool must respawn."""


class GarbageModel(InjectedFault):
    """Injected garbage model bytes from a device solve: the verdict is
    undecodable and must settle as UNKNOWN, never as SAT/UNSAT."""


class InjectedCrash(InjectedFault):
    """Injected unexpected exception in a worker/job path."""


_KIND_MESSAGES = {
    "oom": (
        DeviceOOM,
        "RESOURCE_EXHAUSTED: out of memory allocating device buffer "
        "(injected at seam %r)",
    ),
    "error": (
        DeviceRuntimeFault,
        "XLA runtime error: computation failed (injected at seam %r)",
    ),
    "timeout": (InjectedTimeout, "operation timed out (injected at seam %r)"),
    "worker_death": (WorkerDeath, "worker died (injected at seam %r)"),
    "garbage": (
        GarbageModel,
        "garbage model bytes: cannot decode witness (injected at seam %r)",
    ),
    "crash": (InjectedCrash, "unexpected crash (injected at seam %r)"),
}

KINDS = tuple(_KIND_MESSAGES)


class _Rule:
    """One ``seam=kind:opts`` clause with its own deterministic RNG."""

    __slots__ = ("seam", "kind", "p", "n", "after", "match", "hits", "fired", "rng")

    def __init__(self, seam, kind, p, n, after, match, seed):
        self.seam = seam
        self.kind = kind
        self.p = p
        self.n = n
        self.after = after
        self.match = match
        self.hits = 0
        self.fired = 0
        # stable per-rule stream: zlib.crc32 (unlike hash()) does not
        # vary with PYTHONHASHSEED, so the same spec replays exactly
        self.rng = random.Random(
            (seed << 20) ^ zlib.crc32(("%s=%s" % (seam, kind)).encode())
        )

    def maybe(self, context: Optional[str]) -> Optional[InjectedFault]:
        if self.match is not None and self.match not in (context or ""):
            return None
        self.hits += 1
        if self.hits <= self.after:
            return None
        if self.n is not None and self.fired >= self.n:
            return None
        if self.p < 1.0 and self.rng.random() >= self.p:
            return None
        self.fired += 1
        cls, template = _KIND_MESSAGES[self.kind]
        return cls(template % self.seam, seam=self.seam, kind=self.kind)


class FaultPlan:
    """A parsed spec: rules grouped per seam, plus firing counters."""

    def __init__(self, rules: List[_Rule], seed: int, spec: str):
        self.seed = seed
        self.spec = spec
        self.rules: Dict[str, List[_Rule]] = {}
        for rule in rules:
            self.rules.setdefault(rule.seam, []).append(rule)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        seed = 0
        clauses = [c.strip() for c in spec.split(";") if c.strip()]
        if clauses and clauses[0].startswith("seed="):
            try:
                seed = int(clauses[0][5:])
            except ValueError:
                raise FaultSpecError("bad seed in fault spec: %r" % clauses[0])
            clauses = clauses[1:]
        rules = []
        for clause in clauses:
            if "=" not in clause:
                raise FaultSpecError("bad fault clause (no '='): %r" % clause)
            seam, _, rest = clause.partition("=")
            seam = seam.strip()
            if seam not in SEAMS:
                raise FaultSpecError(
                    "unknown seam %r (valid: %s)" % (seam, ", ".join(SEAMS))
                )
            kind, _, opt_str = rest.partition(":")
            kind = kind.strip()
            if kind not in _KIND_MESSAGES:
                raise FaultSpecError(
                    "unknown fault kind %r (valid: %s)" % (kind, ", ".join(KINDS))
                )
            p, n, after, match = 1.0, None, 0, None
            for opt in filter(None, (o.strip() for o in opt_str.split(","))):
                name, _, value = opt.partition("=")
                try:
                    if name == "p":
                        p = float(value)
                    elif name == "n":
                        n = int(value)
                    elif name == "after":
                        after = int(value)
                    elif name == "match":
                        match = value
                    else:
                        raise FaultSpecError("unknown fault option %r" % opt)
                except ValueError:
                    raise FaultSpecError("bad value in fault option %r" % opt)
            rules.append(_Rule(seam, kind, p, n, after, match, seed))
        return cls(rules, seed, spec)

    def maybe(self, seam: str, context: Optional[str]) -> Optional[InjectedFault]:
        for rule in self.rules.get(seam, ()):
            exc = rule.maybe(context)
            if exc is not None:
                return exc
        return None

    def counts(self) -> Dict[str, int]:
        """Fired-fault count per seam (observability/tests)."""
        return {
            seam: sum(r.fired for r in rules)
            for seam, rules in self.rules.items()
        }

    def total_fired(self) -> int:
        return sum(self.counts().values())


# [plan-or-None] once loaded; empty until the first fire()/active() call
# so importing this module never reads the environment eagerly
_STATE: List[Optional[FaultPlan]] = []


def _load() -> Optional[FaultPlan]:
    if not _STATE:
        spec = os.environ.get(ENV_VAR, "").strip()
        plan = FaultPlan.parse(spec) if spec else None
        if plan is not None:
            log.warning(
                "fault injection ARMED (%s=%r): this process will fail "
                "on purpose", ENV_VAR, spec,
            )
        _STATE.append(plan)
    return _STATE[0]


def configure(spec: Optional[str]) -> Optional[FaultPlan]:
    """Install a fault plan directly (tests); ``None`` disarms. Returns
    the installed plan."""
    plan = FaultPlan.parse(spec) if spec else None
    _STATE.clear()
    _STATE.append(plan)
    return plan


def reset() -> None:
    """Forget any plan; the next crossing re-reads the environment."""
    _STATE.clear()


def active() -> Optional[FaultPlan]:
    """The armed plan, or None (loads from the environment on first use)."""
    return _load()


def fire(seam: str, context: Optional[str] = None) -> None:
    """Cross a seam: raise the planned fault if one is armed for it.

    The disarmed path — the production default — is one list check.
    ``context`` is a free-form call-site string (job name, phase) the
    spec's ``match=`` option filters on.
    """
    plan = _STATE[0] if _STATE else _load()
    if plan is None:
        return
    exc = plan.maybe(seam, context)
    if exc is not None:
        from mythril_tpu_torch import obs
        from mythril_tpu_torch.obs import catalog

        catalog.FAULTS_INJECTED_TOTAL.inc(1.0, seam)
        obs.TRACER.mark(
            "fault_injected", seam=seam, kind=type(exc).__name__,
            context=context,
        )
        log.warning("injecting %s at seam %r (context=%r)",
                    type(exc).__name__, seam, context)
        raise exc
