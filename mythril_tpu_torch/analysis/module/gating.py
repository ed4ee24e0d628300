"""Static-fact gating of detection-module hook dispatch.

Pre-hooks for the modules registered in static_pass.taint.FACT_BITS are
wrapped so that a dispatch is skipped when the static
``module_relevance`` plane proves the module cannot produce work at the
state's current pc. The invariant (docs/TAINT_PASS.md) is:

    a gate may skip work, never an issue.

Everything here fails OPEN — no static tables, an out-of-range pc, a
disabled gate, or a nested call frame all dispatch normally:

* nested frames (transaction_stack depth > 1) are never gated because
  the relevance planes are per-code facts about paths from THIS code's
  dispatch entry; annotations and reentrancy windows can flow in from
  the caller's frame, which those facts know nothing about;
* modules not named in FACT_BITS are only counted, never gated.

Counters feed the bench protocol (``hook_dispatches_skipped``) and the
detection-parity test, which runs gated vs ungated and asserts identical
issue sets with > 0 skips.
"""

import os
from typing import Callable

from mythril_tpu_torch.analysis.static_pass.taint import FACT_BITS
from mythril_tpu_torch.obs import catalog as _cat

# kill switch for A/B parity runs: MYTHRIL_TPU_HOOK_GATE=0 disables the
# gate without touching the wrappers (dispatch counting stays live)
_ENV_FLAG = "MYTHRIL_TPU_HOOK_GATE"

_enabled = os.environ.get(_ENV_FLAG, "1") != "0"


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    """Programmatic toggle (tests); overrides the env default."""
    global _enabled
    _enabled = bool(value)


def stats() -> dict:
    """Thin view over the obs registry (obs/catalog.py)."""
    return {
        "dispatched": int(_cat.HOOK_DISPATCHES_TOTAL.value()),
        "skipped": int(_cat.HOOK_SKIPPED_TOTAL.value()),
    }


def reset_stats() -> None:
    _cat.HOOK_DISPATCHES_TOTAL.reset()
    _cat.HOOK_SKIPPED_TOTAL.reset()


def relevant(analysis, bit: int, pc: int) -> bool:
    """MAY the module owning ``bit`` produce work at byte ``pc``?

    True (dispatch) whenever the fact planes cannot prove otherwise.
    """
    if analysis is None:
        return True
    plane = getattr(analysis, "module_relevance", None)
    if plane is None or not 0 <= pc < analysis.code_len:
        return True
    return bool((int(plane[pc]) >> bit) & 1)


def gate_replay(module, analysis, pc: int, depth_ok: bool) -> bool:
    """Gate decision for the tape-replay channel (laser/tpu/bridge.py),
    which fires ``module.execute`` directly rather than through a
    wrapped hook. True -> dispatch; False -> statically skipped.
    Counters feed the same stats as wrapped dispatch."""
    bit = FACT_BITS.get(type(module).__name__)
    if (
        _enabled
        and depth_ok
        and bit is not None
        and not relevant(analysis, bit, pc)
    ):
        _cat.HOOK_SKIPPED_TOTAL.inc()
        return False
    _cat.HOOK_DISPATCHES_TOTAL.inc()
    return True


def wrap_pre_hook(module) -> Callable:
    """Wrap ``module.execute`` for pre-hook registration.

    Non-FACT_BITS modules get a counting-only wrapper; gated modules
    additionally consult the static relevance plane. The wrapper carries
    ``__self__ = module`` so the batch backend's hook discovery
    (host_op_bytes / tape_replayers_for) keeps seeing the owning module.
    """
    execute = module.execute
    bit = FACT_BITS.get(type(module).__name__)

    if bit is None:

        def counting(global_state):
            _cat.HOOK_DISPATCHES_TOTAL.inc()
            return execute(global_state)

        counting.__self__ = module
        return counting

    def gated(global_state):
        if _enabled and len(global_state.transaction_stack) <= 1:
            analysis = getattr(
                global_state.environment.code, "static_analysis", None
            )
            if analysis is not None:
                try:
                    pc = global_state.get_current_instruction()["address"]
                except IndexError:
                    pc = -1
                if not relevant(analysis, bit, pc):
                    _cat.HOOK_SKIPPED_TOTAL.inc()
                    return None
        _cat.HOOK_DISPATCHES_TOTAL.inc()
        return execute(global_state)

    gated.__self__ = module
    return gated
