"""Static bytecode pre-analysis pass (CFG recovery + stack abstract
interpretation) feeding the host LASER engine and the TPU batch engine.

Runs ONCE per contract before symbolic execution:

1. basic-block decomposition with a verified JUMPDEST set (blocks.py);
2. a stack-height + constant-propagation abstract interpreter resolving
   PUSH-fed and constant-folded computed JUMP/JUMPI targets into a sound
   over-approximate successor table (absint.py);
3. per-block facts — reachability from dispatch, static stack delta,
   interesting-op distance, must-revert/dead blocks — exported as dense
   NumPy tables (tables.py);
4. a second, flow-sensitive stage (dataflow.py + taint.py): taint
   reachability from calldata/ORIGIN/call returns, storage-effect and
   call-ordering summaries, value intervals, and the per-PC
   detector-relevance / SWC candidate planes built from them.

Consumers: laser/tpu/batch.py make_code_bank (device jumpdest +
must-revert + swc_mask bitmaps), laser/evm/instructions.py (host
JUMP/JUMPI fast path over resolved targets), laser/evm/strategy/basic.py
(StaticDistanceWeightedStrategy), the detection probe (probe.py), the
hook-dispatch gate (analysis/module/gating.py), and the solver cache's
static must-UNSAT seeding (laser/tpu/solver_cache.py via bridge.py).

Results are cached per bytecode. (The reference's obs counters and
spans are left out: the observability layer is not ported yet.)

See docs/STATIC_PASS.md and docs/TAINT_PASS.md for the lattices and the
soundness arguments.
"""

from collections import OrderedDict
from typing import Union

from mythril_tpu_torch.analysis.static_pass.blocks import (
    INTERESTING,
    BasicBlock,
    Insn,
    decompose,
    scan,
)
from mythril_tpu_torch.analysis.static_pass.tables import (
    FACT_SCHEMA_VERSION,
    INTEREST_INF,
    MAX_SUCC,
    StaticAnalysis,
    build,
)
from mythril_tpu_torch.analysis.static_pass.taint import (
    FACT_BITS,
    SWC_MASK_BITS,
    TAINT_ALL,
    TAINT_CALLDATA,
    TAINT_CALLRET,
    TAINT_ORIGIN,
)

__all__ = [
    "FACT_BITS",
    "FACT_SCHEMA_VERSION",
    "INTERESTING",
    "INTEREST_INF",
    "MAX_SUCC",
    "SWC_MASK_BITS",
    "TAINT_ALL",
    "TAINT_CALLDATA",
    "TAINT_CALLRET",
    "TAINT_ORIGIN",
    "BasicBlock",
    "Insn",
    "StaticAnalysis",
    "analyze",
    "build",
    "decompose",
    "scan",
]

# analyses are small (a few dense arrays per contract) but the cache must
# not grow without bound in a long-lived service process
_CACHE_CAP = 512
_CACHE: "OrderedDict[bytes, StaticAnalysis]" = OrderedDict()


def _to_bytes(code: Union[bytes, bytearray, str]) -> bytes:
    if isinstance(code, str):
        code = bytes.fromhex(code[2:] if code.startswith("0x") else code)
    return bytes(code)


def analyze(code: Union[bytes, bytearray, str]) -> StaticAnalysis:
    """Cached entry point: bytecode (bytes or hex string) -> tables."""
    code = _to_bytes(code)
    hit = _CACHE.get(code)
    if hit is not None:
        _CACHE.move_to_end(code)
        return hit
    result = build(code)
    _CACHE[code] = result
    while len(_CACHE) > _CACHE_CAP:
        _CACHE.popitem(last=False)
    return result
