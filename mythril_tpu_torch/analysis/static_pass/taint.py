"""Taint + value-interval dataflow: the second static-analysis stage.

Runs over the block CFG (blocks.py, absint.py) through the generic engine in dataflow.py. Each
abstract stack slot is a ``(taint, lo, hi)`` triple:

* ``taint`` — a bitmask of attacker-provenance classes the dynamic value
  MAY carry (TAINT_CALLDATA / TAINT_ORIGIN / TAINT_CALLRET). The lattice
  is the powerset under union; sources the analysis does not model
  (memory, storage, hashes, call return data) produce TAINT_ALL, so the
  static mask over-approximates any taint the host's annotation
  machinery can observe (the soundness property tests assert exactly
  this: dynamic taint at a pc is a subset of the static mask).
* ``[lo, hi]`` — unsigned 256-bit bounds on the dynamic value. Joins
  widen (a bound that grows at a merge point jumps to the extreme), so
  loops converge; MUST facts derived from intervals (``jumpi_verdict``)
  are only emitted when the bound excludes a behaviour on EVERY path.

The per-PC planes compiled here (``TaintFacts``) are folded into
tables.StaticAnalysis and consumed by three layers:

* detector gating (analysis/module/gating.py): ``module_relevance`` —
  a bitset per pc saying which FACT_BITS modules can possibly produce a
  finding there. Invariant: a gate may skip work, never an issue.
* solver seeding (laser/tpu/bridge.py -> solver_cache.py):
  ``jumpi_verdict`` — 1 = the condition is nonzero on every path
  (fall-through infeasible), 2 = zero on every path (taken infeasible).
* device candidate masks (laser/tpu/batch.py CodeBank.swc_mask):
  per-pc SWC candidate bits harvested against the visited plane.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from mythril_tpu_torch.analysis.static_pass import dataflow
from mythril_tpu_torch.analysis.static_pass.absint import _FOLD, MASK, MAX_TRACK
from mythril_tpu_torch.analysis.static_pass.blocks import (
    JUMP,
    JUMPI,
    BasicBlock,
    Insn,
)
from mythril_tpu_torch.support.opcodes import OPCODES

# ---------------------------------------------------------------------------
# taint bits

TAINT_CALLDATA = 1  # message inputs: CALLDATA*, CALLVALUE, CALLER
TAINT_ORIGIN = 2  # ORIGIN
TAINT_CALLRET = 4  # external-call / CREATE results and return data
TAINT_BLOCKENV = 8  # predictable block context: TIMESTAMP/NUMBER/...
TAINT_ALL = TAINT_CALLDATA | TAINT_ORIGIN | TAINT_CALLRET | TAINT_BLOCKENV
# NOT a provenance class: set on every value that is anything other than
# a PUSH immediate (or a DUP/SWAP copy of one). A slot with taint == 0
# is therefore a literal constant in EVERY execution — the host engine
# represents it as a concrete BitVecVal, so probes keying on
# ``.symbolic`` (arbitrary_jump.py) can be gated on it.
TAINT_COMPUTED = 16
_TOP_TAINT = TAINT_ALL | TAINT_COMPUTED

# ---------------------------------------------------------------------------
# per-block storage/call effect bits

EFFECT_SLOAD = 1
EFFECT_SSTORE = 2
EFFECT_EXT_CALL = 4
# an SSTORE in this block may execute after a gas-forwarding external
# call somewhere earlier on a path from the dispatch entry (the SWC-107
# reentrancy-window ordering fact)
EFFECT_CALL_BEFORE_SSTORE = 8

# ---------------------------------------------------------------------------
# detector-relevance bits: module CLASS NAME -> bit index in the per-pc
# module_relevance plane. lint.py's swc_declared rule cross-checks every
# key here against a declared detection-module class, so a renamed or
# deleted module cannot leave a stale gate behind.

FACT_BITS: Dict[str, int] = {
    "AccidentallyKillable": 0,
    "TxOrigin": 1,
    "ExternalCalls": 2,
    "StateChangeAfterCall": 3,
    "PredictableVariables": 4,
    "ArbitraryJump": 5,
    "IntegerArithmetics": 6,
    "MultipleSends": 7,
    "UncheckedRetval": 8,
}

# ---------------------------------------------------------------------------
# device-side SWC candidate-mask bits (CodeBank.swc_mask plane)

SWC_MASK_SUICIDE = 1  # SWC-106
SWC_MASK_ORIGIN = 2  # SWC-115
SWC_MASK_REENTRANCY = 4  # SWC-107

SWC_MASK_BITS = {
    "106": SWC_MASK_SUICIDE,
    "115": SWC_MASK_ORIGIN,
    "107": SWC_MASK_REENTRANCY,
}

# opcode groups (byte values)
_ORIGIN_OP = 0x32
_BLOCKHASH_OP = 0x40
_SLOAD_OP = 0x54
_SSTORE_OP = 0x55
_SUICIDE_OP = 0xFF
_CALL_OP = 0xF1
# integer.py's tag sites and hazard-collection sinks
_ARITH_OPS = frozenset({0x01, 0x02, 0x03, 0x0A})  # ADD, MUL, SUB, EXP
_IA_SINK_OPS = frozenset({0x55, 0x57, 0x00, 0xF3, 0xF1})
# the ops state_change_external_calls.py treats as window-openers
_WINDOW_CALL_OPS = frozenset({0xF1, 0xF2, 0xF4})  # CALL, CALLCODE, DELEGATECALL
_EXT_CALL_OPS = frozenset({0xF0, 0xF1, 0xF2, 0xF4, 0xF5, 0xFA})
_STATE_ACCESS_OPS = frozenset({0x54, 0x55, 0xF0, 0xF5})  # SLOAD/SSTORE/CREATE*

_FULL = (0, MASK)
# unknown slot: any value, any provenance
_TOP_SLOT = (_TOP_TAINT, 0, MASK)

# opcode -> slot pushed, for taint sources and unmodeled loads. Loads
# from memory/storage/return data are TOP because annotated expressions
# round-trip through them on the host (an SSTORE'd origin-tainted value
# SLOADs back WITH its annotations). Every source sets TAINT_COMPUTED:
# its dynamic value is a symbolic expression, not a PUSH literal.
_SOURCE_SLOTS: Dict[int, Tuple[int, int, int]] = {
    0x32: (TAINT_ORIGIN | TAINT_COMPUTED, 0, MASK),  # ORIGIN
    0x33: (TAINT_CALLDATA | TAINT_COMPUTED, 0, MASK),  # CALLER
    0x34: (TAINT_CALLDATA | TAINT_COMPUTED, 0, MASK),  # CALLVALUE
    0x35: (TAINT_CALLDATA | TAINT_COMPUTED, 0, MASK),  # CALLDATALOAD
    0x36: (TAINT_CALLDATA | TAINT_COMPUTED, 0, MASK),  # CALLDATASIZE
    0x41: (TAINT_BLOCKENV | TAINT_COMPUTED, 0, MASK),  # COINBASE
    0x42: (TAINT_BLOCKENV | TAINT_COMPUTED, 0, MASK),  # TIMESTAMP
    0x43: (TAINT_BLOCKENV | TAINT_COMPUTED, 0, MASK),  # NUMBER
    0x44: (TAINT_BLOCKENV | TAINT_COMPUTED, 0, MASK),  # DIFFICULTY
    0x45: (TAINT_BLOCKENV | TAINT_COMPUTED, 0, MASK),  # GASLIMIT
    0x20: _TOP_SLOT,  # SHA3 (reads memory)
    0x31: _TOP_SLOT,  # BALANCE
    0x3B: _TOP_SLOT,  # EXTCODESIZE
    0x3D: _TOP_SLOT,  # RETURNDATASIZE
    0x3F: _TOP_SLOT,  # EXTCODEHASH
    0x40: _TOP_SLOT,  # BLOCKHASH
    0x51: _TOP_SLOT,  # MLOAD
    0x54: _TOP_SLOT,  # SLOAD
    0xF0: (_TOP_TAINT, 0, MASK),  # CREATE
    0xF1: (_TOP_TAINT, 0, 1),  # CALL (success flag)
    0xF2: (_TOP_TAINT, 0, 1),  # CALLCODE
    0xF4: (_TOP_TAINT, 0, 1),  # DELEGATECALL
    0xF5: (_TOP_TAINT, 0, MASK),  # CREATE2
    0xFA: (_TOP_TAINT, 0, 1),  # STATICCALL
}

_CMP_OPS = frozenset({0x10, 0x11, 0x12, 0x13, 0x14, 0x15})


def _arith_safe(
    op: int, a: Tuple[int, int, int], b: Tuple[int, int, int]
) -> bool:
    """MUST fact: the arithmetic op cannot wrap for ANY pair of operand
    values inside the intervals (a = top of stack, b = second)."""
    if op == 0x01:  # ADD
        return a[2] + b[2] <= MASK
    if op == 0x02:  # MUL
        return a[2] * b[2] <= MASK
    if op == 0x03:  # SUB: a - b never borrows
        return a[1] >= b[2]
    if op == 0x0A:  # EXP: base ** exponent
        base_hi, exp_hi = a[2], b[2]
        if base_hi <= 1 or exp_hi == 0:
            return True
        if exp_hi <= 256 and base_hi.bit_length() * exp_hi <= 512:
            return base_hi ** exp_hi <= MASK
        return False
    return False


def _interval(op: int, args: List[Tuple[int, int, int]]) -> Tuple[int, int]:
    """Bounds of the pushed value; args[0] is top of stack, pre-pop."""
    if op in _CMP_OPS:
        return (0, 1)
    if len(args) >= 2:
        _, alo, ahi = args[0]
        _, blo, bhi = args[1]
        if op == 0x01:  # ADD, non-wrapping only
            if ahi + bhi <= MASK:
                return (alo + blo, ahi + bhi)
        elif op == 0x02:  # MUL, non-wrapping only
            if ahi * bhi <= MASK:
                return (alo * blo, ahi * bhi)
        elif op == 0x03:  # SUB, non-borrowing only
            if alo >= bhi:
                return (alo - bhi, ahi - blo)
        elif op == 0x04:  # DIV: result <= numerator
            return (0, ahi)
        elif op == 0x06:  # MOD: result <= numerator and < modulus
            return (0, min(ahi, bhi - 1 if bhi else 0))
        elif op == 0x16:  # AND clears bits
            return (0, min(ahi, bhi))
        elif op == 0x17:  # OR sets bits: at least max(lo), bounded by width
            bits = max(ahi.bit_length(), bhi.bit_length())
            return (max(alo, blo), (1 << bits) - 1 if bits < 256 else MASK)
        elif op == 0x1C:  # SHR: result <= value (args are shift, value)
            return (0, bhi)
    if op == 0x1A:  # BYTE
        return (0, 0xFF)
    return _FULL


class TaintState:
    """Abstract stack of (taint, lo, hi) slots; top at the END of vals."""

    __slots__ = ("vals", "unknown_below")

    def __init__(self, vals: Tuple = (), unknown_below: bool = False):
        self.vals = tuple(vals)
        self.unknown_below = unknown_below

    def copy(self) -> "TaintState":
        return TaintState(self.vals, self.unknown_below)

    def key(self):
        return (self.vals, self.unknown_below)

    def slot(self, depth: int) -> Tuple[int, int, int]:
        """Slot ``depth`` from the top (1 = top); TOP when untracked."""
        if depth <= len(self.vals):
            return self.vals[-depth]
        return _TOP_SLOT


def _join_slot(
    x: Tuple[int, int, int],
    y: Tuple[int, int, int],
    old: Optional[Tuple[int, int, int]],
) -> Tuple[int, int, int]:
    lo, hi = min(x[1], y[1]), max(x[2], y[2])
    if old is not None:
        # widen: a bound still moving at a merge point jumps to the
        # extreme, so interval chains (loop counters) converge fast
        if lo < old[1]:
            lo = 0
        if hi > old[2]:
            hi = MASK
    return (x[0] | y[0], lo, hi)


class TaintDomain:
    """dataflow.Domain over TaintState."""

    def entry_state(self) -> TaintState:
        return TaintState()

    def unknown_state(self) -> TaintState:
        return TaintState((), True)

    def key(self, state: TaintState):
        return state.key()

    def join(self, old: Optional[TaintState], new: TaintState) -> TaintState:
        if old is None:
            return new.copy()
        a, b = old, new
        n = min(len(a.vals), len(b.vals))
        a_tail = a.vals[len(a.vals) - n :]
        b_tail = b.vals[len(b.vals) - n :]
        merged = tuple(
            _join_slot(x, y, x) for x, y in zip(a_tail, b_tail)
        )
        below = a.unknown_below or b.unknown_below or len(a.vals) != len(b.vals)
        return TaintState(merged, below)

    def jump_dest(self, state: TaintState) -> Optional[int]:
        taint, lo, hi = state.slot(1)
        del taint
        return lo if lo == hi else None

    def transfer(self, state: TaintState, insn: Insn) -> TaintState:
        vals = list(state.vals)
        below = state.unknown_below

        def pop() -> Tuple[int, int, int]:
            if vals:
                return vals.pop()
            # past the tracked region (or a dynamic underflow, which
            # faults at runtime) — TOP stays sound either way
            return _TOP_SLOT

        op = insn.op
        if insn.imm is not None:  # PUSH0..PUSH32
            vals.append((0, insn.imm, insn.imm))
        elif 0x80 <= op <= 0x8F:  # DUPk
            k = op - 0x7F
            vals.append(vals[-k] if k <= len(vals) else _TOP_SLOT)
        elif 0x90 <= op <= 0x9F:  # SWAPk
            k = op - 0x8F
            if k + 1 <= len(vals):
                vals[-1], vals[-k - 1] = vals[-k - 1], vals[-1]
            elif vals:
                vals[-1] = _TOP_SLOT
                below = True
        else:
            spec = OPCODES.get(op)
            pops = spec.pops if spec else 0
            pushes = spec.pushes if spec else 0
            args = [pop() for _ in range(pops)]
            if pushes:
                src = _SOURCE_SLOTS.get(op)
                if src is not None:
                    vals.append(src)
                else:
                    taint = TAINT_COMPUTED
                    for a in args:
                        taint |= a[0]
                    fold = _FOLD.get(op)
                    if fold is not None and all(a[1] == a[2] for a in args):
                        v = fold(*[a[1] for a in args])
                        vals.append((taint, v, v))
                    else:
                        lo, hi = _interval(op, args)
                        vals.append((taint, lo, hi))
                    if pushes > 1:  # no EVM op does; stay sound anyway
                        vals.extend([_TOP_SLOT] * (pushes - 1))
        if len(vals) > MAX_TRACK:
            vals = vals[len(vals) - MAX_TRACK :]
            below = True
        return TaintState(tuple(vals), below)


class TaintFacts(NamedTuple):
    """Per-contract fact planes from the taint/interval stage."""

    # OR over all paths of the taint bits of the operands each
    # instruction consumes (TAINT_ALL at statically unreachable pcs)
    taint_mask: np.ndarray  # u8[code_len]
    # MUST branch facts at JUMPI byte-pcs: 0 none, 1 condition nonzero
    # on every path (fall-through infeasible), 2 condition zero on every
    # path (taken infeasible)
    jumpi_verdict: np.ndarray  # i8[code_len]
    # EFFECT_* bits per block
    effect_flags: np.ndarray  # u8[n_blocks]
    # FACT_BITS bitset per pc: which gated modules may produce work here
    module_relevance: np.ndarray  # u32[code_len]
    # SWC_MASK_* candidate bits per pc (device CodeBank plane)
    swc_mask: np.ndarray  # u8[code_len]
    # MUST value bounds on the JUMPI condition word, keyed by JUMPI
    # byte-pc — only sites where the converged interval is strictly
    # narrower than [0, MASK] appear. The stage-3 rewrite pass
    # (analysis/rewrite_pass) consumes these as discharge seeds: the
    # bridge re-keys an entry by the lifted condition term's uid, and
    # interval reasoning then proves/refutes path constraints without
    # blasting (docs/REWRITE_PASS.md). A dict (not a dense plane):
    # values are 256-bit ints numpy cannot hold losslessly.
    cond_intervals: Dict[int, Tuple[int, int]]


def compute(
    insns: Tuple[Insn, ...],
    blocks: Tuple[BasicBlock, ...],
    block_of: dict,
    jumpdests: set,
    code_len: int,
    succ_sets: List[set],
    succ_unknown: np.ndarray,
    jumpdest_blocks: List[int],
) -> TaintFacts:
    """Run the fixpoint and compile the per-PC / per-block fact planes.

    ``succ_sets``/``succ_unknown``/``jumpdest_blocks`` come from the
    stage-1 successor table so the call-ordering fixpoint walks exactly
    the over-approximate CFG the rest of the pass trusts.
    """
    n = len(blocks)
    taint_mask = np.zeros(code_len, np.uint8)
    jumpi_verdict = np.zeros(code_len, np.int8)
    effect_flags = np.zeros(n, np.uint8)
    module_relevance = np.zeros(code_len, np.uint32)
    swc_mask = np.zeros(code_len, np.uint8)

    domain = TaintDomain()
    entry = dataflow.fixpoint(list(blocks), block_of, jumpdests, domain)

    # --- per-pc taint + branch verdicts from the converged states -----
    origin_jumpi: set = set()
    blockenv_jumpi: set = set()
    literal_dest: set = set()  # JUMP/JUMPI pcs with a pure-PUSH dest
    safe_arith: set = set()  # provably non-wrapping ADD/SUB/MUL/EXP pcs
    cond_intervals: Dict[int, Tuple[int, int]] = {}

    def visit(insn: Insn, pre: TaintState) -> None:
        spec = OPCODES.get(insn.op)
        pops = spec.pops if spec else 0
        taint = 0
        for d in range(1, pops + 1):
            taint |= pre.slot(d)[0]
        taint_mask[insn.pc] = taint
        op = insn.op
        if op == JUMPI:
            cond = pre.slot(2)  # [dest, cond] with dest on top
            if cond[0] & TAINT_ORIGIN:
                origin_jumpi.add(insn.pc)
            if cond[0] & TAINT_BLOCKENV:
                blockenv_jumpi.add(insn.pc)
            if cond[1] > 0:
                jumpi_verdict[insn.pc] = 1  # must take
            elif cond[2] == 0:
                jumpi_verdict[insn.pc] = 2  # must fall through
            if (cond[1], cond[2]) != _FULL and cond[1] <= cond[2]:
                cond_intervals[insn.pc] = (cond[1], cond[2])
        if op in (JUMP, JUMPI) and pre.slot(1)[0] == 0:
            literal_dest.add(insn.pc)
        if op in _ARITH_OPS and _arith_safe(op, pre.slot(1), pre.slot(2)):
            safe_arith.add(insn.pc)

    dataflow.sweep(list(blocks), entry, domain, visit)

    # statically unreachable pcs never execute, but stay conservative:
    # full taint, every JUMPI origin/blockenv-relevant, nothing literal
    # or provably safe
    visited_pcs = {
        insn.pc for idx in entry for insn in blocks[idx].insns
    }
    for insn in insns:
        if insn.pc not in visited_pcs:
            taint_mask[insn.pc] = _TOP_TAINT
            if insn.op == JUMPI:
                origin_jumpi.add(insn.pc)
                blockenv_jumpi.add(insn.pc)
            literal_dest.discard(insn.pc)
            safe_arith.discard(insn.pc)
            cond_intervals.pop(insn.pc, None)

    # --- storage-effect summaries + call-before-write ordering --------
    has_window_call = np.zeros(n, bool)
    for b in blocks:
        flags = 0
        for insn in b.insns:
            if insn.op == _SLOAD_OP:
                flags |= EFFECT_SLOAD
            elif insn.op == _SSTORE_OP:
                flags |= EFFECT_SSTORE
            if insn.op in _EXT_CALL_OPS:
                flags |= EFFECT_EXT_CALL
            if insn.op in _WINDOW_CALL_OPS:
                has_window_call[b.index] = True
        effect_flags[b.index] = flags

    # forward MAY fixpoint: can a window-opening call precede this
    # block's entry on some path from the dispatch entry?
    call_entry = np.zeros(n, bool)
    seen = np.zeros(n, bool)
    work = [0] if n else []
    if n:
        seen[0] = True
    while work:
        idx = work.pop()
        out = bool(call_entry[idx] or has_window_call[idx])
        succs = list(succ_sets[idx])
        if succ_unknown[idx]:
            succs.extend(jumpdest_blocks)
        for tgt in succs:
            if not seen[tgt] or (out and not call_entry[tgt]):
                seen[tgt] = True
                call_entry[tgt] = call_entry[tgt] or out
                work.append(tgt)

    call_precedes_pc = np.zeros(code_len, bool)
    for b in blocks:
        # statically unreachable blocks stay conservative (call assumed)
        before = bool(call_entry[b.index]) or not seen[b.index]
        for insn in b.insns:
            if insn.op in _STATE_ACCESS_OPS and before:
                call_precedes_pc[insn.pc] = True
            if insn.op in _WINDOW_CALL_OPS:
                before = True
        if (effect_flags[b.index] & EFFECT_SSTORE) and any(
            call_precedes_pc[i.pc] for i in b.insns if i.op == _SSTORE_OP
        ):
            effect_flags[b.index] |= EFFECT_CALL_BEFORE_SSTORE

    # --- detector relevance + SWC candidate planes --------------------
    kill_bit = 1 << FACT_BITS["AccidentallyKillable"]
    origin_bit = 1 << FACT_BITS["TxOrigin"]
    extcall_bit = 1 << FACT_BITS["ExternalCalls"]
    window_bit = 1 << FACT_BITS["StateChangeAfterCall"]
    pv_bit = 1 << FACT_BITS["PredictableVariables"]
    aj_bit = 1 << FACT_BITS["ArbitraryJump"]
    ia_bit = 1 << FACT_BITS["IntegerArithmetics"]
    sends_bit = 1 << FACT_BITS["MultipleSends"]
    retval_bit = 1 << FACT_BITS["UncheckedRetval"]
    # integer.py's sinks collect hazards tagged anywhere earlier: they
    # are irrelevant only when NO arithmetic in this code can wrap AND
    # no external call can import a tagged value from another frame
    has_ext_call = any(insn.op in _EXT_CALL_OPS for insn in insns)
    ia_hazard = has_ext_call or any(
        insn.op in _ARITH_OPS and insn.pc not in safe_arith
        for insn in insns
    )
    for insn in insns:
        rel = 0
        swc = 0
        op = insn.op
        if op == _SUICIDE_OP:
            rel |= kill_bit
            swc |= SWC_MASK_SUICIDE
        if op == _ORIGIN_OP:
            rel |= origin_bit
            swc |= SWC_MASK_ORIGIN
        if op == JUMPI and insn.pc in origin_jumpi:
            rel |= origin_bit
            swc |= SWC_MASK_ORIGIN
        if op == _CALL_OP:
            rel |= extcall_bit
            swc |= SWC_MASK_REENTRANCY
        if op in _WINDOW_CALL_OPS:
            rel |= window_bit
        if op in _STATE_ACCESS_OPS and call_precedes_pc[insn.pc]:
            rel |= window_bit
            swc |= SWC_MASK_REENTRANCY
        if op == _BLOCKHASH_OP or (
            op == JUMPI and insn.pc in blockenv_jumpi
        ):
            rel |= pv_bit
        if op in (JUMP, JUMPI) and insn.pc not in literal_dest:
            rel |= aj_bit
        if op in _ARITH_OPS and insn.pc not in safe_arith:
            rel |= ia_bit
        if op in _IA_SINK_OPS and ia_hazard:
            rel |= ia_bit
        # multiple_sends/unchecked_retval sinks (STOP/RETURN) report
        # from call trails that only a call-family op in THIS code can
        # populate (trail annotations are per-transaction, and a callee
        # frame is only reachable through a call op here)
        if op in _EXT_CALL_OPS or (op in (0x00, 0xF3) and has_ext_call):
            rel |= sends_bit | retval_bit
        module_relevance[insn.pc] = rel
        swc_mask[insn.pc] = swc

    return TaintFacts(
        taint_mask=taint_mask,
        jumpi_verdict=jumpi_verdict,
        effect_flags=effect_flags,
        module_relevance=module_relevance,
        swc_mask=swc_mask,
        cond_intervals=cond_intervals,
    )
