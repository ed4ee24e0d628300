"""Stack-height + constant-propagation abstract interpretation.

Lattice: an abstract stack slot is either a concrete 256-bit constant or
TOP (unknown). The abstract stack keeps the topmost tracked slots
(values, top at the END of the tuple) plus an ``unknown_below`` flag for
whatever the analysis no longer tracks. Join is pointwise from the top:
disagreeing constants (or disagreeing heights) widen to TOP /
unknown_below — strictly lossy, never wrong, so every value the concrete
machine can compute is represented by its abstract slot (soundness: a
slot is either exactly the dynamic value or TOP).

The interpreter runs a worklist fixpoint over basic blocks. Each
JUMP/JUMPI site accumulates the set of constant destinations observed at
its evaluation, or an ``unknown`` flag when the destination widened to
TOP — the flag is what keeps the successor table over-approximate: an
unknown jump may go to ANY valid JUMPDEST.
"""

from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.analysis.static_pass.blocks import (
    JUMP,
    JUMPI,
    BasicBlock,
    Insn,
)
from mythril_tpu_torch.support.opcodes import OPCODES

TOP = None
MASK = (1 << 256) - 1
SIGN_BIT = 1 << 255

# how many stack slots the abstract stack tracks before widening the
# bottom into unknown_below (the EVM limit is 1024; jump targets live
# within a few slots of the top in practice)
MAX_TRACK = 64

# fixpoint safety valve: bail to all-TOP behaviour rather than loop
# (each (block, entry-state) join is monotone, so this should never
# trip; it bounds the damage of a lattice bug to imprecision)
MAX_VISITS_PER_BLOCK = 256


def _signed(x: int) -> int:
    return x - (1 << 256) if x & SIGN_BIT else x


def _sdiv(a: int, b: int) -> int:
    if b == 0:
        return 0
    sa, sb = _signed(a), _signed(b)
    return (abs(sa) // abs(sb)) * (1 if (sa < 0) == (sb < 0) else -1) & MASK


def _smod(a: int, b: int) -> int:
    if b == 0:
        return 0
    sa, sb = _signed(a), _signed(b)
    return (abs(sa) % abs(sb)) * (1 if sa >= 0 else -1) & MASK


def _exp(a: int, b: int) -> int:
    return pow(a, b, 1 << 256)


def _signextend(k: int, v: int) -> int:
    if k >= 31:
        return v
    bit = 8 * (k + 1) - 1
    if v & (1 << bit):
        return v | (MASK ^ ((1 << (bit + 1)) - 1))
    return v & ((1 << (bit + 1)) - 1)


def _byte(i: int, v: int) -> int:
    return (v >> (8 * (31 - i))) & 0xFF if i < 32 else 0


# opcode byte -> constant folder over fully-concrete operands (operand
# order matches the stack: lambda args are [top, second, ...])
_FOLD = {
    0x01: lambda a, b: (a + b) & MASK,
    0x02: lambda a, b: (a * b) & MASK,
    0x03: lambda a, b: (a - b) & MASK,
    0x04: lambda a, b: a // b if b else 0,
    0x05: _sdiv,
    0x06: lambda a, b: a % b if b else 0,
    0x07: _smod,
    0x08: lambda a, b, m: (a + b) % m if m else 0,
    0x09: lambda a, b, m: (a * b) % m if m else 0,
    0x0A: _exp,
    0x0B: _signextend,
    0x10: lambda a, b: int(a < b),
    0x11: lambda a, b: int(a > b),
    0x12: lambda a, b: int(_signed(a) < _signed(b)),
    0x13: lambda a, b: int(_signed(a) > _signed(b)),
    0x14: lambda a, b: int(a == b),
    0x15: lambda a: int(a == 0),
    0x16: lambda a, b: a & b,
    0x17: lambda a, b: a | b,
    0x18: lambda a, b: a ^ b,
    0x19: lambda a: a ^ MASK,
    0x1A: _byte,
    0x1B: lambda s, v: (v << s) & MASK if s < 256 else 0,
    0x1C: lambda s, v: v >> s if s < 256 else 0,
    0x1D: lambda s, v: (
        _signed(v) >> s if s < 256 else (MASK if v & SIGN_BIT else 0)
    )
    & MASK,
}


class AbsStack:
    """Immutable-ish abstract stack: ``vals`` tracks the top slots."""

    __slots__ = ("vals", "unknown_below")

    def __init__(self, vals: Tuple = (), unknown_below: bool = False):
        self.vals = tuple(vals)
        self.unknown_below = unknown_below

    def copy(self) -> "AbsStack":
        return AbsStack(self.vals, self.unknown_below)

    def key(self):
        return (self.vals, self.unknown_below)


def join(a: Optional[AbsStack], b: AbsStack) -> AbsStack:
    """Pointwise-from-the-top join; None joins as bottom (identity)."""
    if a is None:
        return b.copy()
    n = min(len(a.vals), len(b.vals))
    merged = tuple(
        x if x == y else TOP
        for x, y in zip(a.vals[len(a.vals) - n :], b.vals[len(b.vals) - n :])
    )
    below = (
        a.unknown_below
        or b.unknown_below
        or len(a.vals) != len(b.vals)
    )
    return AbsStack(merged, below)


class JumpFacts:
    """Accumulated per-site jump-destination facts."""

    __slots__ = ("consts", "unknown")

    def __init__(self):
        self.consts: set = set()
        self.unknown = False


def transfer_insn(stack: AbsStack, insn: Insn) -> AbsStack:
    """One instruction over the abstract stack (jumps handled by caller)."""
    vals = list(stack.vals)
    below = stack.unknown_below

    def pop():
        nonlocal below
        if vals:
            return vals.pop()
        # popping past the tracked region (or a dynamic underflow —
        # which would fault at runtime, so TOP stays sound either way)
        return TOP

    op = insn.op
    if insn.imm is not None:  # PUSH0..PUSH32
        vals.append(insn.imm)
    elif 0x80 <= op <= 0x8F:  # DUPk
        k = op - 0x7F
        vals.append(vals[-k] if k <= len(vals) else TOP)
    elif 0x90 <= op <= 0x9F:  # SWAPk
        k = op - 0x8F
        if k + 1 <= len(vals):
            vals[-1], vals[-k - 1] = vals[-k - 1], vals[-1]
        elif vals:
            # the partner slot is untracked: the top becomes unknown and
            # an unknown value sinks into the untracked region
            vals[-1] = TOP
            below = True
    else:
        spec = OPCODES.get(op)
        pops = spec.pops if spec else 0
        pushes = spec.pushes if spec else 0
        args = [pop() for _ in range(pops)]
        fold = _FOLD.get(op)
        if pushes:
            if fold is not None and all(a is not TOP for a in args):
                vals.append(fold(*args))
            else:
                vals.extend([TOP] * pushes)
    if len(vals) > MAX_TRACK:
        vals = vals[len(vals) - MAX_TRACK :]
        below = True
    return AbsStack(tuple(vals), below)


def interpret(
    blocks: List[BasicBlock],
    block_of: dict,
    jumpdests: set,
) -> Tuple[Dict[int, JumpFacts], bool]:
    """Worklist fixpoint; returns (jump site pc -> JumpFacts, any_unknown).

    ``jumpdests`` is the verified JUMPDEST byte-pc set. When any jump
    destination widens to TOP, every JUMPDEST block is (re)seeded with an
    unknown entry stack so blocks reachable only through unresolved jumps
    are still analyzed — that is what keeps reachability and the
    successor table over-approximate.
    """
    if not blocks:
        return {}, False
    entry: Dict[int, Optional[AbsStack]] = {}
    facts: Dict[int, JumpFacts] = {}
    visits: Dict[int, int] = {}
    any_unknown = False
    seeded_unknown = False
    work: List[int] = [0]
    entry[0] = AbsStack()

    def push_entry(idx: int, state: AbsStack) -> None:
        old = entry.get(idx)
        new = join(old, state)
        if old is None or new.key() != old.key():
            entry[idx] = new
            if idx not in work:
                work.append(idx)

    def seed_all_jumpdests() -> None:
        nonlocal seeded_unknown
        if seeded_unknown:
            return
        seeded_unknown = True
        for b in blocks:
            if b.insns[0].pc in jumpdests:
                push_entry(b.index, AbsStack((), True))

    while work:
        idx = work.pop(0)
        visits[idx] = visits.get(idx, 0) + 1
        block = blocks[idx]
        state = entry[idx]
        if visits[idx] > MAX_VISITS_PER_BLOCK:
            state = AbsStack((), True)  # widen hard; terminates
        for insn in block.insns:
            if insn.op in (JUMP, JUMPI):
                fact = facts.setdefault(insn.pc, JumpFacts())
                dest = state.vals[-1] if state.vals else TOP
                if dest is TOP:
                    if not fact.unknown:
                        fact.unknown = True
                    any_unknown = True
                    seed_all_jumpdests()
                elif dest not in fact.consts:
                    fact.consts.add(dest)
            state = transfer_insn(state, insn)
        # propagate the exit state along resolved edges
        last = block.insns[-1]
        if last.op == JUMP or last.op == JUMPI:
            fact = facts[last.pc]
            for dest in fact.consts:
                tgt = block_of.get(dest)
                if tgt is not None and dest in jumpdests:
                    push_entry(tgt, state)
            # unknown dests were handled by seed_all_jumpdests
        if block.falls_through and idx + 1 < len(blocks):
            push_entry(idx + 1, state)
    return facts, any_unknown
