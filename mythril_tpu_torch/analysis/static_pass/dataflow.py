"""Generic forward dataflow engine over the block CFG (blocks.py, absint.py).

absint.interpret is a fixpoint specialized to the const-or-TOP stack
domain. The taint/interval pass (taint.py) needs the same traversal —
worklist over basic blocks, join at entries, jump resolution driving
edge propagation, seed-all-JUMPDESTs once any destination widens — over
a richer slot domain. This module factors the traversal out so the two
stages cannot drift: a *domain* supplies the lattice (entry/unknown
states, join, transfer) plus one query, ``jump_dest``, that tells the
engine whether the top-of-stack is a single concrete destination.

Soundness contract (same as absint): when a jump destination is not a
single constant, every JUMPDEST block is seeded with the domain's
unknown state, so the set of blocks the fixpoint visits — and the entry
states it computes — over-approximate every dynamically reachable
(block, machine-state) pair.
"""

from typing import Callable, Dict, List

from mythril_tpu_torch.analysis.static_pass.blocks import JUMP, JUMPI, BasicBlock

# fixpoint safety valve, mirroring absint.MAX_VISITS_PER_BLOCK: joins
# are monotone and the taint domain widens, so this should never trip;
# it bounds a lattice bug to imprecision instead of divergence
MAX_VISITS_PER_BLOCK = 256


class Domain:
    """Protocol for a forward dataflow domain (duck-typed, not enforced).

    entry_state()          state at the dispatch entry (pc 0, empty stack)
    unknown_state()        state seeded at JUMPDESTs behind unresolved jumps
    join(old, new)         least upper bound; ``old`` may be None (bottom).
                           Implementations may widen here — the engine only
                           requires the result to be an upper bound.
    key(state)             hashable identity used to detect convergence
    transfer(state, insn)  abstract post-state of one instruction
    jump_dest(state)       concrete byte destination when the top slot is a
                           single constant, else None
    """


def fixpoint(
    blocks: List[BasicBlock],
    block_of: dict,
    jumpdests: set,
    domain: "Domain",
) -> Dict[int, object]:
    """Worklist fixpoint; returns {block index: entry state} for every
    block the analysis visits (statically unreachable blocks are absent —
    callers must treat absence conservatively)."""
    if not blocks:
        return {}
    entry: Dict[int, object] = {0: domain.entry_state()}
    visits: Dict[int, int] = {}
    seeded_unknown = False
    work: List[int] = [0]

    def push_entry(idx: int, state: object) -> None:
        old = entry.get(idx)
        new = domain.join(old, state)
        if old is None or domain.key(new) != domain.key(old):
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
                push_entry(b.index, domain.unknown_state())

    while work:
        idx = work.pop(0)
        visits[idx] = visits.get(idx, 0) + 1
        block = blocks[idx]
        state = entry[idx]
        if visits[idx] > MAX_VISITS_PER_BLOCK:
            state = domain.unknown_state()  # widen hard; terminates
        dests: List[int] = []
        for insn in block.insns:
            if insn.op in (JUMP, JUMPI):
                dest = domain.jump_dest(state)
                if dest is None:
                    # unknown destination: every JUMPDEST is a successor
                    seed_all_jumpdests()
                else:
                    dests.append(dest)
            state = domain.transfer(state, insn)
        last = block.insns[-1]
        if last.op in (JUMP, JUMPI):
            for dest in dests:
                tgt = block_of.get(dest)
                if tgt is not None and dest in jumpdests:
                    push_entry(tgt, state)
        if block.falls_through and idx + 1 < len(blocks):
            push_entry(idx + 1, state)
    return entry


def sweep(
    blocks: List[BasicBlock],
    entry: Dict[int, object],
    domain: "Domain",
    visit: Callable[["object", object], None],
) -> None:
    """One deterministic pass over the converged entry states.

    Calls ``visit(insn, pre_state)`` for every instruction of every
    visited block, where ``pre_state`` is the abstract state immediately
    before the instruction executes. Because ``transfer`` is a function
    of the entry state alone, re-running it from the fixpoint entry
    yields the join-over-all-paths state at each pc — the per-PC facts
    the fact planes are built from.
    """
    for idx, state in entry.items():
        for insn in blocks[idx].insns:
            visit(insn, state)
            state = domain.transfer(state, insn)
