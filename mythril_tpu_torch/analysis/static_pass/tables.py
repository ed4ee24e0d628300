"""Dense per-contract tables derived from the static pass.

Everything here is plain NumPy on the host — the arrays are either
consumed host-side (strategy weighting, host jump resolution, the
detection probe) or threaded into the device CodeBank by
laser/tpu/batch.py make_code_bank (jumpdest bitmap, must-revert bitmap).

Soundness contract (docs/STATIC_PASS.md): the successor table is an
OVER-approximation — every dynamically feasible edge is present (an
unresolved destination means "any valid JUMPDEST") — while
``resolved_target`` and ``must_revert`` are MUST facts: they are only
set when every execution reaching that point behaves as stated.
"""

from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np

from mythril_tpu_torch.analysis.static_pass import absint, taint
from mythril_tpu_torch.analysis.static_pass.blocks import (
    INTERESTING,
    INVALID,
    JUMP,
    JUMPDEST,
    JUMPI,
    REVERT,
    BasicBlock,
    Insn,
    decompose,
)
from mythril_tpu_torch.support.opcodes import OPCODES

# sentinel distance for "no interesting op reachable from here"
INTEREST_INF = 1 << 30

# Version of the fact-table schema. Bump whenever the meaning, layout,
# or derivation of any StaticAnalysis plane changes: service/cache.py
# folds this into its parameter match so result entries (and the
# detector dedup state they captured) built against older fact tables
# miss instead of resurrecting stale verdicts.
#   1 = CFG/absint planes
#   2 = taint/interval stage (taint_mask, jumpi_verdict, effect_flags,
#       module_relevance, swc_mask)
#   3 = stage-3 rewrite-pass plumbing: cond_intervals (MUST value
#       bounds per JUMPI condition, the interval-discharge seeds).
#       service/cache.py also folds this version into the solver-memo
#       export keys, so alpha memos seeded from older fact planes miss
#       instead of resurrecting (docs/REWRITE_PASS.md)
FACT_SCHEMA_VERSION = 3

# successor-table column cap: blocks with more resolved destinations
# (huge dispatchers) overflow into succ_unknown, which stays sound
# (unknown = any JUMPDEST, a superset)
MAX_SUCC = 16

# ops the device kernel models completely and that can neither trap back
# to the host, fire a detection hook, nor touch observable state — the
# closure a fork child may be killed over (see must_revert below).
# Deliberately excludes memory ops (symbolic offsets trap), env/calldata
# reads (term-tape allocation can trap on a full tape), JUMPI (hooked by
# detection modules), and everything storage/call-shaped.
_PURE_OPS = (
    frozenset(range(0x01, 0x0C))  # ADD..SIGNEXTEND
    | frozenset(range(0x10, 0x1E))  # LT..SAR
    | frozenset({0x50, 0x5B})  # POP, JUMPDEST
    | frozenset(range(0x5F, 0x80))  # PUSH0..PUSH32
    | frozenset(range(0x80, 0xA0))  # DUP1..SWAP16
)


class StaticAnalysis(NamedTuple):
    """The static pass result for one bytecode (immutable, cached)."""

    code_len: int
    insns: Tuple[Insn, ...]
    blocks: Tuple[BasicBlock, ...]
    # byte pc -> block index (instruction starts AND their immediate
    # bytes; -1 past the last instruction)
    block_of: np.ndarray  # i32[code_len]
    block_start: np.ndarray  # i32[n_blocks]
    # verified JUMPDEST byte pcs (instruction starts only)
    jumpdest_bitmap: np.ndarray  # bool[code_len]
    # over-approximate successor table: resolved successor BLOCK indices,
    # -1 padded; succ_unknown marks blocks whose jump destination did not
    # resolve — their successor set is every JUMPDEST block
    succ: np.ndarray  # i32[n_blocks, MAX_SUCC]
    succ_unknown: np.ndarray  # bool[n_blocks]
    stack_delta: np.ndarray  # i32[n_blocks] net pushes - pops
    interest_dist: np.ndarray  # i32[n_blocks] blocks to nearest interesting op
    reachable: np.ndarray  # bool[n_blocks] from the dispatch entry (pc 0)
    # MUST facts: every execution entering the block reverts (resp. hits
    # INVALID) after executing only _PURE_OPS; dead = never reachable
    must_revert: np.ndarray  # bool[n_blocks]
    must_fail: np.ndarray  # bool[n_blocks]
    dead: np.ndarray  # bool[n_blocks]
    # per byte-pc projection of must_revert (device bitmap: a jump whose
    # destination lands on a True byte enters a provably-reverting region)
    must_revert_pc: np.ndarray  # bool[code_len]
    # MUST-resolved jump destinations per JUMP/JUMPI site byte-pc
    # (-1 = unresolved): constant-folded over ALL paths, so the dynamic
    # destination is exactly this value
    resolved_target: np.ndarray  # i32[code_len]
    has_unresolved_jumps: bool
    has_truncated_push: bool
    # stage-2 fact planes (taint.py; see docs/TAINT_PASS.md). taint_mask
    # and module_relevance are MAY facts (over-approximations — a clear
    # bit proves absence); jumpi_verdict holds MUST branch facts
    taint_mask: np.ndarray  # u8[code_len]
    jumpi_verdict: np.ndarray  # i8[code_len]
    effect_flags: np.ndarray  # u8[n_blocks]
    module_relevance: np.ndarray  # u32[code_len]
    swc_mask: np.ndarray  # u8[code_len]
    # MUST bounds on JUMPI condition words (taint.py; consumed by the
    # stage-3 rewrite pass as interval-discharge seeds): byte-pc ->
    # (lo, hi) unsigned-256 inclusive; absent pc = no fact
    cond_intervals: Dict[int, Tuple[int, int]]

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def block_at(self, pc: int) -> Optional[int]:
        """Block index containing byte ``pc`` (None when out of range)."""
        if 0 <= pc < self.code_len and self.block_of[pc] >= 0:
            return int(self.block_of[pc])
        return None

    def successors(self, index: int) -> Set[int]:
        """Successor block indices, expanding the unknown flag."""
        out = {int(s) for s in self.succ[index] if s >= 0}
        if self.succ_unknown[index]:
            out.update(
                b.index
                for b in self.blocks
                if self.jumpdest_bitmap[b.start]
            )
        return out


def _jump_edges(
    block: BasicBlock,
    facts: Dict[int, absint.JumpFacts],
    block_of: dict,
    jumpdests: set,
) -> Tuple[Set[int], bool]:
    """(resolved successor block set, unknown flag) for a block."""
    succ: Set[int] = set()
    unknown = False
    last = block.insns[-1]
    if last.op in (JUMP, JUMPI):
        fact = facts.get(last.pc)
        if fact is None:
            # never visited by the fixpoint: statically unreachable;
            # keep the table conservative anyway
            unknown = True
        else:
            unknown = fact.unknown
            for dest in fact.consts:
                if dest in jumpdests and dest in block_of:
                    succ.add(block_of[dest])
    return succ, unknown


def build(code: bytes) -> StaticAnalysis:
    """Run the full static pass over one bytecode."""
    code = bytes(code)
    code_len = len(code)
    insns, blocks, block_of_map = decompose(code)
    n = len(blocks)

    block_of = np.full(code_len, -1, np.int32)
    for b in blocks:
        block_of[b.start : b.end] = b.index
    block_start = np.asarray([b.start for b in blocks], np.int32).reshape(n)

    jumpdest_bitmap = np.zeros(code_len, bool)
    for insn in insns:
        if insn.op == JUMPDEST:
            jumpdest_bitmap[insn.pc] = True
    jumpdests = {insn.pc for insn in insns if insn.op == JUMPDEST}

    facts, _ = absint.interpret(blocks, block_of_map, jumpdests)

    succ = np.full((n, MAX_SUCC), -1, np.int32)
    succ_unknown = np.zeros(n, bool)
    succ_sets: List[Set[int]] = []
    for b in blocks:
        edges, unknown = _jump_edges(b, facts, block_of_map, jumpdests)
        if b.falls_through and b.index + 1 < n:
            edges.add(b.index + 1)
        if len(edges) > MAX_SUCC:
            unknown = True
            edges = set(list(sorted(edges))[:MAX_SUCC])
        succ_unknown[b.index] = unknown
        succ_sets.append(edges)
        for k, tgt in enumerate(sorted(edges)):
            succ[b.index, k] = tgt

    stack_delta = np.zeros(n, np.int32)
    for b in blocks:
        delta = 0
        for insn in b.insns:
            if insn.imm is not None:
                delta += 1
            else:
                spec = OPCODES.get(insn.op)
                if spec is not None:
                    delta += spec.pushes - spec.pops
        stack_delta[b.index] = delta

    jumpdest_blocks = [
        b.index for b in blocks if jumpdest_bitmap[b.start]
    ]

    def expand(index: int) -> List[int]:
        out = list(succ_sets[index])
        if succ_unknown[index]:
            out.extend(jumpdest_blocks)
        return out

    # forward reachability from the dispatch entry (block 0 = pc 0)
    reachable = np.zeros(n, bool)
    frontier = [0] if n else []
    while frontier:
        idx = frontier.pop()
        if reachable[idx]:
            continue
        reachable[idx] = True
        frontier.extend(expand(idx))

    # interesting-op distance: multi-source BFS over REVERSED edges
    interest_dist = np.full(n, INTEREST_INF, np.int32)
    preds: List[List[int]] = [[] for _ in range(n)]
    for b in blocks:
        for tgt in expand(b.index):
            preds[tgt].append(b.index)
    frontier = [
        b.index
        for b in blocks
        if any(insn.op in INTERESTING for insn in b.insns)
    ]
    for idx in frontier:
        interest_dist[idx] = 0
    while frontier:
        nxt: List[int] = []
        for idx in frontier:
            d = interest_dist[idx] + 1
            for p in preds[idx]:
                if d < interest_dist[p]:
                    interest_dist[p] = d
                    nxt.append(p)
        frontier = nxt

    # must-revert / must-fail closure (backward fixpoint over MUST
    # edges): a block qualifies when its ops are pure and it either
    # terminates in REVERT/INVALID itself or hands over — by fall-through
    # or a fully-resolved JUMP — exclusively to qualifying blocks
    must_revert = np.zeros(n, bool)
    must_fail = np.zeros(n, bool)
    for terminator, out in ((REVERT, must_revert), (INVALID, must_fail)):
        changed = True
        while changed:
            changed = False
            for b in blocks:
                if out[b.index]:
                    continue
                if not all(
                    insn.op in _PURE_OPS or insn is b.insns[-1]
                    for insn in b.insns
                ):
                    continue
                last = b.insns[-1]
                if last.op == terminator:
                    qualifies = True
                elif last.op == JUMP:
                    edges = succ_sets[b.index]
                    qualifies = (
                        not succ_unknown[b.index]
                        and len(edges) > 0
                        and all(out[t] for t in edges)
                    )
                elif last.op in _PURE_OPS and b.index + 1 < n:
                    qualifies = bool(out[b.index + 1])
                else:
                    qualifies = False
                if qualifies:
                    out[b.index] = True
                    changed = True

    dead = ~reachable

    must_revert_pc = np.zeros(code_len, bool)
    for b in blocks:
        if must_revert[b.index]:
            must_revert_pc[b.start : b.end] = True

    resolved_target = np.full(code_len, -1, np.int32)
    for pc, fact in facts.items():
        if not fact.unknown and len(fact.consts) == 1:
            (dest,) = fact.consts
            if dest in jumpdests:
                resolved_target[pc] = dest

    has_unresolved = bool(succ_unknown.any())
    has_truncated = any(insn.truncated for insn in insns)

    taint_facts = taint.compute(
        tuple(insns),
        tuple(blocks),
        block_of_map,
        jumpdests,
        code_len,
        succ_sets,
        succ_unknown,
        jumpdest_blocks,
    )

    return StaticAnalysis(
        code_len=code_len,
        insns=tuple(insns),
        blocks=tuple(blocks),
        block_of=block_of,
        block_start=block_start,
        jumpdest_bitmap=jumpdest_bitmap,
        succ=succ,
        succ_unknown=succ_unknown,
        stack_delta=stack_delta,
        interest_dist=interest_dist,
        reachable=reachable,
        must_revert=must_revert,
        must_fail=must_fail,
        dead=dead,
        must_revert_pc=must_revert_pc,
        resolved_target=resolved_target,
        has_unresolved_jumps=has_unresolved,
        has_truncated_push=has_truncated,
        taint_mask=taint_facts.taint_mask,
        jumpi_verdict=taint_facts.jumpi_verdict,
        effect_flags=taint_facts.effect_flags,
        module_relevance=taint_facts.module_relevance,
        swc_mask=taint_facts.swc_mask,
        cond_intervals=taint_facts.cond_intervals,
    )
