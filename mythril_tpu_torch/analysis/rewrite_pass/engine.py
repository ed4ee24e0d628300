"""Bottom-up rewrite driver over constraint sets (docs/REWRITE_PASS.md).

``rewrite_term`` rebuilds a term's DAG bottom-up through the smart
constructors in smt/terms.py — so every constructor-level fold
(constant folding, slice resolution, neutral elements, double negation)
re-fires over already-rewritten children — then applies the registered
word-level rules (rules.py) at each node to a local fixpoint.
Hash-consing makes the rewrite idempotent and cheap to memoize: the
process-wide uid -> rewritten-term memo means a fork child re-rewrites
only its path-condition suffix, never the shared prefix (the
assumption-reuse analogue of the blaster's shared-prefix trie).

``rewrite_set`` runs the set-level pipeline the solver cache consumes:
rewrite each member, drop members proven TRUE, collapse the set on a
member proven FALSE, then interval-discharge the survivors
(intervals.py) against the structural bounds plus any static seeds. The
result carries the DAG-size deltas (node and bit-width-weighted counts)
that back the ``cnf_vars_saved_pct`` bench estimator.
"""

import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from mythril_tpu_torch.analysis.rewrite_pass import intervals, rules
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term

# per-node rule fixpoint bound: rules strictly simplify, so in practice
# two passes settle; the cap only guards a pathological rule interaction
MAX_RULE_ITERS = 8

# process-wide rewrite memo (uid -> rewritten Term). uids are monotonic
# and never reused, so stale entries can only false-miss. Holding the
# Term value keeps the rewritten DAG alive while its source is cached.
_memo: "OrderedDict[int, Term]" = OrderedDict()
_MEMO_MAX = 1 << 16
_memo_lock = threading.Lock()

# DAG-walk cap for the size estimator (mirrors solver_cache's
# ALPHA_NODE_CAP rationale: stats must never dominate the solve)
STATS_NODE_CAP = 20_000


def reset_memo() -> None:
    with _memo_lock:
        _memo.clear()


def _rebuild(t: Term, kids: List[Term]) -> Term:
    """Re-apply the smart constructor for ``t`` over rewritten children.
    Identity-preserving: when no child changed, the hash-cons table
    returns the original node."""
    op = t.op
    if not kids and op not in ("true", "false"):
        return t
    if op == "add":
        return terms.bv_add(kids[0], kids[1])
    if op == "sub":
        return terms.bv_sub(kids[0], kids[1])
    if op == "mul":
        return terms.bv_mul(kids[0], kids[1])
    if op == "udiv":
        return terms.bv_udiv(kids[0], kids[1])
    if op == "sdiv":
        return terms.bv_sdiv(kids[0], kids[1])
    if op == "urem":
        return terms.bv_urem(kids[0], kids[1])
    if op == "srem":
        return terms.bv_srem(kids[0], kids[1])
    if op == "and":
        return terms.bv_and(kids[0], kids[1])
    if op == "or":
        return terms.bv_or(kids[0], kids[1])
    if op == "xor":
        return terms.bv_xor(kids[0], kids[1])
    if op == "not":
        return terms.bv_not(kids[0])
    if op == "neg":
        return terms.bv_neg(kids[0])
    if op == "shl":
        return terms.bv_shl(kids[0], kids[1])
    if op == "lshr":
        return terms.bv_lshr(kids[0], kids[1])
    if op == "ashr":
        return terms.bv_ashr(kids[0], kids[1])
    if op == "concat":
        return terms.bv_concat(kids)
    if op == "extract":
        return terms.bv_extract(t.params[0], t.params[1], kids[0])
    if op == "zext":
        return terms.bv_zext(t.params[0], kids[0])
    if op == "sext":
        return terms.bv_sext(t.params[0], kids[0])
    if op == "ite":
        return terms.bv_ite(kids[0], kids[1], kids[2])
    if op == "eq":
        return terms.bool_eq(kids[0], kids[1])
    if op == "ult":
        return terms.bool_ult(kids[0], kids[1])
    if op == "ule":
        return terms.bool_ule(kids[0], kids[1])
    if op == "slt":
        return terms.bool_slt(kids[0], kids[1])
    if op == "sle":
        return terms.bool_sle(kids[0], kids[1])
    if op == "bnot":
        return terms.bool_not(kids[0])
    if op == "band":
        return terms.bool_and(*kids)
    if op == "bor":
        return terms.bool_or(*kids)
    if op == "iff":
        return terms.bool_iff(kids[0], kids[1])
    if op == "store":
        return terms.array_store(kids[0], kids[1], kids[2])
    if op == "select":
        return terms.array_select(kids[0], kids[1])
    if op == "apply":
        return terms.func_app(
            t.params[0], tuple(kids), t.params[1], t.params[2]
        )
    return t  # leaves and unmodeled ops pass through unchanged


def _apply_rules(t: Term) -> Term:
    """Run the registered rules at one node to a local fixpoint."""
    for _ in range(MAX_RULE_ITERS):
        replaced = None
        for rr in rules.rules_for(t.op):
            replaced = rr(t)
            if replaced is not None and replaced is not t:
                break
            replaced = None
        if replaced is None:
            return t
        t = replaced
    return t


def rewrite_term(root: Term) -> Term:
    """The equivalent rewritten form of ``root`` (memoized process-wide)."""
    with _memo_lock:
        hit = _memo.get(root.uid)
        if hit is not None:
            _memo.move_to_end(root.uid)
            return hit
    local: Dict[int, Term] = {}
    stack: List[Tuple[Term, bool]] = [(root, False)]
    while stack:
        t, expanded = stack.pop()
        if t.uid in local:
            continue
        if not expanded:
            with _memo_lock:
                hit = _memo.get(t.uid)
            if hit is not None:
                local[t.uid] = hit
                continue
            stack.append((t, True))
            stack.extend((a, False) for a in t.args)
            continue
        kids = [local[a.uid] for a in t.args]
        try:
            out = _apply_rules(_rebuild(t, kids))
        except (ValueError, TypeError, KeyError):
            # a malformed rebuild (foreign op, width surprise) keeps the
            # original node: the rewrite must never be the reason a
            # constraint fails to reach the solver
            out = t
        local[t.uid] = out
        with _memo_lock:
            _memo[t.uid] = out
            while len(_memo) > _MEMO_MAX:
                _memo.popitem(last=False)
    return local[root.uid]


def _dag_stats(roots: Sequence[Term]) -> Tuple[int, int]:
    """(node count, bit-width-weighted node count) of the forest — the
    CNF proxy: the blaster mints about one aux CNF variable per bit of
    every internal bv node. Capped walk; past the cap the stats saturate
    (they feed telemetry, never verdicts)."""
    seen = set()
    nodes = 0
    bits = 0
    stack = list(roots)
    while stack:
        t = stack.pop()
        if t.uid in seen:
            continue
        seen.add(t.uid)
        nodes += 1
        bits += t.size if t.sort == terms.BV else 1
        if len(seen) >= STATS_NODE_CAP:
            break
        stack.extend(t.args)
    return nodes, bits


class RewriteOutcome(NamedTuple):
    """What rewrite_set proved and what remains to solve."""

    terms: Tuple[Term, ...]  # the residual set (TRUE members dropped)
    verdict: Optional[bool]  # True/False when the set is decided statically
    # the single rewritten member proven FALSE (an UNSAT core of size
    # one — fed back as a subsumption seed and a bridge prune fact)
    false_core: Optional[Term]
    # the ORIGINAL (pre-rewrite) member the false core came from: its
    # uid is what the bridge sees on raw lane constraints, so THIS is
    # the term worth noting in the known-unsat prune set
    false_source: Optional[Term]
    # True when the false core holds for EVERY assignment (rewrite or
    # seedless intervals): only then may it enter the process-global
    # known-unsat set — a seeded core is scoped to its fact planes
    core_is_structural: bool
    discharged: int  # members proven TRUE/FALSE by rewrite + intervals
    nodes_before: int
    nodes_after: int
    bits_before: int
    bits_after: int


def rewrite_set(
    raw_terms: Sequence[Term],
    seeds: Optional[Dict[int, Tuple[int, int]]] = None,
) -> RewriteOutcome:
    """Rewrite + interval-discharge one constraint set.

    ``seeds`` maps term uids (keyed on the ORIGINAL lifted terms, as the
    bridge attaches them) to MUST value intervals from the fact
    planes. Seed keys are remapped through the rewrite so a seed on a
    source term constrains its rewritten form too."""
    nodes_before, bits_before = _dag_stats(raw_terms)
    rewritten: List[Term] = []
    seen = set()
    sources: Dict[int, Term] = {}
    discharged = 0
    false_core: Optional[Term] = None
    false_source: Optional[Term] = None
    core_is_structural = True
    for t in raw_terms:
        rw = rewrite_term(t)
        if rw is terms.TRUE:
            if t is not terms.TRUE:
                discharged += 1
            continue
        if rw is terms.FALSE:
            discharged += 1
            false_core = rw
            false_source = t
            break
        if rw.uid in seen:
            continue
        seen.add(rw.uid)
        sources[rw.uid] = t
        rewritten.append(rw)
    seed_map: Optional[Dict[int, Tuple[int, int]]] = None
    if seeds and false_core is None:
        # seeds key ORIGINAL lifted node uids (the bridge attaches them
        # on the condition words); remap each through the rewrite memo
        # so a seed survives its node being rewritten. A miss (evicted
        # memo entry) only loses precision, never soundness.
        seed_map = dict(seeds)
        with _memo_lock:
            for uid, bound in list(seeds.items()):
                hit = _memo.get(uid)
                if hit is not None and hit.uid != uid:
                    seed_map.setdefault(hit.uid, bound)
    if false_core is None and rewritten:
        verdict_by_uid = intervals.discharge_set(rewritten, seed_map)
        kept: List[Term] = []
        for rw in rewritten:
            v = verdict_by_uid.get(rw.uid)
            if v is True:
                discharged += 1
                continue
            if v is False:
                discharged += 1
                false_core = rw
                false_source = sources.get(rw.uid)
                if seed_map:
                    # seeded refutation: structural only if it survives
                    # a seedless re-check (one small DAG pass)
                    core_is_structural = (
                        intervals.discharge(rw, intervals.compute([rw]))
                        is False
                    )
                kept = []
                break
            kept.append(rw)
        if false_core is None:
            rewritten = kept
    if false_core is not None:
        rewritten = [false_core]
    verdict: Optional[bool] = None
    if false_core is not None:
        verdict = False
    elif not rewritten:
        verdict = True
    nodes_after, bits_after = _dag_stats(rewritten)
    return RewriteOutcome(
        terms=tuple(rewritten),
        verdict=verdict,
        false_core=false_core,
        false_source=false_source,
        core_is_structural=core_is_structural,
        discharged=discharged,
        nodes_before=nodes_before,
        nodes_after=nodes_after,
        bits_before=bits_before,
        bits_after=bits_after,
    )
