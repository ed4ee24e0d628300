"""Static-analysis probe: findings that cost zero symbolic budget.

Unlike every other detector this module never inspects symbolic states —
it maps the static pass (analysis/static_pass/) over each contract's
bytecode after execution and reports:

* statically-unreachable code (dead basic blocks the dispatcher can
  never route to), and
* statically-guaranteed assert failures (blocks whose every execution
  runs only pure ops into INVALID — the Solidity assert/panic shape).

Gated OFF by default behind MYTHRIL_TPU_STATIC_PROBE so the default SWC
finding set stays byte-identical whether the static pass runs or not;
set the variable to any non-empty value to enable.
"""

import logging
import os
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue

log = logging.getLogger(__name__)


def report_static_findings(code: bytes, contract_name: str) -> List[Issue]:
    """Static-pass findings for one bytecode (no symbolic state needed)."""
    from mythril_tpu_torch.analysis import static_pass

    if not code:
        return []
    analysis = static_pass.analyze(code)
    bytecode_hex = "0x" + bytes(code).hex()
    issues: List[Issue] = []
    for block in analysis.blocks:
        if analysis.must_fail[block.index] and analysis.reachable[block.index]:
            issues.append(
                Issue(
                    contract=contract_name,
                    function_name="_fallback",
                    address=block.start,
                    swc_id="110",
                    title="Statically-guaranteed assert failure",
                    bytecode=bytecode_hex,
                    severity="Medium",
                    description_head=(
                        "Every execution entering the basic block at pc "
                        "%d reaches an INVALID instruction." % block.start
                    ),
                    description_tail=(
                        "The static pass proved this block runs only "
                        "stack/arithmetic operations before INVALID, so any "
                        "path the dispatcher routes here consumes all gas."
                    ),
                )
            )
        elif analysis.dead[block.index]:
            issues.append(
                Issue(
                    contract=contract_name,
                    function_name="_fallback",
                    address=block.start,
                    swc_id="131",
                    title="Statically-unreachable code",
                    bytecode=bytecode_hex,
                    severity="Low",
                    description_head=(
                        "The basic block at pc %d is unreachable from the "
                        "dispatch entry." % block.start
                    ),
                    description_tail=(
                        "No resolved jump, fall-through, or unknown-jump "
                        "over-approximation reaches this block; it is dead "
                        "code (or data misclassified as code)."
                    ),
                )
            )
    return issues


class StaticAnalysisProbe(DetectionModule):
    """Report static-pass findings over every analyzed contract."""

    name = "Static analysis probe"
    swc_id = "110"
    description = (
        "Reports statically-unreachable code and statically-guaranteed "
        "assert failures found by the bytecode pre-analysis pass"
    )
    entry_point = EntryPoint.POST
    pre_hooks: List[str] = []
    post_hooks: List[str] = []

    def _execute(self, statespace) -> Optional[List[Issue]]:
        if not os.environ.get("MYTHRIL_TPU_STATIC_PROBE"):
            return []
        issues: List[Issue] = []
        seen = set()
        for node in statespace.nodes.values():
            if not node.states:
                continue
            env = node.states[0].environment
            code = getattr(env.code, "bytecode", None)
            if not code:
                continue
            if isinstance(code, str):
                code = bytes.fromhex(code[2:] if code.startswith("0x") else code)
            if code in seen:
                continue
            seen.add(code)
            issues.extend(
                report_static_findings(code, env.active_account.contract_name)
            )
        return issues
