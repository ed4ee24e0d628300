"""SWC-110: reachable assert violations.

Parity surface: mythril/analysis/module/modules/exceptions.py — any
reachable ASSERT_FAIL/INVALID instruction with a satisfiable path is an
issue."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION


class Exceptions(ProbeModule):
    name = "Assertion violation"
    swc_id = ASSERT_VIOLATION
    description = "Checks whether any exception states are reachable."
    pre_hooks = ["ASSERT_FAIL", "INVALID"]

    title = "Exception State"
    severity = "Medium"
    description_head = "An exception or assertion violation was triggered."
    description_tail = (
        "It is possible to trigger an assertion violation. Note that Solidity assert() statements should "
        "only be used to check invariants. Review the transaction trace generated for this issue and "
        "either make sure your program logic is correct, or use require() instead of assert() if your goal "
        "is to constrain user inputs or enforce preconditions. Remember to validate inputs from both callers "
        "(for instance, via passed arguments) and callees (for instance, via return values)."
    )

    def probe(self, state):
        yield Finding()


detector = Exceptions()
