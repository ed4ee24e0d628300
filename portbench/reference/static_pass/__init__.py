"""Frozen copy of the program's static bytecode pre-analysis
(``mythril_tpu_torch/analysis/static_pass``): basic blocks, the stack
abstract interpreter, the taint and interval stages, and the dense
tables the code bank takes from them (JUMPDEST bitmap, must-revert pcs,
SWC candidate mask, JUMPI verdicts). ``analyze`` here is the program's
``build``, uncached."""

from portbench.reference.static_pass.tables import StaticAnalysis, build


def analyze(code: bytes) -> StaticAnalysis:
    return build(bytes(code))
