from mythril_tpu_torch.laser.evm.plugins.implementations.coverage.coverage_plugin import (
    InstructionCoveragePlugin,
)
