"""Factory for the built-in laser plugins.

Parity surface: mythril/laser/ethereum/plugins/plugin_factory.py. Imports
stay inside the builders so loading the factory never pulls plugin
dependencies."""

from mythril_tpu_torch.laser.evm.plugins.plugin import LaserPlugin


class PluginFactory:
    @staticmethod
    def build_benchmark_plugin(name: str) -> LaserPlugin:
        from mythril_tpu_torch.laser.evm.plugins.implementations.benchmark import (
            BenchmarkPlugin,
        )

        return BenchmarkPlugin(name)

    @staticmethod
    def build_mutation_pruner_plugin() -> LaserPlugin:
        from mythril_tpu_torch.laser.evm.plugins.implementations.mutation_pruner import (
            MutationPruner,
        )

        return MutationPruner()

    @staticmethod
    def build_instruction_coverage_plugin() -> LaserPlugin:
        from mythril_tpu_torch.laser.evm.plugins.implementations.coverage import (
            InstructionCoveragePlugin,
        )

        return InstructionCoveragePlugin()

    @staticmethod
    def build_dependency_pruner_plugin() -> LaserPlugin:
        from mythril_tpu_torch.laser.evm.plugins.implementations.dependency_pruner import (
            DependencyPruner,
        )

        return DependencyPruner()
