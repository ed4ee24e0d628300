"""Laser plugin base (reference surface:
mythril/laser/ethereum/plugins/plugin.py)."""


class LaserPlugin:
    """Base class for laser plugins: implement initialize(symbolic_vm) and
    register hooks; direct execution by raising the signals in
    plugins/signals.py."""

    def initialize(self, symbolic_vm) -> None:
        raise NotImplementedError
