"""Benchmark plugin (reference surface:
mythril/laser/ethereum/plugins/implementations/benchmark.py): instructions
per second and coverage over time; dumps a JSON report (the reference emits
a matplotlib graph — here the raw series are written instead, plottable by
any frontend)."""

import json
import logging
import time
from typing import Dict

from mythril_tpu_torch.laser.evm.plugins.plugin import LaserPlugin

log = logging.getLogger(__name__)


class BenchmarkPlugin(LaserPlugin):
    """Benchmarks laser: nr of executed instructions over time."""

    def __init__(self, name=None):
        self.nr_of_executed_insns = 0
        self.begin = None
        self.end = None
        self.points: Dict[float, int] = {}
        self.name = name

    def initialize(self, symbolic_vm):
        self._reset()

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(_):
            current_time = time.time() - self.begin
            self.nr_of_executed_insns += 1
            self.points[current_time] = self.nr_of_executed_insns

        @symbolic_vm.laser_hook("start_sym_exec")
        def start_sym_exec_hook():
            self.begin = time.time()

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_sym_exec_hook():
            self.end = time.time()
            self._write_results()

    def _reset(self):
        self.nr_of_executed_insns = 0
        self.begin = time.time()
        self.end = None
        self.points = {}

    def _write_results(self):
        total_time = (self.end or time.time()) - self.begin
        rate = self.nr_of_executed_insns / total_time if total_time > 0 else 0
        log.info(
            "Benchmark: %d instructions in %.2f s (%.1f insns/s)",
            self.nr_of_executed_insns,
            total_time,
            rate,
        )
        if self.name:
            with open("%s.json" % self.name, "w") as f:
                json.dump(
                    {
                        "instructions": self.nr_of_executed_insns,
                        "seconds": total_time,
                        "insns_per_second": rate,
                        "series": self.points,
                    },
                    f,
                )
