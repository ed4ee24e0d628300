"""Per-opcode wall-time profiler (reference surface:
mythril/laser/ethereum/iprof.py), enabled by --enable-iprof.

Host-executed instructions get exact per-call wall times. Instructions
retired inside a batched device round have no individual timings, so
the tpu-batch backend feeds per-opcode retire COUNTS plus the round's
wall time; those are amortized (round wall / instructions retired) and
merged into the same sorted per-op table as the host rows, so an opcode
executed on both tiers shows both columns instead of the host row
shadowing the device totals."""

from collections import defaultdict
from typing import Dict, List


class InstructionProfiler:
    """Aggregates min/max/avg wall time per opcode."""

    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)
        self.device_counts: Dict[str, int] = defaultdict(int)
        self.device_time = 0.0

    def record(self, op: str, start: float, end: float) -> None:
        self.records[op].append(end - start)

    def record_device_round(
        self, counts: Dict[str, int], wall_time: float
    ) -> None:
        """Merge one device round: opcode -> retired count, round wall."""
        for op, count in counts.items():
            self.device_counts[op] += count
        self.device_time += wall_time

    def __repr__(self) -> str:
        host_total = sum(sum(d) for d in self.records.values())
        retired = sum(self.device_counts.values())
        amortized = self.device_time / max(retired, 1)
        lines = []
        # ONE sorted table over the union of host and device ops: a
        # host-only row, a device-only row, or both columns side by side
        for op in sorted(set(self.records) | set(self.device_counts)):
            cols = []
            durations = self.records.get(op)
            if durations:
                s = sum(durations)
                cols.append(
                    "host nr %d, total %f s, avg %f s, min %f s, max %f s"
                    % (len(durations), s, s / len(durations),
                       min(durations), max(durations))
                )
            dev_n = self.device_counts.get(op)
            if dev_n:
                cols.append(
                    "device nr %d, ~%f s amortized" % (dev_n, dev_n * amortized)
                )
            lines.append("[%-12s] %s" % (op, ", ".join(cols)))
        header = "Total: %f s (host %f s + device %f s)\n" % (
            host_total + self.device_time, host_total, self.device_time,
        )
        out = header + "\n".join(lines)
        if self.device_counts:
            out += (
                "\nDevice rounds: %f s, %d instructions retired "
                "(amortized %f s/instr)"
                % (self.device_time, retired, amortized)
            )
        return out
