"""Cells for the tests: a benchmark cell or a pairing of a configuration
and a mix that has no cell yet, and either cut to a size a CPU test run
holds (few lanes, short rounds)."""

from portbench import run, traffic

STEPS = 32


def load(workload: str):
    """``(bench, cell, config, mix)`` of ``workload``; a name
    ``<config>.<traffic>`` that ``BENCHMARK.json`` lists no cell for pairs
    its configuration with its mix."""
    bench = run.load_benchmark()
    if workload not in {w["name"] for w in bench["workloads"]}:
        conf, mix = workload.split(".")
        bench["workloads"].append({"name": workload, "config": conf, "traffic": mix, "chips": 1})
    cell, config = run.load_cell(bench, workload)
    return bench, cell, config, traffic.load_mix(cell["traffic"])


def tiny_cell(workload: str, monkeypatch, lanes: int = 16, seed_lanes: int = 4):
    """The cell's configuration and mix at ``lanes`` lanes, ``seed_lanes``
    of them seeded, one batch; the round loop runs ``STEPS`` steps a
    round for the test's duration only (``monkeypatch``)."""
    monkeypatch.setenv("MYTHRIL_TPU_FUSED_STEPS", str(STEPS))
    bench, cell, config, mix = load(workload)
    config["batch"]["lanes"] = lanes
    mix["seed_lanes"] = seed_lanes
    mix["distinct_batches"] = 1
    return bench, cell, config, mix
