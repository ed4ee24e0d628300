"""The benchmark's data: BENCHMARK.json, the configuration and traffic
files, the metric readers, and the seeds."""

import json
import os
import re

import numpy as np
import pytest

from portbench import control, run, traffic
from portbench.reference import lanes
from portbench.tests.tiny import load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_entries_resolve():
    bench = run.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        with open(os.path.join(run.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        # every departure from the source is a key of the file, listed in reduced, with its reason
        assert c["reduced"] == conf["reduced"] and all(k in conf and k in conf["departures"] for k in c["reduced"])
        lanes.BatchConfig(**conf["batch"])
        bytes.fromhex(conf["runtime_hex"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        run.load_cell(bench, w["name"])
        assert traffic.load_mix(w["traffic"])["control"] in control.CONTROLS
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert callable(run._metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_default_batch_is_the_production_shape():
    for name in ("bectoken", "token"):
        with open(os.path.join(run.HERE, "configs", name + ".json")) as f:
            assert lanes.BatchConfig(**json.load(f)["batch"]) == lanes.DEFAULT_BATCH_CFG


@pytest.mark.parametrize("workload", ["bectoken.frontier", "token.frontier", "bectoken.concrete"])
@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3])
def test_seeds_are_deterministic(workload, seed):
    _bench, _cell, config, mix = load(workload)
    a = traffic.lane_specs(config, mix, seed, 1)
    assert a == traffic.lane_specs(config, mix, seed, 1)
    assert len(a) == mix["seed_lanes"]
    other = traffic.lane_specs(config, mix, seed + 1, 1)
    drawn = any(k["caller"] == "drawn" or k["calldata"] != "symbolic" for k in mix["kinds"])
    assert (a != other) == drawn  # an all-symbolic frontier is the same batch under every seed
    # the same set of lane kinds and sizes under every seed, in another order
    kinds = lambda specs: sorted(tuple(sorted(k for k in s if k != "caller")) for s in specs)  # noqa: E731
    assert kinds(a) == kinds(other)
    if "calldata" in a[0]:
        assert sorted(len(s["calldata"]) for s in a) == sorted(len(s["calldata"]) for s in other)


def test_batches_match_lane_by_lane_filling():
    bench = run.load_benchmark()
    cell, config = run.load_cell(bench, "bectoken.frontier")
    config["batch"]["lanes"] = 64
    mix = traffic.load_mix(cell["traffic"])
    mix["seed_lanes"] = 16
    specs = traffic.lane_specs(config, mix, 11, 0)
    cfg = lanes.BatchConfig(**config["batch"])
    fast = lanes.numpy_batch(cfg, specs)
    slow = {k: np.zeros(s, d) for k, (s, d) in lanes.batch_shapes(cfg).items()}
    for i, spec in enumerate(specs):
        lanes._fill_lane(slow, i, **spec)
    assert all(np.array_equal(fast[k], slow[k]) for k in slow)


def test_concrete_calls_decode_as_the_contract_reads_them():
    _bench, _cell, config, mix = load("bectoken.concrete")
    specs = traffic.lane_specs(config, mix, 5, 0)
    for s in specs:
        cd = s["calldata"]
        assert cd[:4] == bytes.fromhex("83f12fec")
        word = lambda off: int.from_bytes(cd[off:off + 32], "big")  # noqa: E731
        assert word(4) == 0x40 and 1 <= word(0x44) <= 4 and len(cd) == 0x64 + 32 * word(0x44)
        assert s["caller"] < 2**160 and not s.get("symbolic_storage")
    assert traffic.keccak_words([0])[0] == 0x290DECD9548B62A8D60345A988386FC84BA6BC95484008F6362F93160EF3E563
