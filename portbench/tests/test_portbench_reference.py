"""The plain reference on tiny batches: it agrees with itself, its early
end of a round changes nothing, it agrees with the program's own twin,
and its controls do not."""

import numpy as np
import pytest

from portbench import check, traffic
from portbench.reference import fused, lanes
from portbench.tests.tiny import STEPS, tiny_cell

SETTINGS = (16, STEPS, True)


def _batch(workload, seed, monkeypatch, lanes_=16, seed_lanes=4):
    _bench, _cell, config, mix = tiny_cell(workload, monkeypatch, lanes_, seed_lanes)
    return config, lanes.numpy_batch(lanes.BatchConfig(**config["batch"]), traffic.lane_specs(config, mix, seed, 0))


@pytest.mark.parametrize("workload", ["token.frontier", "bectoken.concrete"])
def test_reference_agrees_with_itself(workload, monkeypatch):
    config, nb = _batch(workload, 3, monkeypatch)
    a = check.reference_handoff(config, nb, "cpu", SETTINGS)
    b = check.reference_handoff(config, nb, "cpu", SETTINGS)
    assert check.plane_differences(a[0], b[0]) == {} and a[1] == b[1]
    assert not np.any(a[2] != b[2])


def test_early_end_of_a_round_changes_nothing(monkeypatch):
    config, nb = _batch("token.frontier", 4, monkeypatch)
    cfg = lanes.BatchConfig(**config["batch"])
    cb = lanes.make_code_bank([bytes.fromhex(config["runtime_hex"])], cfg.code_len, host_ops=config["bank"]["host_ops"],
                              freeze_errors=True, record_storage_events=True, prune_revert=True, device="cpu")
    st = lanes.StateBatch(**lanes._to_torch(nb, "cpu"))
    pool = fused.clause_free_pool("cpu")
    early = fused.run_fused_plain(cb, st, 2, 48, True, pool, check_every=1)
    full = fused.run_fused_plain(cb, st, 2, 48, True, pool, check_every=10**9)
    assert early.info == full.info
    assert all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(early.st, full.st))


@pytest.mark.parametrize("workload", ["token.frontier", "bectoken.frontier", "bectoken.concrete"])
def test_reference_agrees_with_the_programs_twin(workload, monkeypatch):
    from portbench import program

    config, nb = _batch(workload, 9, monkeypatch)
    prog = program.Program(config, "cpu")
    host, totals, pv = prog.handoff(nb)
    settings = prog.settings(totals)
    assert settings == SETTINGS and prog.pool_clauses() == 0
    planes, counts, ref_pv = check.reference_handoff(config, nb, "cpu", settings)
    assert check.plane_differences(host._asdict(), planes) == {}
    assert program.counts(host, totals) == counts
    assert check.coverage_differences(pv, ref_pv) == 0


def test_reference_follows_the_programs_round_length(monkeypatch):
    """The reference runs what the program's round loop ran: a round
    length set in the environment reaches both sides."""
    from portbench import program

    config, nb = _batch("bectoken.frontier", 9, monkeypatch)
    monkeypatch.setenv("MYTHRIL_TPU_FUSED_STEPS", "8")
    prog = program.Program(config, "cpu")
    host, totals, _pv = prog.handoff(nb)
    settings = prog.settings(totals)
    assert settings == (16, 8, True)
    _planes, counts, _ = check.reference_handoff(config, nb, "cpu", settings)
    assert program.counts(host, totals) == counts
    _planes, other, _ = check.reference_handoff(config, nb, "cpu", SETTINGS)
    assert other != counts


@pytest.mark.parametrize("workload", ["token.frontier", "bectoken.frontier", "bectoken.concrete"])
def test_control_is_not_correct(workload, monkeypatch):
    from portbench import control

    _bench, cell, config, mix = tiny_cell(workload, monkeypatch)
    nb = lanes.numpy_batch(lanes.BatchConfig(**config["batch"]), traffic.lane_specs(config, mix, 2**31 + 1, 0))
    r = control.reading(config, nb, "cpu", mix["control"], SETTINGS)
    assert r["plane_bytes_differing"] > 0 and r["info_fields_differing"] > 0
