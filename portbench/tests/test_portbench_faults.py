"""A run on the CPU at a tiny size, the chip's look skipped, with the
timed path broken underneath: ``correct`` has to come out false. The
exchange between chips has no fault here: every cell runs on one card."""

import numpy as np
import pytest

from portbench import run
from portbench.tests.tiny import tiny_cell


def _run(monkeypatch, workload="token.frontier"):
    bench, cell, config, mix = tiny_cell(workload, monkeypatch)
    per_layer = [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]
    result, checks = run.run_cell(cell, config, mix, 2**31 + 99, 0.01, False, "cpu", per_layer=per_layer,
                                  log=lambda msg: None)
    return result


def test_sound_run_is_correct(monkeypatch):
    r = _run(monkeypatch)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"steps_per_s", "handoff_p95_ms", "setup_s"}
    assert [c["name"] for c in r["checks"]] == ["plane_bytes_differing", "info_fields_differing",
                                                "handoffs_disagreeing"]


def test_step_that_returns_its_state_unchanged(monkeypatch):
    from mythril_tpu_torch.laser.cuda import engine

    monkeypatch.setattr(engine, "step_plain", lambda cb, st, n_shards=1: st)
    assert _run(monkeypatch)["correct"] is False


def test_half_the_batch_left_out(monkeypatch):
    from mythril_tpu_torch.laser.cuda import transfer

    real = transfer.batch_to_device

    def upload_half(np_batch, cfg, device="cuda"):
        half = {k: v.copy() for k, v in np_batch.items()}
        half["alive"][len(half["alive"]) // 2:] = False
        seeded = np.nonzero(np_batch["alive"])[0]
        half["alive"][seeded[len(seeded) // 2:]] = False
        return real(half, cfg, device=device)

    monkeypatch.setattr(transfer, "batch_to_device", upload_half)
    assert _run(monkeypatch)["correct"] is False


def test_answer_altered_where_it_is_produced(monkeypatch):
    from mythril_tpu_torch.laser.cuda import transfer

    real = transfer.batch_to_host

    def download_altered(st, n_shards=1):
        host = real(st, n_shards)
        pc = np.array(host.pc)
        pc[0] += 1
        return host._replace(pc=pc)

    monkeypatch.setattr(transfer, "batch_to_host", download_altered)
    assert _run(monkeypatch)["correct"] is False


@pytest.mark.card
def test_a_run_on_the_card(card, tmp_path):
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "token.frontier", "--seed", "5",
                          "--seconds", "2", "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
