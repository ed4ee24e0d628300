"""The system under test: one device hand-off of ``mythril_tpu_torch``,
as ``backend.exec_batch`` makes it through ``retry.run_round_guarded``.

A hand-off uploads a host batch (K6, ``transfer.batch_to_device``), runs
``backend._run_device_fused`` with the backend's own defaults (the fused
tier, its k, 256 steps a round, the in-loop screen on, its pool from
``solver_cache.GLOBAL``), and downloads the planes as the bridge does
(K7, ``transfer.batch_to_host``). It ends when the planes are on the
host. This module is the benchmark's only import of the program.
"""

import contextlib
import time

import numpy as np


class Bridge:
    """What ``_run_device_fused`` reads and writes on exec_batch's bridge:
    the super-round totals and the pruned lanes' coverage come back here.
    A lane that fills its storage-event ring would need the bridge's host
    spill chain; the benchmark's traffic never does, and a run where one
    does fails."""

    def __init__(self):
        self.fused_round_info = None
        self.fused_pruned_visited = None

    def spill_chain(self, token, events):
        raise RuntimeError("a lane filled its storage-event ring: outside what the benchmark's traffic may do")


class Program:
    def __init__(self, config: dict, device: str):
        from mythril_tpu_torch.laser.cuda import _build, backend, batch, transfer

        self._backend, self._transfer = backend, transfer
        backend.DEVICE = device
        self.device = device
        self.build_s = _build.build_all() if device == "cuda" else {}
        self.cfg = batch.BatchConfig(**config["batch"])
        bank = config["bank"]
        self.cb = batch.make_code_bank(
            [bytes.fromhex(config["runtime_hex"])], self.cfg.code_len, host_ops=bank["host_ops"],
            freeze_errors=bank["freeze_errors"], record_storage_events=bank["record_storage_events"],
            prune_revert=bank["prune_revert"], device=device)

    def settings(self, totals: dict) -> tuple:
        """What the round loop ran a hand-off with, as the reference needs
        it: ``(rounds a dispatch may run, steps a round, the screen on)``.
        The first is the backend's adaptive k as the totals record it; the
        others are read from the backend's getters, as it read them."""
        b = self._backend
        return int(totals["k"]), int(b._fused_steps_per_round()), bool(b._inloop_enabled())

    def pool_clauses(self) -> int:
        """Clauses in the in-loop pool the backend builds now (the
        reference has only the clause-free pool, so this has to be 0)."""
        from mythril_tpu_torch.laser.cuda import solver_cache

        return int(solver_cache.GLOBAL.build_inloop_pool().lit_used.any(-1).sum())

    def handoff(self, np_batch: dict, span=None, events=None, clock=None):
        """One hand-off: ``(host planes as a StateBatch of numpy arrays,
        the super-round totals, the pruned lanes' coverage or None)``.
        ``span(name)`` wraps each phase (the traced run's host spans);
        ``events`` (a list) gets CUDA event pairs around upload and
        download; ``clock`` (a list) gets the host clock at the start of
        each phase and at the end."""
        span = span or (lambda name: contextlib.nullcontext())
        tick = clock.append if clock is not None else (lambda t: None)
        bridge = Bridge()
        tick(time.perf_counter())
        with span("handoff.upload"):
            e = _event_pair(events, "upload")
            st = self._transfer.batch_to_device(np_batch, self.cfg, device=self.device)
            _close(e)
        tick(time.perf_counter())
        with span("handoff.round_loop"):
            out, _hist = self._backend._run_device_fused(self.cb, st, self.cfg, bridge=bridge)
        tick(time.perf_counter())
        with span("handoff.download"):
            e = _event_pair(events, "download")
            host = self._transfer.batch_to_host(out)
            _close(e)
        tick(time.perf_counter())
        return host, bridge.fused_round_info, bridge.fused_pruned_visited


def _event_pair(events, name):
    if events is None:
        return None
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    events.append((name, e0, e1))
    return e1


def _close(e1):
    if e1 is not None:
        e1.record()


def counts(host, totals: dict) -> tuple:
    """What a hand-off's answer is judged on beside its planes: the steps
    of every path it retired (each lane's final ``steps`` plus the pruned
    lanes' from the info vector) and the info vector's fields."""
    alive = np.asarray(host.alive)
    status = np.asarray(host.status)
    steps = int(np.asarray(host.steps, dtype=np.int64).sum()) + int(totals["pruned_steps"])
    return (steps, int(totals["rounds"]), int(totals["pruned_lanes"]), int(totals["pruned_steps"]),
            int(totals["pruned_static"]), int(alive.sum()), int((alive & (status == 0)).sum()),
            int(totals["inloop_kills"]))


SETTING_NAMES = ("fused_k", "steps_per_round", "inloop_screen")
COUNT_NAMES = ("steps", "rounds", "pruned_lanes", "pruned_steps", "pruned_static", "n_alive", "n_running",
               "inloop_kills")
