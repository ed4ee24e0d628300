"""The comparison that decides ``correct``: a hand-off's answer against
the plain reference's, run from the same host batch.

The reference (``portbench/reference``) builds its own code bank from the
configuration's bytecode (with its own copy of the static pre-analysis),
uploads the same host planes, runs the fused super-round with the
settings the program's round loop ran the hand-off with (rounds at most,
steps a round, the screen; the pool clause-free), and cuts its planes as
the download ships them (``download_cut``). Compared, byte for byte: every plane of every
lane, the pruned lanes' coverage, and the info vector's counts.
"""

import numpy as np
import torch

from portbench.reference import fused, lanes

# the download's contract (the port's transfer.batch_to_host): planes the
# host never reads come back as zeros, the term tapes as the used-row
# bucket, the bulky planes as a lane bucket over the alive prefix
SKIP_DOWN = ("tape_h1", "tape_h2")
TAPE_PLANES = ("tape_op", "tape_a", "tape_b", "tape_imm", "tape_h1", "tape_h2", "tape_meta")
TAPE_BUCKETS = (16, 64, 256, 1024, 4096)
BIG_DOWN = ("stack", "stack_sym", "memory", "visited", "calldata", "storage_key", "storage_val", "tape_op",
            "tape_a", "tape_b", "tape_imm", "tape_meta")
NDIGITS = 16


def _bucket(n: int, cap: int) -> int:
    for b in TAPE_BUCKETS:
        if n <= b and b <= cap:
            return b
    return cap


def _lane_bucket(n: int, cap: int) -> int:
    b = 16
    while b < n:
        b <<= 1
    return min(b, cap)


def download_cut(planes: dict) -> dict:
    """The planes as the download ships them, padded back to full size."""
    out = {k: v.copy() for k, v in planes.items()}
    cap = out["tape_op"].shape[1]
    L = out["alive"].shape[0]
    t_used = _bucket(int(out["tape_len"].max()), cap)
    for f in TAPE_PLANES:
        cols = t_used * (NDIGITS if f == "tape_imm" else 1)
        out[f][:, cols:] = 0
    alive = out["alive"]
    n_alive = int(alive.sum())
    if n_alive < L and not alive[n_alive:].any():
        lb = _lane_bucket(n_alive, L)
        for f in BIG_DOWN:
            out[f][lb:] = 0
    for f in SKIP_DOWN:
        out[f][:] = 0
    return out


def _to_numpy(st) -> dict:
    shapes = lanes.batch_shapes(lanes.BatchConfig())
    out = {}
    for k, v in st._asdict().items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if np.dtype(shapes[k][1]) == np.uint32 else a
    return out


def reference_handoff(config: dict, np_batch: dict, device, settings, step=None, keep_forks=True):
    """``(planes as downloaded, counts, pruned coverage)`` of the plain
    reference's hand-off of ``np_batch`` under ``settings`` = ``(rounds
    at most, steps a round, screen on)``, as ``program.Program.settings``
    reads them. ``step`` and ``keep_forks`` break the reference (the
    controls)."""
    cfg = lanes.BatchConfig(**config["batch"])
    bank = config["bank"]
    max_rounds, steps_per_round, screen = settings
    with torch.no_grad():
        cb = lanes.make_code_bank([bytes.fromhex(config["runtime_hex"])], cfg.code_len, host_ops=bank["host_ops"],
                                  freeze_errors=bank["freeze_errors"],
                                  record_storage_events=bank["record_storage_events"],
                                  prune_revert=bank["prune_revert"], device=device)
        st = lanes.StateBatch(**lanes._to_torch(np_batch, device))
        out = fused.run_fused_plain(cb, st, max_rounds, steps_per_round, screen, fused.clause_free_pool(device),
                                    step=step, keep_forks=keep_forks)
        planes = download_cut(_to_numpy(out.st))
        pv = out.pruned_visited.cpu().numpy()
    r, pl, ps, pst, n_alive, n_running, kills = out.info
    steps = int(planes["steps"].astype(np.int64).sum()) + ps
    return planes, (steps, r, pl, ps, pst, n_alive, n_running, kills), pv


def plane_differences(got: dict, want: dict) -> dict:
    """Bytes that differ, per plane (only the planes that differ)."""
    diff = {}
    for k, w in want.items():
        g = np.asarray(got[k])
        if g.shape != w.shape:
            diff[k] = int(w.nbytes)
            continue
        n = int(np.count_nonzero(np.ascontiguousarray(g).view(np.uint8) != np.ascontiguousarray(w).view(np.uint8)))
        if n:
            diff[k] = n
    return diff


def coverage_differences(got, want) -> int:
    """The pruned lanes' coverage: the program hands back None where no
    lane was pruned or killed, which is an all-False plane."""
    g = np.zeros_like(want) if got is None else np.asarray(got, dtype=bool)
    if g.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(g != want))

