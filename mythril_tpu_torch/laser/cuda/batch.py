"""Structure-of-arrays EVM state batch: the port's ``StateBatch``.

Counterpart of ``mythril_tpu/laser/tpu/batch.py``. ``StateBatch``,
``CodeBank`` and ``Env`` keep the reference's field names and order, and
``batch_shapes()`` is identical, so every plane maps 1:1. Planes are
torch tensors; the reference's u32 planes are ``torch.int32`` tensors
holding the same bits (see ``convert.py``). The host helpers below are
the reference's, building numpy planes that one transfer moves to the
device.

(Reference notes follow.)

The reference holds one ``GlobalState`` per path as a Python object graph
(mythril/laser/ethereum/state/global_state.py:21) and forks by deepcopy.
Here a whole *population* of machine states lives as one pytree of dense
arrays in HBM — lane ``i`` of every array is path ``i`` — so the step
function vectorises across paths on the VPU and forking is a lane copy.

Words are 16x16-bit digit vectors (laser/tpu/words.py). Memory and
calldata are fixed-capacity byte planes with explicit lengths; storage is
a per-lane associative array of (key, value) word pairs probed by linear
scan (K slots, vectorised compare — the EVM touches only a handful of
slots per path, and a miss traps the lane back to the host engine).

Lanes carry a ``status`` machine word:
  0 RUNNING   1 STOPPED    2 RETURNED   3 REVERTED
  4 ERROR (invalid op / bad jump / stack fault / out-of-gas)
  5 TRAP  — lane hit something the device kernel doesn't model
            (CALL family, CREATE, storage overflow, oversized SHA3);
            the host engine unpacks the lane and continues it symbolically.
  6 TRAP_SS — the storage-event ring filled and that is the ONLY reason
            the lane stopped: the backend drains the ring to a host-side
            spill buffer mid-round (keyed by the lane's spill_id chain)
            and resumes the lane on device; at lift the spilled events
            replay before the ring's. A TRAP_SS lane that is never
            drained (round deadline) lifts exactly like TRAP.
Dead lanes (alive=False) are free slots for JUMPI forking.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from mythril_tpu_torch.laser.cuda import _build, symtape, words

RUNNING, STOPPED, RETURNED, REVERTED, ERROR, TRAP = range(6)
TRAP_SS = 6



class BatchConfig(NamedTuple):
    """Static capacities (shape parameters) of a state batch."""

    lanes: int = 256
    stack_slots: int = 64
    memory_bytes: int = 4096
    calldata_bytes: int = 512
    storage_slots: int = 32
    code_len: int = 8192
    tape_slots: int = 256  # symbolic term-tape rows per lane
    path_slots: int = 64  # path-condition entries per lane
    mem_sym_slots: int = 16  # 32-byte symbolic memory-overlay words per lane
    # storage event capacity per lane (SLOADs + SSTOREs): the bridge
    # re-fires the skipped pre-hooks per recorded event at lift; a lane
    # exceeding this in one device segment freeze-traps at the
    # overflowing op. 128 keeps write-heavy loops (the workloads the
    # batch engine should win on) on device for whole transactions at
    # ~2KB/lane. Coupled to tape_slots: each DISTINCT concrete key or
    # value also allocates one OP_CONST tape row (CSE dedupes repeats),
    # so tape_slots should stay comfortably above the distinct-operand
    # count a full ring can record.
    ss_ring: int = 128
    # hybrid scheduler policy, two gates ANDed together (0 = gate off;
    # test configs pin both to 0 for deterministic device engagement):
    #
    # min_device_frontier: the device only joins when the host-phase
    # survivor frontier is at least this wide.
    #
    # device_engage_after_s: the device only joins once the analysis has
    # RUN this long. Frontier width alone cannot discriminate (on the
    # bench stress workload the host-side frontier never exceeds 2
    # because the DEVICE's JUMPI forking is what amplifies it — yet
    # device rounds give it 13x; meanwhile sub-second analyses lose 3x+
    # to per-round fixed overheads). Elapsed time does discriminate:
    # contracts the host finishes in under the threshold never pay a
    # device round, and long-running analyses engage and amplify.
    min_device_frontier: int = 0
    device_engage_after_s: float = 0.0


# The production batch shape: a copy of the reference backend's
# DEFAULT_BATCH_CFG (mythril_tpu/laser/tpu/backend.py:75-98). The
# scheduler gates (min_device_frontier, device_engage_after_s) belong to
# the host backend, which is not ported yet; they are kept for parity.
DEFAULT_BATCH_CFG = BatchConfig(
    lanes=512,
    stack_slots=32,
    memory_bytes=1024,
    calldata_bytes=256,
    storage_slots=32,
    code_len=8192,
    tape_slots=192,
    path_slots=32,
    mem_sym_slots=8,
    min_device_frontier=1,
    device_engage_after_s=1.5,
)


class CodeBank(NamedTuple):
    """Deduplicated bytecode plane shared by all lanes (lane -> code_id).

    ``host_ops`` and ``freeze_errors`` configure the hybrid host/device
    loop (laser/tpu/backend.py): opcodes flagged in host_ops freeze-trap
    so the host executes them with full hook/signal fidelity, and with
    freeze_errors set, error conditions (invalid op, stack faults, bad
    jumps, OOG) freeze instead of killing the lane so the host replays
    them through its exception handling."""

    code: torch.Tensor  # u8[n_codes, code_len]
    code_len: torch.Tensor  # i32[n_codes]
    jumpdest: torch.Tensor  # bool[n_codes, code_len] valid JUMPDEST targets
    # PUSH immediates pre-decoded per byte-pc (zero elsewhere): turns the
    # step kernel's per-lane 32-byte code gather + big-endian assembly
    # into one [L, 16] row gather — PUSH is the most common opcode, and
    # byte-granularity gathers were the hottest ops in the step profile
    push_imm: torch.Tensor  # u32[n_codes, code_len, 16]
    host_ops: torch.Tensor  # bool[256] opcodes that must return to the host
    freeze_errors: torch.Tensor  # bool[] scalar
    # record storage events (and freeze-trap on ring overflow, and
    # allocate CONST nodes for concrete keys/values) only when someone
    # will replay them: without SLOAD/SSTORE replay hooks the ring is
    # dead weight, concrete workloads would allocate tape rows for
    # nothing, and the overflow trap would bounce write-heavy lanes to
    # the host for no detection benefit
    record_storage_events: torch.Tensor  # bool[] scalar
    # static-pass must-revert bitmap (analysis/static_pass/): a byte-pc
    # flagged True starts/continues a block whose every execution runs
    # only device-pure ops into REVERT. With prune_revert set, JUMPI fork
    # children landing on such a pc in an OUTERMOST frame are suppressed
    # instead of forked (engine.py) — the host never sees the lane.
    must_revert: torch.Tensor  # bool[n_codes, code_len]
    prune_revert: torch.Tensor  # bool[] scalar
    # static SWC candidate bits per byte-pc (analysis/static_pass/taint
    # SWC_MASK_*): the kernel does not branch on this plane — the
    # backend joins it host-side against the visited plane after each
    # round to surface device-side candidate sites per SWC class, with
    # the host detection modules as the authoritative confirm
    swc_mask: torch.Tensor  # u8[n_codes, code_len]
    # taint/interval MUST branch facts per JUMPI byte-pc (tables.py
    # jumpi_verdict: 1 = condition provably nonzero, 2 = provably zero,
    # 0 = unknown). The step kernel applies these at symbolic JUMPIs:
    # a must-take lane jumps in place (path sign True, no fork) and a
    # must-fall-through lane suppresses its taken child — the branch the
    # verdict contradicts is UNSAT, so no lane, no lift, and no solver
    # call are ever spent on it. The host-side contradiction seeding in
    # bridge.py stays as the check for host-forked states.
    jumpi_verdict: torch.Tensor  # i8[n_codes, code_len]


class Env(NamedTuple):
    """Lane-shared block context: EMPTY by design. Block/tx environment
    reads (TIMESTAMP/NUMBER/...) retire as symbolic tape leaves
    (symtape.ENV_LEAF_OP) that the bridge lifts to host symbols, so the
    kernel carries no concrete env words; the tuple survives as the
    run()/mesh plumbing slot for future genuinely-shared context."""


# depth of the on-device jump-LANDING ring buffer (where each committed
# JUMP/JUMPI landed — the host's block-entry stream): feeds bounded-loop
# suffix-cycle detection and the dependency pruner's entry replay
JD_RING = 64



class StateBatch(NamedTuple):
    alive: torch.Tensor  # bool[L] lane holds a state
    status: torch.Tensor  # i32[L] RUNNING..TRAP
    trap_op: torch.Tensor  # i32[L] opcode that caused TRAP
    pc: torch.Tensor  # i32[L]
    code_id: torch.Tensor  # i32[L] row into CodeBank
    stack: torch.Tensor  # u32[L, S*16] FLAT (see batch_shapes)
    sp: torch.Tensor  # i32[L] number of live stack slots
    memory: torch.Tensor  # u8[L, M]
    mem_words: torch.Tensor  # i32[L] EVM msize / 32 (expansion high-water)
    gas_left: torch.Tensor  # u32[L] gas remaining under the MIN-cost model
    gas_spent_max: torch.Tensor  # u32[L] accumulated MAX-cost bound
    storage_key: torch.Tensor  # u32[L, K*16] FLAT
    storage_val: torch.Tensor  # u32[L, K*16] FLAT
    storage_used: torch.Tensor  # bool[L, K]
    ret_off: torch.Tensor  # i32[L] RETURN/REVERT data offset
    ret_len: torch.Tensor  # i32[L]
    calldata: torch.Tensor  # u8[L, C]
    calldata_len: torch.Tensor  # i32[L]
    callvalue: torch.Tensor  # u32[L, 16]
    caller: torch.Tensor  # u32[L, 16]
    origin: torch.Tensor  # u32[L, 16]
    address: torch.Tensor  # u32[L, 16]
    balance: torch.Tensor  # u32[L, 16] self-balance
    steps: torch.Tensor  # i32[L] instructions retired in this lane
    visited: torch.Tensor  # bool[L, code_len] byte-pcs retired (coverage)
    jd_ring: torch.Tensor  # i32[L, JD_RING] last jump-landing byte-pcs
    jd_cnt: torch.Tensor  # i32[L] total jump landings
    jump_cnt: torch.Tensor  # i32[L] JUMP/JUMPI retired (the host's depth unit)
    ss_pc: torch.Tensor  # i32[L, ss_ring] byte pc of each storage event
    ss_key: torch.Tensor  # i32[L, ss_ring] key tape id (CONST node if concrete)
    ss_val: torch.Tensor  # i32[L, ss_ring] SSTORE value tape id (0 for loads)
    ss_is_load: torch.Tensor  # bool[L, ss_ring] SLOAD (True) vs SSTORE
    ss_jd: torch.Tensor  # i32[L, ss_ring] landing count when the event fired
    ss_cnt: torch.Tensor  # i32[L] storage events retired on device
    spill_id: torch.Tensor  # i32[L] host spill-chain token for drained ring events (0 = none); fork-copied with the lane
    # ---- symbolic layer (laser/tpu/symtape.py). Tags are 1-based tape
    # ids; 0 = concrete (the word/byte planes are authoritative).
    stack_sym: torch.Tensor  # i32[L, S]
    tape_op: torch.Tensor  # i32[L, T]
    tape_a: torch.Tensor  # i32[L, T]
    tape_b: torch.Tensor  # i32[L, T]
    tape_imm: torch.Tensor  # u32[L, T*16] FLAT; row t = cols [16t, 16t+16) (see batch_shapes)
    tape_h1: torch.Tensor  # u32[L, T] node identity hashes: the device
    tape_h2: torch.Tensor  # u32[L, T] CSE scan compares only these planes
    tape_meta: torch.Tensor  # u32[L, T] allocation-site pc|path_len (symtape.pack_meta)
    tape_len: torch.Tensor  # i32[L]
    path_id: torch.Tensor  # i32[L, P] branch-condition tape ids
    path_sign: torch.Tensor  # bool[L, P] True = condition word != 0
    path_meta: torch.Tensor  # u32[L, P] symtape.pack_meta of the appending JUMPI (host pack appends no entries)
    path_len: torch.Tensor  # i32[L]
    msym_off: torch.Tensor  # i32[L, MS] byte offset of a symbolic mem word
    msym_id: torch.Tensor  # i32[L, MS]
    msym_used: torch.Tensor  # bool[L, MS]
    # storage key tags. A tagged (symbolic) entry zeroes its concrete
    # key word EXCEPT digits 0..7, which carry the key's 128-bit
    # content digest (symtape.sha3_imm contract; 0 = none) so device
    # probes match by content across node-id renumbering — consumers
    # must check skey_sym first and never read a tagged entry's key
    # word as a key value (read_storage_full callers lift the tag)
    skey_sym: torch.Tensor  # i32[L, K]
    sval_sym: torch.Tensor  # i32[L, K] storage value tags
    calldata_symbolic: torch.Tensor  # bool[L] calldata is a free symbol plane
    storage_symbolic: torch.Tensor  # bool[L] world storage is symbolic
    cdsize_sym: torch.Tensor  # i32[L] tag for CALLDATASIZE
    caller_sym: torch.Tensor  # i32[L]
    callvalue_sym: torch.Tensor  # i32[L]
    origin_sym: torch.Tensor  # i32[L]
    balance_sym: torch.Tensor  # i32[L]
    seed_id: torch.Tensor  # i32[L] host-side id of the seeding state
    # owning analysis job in a shared multi-tenant round (service/lanes.py);
    # 0 = single-tenant / free lane. Fork children inherit it through the
    # generic plane gather, so per-job harvest splits the batch exactly.
    job_id: torch.Tensor  # i32[L]
    # True when the lane's host state is an outermost (transaction-level)
    # frame — the gate for static must-revert pruning: a reverting
    # outermost frame is discarded by _finalize_transaction with no
    # observable effect, so its lane may be killed at fork time
    outermost: torch.Tensor  # bool[L]
    static_pruned: torch.Tensor  # i32[L] fork children suppressed by the static pass


def batch_shapes(cfg: BatchConfig) -> dict:
    """field -> (shape, numpy dtype) for a batch of this config."""
    L, S, M, C, K = (
        cfg.lanes,
        cfg.stack_slots,
        cfg.memory_bytes,
        cfg.calldata_bytes,
        cfg.storage_slots,
    )
    T, P, MS = cfg.tape_slots, cfg.path_slots, cfg.mem_sym_slots
    D = words.NDIGITS
    word = ((L, D), np.uint32)
    return {
        "alive": ((L,), np.bool_),
        "status": ((L,), np.int32),
        "trap_op": ((L,), np.int32),
        "pc": ((L,), np.int32),
        "code_id": ((L,), np.int32),
        # stack/storage word planes are FLAT like tape_imm (row i =
        # cols [i*D, (i+1)*D)): one canonical 2D layout for the fork
        # gather; engine/step reshapes 3D views over the same bytes
        "stack": ((L, S * D), np.uint32),
        "sp": ((L,), np.int32),
        "memory": ((L, M), np.uint8),
        "mem_words": ((L,), np.int32),
        "gas_left": ((L,), np.uint32),
        "gas_spent_max": ((L,), np.uint32),
        "storage_key": ((L, K * D), np.uint32),
        "storage_val": ((L, K * D), np.uint32),
        "storage_used": ((L, K), np.bool_),
        "ret_off": ((L,), np.int32),
        "ret_len": ((L,), np.int32),
        "calldata": ((L, C), np.uint8),
        "calldata_len": ((L,), np.int32),
        "callvalue": word,
        "caller": word,
        "origin": word,
        "address": word,
        "balance": word,
        "steps": ((L,), np.int32),
        "visited": ((L, cfg.code_len), np.bool_),
        "jd_ring": ((L, JD_RING), np.int32),
        "jd_cnt": ((L,), np.int32),
        "jump_cnt": ((L,), np.int32),
        "ss_pc": ((L, cfg.ss_ring), np.int32),
        "ss_key": ((L, cfg.ss_ring), np.int32),
        "ss_val": ((L, cfg.ss_ring), np.int32),
        "ss_is_load": ((L, cfg.ss_ring), np.bool_),
        "ss_jd": ((L, cfg.ss_ring), np.int32),
        "ss_cnt": ((L,), np.int32),
        "spill_id": ((L,), np.int32),
        "stack_sym": ((L, S), np.int32),
        "tape_op": ((L, T), np.int32),
        "tape_a": ((L, T), np.int32),
        "tape_b": ((L, T), np.int32),
        # FLAT [L, T*D] (not [L, T, D]): 2D planes keep one canonical
        # tiled layout on TPU — the 3D form made XLA satisfy the fork
        # gather with a transposed layout and pay two full-plane
        # transpose copies per step (symtape._alloc_impl reshapes a 3D
        # view over the same bytes; row t = columns [t*D, (t+1)*D))
        "tape_imm": ((L, T * D), np.uint32),
        "tape_h1": ((L, T), np.uint32),
        "tape_h2": ((L, T), np.uint32),
        "tape_meta": ((L, T), np.uint32),
        "tape_len": ((L,), np.int32),
        "path_id": ((L, P), np.int32),
        "path_sign": ((L, P), np.bool_),
        "path_meta": ((L, P), np.uint32),
        "path_len": ((L,), np.int32),
        "msym_off": ((L, MS), np.int32),
        "msym_id": ((L, MS), np.int32),
        "msym_used": ((L, MS), np.bool_),
        "skey_sym": ((L, K), np.int32),
        "sval_sym": ((L, K), np.int32),
        "calldata_symbolic": ((L,), np.bool_),
        "storage_symbolic": ((L,), np.bool_),
        "cdsize_sym": ((L,), np.int32),
        "caller_sym": ((L,), np.int32),
        "callvalue_sym": ((L,), np.int32),
        "origin_sym": ((L,), np.int32),
        "balance_sym": ((L,), np.int32),
        "seed_id": ((L,), np.int32),
        "job_id": ((L,), np.int32),
        "outermost": ((L,), np.bool_),
        "static_pruned": ((L,), np.int32),
    }


def empty_batch(cfg: BatchConfig, device="cuda") -> StateBatch:
    dev = _build.resolve_device(device)
    from mythril_tpu_torch.laser.cuda import convert

    return StateBatch(
        **{
            k: torch.zeros(shape, dtype=convert.torch_dtype(dtype), device=dev)
            for k, (shape, dtype) in batch_shapes(cfg).items()
        }
    )


def make_code_bank(
    codes, code_len: int, host_ops=None, freeze_errors=False,
    record_storage_events=False, prune_revert=False, device="cuda",
) -> CodeBank:
    """Host helper: list of bytes objects -> CodeBank (pads / analyses).

    ``host_ops`` is an optional iterable of opcode bytes that must
    freeze-trap back to the host (hybrid-loop mode). ``prune_revert``
    arms static must-revert fork pruning (see CodeBank.must_revert).

    The JUMPDEST and must-revert bitmaps come from the static
    pre-analysis pass (analysis/static_pass/, one cached analysis per
    bytecode); only the PUSH-immediate pre-decode stays inline because
    its u32-digit layout is device-specific.

    The row count pads to a power of two so the jitted step kernel sees a
    stable CodeBank shape across analyses (one compile per bucket, not one
    per distinct contract count)."""
    dev = _build.resolve_device(device)
    from mythril_tpu_torch.analysis import static_pass
    from mythril_tpu_torch.laser.cuda import convert

    n = 1
    while n < len(codes):
        n <<= 1
    code = np.zeros((n, code_len), dtype=np.uint8)
    lens = np.zeros((n,), dtype=np.int32)
    jd = np.zeros((n, code_len), dtype=bool)
    mrev = np.zeros((n, code_len), dtype=bool)
    swc = np.zeros((n, code_len), dtype=np.uint8)
    jvrd = np.zeros((n, code_len), dtype=np.int8)
    pimm = np.zeros((n, code_len, words.NDIGITS), dtype=np.uint32)
    for i, c in enumerate(codes):
        if len(c) > code_len:
            raise ValueError(f"code {i} length {len(c)} exceeds bank width {code_len}")
        code[i, : len(c)] = np.frombuffer(bytes(c), dtype=np.uint8)
        lens[i] = len(c)
        analysis = static_pass.analyze(bytes(c))
        jd[i, : len(c)] = analysis.jumpdest_bitmap
        mrev[i, : len(c)] = analysis.must_revert_pc
        swc[i, : len(c)] = analysis.swc_mask
        verdict = getattr(analysis, "jumpi_verdict", None)
        if verdict is not None:
            jvrd[i, : len(c)] = verdict
        # Pre-decode PUSH immediates (truncated pushes zero-pad on the
        # right, matching the EVM's implicit zero bytes past code end).
        pc = 0
        while pc < len(c):
            op = c[pc]
            if 0x60 <= op <= 0x7F:
                k = op - 0x5F
                imm = bytes(c[pc + 1 : pc + 1 + k])
                imm = imm + b"\x00" * (k - len(imm))
                pimm[i, pc] = words.from_int(int.from_bytes(imm, "big"))
                pc += k
            pc += 1
    hops = np.zeros(256, dtype=bool)
    for b in host_ops or ():
        hops[b] = True
    return convert.code_bank_to_torch(
        dict(
            code=code,
            code_len=lens,
            jumpdest=jd,
            push_imm=pimm,
            host_ops=hops,
            freeze_errors=np.asarray(bool(freeze_errors)),
            record_storage_events=np.asarray(bool(record_storage_events)),
            must_revert=mrev,
            prune_revert=np.asarray(bool(prune_revert)),
            swc_mask=swc,
            jumpi_verdict=jvrd,
        ),
        dev,
    )


def default_env() -> Env:
    return Env()


def append_node(np_batch: dict, lane: int, op: int, a: int = 0, b: int = 0, imm=None) -> int:
    """Host helper: append one term-tape node to a lane; returns 1-based id.

    Performs the same CSE as the device allocator (symtape.alloc) so host
    packing and device stepping agree on node identity.
    """
    T = np_batch["tape_op"].shape[1]
    n = int(np_batch["tape_len"][lane])
    imm_row = np.zeros(words.NDIGITS, np.uint32) if imm is None else np.asarray(imm, np.uint32)
    imm3 = np_batch["tape_imm"][lane].reshape(T, words.NDIGITS)
    for j in range(n):
        if (
            np_batch["tape_op"][lane, j] == op
            and np_batch["tape_a"][lane, j] == a
            and np_batch["tape_b"][lane, j] == b
            and (imm3[j] == imm_row).all()
        ):
            return j + 1
    if n >= T:
        raise ValueError(f"lane {lane} term tape full ({T} slots)")
    np_batch["tape_op"][lane, n] = op
    np_batch["tape_a"][lane, n] = a
    np_batch["tape_b"][lane, n] = b
    imm3[n] = imm_row  # view write-through into the flat plane
    h1, h2 = symtape.node_hash(op, a, b, imm_row)
    np_batch["tape_h1"][lane, n] = h1
    np_batch["tape_h2"][lane, n] = h2
    np_batch["tape_meta"][lane, n] = symtape.HOST_META
    np_batch["tape_len"][lane] = n + 1
    return n + 1


def _fill_lane(
    np_batch: dict,
    lane: int,
    *,
    code_id: int = 0,
    calldata: bytes = b"",
    callvalue: int = 0,
    caller: int = 0xDEADBEEF,
    origin: Optional[int] = None,
    address: int = 0xAFFE,
    balance: int = 10**18,
    gas: int = 10_000_000,
    storage: Optional[dict] = None,
    symbolic_calldata: bool = False,
    symbolic_storage: bool = False,
    symbolic_caller: bool = False,
    symbolic_callvalue: bool = False,
    symbolic_balance: bool = False,
    seed_id: int = 0,
    job_id: int = 0,
    outermost: bool = True,
) -> None:
    C = np_batch["calldata"].shape[1]
    if len(calldata) > C:
        raise ValueError("calldata exceeds batch capacity")
    np_batch["alive"][lane] = True
    np_batch["status"][lane] = RUNNING
    np_batch["trap_op"][lane] = 0
    np_batch["pc"][lane] = 0
    np_batch["code_id"][lane] = code_id
    np_batch["stack"][lane] = 0
    np_batch["sp"][lane] = 0
    np_batch["memory"][lane] = 0
    np_batch["mem_words"][lane] = 0
    np_batch["gas_left"][lane] = gas
    np_batch["gas_spent_max"][lane] = 0
    np_batch["storage_used"][lane] = False
    np_batch["ret_off"][lane] = 0
    np_batch["ret_len"][lane] = 0
    np_batch["calldata"][lane] = 0
    np_batch["calldata"][lane, : len(calldata)] = np.frombuffer(bytes(calldata), np.uint8)
    np_batch["calldata_len"][lane] = len(calldata)
    np_batch["callvalue"][lane] = words.from_int(callvalue)
    np_batch["caller"][lane] = words.from_int(caller)
    np_batch["origin"][lane] = words.from_int(caller if origin is None else origin)
    np_batch["address"][lane] = words.from_int(address)
    np_batch["balance"][lane] = words.from_int(balance)
    np_batch["steps"][lane] = 0
    np_batch["visited"][lane] = False
    np_batch["jd_ring"][lane] = 0
    np_batch["jd_cnt"][lane] = 0
    np_batch["jump_cnt"][lane] = 0
    np_batch["ss_pc"][lane] = 0
    np_batch["ss_key"][lane] = 0
    np_batch["ss_val"][lane] = 0
    np_batch["ss_is_load"][lane] = False
    np_batch["ss_jd"][lane] = 0
    np_batch["ss_cnt"][lane] = 0
    np_batch["spill_id"][lane] = 0
    # symbolic layer resets
    for f in (
        "stack_sym", "tape_op", "tape_a", "tape_b", "tape_imm", "tape_h1",
        "tape_h2", "tape_meta", "tape_len",
        "path_id", "path_sign", "path_meta", "path_len", "msym_off",
        "msym_id",
        "msym_used", "skey_sym", "sval_sym", "cdsize_sym", "caller_sym",
        "callvalue_sym", "origin_sym", "balance_sym",
    ):
        np_batch[f][lane] = 0
    np_batch["calldata_symbolic"][lane] = symbolic_calldata
    np_batch["storage_symbolic"][lane] = symbolic_storage
    np_batch["seed_id"][lane] = seed_id
    np_batch["job_id"][lane] = job_id
    np_batch["outermost"][lane] = outermost
    np_batch["static_pruned"][lane] = 0
    if symbolic_calldata:
        np_batch["cdsize_sym"][lane] = append_node(np_batch, lane, symtape.OP_CDSIZE)
    if symbolic_caller:
        tag = append_node(np_batch, lane, symtape.OP_CALLER)
        np_batch["caller_sym"][lane] = tag
        np_batch["origin_sym"][lane] = append_node(np_batch, lane, symtape.OP_ORIGIN)
    if symbolic_callvalue:
        np_batch["callvalue_sym"][lane] = append_node(np_batch, lane, symtape.OP_CALLVALUE)
    if symbolic_balance:
        np_batch["balance_sym"][lane] = append_node(np_batch, lane, symtape.OP_BALANCE)
    if storage:
        if len(storage) > np_batch["storage_used"].shape[1]:
            raise ValueError("storage exceeds batch slot capacity")
        key3 = np_batch["storage_key"][lane].reshape(-1, words.NDIGITS)
        val3 = np_batch["storage_val"][lane].reshape(-1, words.NDIGITS)
        for j, (k, v) in enumerate(sorted(storage.items())):
            key3[j] = words.from_int(k)  # view write-through
            val3[j] = words.from_int(v)
            np_batch["storage_used"][lane, j] = True


def build_batch(cfg: BatchConfig, lane_specs, device="cuda") -> StateBatch:
    """Host helper: build a batch with one device transfer.

    ``lane_specs`` is a list of kwarg dicts (see _fill_lane); lane i gets
    spec i, remaining lanes stay free (dead). Much faster than repeated
    load_lane for thousands of lanes (one host->device copy total).
    """
    dev = _build.resolve_device(device)
    if len(lane_specs) > cfg.lanes:
        raise ValueError("more lane specs than lanes")
    np_batch = {
        k: np.zeros(shape, dtype=dtype)
        for k, (shape, dtype) in batch_shapes(cfg).items()
    }
    for lane, spec in enumerate(lane_specs):
        _fill_lane(np_batch, lane, **spec)
    from mythril_tpu_torch.laser.cuda import convert

    return convert.batch_to_torch(np_batch, dev)
