"""Host <-> device state bridge: pack GlobalStates into lanes, lift tape
nodes back into SMT terms, unpack lanes into resumable GlobalStates.

This is the trap/resume protocol half the device engine promises
(laser/cuda/batch.py): a lane that hits something outside the device model
(CALL family, CREATE, symbolic memory offsets, ...) TRAPs frozen before
the instruction; ``unpack_lane`` rebuilds an exact host ``GlobalState``
(reference shape: mythril/laser/ethereum/state/global_state.py:21) and the
host engine continues it through ``Instruction.evaluate``
(mythril/laser/ethereum/instructions.py:1901-2407 for the call family).

Lowering (host term -> tape rows) recognizes the seed state's environment
leaves by hash-consed uid — calldata reads, calldatasize, sender, origin,
callvalue, self-balance — so round-tripped states stay compact; anything
with no device counterpart becomes an OPAQUE leaf carried by reference.
Lifting rebuilds host terms through the smart constructors (hash-consing
makes re-lifted leaves identical to the seed's originals) and returns
keccak side-conditions the same way the host sha3_ op does
(keccak_function_manager.create_keccak).

States the bridge cannot represent raise ``PackError`` — the caller keeps
them on the host path (the reference's concretize-or-bail idiom,
mythril/laser/ethereum/util.py get_concrete_int, as a pressure valve).
"""

import logging
from copy import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

from mythril_tpu_torch.analysis.module.module_helpers import forced_hook_phase
from mythril_tpu_torch.laser.evm import util as evm_util
from mythril_tpu_torch.laser.evm.keccak_function_manager import keccak_function_manager
from mythril_tpu_torch.laser.evm.state.calldata import ConcreteCalldata
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.state.machine_state import MachineStack
from mythril_tpu_torch.laser.cuda import solver_cache, symtape, words
from mythril_tpu_torch.laser.cuda.batch import (
    RUNNING,
    BatchConfig,
    CodeBank,
    StateBatch,
    append_node,
    batch_shapes,
    make_code_bank,
    read_path,
    read_storage_full,
)
from mythril_tpu_torch.smt import (
    BitVec,
    Bool,
    Concat,
    If,
    Not,
    ULT,
    simplify,
    symbol_factory,
)
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.support.keccak import keccak256 as host_keccak256

log = logging.getLogger(__name__)


class PackError(Exception):
    """The state cannot be represented in the device model."""


class _TapeWorldState:
    """Lazy stand-in for a world state: only ``constraints`` is real."""

    def __init__(self, constraints_fn):
        self._fn = constraints_fn
        self._constraints = None

    @property
    def constraints(self):
        if self._constraints is None:
            self._constraints = self._fn()
        return self._constraints


class TapeOrigin:
    """Origin view of a device-retired instruction for detection replays.

    Carries exactly what the hook-path modules read from their origin
    ``GlobalState``: the instruction address, the environment (shared
    with the seed — code/account/function name are lane-invariant), and
    the constraints in force at the origin (materialized lazily; most
    hazards are never solved)."""

    def __init__(self, pc: int, seed: GlobalState, constraints_fn):
        self.environment = seed.environment
        self.world_state = _TapeWorldState(constraints_fn)
        self._instruction = {"address": pc, "opcode": None}

    def get_current_instruction(self) -> dict:
        return self._instruction


# host term op -> (device op, commutes-with-EVM-order)
_TERM_TO_DEV = {
    "add": symtape.OP_ADD,
    "sub": symtape.OP_SUB,
    "mul": symtape.OP_MUL,
    "udiv": symtape.OP_UDIV,
    "sdiv": symtape.OP_SDIV,
    "urem": symtape.OP_UREM,
    "srem": symtape.OP_SREM,
    "and": symtape.OP_AND,
    "or": symtape.OP_OR,
    "xor": symtape.OP_XOR,
}

_CMP_TO_DEV = {
    "ult": symtape.OP_LT,
    "slt": symtape.OP_SLT,
    "eq": symtape.OP_EQ,
}


def _word(value: int) -> np.ndarray:
    return words.from_int(value)


class DeviceBridge:
    """Packs host states into a StateBatch and unpacks/lifts lanes back.

    One bridge instance corresponds to one packed batch: ``seeds[i]`` is
    the pristine host state that seeded lane ``seed_id == i`` (forked
    children inherit the parent's seed id through the fork gather), and
    ``opaque`` carries host terms referenced by OPAQUE leaves.
    """

    def __init__(
        self,
        cfg: BatchConfig,
        host_ops=None,
        freeze_errors: bool = False,
        tape_replayers=None,
        value_replayers=None,
        prune_revert: bool = False,
        job_id: int = 0,
        device="cuda",
    ):
        self.cfg = cfg
        # where finish() builds the code bank and uploads the batch
        self.device = device
        self.host_ops = host_ops
        self.freeze_errors = freeze_errors
        # owning analysis job for every lane this bridge packs (0 =
        # single-tenant). Written into the job_id plane so a shared
        # multi-tenant round can be split per job at harvest.
        self.job_id = job_id
        # arm static must-revert fork pruning in the step kernel (the
        # backend only sets this when no REVERT hook is registered and
        # gas accounting is not being tracked — see exec_batch)
        self.prune_revert = prune_revert
        # symtape op -> [(detection module, EVM opcode name)]: batch-aware
        # modules whose pre-hook is replayed over device-allocated tape
        # nodes at lift time instead of freeze-trapping the opcode
        self.tape_replayers = tape_replayers or {}
        # symtape op -> [(detection module, EVM opcode name)]: modules
        # whose POST-hook semantics (taint the pushed value) replay over
        # the LIFTED value of an env-leaf node. Fired for packed nodes
        # too: the taint is a property of the value, not the site.
        self.value_replayers = value_replayers or {}
        self.packed_tape_len: List[int] = []
        self.seeds: List[GlobalState] = []
        self.opaque: List[BitVec] = []
        self._opaque_ids: Dict[int, int] = {}  # term uid -> opaque index
        self.codes: List[bytes] = []
        self._code_ids: Dict[bytes, int] = {}
        self._np_batch: Optional[dict] = None
        self._n_staged = 0
        # (seed_id, node_id) -> wrapper annotations recorded at pack time.
        # Forked children share the parent's tape prefix, so pack-time ids
        # are stable across descendants; device-born combinations inherit
        # annotations for free because lifting uses the annotation-union
        # wrapper ops (smt/bitvec_helper.py), same as the reference's
        # taint mechanism (mythril/laser/smt/expression.py annotations).
        self.pack_annotations: Dict[Tuple[int, int], set] = {}
        # spill-chain token -> (prev_token, ordered (pc, key id, val id,
        # is_load, jd) event tuples) drained from a lane's full storage
        # ring mid-round (backend._drain_ss_rings). Chains share prefix
        # storage (a re-drain stores only the NEW events under a fresh
        # token pointing at its predecessor), so fork children — which
        # copy the parent's spill_id plane on device — resolve their
        # exact inherited prefix at O(chain) cost, not O(chain^2).
        self._ss_spill: Dict[int, tuple] = {}
        self._spill_next = 1
        self.ss_drain_count = 0
        # per-job drain attribution for shared multi-tenant rounds
        # (filled by backend._drain_ss_rings from the job_id plane)
        self.ss_drains_by_job: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # storage-ring spill

    def spill_chain(self, prev_token: int, events: list) -> int:
        """Store ``events`` as a chain link extending ``prev_token``;
        returns the new token."""
        token = self._spill_next
        self._spill_next += 1
        self._ss_spill[token] = (prev_token, events)
        self.ss_drain_count += 1
        return token

    def spilled_events(self, token: int) -> list:
        """The full ordered event list behind ``token`` (chain walk)."""
        chunks = []
        token = int(token)
        while token:
            token, events = self._ss_spill.get(token, (0, []))
            chunks.append(events)
        out = []
        for events in reversed(chunks):
            out.extend(events)
        return out

    # ------------------------------------------------------------------
    # packing

    def stage(self, state: GlobalState) -> int:
        """Pack one host state into the next lane; returns the lane.

        On PackError the lane is wiped and the bridge stays consistent —
        the caller keeps that state on the host path.
        """
        if self._np_batch is None:
            self._np_batch = {
                k: np.zeros(shape, dtype=dtype)
                for k, (shape, dtype) in batch_shapes(self.cfg).items()
            }
        lane = self._n_staged
        if lane >= self.cfg.lanes:
            raise PackError("batch full")
        n_seeds = len(self.seeds)
        try:
            self.pack_into(self._np_batch, lane, state)
        except Exception:
            # wipe the lane for ANY failure (not only PackError) so an
            # unexpected packing bug leaves the bridge consistent and the
            # caller can keep the state on the host path. Annotations
            # recorded before the failure must go too: the rolled-back
            # seed_id is reused by the next staged state, which would
            # otherwise inherit this state's taints at lift.
            del self.seeds[n_seeds:]
            self.pack_annotations = {
                key: val
                for key, val in self.pack_annotations.items()
                if key[0] < n_seeds
            }
            for plane in self._np_batch.values():
                plane[lane] = 0
            raise
        self.packed_tape_len.append(int(self._np_batch["tape_len"][lane]))
        self._n_staged += 1
        return lane

    def finish(self) -> Tuple[CodeBank, StateBatch]:
        """Freeze the staged lanes into device arrays (one upload).

        Re-runnable: the staged numpy batch is kept, so a retried round
        (robustness/retry.py) re-enters here and re-uploads the same
        lanes after a transfer fault."""
        from mythril_tpu_torch import obs
        from mythril_tpu_torch.laser.cuda import transfer
        from mythril_tpu_torch.robustness import faults

        faults.fire(faults.TRANSFER_UP, context="bridge.finish")
        if self._np_batch is None or self._n_staged == 0:
            raise PackError("nothing staged")
        # child spans on the transfer_up row: bank build vs. the actual
        # host->device upload attribute the seam separately in a trace
        with obs.TRACER.span(
            "codebank", tid="transfer_up", n_codes=len(self.codes)
        ):
            cb = make_code_bank(
                self.codes,
                self.cfg.code_len,
                host_ops=self.host_ops,
                freeze_errors=self.freeze_errors,
                record_storage_events=bool(
                    self.tape_replayers.get("SSTORE")
                    or self.tape_replayers.get("SLOAD")
                ),
                prune_revert=self.prune_revert,
                device=self.device,
            )
        with obs.TRACER.span(
            "upload", tid="transfer_up", lanes=self._n_staged
        ):
            st = transfer.batch_to_device(self._np_batch, self.cfg, device=self.device)
        return cb, st

    def pack(self, states: List[GlobalState]) -> Tuple[CodeBank, StateBatch]:
        """Stage + finish in one call (per-state PackErrors propagate)."""
        for state in states:
            self.stage(state)
        return self.finish()

    def pack_into(self, np_batch: dict, lane: int, state: GlobalState) -> None:
        """Pack one host GlobalState into one lane of a numpy batch."""
        for annotation in state.annotations:
            if not getattr(annotation, "pack_to_device", True):
                raise PackError(
                    f"annotation requires host hooks: {type(annotation).__name__}"
                )
        env = state.environment
        mstate = state.mstate
        account = env.active_account
        code_bytes = bytes.fromhex(env.code.bytecode)
        if len(code_bytes) > self.cfg.code_len:
            raise PackError("code exceeds bank width")
        code_id = self._code_ids.get(code_bytes)
        if code_id is None:
            code_id = len(self.codes)
            self.codes.append(code_bytes)
            self._code_ids[code_bytes] = code_id

        instr_list = env.code.instruction_list
        if mstate.pc >= len(instr_list):
            raise PackError("pc out of range")
        pc_byte = instr_list[mstate.pc]["address"]

        seed_id = len(self.seeds)
        self.seeds.append(state)

        L = np_batch["alive"].shape[0]
        if lane >= L:
            raise PackError("lane out of range")

        np_batch["alive"][lane] = True
        np_batch["status"][lane] = RUNNING
        np_batch["pc"][lane] = pc_byte
        np_batch["code_id"][lane] = code_id
        np_batch["seed_id"][lane] = seed_id
        np_batch["job_id"][lane] = self.job_id
        # outermost = transaction-level frame (no caller state): the only
        # frames static must-revert pruning may kill at fork time
        np_batch["outermost"][lane] = (
            state.transaction_stack[-1][1] is None
            if state.transaction_stack
            else False
        )

        gas_left = max(0, int(mstate.gas_limit) - int(mstate.min_gas_used))
        np_batch["gas_left"][lane] = min(gas_left, 0xFFFFFFFF)

        # --- environment leaves (recognized by hash-consed uid on lower)
        leaf_map: Dict[int, Tuple[int, int, int, Optional[np.ndarray]]] = {}

        def leaf(op, imm=None):
            return (op, 0, 0, imm)

        def reg_value(field_word, field_sym, term_w, dev_op):
            if isinstance(term_w, int):
                np_batch[field_word][lane] = _word(term_w)
                return
            if term_w.symbolic is False:
                np_batch[field_word][lane] = _word(term_w.value)
            else:
                leaf_map[term_w.raw.uid] = leaf(dev_op)
                np_batch[field_sym][lane] = append_node(np_batch, lane, dev_op)

        reg_value("caller", "caller_sym", env.sender, symtape.OP_CALLER)
        reg_value("origin", "origin_sym", env.origin, symtape.OP_ORIGIN)
        reg_value("callvalue", "callvalue_sym", env.callvalue, symtape.OP_CALLVALUE)

        if isinstance(env.address, BitVec):
            if env.address.symbolic:
                raise PackError("symbolic self address")
            np_batch["address"][lane] = _word(env.address.value)
        else:
            np_batch["address"][lane] = _word(int(env.address))

        balance = account.balance() if callable(account.balance) else account.balance
        reg_value("balance", "balance_sym", balance, symtape.OP_BALANCE)

        # --- calldata
        calldata = env.calldata
        if isinstance(calldata, ConcreteCalldata):
            data = bytes(calldata.concrete(None))
            if len(data) > self.cfg.calldata_bytes:
                raise PackError("calldata exceeds capacity")
            np_batch["calldata"][lane, : len(data)] = np.frombuffer(data, np.uint8)
            np_batch["calldata_len"][lane] = len(data)
        else:
            np_batch["calldata_symbolic"][lane] = True
            size_t = calldata.calldatasize
            leaf_map[size_t.raw.uid] = leaf(symtape.OP_CDSIZE)
            np_batch["cdsize_sym"][lane] = append_node(
                np_batch, lane, symtape.OP_CDSIZE
            )
            # pre-register word reads at 32-byte offsets so round-tripped
            # stack values lower back to CDLOAD leaves. (Measured r5:
            # this does NOT inflate the Ackermann select tables — the
            # 68-vs-36 entry growth under tpu-batch comes from
            # speculative device paths' constraints passing through the
            # eliminator, not from these leaf registrations.)
            for k in range(self.cfg.calldata_bytes // 32):
                t = calldata.get_word_at(k * 32)
                if isinstance(t, BitVec) and t.symbolic:
                    leaf_map[t.raw.uid] = leaf(
                        symtape.OP_CDLOAD, _word(k * 32)
                    )

        self._leaf_maps = getattr(self, "_leaf_maps", {})
        self._leaf_maps[seed_id] = leaf_map

        def lower_top(wrapper):
            """Lower a top-level wrapper, preserving its annotations."""
            node_id = self._lower(np_batch, lane, leaf_map, wrapper.raw)
            if wrapper.annotations:
                key = (seed_id, node_id)
                self.pack_annotations.setdefault(key, set()).update(
                    wrapper.annotations
                )
            return node_id

        # --- stack
        if len(mstate.stack) > self.cfg.stack_slots:
            raise PackError("stack exceeds capacity")
        stack3 = np_batch["stack"][lane].reshape(-1, words.NDIGITS)
        for i, item in enumerate(mstate.stack):
            if isinstance(item, Bool):
                # some host instructions leave raw Bools on the stack
                # (word-valued on read); pack the 0/1 word form, keeping
                # the wrapper's annotations for taint flow
                item = If(
                    item,
                    symbol_factory.BitVecVal(1, 256),
                    symbol_factory.BitVecVal(0, 256),
                )
            if isinstance(item, int):
                stack3[i] = _word(item)  # view write-through
            elif item.symbolic is False:
                stack3[i] = _word(item.value)
            else:
                np_batch["stack_sym"][lane, i] = lower_top(item)
        np_batch["sp"][lane] = len(mstate.stack)

        # --- memory (concrete bytes + aligned 32-byte symbolic words)
        msize = len(mstate.memory)
        if msize > self.cfg.memory_bytes:
            raise PackError("memory exceeds capacity")
        np_batch["mem_words"][lane] = (msize + 31) // 32
        sym_words: Dict[int, terms.Term] = {}
        for off in range(msize):
            cell = mstate.memory[off]
            if isinstance(cell, int):
                np_batch["memory"][lane, off] = cell & 0xFF
            elif cell.symbolic is False:
                np_batch["memory"][lane, off] = cell.value & 0xFF
            else:
                raw = cell.raw
                # write_word_at writes Extract((31-rel)*8+7, (31-rel)*8, w)
                rel = off % 32
                base = off - rel
                if (
                    raw.op == "extract"
                    and raw.params[0] == (31 - rel) * 8 + 7
                    and raw.params[1] == (31 - rel) * 8
                ):
                    prev = sym_words.get(base)
                    if prev is None:
                        sym_words[base] = raw.args[0]
                    elif prev is not raw.args[0]:
                        raise PackError("interleaved symbolic memory words")
                else:
                    raise PackError("unaligned symbolic memory byte")
        # each symbolic word must cover its full 32 bytes
        slot = 0
        for base, t in sorted(sym_words.items()):
            for j in range(32):
                cell = mstate.memory[base + j]
                if isinstance(cell, int) or cell.symbolic is False:
                    raise PackError("partially-symbolic memory word")
            if slot >= self.cfg.mem_sym_slots:
                raise PackError("too many symbolic memory words")
            np_batch["msym_off"][lane, slot] = base
            np_batch["msym_id"][lane, slot] = self._lower(
                np_batch, lane, leaf_map, t
            )
            np_batch["msym_used"][lane, slot] = True
            slot += 1
        # re-attach annotations the byte-wise Extract cells carried
        for base in sym_words:
            cell = mstate.memory[base]
            if isinstance(cell, BitVec) and cell.annotations:
                key = (seed_id, int(np_batch["msym_id"][lane, 0]))
                # find the slot for this base
                for j in range(slot):
                    if int(np_batch["msym_off"][lane, j]) == base:
                        key = (seed_id, int(np_batch["msym_id"][lane, j]))
                        break
                self.pack_annotations.setdefault(key, set()).update(cell.annotations)

        # --- storage
        storage = account.storage
        concrete_world = not storage._backing.__class__.__name__ == "Array"
        np_batch["storage_symbolic"][lane] = not concrete_world
        entries = list(storage.printable_storage.items())
        if len(entries) > self.cfg.storage_slots:
            raise PackError("storage exceeds slot capacity")
        key3 = np_batch["storage_key"][lane].reshape(-1, words.NDIGITS)
        val3 = np_batch["storage_val"][lane].reshape(-1, words.NDIGITS)
        for j, (k_bv, v_bv) in enumerate(entries):
            if k_bv.symbolic:
                kid = lower_top(k_bv)
                np_batch["skey_sym"][lane, j] = kid
                # digest stamp (engine write_key contract): lets device
                # probes match this entry by key content, not just node id
                key3[j][: symtape.DIGEST_DIGITS] = symtape.key_digest_host(
                    np_batch["tape_op"][lane],
                    np_batch["tape_a"][lane],
                    np_batch["tape_b"][lane],
                    np_batch["tape_imm"][lane].reshape(-1, words.NDIGITS),
                    kid,
                )
            else:
                key3[j] = _word(k_bv.value)  # view write-through
            if isinstance(v_bv, int):
                val3[j] = _word(v_bv)
            elif v_bv.symbolic:
                np_batch["sval_sym"][lane, j] = lower_top(v_bv)
            else:
                val3[j] = _word(v_bv.value)
            np_batch["storage_used"][lane, j] = True

    # ------------------------------------------------------------------
    # term lowering (host -> tape)

    def _opaque(self, np_batch, lane, raw: terms.Term) -> int:
        idx = self._opaque_ids.get(raw.uid)
        if idx is None:
            idx = len(self.opaque)
            self.opaque.append(raw)
            self._opaque_ids[raw.uid] = idx
        return append_node(
            np_batch, lane, symtape.OP_OPAQUE, imm=_word(idx)
        )

    def _lower(self, np_batch, lane, leaf_map, raw: terms.Term, _memo=None) -> int:
        """Lower a host term into the lane's tape; returns 1-based id."""
        if _memo is None:
            _memo = {}
        if raw.uid in _memo:
            return _memo[raw.uid]

        def rec(t):
            return self._lower(np_batch, lane, leaf_map, t, _memo)

        node_id = None
        hit = leaf_map.get(raw.uid)
        if hit is not None:
            op, na, nb, imm = hit
            node_id = append_node(np_batch, lane, op, na, nb, imm)
        elif raw.op == "const":
            # a bare const should have stayed on the concrete plane; as a
            # node arg it rides inline — parent handles it
            raise PackError("const reached _lower")
        elif raw.op in _TERM_TO_DEV and len(raw.args) == 2:
            node_id = self._lower_binop(
                np_batch, lane, _TERM_TO_DEV[raw.op], raw.args, rec
            )
        elif raw.op == "not" and raw.sort == terms.BV:
            node_id = append_node(
                np_batch, lane, symtape.OP_NOT, rec(raw.args[0]), 0
            )
        elif raw.op == "shl":
            # terms.bv_shl(value, shift); device lhs=shift, rhs=value
            node_id = self._lower_shift(np_batch, lane, symtape.OP_SHL, raw, rec)
        elif raw.op == "lshr":
            node_id = self._lower_shift(np_batch, lane, symtape.OP_SHR, raw, rec)
        elif raw.op == "ashr":
            node_id = self._lower_shift(np_batch, lane, symtape.OP_SAR, raw, rec)
        elif raw.op == "ite":
            node_id = self._lower_ite(np_batch, lane, raw, rec)
        elif raw.op == "apply" and str(raw.params[0]).startswith("keccak256_"):
            node_id = self._lower_keccak(np_batch, lane, raw, rec)
        if node_id is None:
            node_id = self._opaque(np_batch, lane, raw)
        _memo[raw.uid] = node_id
        return node_id

    def _arg(self, np_batch, lane, t: terms.Term, rec):
        """(arg encoding, imm or None) for one operand."""
        if t.op == "const":
            return symtape.ARG_IMM, _word(t.value)
        return rec(t), None

    def _lower_binop(self, np_batch, lane, dev_op, args, rec):
        ea, imma = self._arg(np_batch, lane, args[0], rec)
        eb, immb = self._arg(np_batch, lane, args[1], rec)
        if imma is not None and immb is not None:
            raise PackError("two-const binop reached _lower")
        imm = imma if imma is not None else immb
        return append_node(np_batch, lane, dev_op, ea, eb, imm)

    def _lower_shift(self, np_batch, lane, dev_op, raw, rec):
        # host (value, shift) -> device (lhs=shift, rhs=value)
        ev, immv = self._arg(np_batch, lane, raw.args[0], rec)
        es, imms = self._arg(np_batch, lane, raw.args[1], rec)
        if immv is not None and imms is not None:
            raise PackError("two-const shift reached _lower")
        imm = imms if imms is not None else immv
        return append_node(np_batch, lane, dev_op, es, ev, imm)

    def _lower_ite(self, np_batch, lane, raw, rec):
        cond, tv, fv = raw.args
        if not (
            tv.op == "const" and tv.value == 1 and fv.op == "const" and fv.value == 0
        ):
            return None
        if cond.op in _CMP_TO_DEV and len(cond.args) == 2:
            return self._lower_binop(
                np_batch, lane, _CMP_TO_DEV[cond.op], cond.args, rec
            )
        return None

    def _lower_keccak(self, np_batch, lane, raw, rec):
        data = raw.args[0]
        if data.size == 256:
            word_terms = [data]
        elif data.op == "concat" and all(t.size == 256 for t in data.args):
            word_terms = list(data.args)
        else:
            return None
        if len(word_terms) > 4:
            return None
        rest = 0
        # canonical preimage digest (symtape.sha3_imm contract): must
        # byte-match what engine.do_sha_sym computes on device for the
        # same content, so host-packed and device-allocated SHA3 nodes
        # CSE-unify and keccak-rooted storage keys resolve in-loop
        records = bytearray()
        for t in reversed(word_terms):
            ea, imm = self._arg(np_batch, lane, t, rec)
            if imm is not None:
                rec_bytes = b"\x00" + int(t.value).to_bytes(32, "big")
            else:
                h1 = int(np_batch["tape_h1"][lane, ea - 1])
                h2 = int(np_batch["tape_h2"][lane, ea - 1])
                rec_bytes = (
                    b"\x01"
                    + h1.to_bytes(4, "big")
                    + h2.to_bytes(4, "big")
                    + b"\x00" * 24
                )
            records[:0] = rec_bytes  # preimage order (we walk reversed)
            rest = append_node(np_batch, lane, symtape.OP_COMB, ea, rest, imm)
        digest = host_keccak256(bytes(records))[:16]
        return append_node(
            np_batch,
            lane,
            symtape.OP_SHA3,
            rest,
            0,
            symtape.sha3_imm(32 * len(word_terms), digest),
        )

    # ------------------------------------------------------------------
    # term lifting (tape -> host)

    def lift_lane(self, st: StateBatch, lane: int):
        """Lift every tape node of a lane; returns (values, side_conds).

        values[i] is the host BitVec for 1-based id i+1; side_conds are
        keccak consistency Bools to append to the path condition.
        """
        seed_id_val = int(np.asarray(st.seed_id)[lane])
        seed = self.seeds[seed_id_val]
        env = seed.environment
        account = env.active_account
        n = int(np.asarray(st.tape_len)[lane])
        ops = np.asarray(st.tape_op)[lane]
        aa = np.asarray(st.tape_a)[lane]
        bb = np.asarray(st.tape_b)[lane]
        imms = np.asarray(st.tape_imm)[lane].reshape(-1, words.NDIGITS)
        metas = np.asarray(st.tape_meta)[lane]
        path_ids = np.asarray(st.path_id)[lane]
        path_signs = np.asarray(st.path_sign)[lane]
        packed_prefix = (
            self.packed_tape_len[seed_id_val]
            if seed_id_val < len(self.packed_tape_len)
            else n
        )
        values: List[Optional[BitVec]] = [None] * n
        side: List[Bool] = []

        def arg(i, enc):
            if enc == symtape.ARG_IMM:
                return symbol_factory.BitVecVal(words.to_int(imms[i]), 256)
            if enc > 0:
                return values[enc - 1]
            return None

        one = symbol_factory.BitVecVal(1, 256)
        zero = symbol_factory.BitVecVal(0, 256)

        for i in range(n):
            op = int(ops[i])
            x = arg(i, int(aa[i]))
            y = arg(i, int(bb[i]))
            imm_int = words.to_int(imms[i])
            if (
                self.tape_replayers
                and i >= packed_prefix
                and op in self.tape_replayers
            ):
                self._replay_node(
                    seed, op, i, int(metas[i]), x, y, values, side,
                    path_ids, path_signs,
                )
            if op == symtape.OP_OPAQUE:
                v = BitVec(self.opaque[imm_int])
            elif op == symtape.OP_CONST:
                v = symbol_factory.BitVecVal(imm_int, 256)
            elif op == symtape.OP_CDLOAD:
                off = x if int(aa[i]) > 0 else imm_int
                off = off.value if isinstance(off, BitVec) and not off.symbolic else off
                v = env.calldata.get_word_at(off)
            elif op == symtape.OP_CDSIZE:
                v = env.calldata.calldatasize
            elif op == symtape.OP_CALLER:
                v = env.sender
            elif op == symtape.OP_ORIGIN:
                v = env.origin
            elif op == symtape.OP_CALLVALUE:
                v = env.callvalue
            elif op == symtape.OP_BALANCE:
                bal = account.balance() if callable(account.balance) else account.balance
                v = bal
            elif op == symtape.OP_SLOAD:
                key = x if int(aa[i]) > 0 else symbol_factory.BitVecVal(imm_int, 256)
                v = account.storage[key]
            elif op == symtape.OP_SHA3:
                data_words = []
                j = int(aa[i])
                while j > 0:
                    k = j - 1
                    w = arg(k, int(aa[k]))
                    data_words.append(
                        w
                        if w is not None
                        else symbol_factory.BitVecVal(words.to_int(imms[k]), 256)
                    )
                    j = int(bb[k])
                data = (
                    data_words[0]
                    if len(data_words) == 1
                    else Concat(data_words)
                )
                v, cond = keccak_function_manager.create_keccak(data)
                side.append(cond)
            elif op == symtape.OP_COMB:
                v = zero  # never read directly; SHA3 walks the chain
            elif op == symtape.OP_ADD:
                v = x + y
            elif op == symtape.OP_SUB:
                v = x - y
            elif op == symtape.OP_MUL:
                v = x * y
            elif op == symtape.OP_UDIV:
                from mythril_tpu_torch.smt import UDiv

                v = If(y == 0, zero, UDiv(x, y))
            elif op == symtape.OP_SDIV:
                v = If(y == 0, zero, x / y)
            elif op == symtape.OP_UREM:
                from mythril_tpu_torch.smt import URem

                v = If(y == 0, zero, URem(x, y))
            elif op == symtape.OP_SREM:
                from mythril_tpu_torch.smt import SRem

                v = If(y == 0, zero, SRem(x, y))
            elif op == symtape.OP_EXP:
                # no closed QF_BV form: mirror the HOST's uninterpreted
                # symbol naming INCLUDING the tx-id prefix new_bitvec adds
                # (instructions.py exp_), so the same operand pair lifts to
                # the SAME symbol on either interpreter
                v = symbol_factory.BitVecSym(
                    "%s_invhash(%s)**invhash(%s)"
                    % (
                        seed.current_transaction.id,
                        hash(simplify(x)),
                        hash(simplify(y)),
                    ),
                    256,
                )
            elif op == symtape.OP_SIGNEXT:
                # exact: for position b < 32, shift the target byte's sign
                # bit to the top and arithmetic-shift back down
                t = (symbol_factory.BitVecVal(31, 256) - x) * symbol_factory.BitVecVal(8, 256)
                v = If(ULT(x, symbol_factory.BitVecVal(32, 256)), (y << t) >> t, y)
            elif op == symtape.OP_AND:
                v = x & y
            elif op == symtape.OP_OR:
                v = x | y
            elif op == symtape.OP_XOR:
                v = x ^ y
            elif op == symtape.OP_NOT:
                v = ~x
            elif op == symtape.OP_BYTE:
                # exact: byte i of the word, 0 for i >= 32
                from mythril_tpu_torch.smt import LShR as _LShR

                shift = (symbol_factory.BitVecVal(31, 256) - x) * symbol_factory.BitVecVal(8, 256)
                v = If(
                    ULT(x, symbol_factory.BitVecVal(32, 256)),
                    _LShR(y, shift) & symbol_factory.BitVecVal(0xFF, 256),
                    zero,
                )
            elif op == symtape.OP_SHL:
                v = y << x
            elif op == symtape.OP_SHR:
                from mythril_tpu_torch.smt import LShR

                v = LShR(y, x)
            elif op == symtape.OP_SAR:
                v = y >> x
            elif op == symtape.OP_LT:
                v = If(ULT(x, y), one, zero)
            elif op == symtape.OP_GT:
                v = If(ULT(y, x), one, zero)
            elif op == symtape.OP_SLT:
                v = If(x < y, one, zero)
            elif op == symtape.OP_SGT:
                v = If(y < x, one, zero)
            elif op == symtape.OP_EQ:
                v = If(x == y, one, zero)
            elif op == symtape.OP_ISZERO:
                v = If(x == zero, one, zero)
            # env-leaf nodes lift to EXACTLY the term the host instruction
            # pushes (instructions.py _stamp_block_context / number_ /
            # _NULLARY_PUSH_OPS), including concolic block_context pins,
            # so constraints line up across interpreters
            elif op == symtape.OP_TIMESTAMP:
                v = self._block_context_symbol(seed, "timestamp", "timestamp")
            elif op == symtape.OP_COINBASE:
                v = self._block_context_symbol(seed, "coinbase", "coinbase")
            elif op == symtape.OP_DIFFICULTY:
                v = self._block_context_symbol(
                    seed, "difficulty", "block_difficulty"
                )
            elif op == symtape.OP_BASEFEE:
                v = self._block_context_symbol(seed, "basefee", "basefee")
            elif op == symtape.OP_NUMBER:
                v = env.block_number
            elif op == symtape.OP_CHAINID:
                v = env.chainid
            elif op == symtape.OP_GASPRICE:
                gp = env.gasprice
                v = (
                    gp
                    if isinstance(gp, BitVec)
                    else symbol_factory.BitVecVal(int(gp), 256)
                )
            elif op == symtape.OP_GASLIMIT:
                gl = seed.mstate.gas_limit
                v = (
                    gl
                    if isinstance(gl, BitVec)
                    else symbol_factory.BitVecVal(int(gl), 256)
                )
            elif op == symtape.OP_BLOCKHASH:
                # mirror instructions.py blockhash_: symbol named after
                # the queried number's printed form
                v = seed.new_bitvec("blockhash_block_" + str(x), 256)
            else:
                raise ValueError(f"unknown tape op {op}")
            # re-attach pack-time annotations (taint) without mutating
            # shared leaf wrappers
            ann = self.pack_annotations.get((seed_id_val, i + 1))
            if ann and isinstance(v, BitVec):
                v = BitVec(v.raw, annotations=set(v.annotations) | ann)
            # post-hook replay over the lifted value (block-var taints):
            # fired for packed nodes too — the taint is a property of the
            # value, not of the instruction site
            if self.value_replayers and op in self.value_replayers:
                v = self._replay_value(
                    seed, op, int(metas[i]), x, v, values, side,
                    path_ids, path_signs,
                )
            values[i] = v
        return values, side

    # ------------------------------------------------------------------
    # unpacking

    @staticmethod
    def _block_context_symbol(seed, ctx_key: str, symbol_name: str):
        """The term a block-context opcode pushes on the host: the
        concolic pin when one is set, a tx-scoped symbol otherwise
        (instructions.py _stamp_block_context)."""
        pinned = seed.environment.block_context.get(ctx_key)
        if pinned is not None:
            return pinned
        return seed.new_bitvec(symbol_name, 256)

    def _node_origin(self, seed, meta, values, side, path_ids, path_signs):
        """TapeOrigin for a node: its pc and the constraints in force at
        allocation. Pack-time nodes (HOST_META) have no device site —
        pc -1, seed constraints only."""
        unpacked = symtape.unpack_meta(meta)
        # materialize the origin's path-condition terms NOW (they are
        # already-built earlier tape nodes) so the lazy constraints
        # closure pins a handful of terms, not the whole lift scope
        zero = symbol_factory.BitVecVal(0, 256)
        prefix_conds = []
        pc = -1
        if unpacked is not None:
            pc, plen = unpacked
            for j in range(plen):
                node_id = int(path_ids[j])
                if node_id <= 0 or values[node_id - 1] is None:
                    continue
                w = values[node_id - 1]
                prefix_conds.append(
                    Not(w == zero) if path_signs[j] else (w == zero)
                )
        seed_constraints = seed.world_state.constraints
        side_snapshot = list(side)
        return TapeOrigin(
            pc,
            seed,
            lambda: self._origin_constraints(
                seed_constraints, side_snapshot, prefix_conds
            ),
        )

    def _replay_node(
        self, seed, op, index, meta, x, y, values, side, path_ids, path_signs
    ) -> None:
        """Run batch-aware detection hooks for one device-allocated node.

        The module's pre-hook semantics are reproduced over the lifted
        operand terms: annotations it attaches propagate into every
        dependent lifted value exactly as they do through host execution,
        so downstream sink collection (on still-hooked opcodes) and
        settlement need no changes."""
        if symtape.unpack_meta(meta) is None:
            return
        origin = self._node_origin(seed, meta, values, side, path_ids, path_signs)
        for module, opcode_name in self.tape_replayers[op]:
            try:
                module.replay_tape_node(origin, opcode_name, x, y)
            except Exception as e:  # pragma: no cover - module bugs degrade
                log.warning("tape replay failed (%s): %s", opcode_name, e)

    def _replay_value(
        self, seed, op, meta, x, v, values, side, path_ids, path_signs
    ):
        """Replay POST-hook semantics over a lifted env-leaf value.

        Modules return a replacement wrapper (same raw term, taint
        annotations added) or None to keep ``v``; replacing instead of
        mutating keeps shared seed wrappers (env.origin et al.) clean
        across lanes."""
        origin = self._node_origin(seed, meta, values, side, path_ids, path_signs)
        for module, opcode_name in self.value_replayers[op]:
            try:
                replacement = module.replay_tape_value(origin, opcode_name, v, x)
                if replacement is not None:
                    v = replacement
            except Exception as e:  # pragma: no cover - module bugs degrade
                log.warning("value replay failed (%s): %s", opcode_name, e)
        return v

    @staticmethod
    def _origin_constraints(seed_constraints, side_conds, prefix_conds):
        """Constraints in force when the node was allocated: the seed's
        world constraints, keccak side conditions, and the lifted
        path-condition prefix."""
        from mythril_tpu_torch.laser.evm.state.constraints import Constraints

        return Constraints(
            list(seed_constraints) + side_conds + prefix_conds
        )

    def lane_constraints(self, st: StateBatch, lane: int, values, side):
        """The lane's accumulated path condition as host Bools.

        This is the ONE place host path-literal terms meet their device
        identities (tape_h1/tape_h2 of the condition node), so each
        literal is registered with the solver cache here: when the host
        later proves a set of these literals UNSAT, ``build_inloop_pool``
        can compile that fact into the device-side in-loop clause pool
        (inloop_solve.py) keyed by the same hashes.
        """
        conds: List[Bool] = list(side)
        h1s = np.asarray(st.tape_h1)[lane]
        h2s = np.asarray(st.tape_h2)[lane]
        for node_id, sign in read_path(st, lane):
            w = values[node_id - 1]
            zero = symbol_factory.BitVecVal(0, 256)
            cond = Not(w == zero) if sign else (w == zero)
            raw = getattr(cond, "raw", None)
            if raw is not None:
                solver_cache.GLOBAL.note_path_literal(
                    raw.uid,
                    int(h1s[node_id - 1]),
                    int(h2s[node_id - 1]),
                    bool(sign),
                )
            conds.append(cond)
        return conds

    def unpack_lane(self, st: StateBatch, lane: int) -> GlobalState:
        """Rebuild a host GlobalState from a lane (frozen at its pc)."""
        seed = self.seeds[int(np.asarray(st.seed_id)[lane])]
        gs = copy(seed)
        values, side = self.lift_lane(st, lane)

        instr_list = gs.environment.code.instruction_list
        pc_byte = int(np.asarray(st.pc)[lane])
        pc_index = evm_util.get_instruction_index(instr_list, pc_byte)
        if pc_index is None:
            pc_index = len(instr_list)
        gs.mstate.pc = pc_index

        # stack
        sp = int(np.asarray(st.sp)[lane])
        stack_words = np.asarray(st.stack)[lane].reshape(-1, words.NDIGITS)
        stack_tags = np.asarray(st.stack_sym)[lane]
        new_stack = MachineStack()
        for i in range(sp):
            tag = int(stack_tags[i])
            if tag > 0:
                new_stack.append(values[tag - 1])
            else:
                new_stack.append(
                    symbol_factory.BitVecVal(words.to_int(stack_words[i]), 256)
                )
        gs.mstate.stack = new_stack

        # memory: concrete bytes, then symbolic overlay words
        mem_words_n = int(np.asarray(st.mem_words)[lane])
        msize = mem_words_n * 32
        cur = len(gs.mstate.memory)
        if msize > cur:
            gs.mstate.memory.extend(msize - cur)
        mem_bytes = np.asarray(st.memory)[lane]
        for off in range(min(msize, mem_bytes.shape[0])):
            gs.mstate.memory[off] = int(mem_bytes[off])
        used = np.asarray(st.msym_used)[lane]
        offs = np.asarray(st.msym_off)[lane]
        ids = np.asarray(st.msym_id)[lane]
        for j in range(used.shape[0]):
            if used[j]:
                gs.mstate.memory.write_word_at(int(offs[j]), values[int(ids[j]) - 1])

        # storage: apply store-written entries (skip load-created caches)
        account = gs.environment.active_account
        tape_ops = np.asarray(st.tape_op)[lane]
        tape_a = np.asarray(st.tape_a)[lane]
        tape_imm = np.asarray(st.tape_imm)[lane].reshape(-1, words.NDIGITS)
        for key_int, val_int, ktag, vtag in read_storage_full(st, lane):
            if vtag > 0 and int(tape_ops[vtag - 1]) == symtape.OP_SLOAD:
                leaf_a = int(tape_a[vtag - 1])
                if leaf_a == symtape.ARG_IMM and ktag == 0 and (
                    words.to_int(tape_imm[vtag - 1]) == key_int
                ):
                    continue  # load-created: Select(storage, k) cached at k
                if leaf_a > 0 and leaf_a == ktag:
                    continue
            key = (
                values[ktag - 1]
                if ktag > 0
                else symbol_factory.BitVecVal(key_int, 256)
            )
            val = (
                values[vtag - 1]
                if vtag > 0
                else symbol_factory.BitVecVal(val_int, 256)
            )
            account.storage[key] = val

        # gas accounting: gas_left tracks the MIN-cost model; the separate
        # gas_spent_max counter accumulates the worst-case bound (symbolic
        # EXP exponents, symbolic SSTORE old/new values, ...)
        packed_gas = max(0, int(seed.mstate.gas_limit) - int(seed.mstate.min_gas_used))
        spent = max(0, min(packed_gas, 0xFFFFFFFF) - int(np.asarray(st.gas_left)[lane]))
        gs.mstate.min_gas_used += spent
        gs.mstate.max_gas_used += int(np.asarray(st.gas_spent_max)[lane])

        # device-retired JUMP/JUMPIs count toward path depth (the host's
        # depth unit is jumps, not instructions), so --max-depth
        # bounds device-explored paths exactly like host-explored ones
        gs.mstate.depth += int(np.asarray(st.jump_cnt)[lane])

        # jump landings retired on device extend the per-state trace, so
        # BoundedLoopsStrategy bounds device-explored loops too. The
        # device keeps the last JD_RING entries — the suffix is exactly
        # what the repeating-cycle detector inspects.
        jd_cnt = int(np.asarray(st.jd_cnt)[lane])
        if jd_cnt:
            from mythril_tpu_torch.laser.evm.strategy.extensions.bounded_loops import (
                JumpdestCountAnnotation,
            )
            from mythril_tpu_torch.laser.cuda.batch import JD_RING

            ring = np.asarray(st.jd_ring)[lane]
            n = min(jd_cnt, JD_RING)
            entries = [int(ring[k % JD_RING]) for k in range(jd_cnt - n, jd_cnt)]
            annotations = list(gs.get_annotations(JumpdestCountAnnotation))
            if annotations:
                annotation = annotations[0]
            else:
                annotation = JumpdestCountAnnotation()
                gs.annotate(annotation)
            annotation.trace.extend(entries)

        # path conditions + keccak side conditions
        for cond in self.lane_constraints(st, lane, values, side):
            gs.world_state.constraints.append(cond)

        # stable fork-time fingerprints of the device path prefix:
        # siblings share the parent tape, so shared prefixes hash
        # identically — the solver cache keys warm-start models by
        # these (laser/cuda/solver_cache.py; hint-only, never a verdict)
        plen = int(np.asarray(st.path_len)[lane])
        if plen:
            ids = np.asarray(st.path_id)[lane, :plen]
            if (ids > 0).all():
                h1 = np.asarray(st.tape_h1)[lane][ids - 1]
                h2 = np.asarray(st.tape_h2)[lane][ids - 1]
                signs = np.asarray(st.path_sign)[lane, :plen]
                fps = symtape.path_fingerprint(h1, h2, signs)
                gs._solver_prefix_fps = tuple(int(f) for f in fps)

        # static must-fact contradiction: a device branch whose recorded
        # sign conflicts with the taint pass's MUST verdict at that JUMPI
        # cannot be satisfied, so the whole path condition is UNSAT. The
        # flag rides to filter_feasible, which seeds the solver cache
        # (static_unsat_seeds) instead of spending a solve on the lane.
        if plen:
            analysis = getattr(gs.environment.code, "static_analysis", None)
            verdict_plane = getattr(analysis, "jumpi_verdict", None)
            if verdict_plane is not None:
                # MUST value bounds on the same JUMPI condition words
                # (tables.cond_intervals): any execution reaching the
                # site keeps its condition inside the bound, and this
                # lane's path passes through the site — so the bound is
                # a sound fact about the lifted word in every model of
                # the path condition. Keyed by the word's term uid; the
                # rewrite pass uses them as interval-discharge seeds.
                bounds_plane = getattr(analysis, "cond_intervals", None)
                seeds: Dict[int, Tuple[int, int]] = {}
                metas = np.asarray(st.path_meta)[lane]
                path_signs = np.asarray(st.path_sign)[lane]
                path_ids = np.asarray(st.path_id)[lane]
                for j in range(plen):
                    site = symtape.unpack_meta(int(metas[j]))
                    if site is None or not 0 <= site[0] < analysis.code_len:
                        continue
                    verdict = int(verdict_plane[site[0]])
                    taken = bool(path_signs[j])
                    if (verdict == 1 and not taken) or (
                        verdict == 2 and taken
                    ):
                        gs._static_unsat = True
                        break
                    if bounds_plane:
                        bound = bounds_plane.get(site[0])
                        node_id = int(path_ids[j])
                        if bound is not None and 0 < node_id <= len(values):
                            raw = getattr(values[node_id - 1], "raw", None)
                            if raw is not None:
                                seeds[raw.uid] = bound
                if seeds and not gs._static_unsat:
                    gs._interval_seeds = seeds

        self._replay_jumpi_sites(gs, st, lane, values)
        self._replay_segment_sites(gs, st, lane, values)
        return gs

    def _replay_segment_sites(self, gs, st, lane, values) -> None:
        """Re-fire the skipped site hooks for this lane's device segment
        in EXACT execution order: block entries (JUMP/JUMPI post-hooks,
        from the jump-landing ring) interleaved with storage events
        (SLOAD/SSTORE pre-hooks, from the event ring — each event
        carries the landing count at which it fired). Keys and values
        lift exactly: concrete operands ride as CONST tape nodes.

        Ring overflow makes the order unreconstructable: entry hooks
        offering an on_device_overflow callback are told (the dependency
        pruner disables itself — sound, just slower), storage events
        cannot have been lost (ss overflow either drains to the host
        spill chain mid-round — replayed first, below — or freeze-traps
        the lane), and the surviving events replay uninterleaved.

        PluginSkipState raised by an entry hook propagates: the caller
        drops the lifted state, mirroring the host pruner's
        skip-at-entry. Events before the prune point have replayed;
        later ones have not — exactly the host's stop-at-entry."""
        entry_hooks = self.tape_replayers.get("BLOCK_ENTRY") or ()
        sstore_hooks = self.tape_replayers.get("SSTORE") or ()
        sload_hooks = self.tape_replayers.get("SLOAD") or ()
        if not (entry_hooks or sstore_hooks or sload_hooks):
            return
        from mythril_tpu_torch.laser.cuda.batch import JD_RING

        jd_cnt = int(np.asarray(st.jd_cnt)[lane])
        overflowed = jd_cnt > JD_RING
        if overflowed:
            for hook in entry_hooks:
                overflow_cb = getattr(hook, "on_device_overflow", None)
                if overflow_cb is not None:
                    overflow_cb()
            landings = []
        else:
            ring = np.asarray(st.jd_ring)[lane]
            landings = [int(ring[k]) for k in range(jd_cnt)]

        ev_cnt = int(np.asarray(st.ss_cnt)[lane])
        ev_pc = np.asarray(st.ss_pc)[lane]
        ev_key = np.asarray(st.ss_key)[lane]
        ev_val = np.asarray(st.ss_val)[lane]
        ev_is_load = np.asarray(st.ss_is_load)[lane]
        ev_jd = np.asarray(st.ss_jd)[lane]

        # events drained mid-round (ring overflow spill) replay FIRST:
        # they happened before everything still in the ring, and their
        # jd counts are <= the ring's, so the concatenation stays sorted
        # for the landing-interleave merge below
        events = self.spilled_events(int(np.asarray(st.spill_id)[lane]))
        events = events + [
            (
                int(ev_pc[j]),
                int(ev_key[j]),
                int(ev_val[j]),
                bool(ev_is_load[j]),
                int(ev_jd[j]),
            )
            for j in range(ev_cnt)
        ]

        zero = symbol_factory.BitVecVal(0, 256)

        def term(tag):
            if tag > 0 and values[tag - 1] is not None:
                return values[tag - 1]
            return zero

        instr_list = gs.environment.code.instruction_list
        saved_pc, saved_stack = gs.mstate.pc, gs.mstate.stack

        def fire_storage(event) -> None:
            pc_byte, key_id, val_id, is_load, _jd = event
            pc_index = evm_util.get_instruction_index(instr_list, pc_byte)
            if pc_index is None:
                return
            gs.mstate.pc = pc_index
            if is_load:
                hooks = sload_hooks
                gs.mstate.stack = MachineStack([term(key_id)])
            else:
                hooks = sstore_hooks
                gs.mstate.stack = MachineStack([term(val_id), term(key_id)])
            with forced_hook_phase(prehook=True):
                for hook in hooks:
                    try:
                        hook(gs)
                    except Exception as e:  # pragma: no cover
                        log.warning("storage event replay failed: %s", e)

        def fire_entry(landing: int) -> None:
            pc_index = evm_util.get_instruction_index(instr_list, landing)
            if pc_index is None:
                return
            gs.mstate.pc = pc_index
            with forced_hook_phase(prehook=False):
                for hook in entry_hooks:
                    hook(gs)

        event_j = 0
        try:
            for k, landing in enumerate(landings):
                while event_j < len(events) and events[event_j][4] <= k:
                    fire_storage(events[event_j])
                    event_j += 1
                fire_entry(landing)
            while event_j < len(events):
                fire_storage(events[event_j])
                event_j += 1
        finally:
            gs.mstate.pc = saved_pc
            gs.mstate.stack = saved_stack

    def _replay_jumpi_sites(self, gs, st, lane, values) -> None:
        """Run JUMPI pre-hooks of batch-aware modules for every branch
        the device took on this lane.

        The unpacked state is mutated into the shape the hook expects at
        the branch site (pc at the JUMPI, ``[cond, dest]`` on top of the
        stack) and restored afterwards — probe modules snapshot what they
        report at materialize time, and sink annotations land on the
        continuing state exactly as a host-fired hook's would. The dest
        slot is a concrete dummy: device-retired JUMPIs always have
        concrete destinations (symbolic destinations trap), so
        dest-sensitive modules see what they would have seen."""
        replayers = self.tape_replayers.get("JUMPI")
        if not replayers:
            return
        plen = int(np.asarray(st.path_len)[lane])
        if plen == 0:
            return
        from mythril_tpu_torch.analysis.module import gating

        analysis = getattr(gs.environment.code, "static_analysis", None)
        depth_ok = len(gs.transaction_stack) <= 1
        path_ids = np.asarray(st.path_id)[lane]
        path_metas = np.asarray(st.path_meta)[lane]
        instr_list = gs.environment.code.instruction_list
        saved_pc, saved_stack = gs.mstate.pc, gs.mstate.stack
        dest_dummy = symbol_factory.BitVecVal(0, 256)
        try:
            for j in range(plen):
                site = symtape.unpack_meta(int(path_metas[j]))
                if site is None:
                    continue
                pc_byte, _ = site
                node_id = int(path_ids[j])
                if node_id <= 0 or values[node_id - 1] is None:
                    continue
                pc_index = evm_util.get_instruction_index(instr_list, pc_byte)
                if pc_index is None:
                    continue
                gs.mstate.pc = pc_index
                gs.mstate.stack = MachineStack(
                    [values[node_id - 1], dest_dummy]
                )
                with forced_hook_phase(prehook=True):
                    for module, _name in replayers:
                        if not gating.gate_replay(
                            module, analysis, pc_byte, depth_ok
                        ):
                            continue
                        try:
                            module.execute(gs)
                        except Exception as e:  # pragma: no cover
                            log.warning("JUMPI replay failed: %s", e)
        finally:
            gs.mstate.pc = saved_pc
            gs.mstate.stack = saved_stack
