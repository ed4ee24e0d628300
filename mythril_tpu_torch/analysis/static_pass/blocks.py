"""Basic-block decomposition over raw EVM bytecode.

The scan walks instruction boundaries exactly like the device code bank
constructor (laser/cuda/batch.py make_code_bank): PUSH immediates are skipped
(so a 0x5B byte inside push data is NOT a JUMPDEST) and a PUSH whose
immediate runs past the end of the code zero-pads on the right, matching
the EVM's implicit zero bytes past the code end. Everything downstream
(the abstract interpreter, the dense tables, the device must-revert
bitmap) is keyed to these byte-pc boundaries.
"""

from typing import List, NamedTuple, Optional, Tuple

from mythril_tpu_torch.support.opcodes import OPCODES

JUMPDEST, JUMP, JUMPI = 0x5B, 0x56, 0x57
PUSH0, PUSH1, PUSH32 = 0x5F, 0x60, 0x7F
STOP, RETURN, REVERT, INVALID, SUICIDE = 0x00, 0xF3, 0xFD, 0xFE, 0xFF

# instructions that end a block with NO fall-through successor
HALTS = frozenset({STOP, RETURN, REVERT, INVALID, SUICIDE})

# the sites detection modules anchor on: state mutation + call family
# (SSTORE, CREATE, CALL, CALLCODE, CREATE2, DELEGATECALL, STATICCALL,
# SELFDESTRUCT/SUICIDE) — the "interesting-op" distance metric targets
INTERESTING = frozenset({0x55, 0xF0, 0xF1, 0xF2, 0xF4, 0xF5, 0xFA, 0xFF})


class Insn(NamedTuple):
    """One decoded instruction (PUSH immediates zero-padded if truncated)."""

    pc: int
    op: int
    imm: Optional[int]
    truncated: bool


class BasicBlock(NamedTuple):
    """A maximal straight-line instruction run.

    ``start`` is the byte pc of the first instruction, ``end`` one past
    the last instruction's bytes. ``terminator`` is the last
    instruction's opcode byte — the block may also simply fall through
    into the next leader when the terminator is not a jump/halt.
    """

    index: int
    start: int
    end: int
    insns: Tuple[Insn, ...]

    @property
    def terminator(self) -> int:
        return self.insns[-1].op

    @property
    def falls_through(self) -> bool:
        t = self.terminator
        return t != JUMP and t not in HALTS and t in OPCODES


def scan(code: bytes) -> List[Insn]:
    """Decode ``code`` into instructions at true boundaries."""
    insns: List[Insn] = []
    pc, n = 0, len(code)
    while pc < n:
        op = code[pc]
        if PUSH1 <= op <= PUSH32:
            width = op - 0x5F
            data = code[pc + 1 : pc + 1 + width]
            truncated = len(data) < width
            imm = int.from_bytes(data + b"\x00" * (width - len(data)), "big")
            insns.append(Insn(pc, op, imm, truncated))
            pc += 1 + width
        elif op == PUSH0:
            insns.append(Insn(pc, op, 0, False))
            pc += 1
        else:
            insns.append(Insn(pc, op, None, False))
            pc += 1
    return insns


def decompose(code: bytes) -> Tuple[List[Insn], List[BasicBlock], dict]:
    """(instructions, blocks, byte-pc -> block index for insn starts).

    Leaders: pc 0, every JUMPDEST, and the instruction following a
    JUMP/JUMPI/halt. An unknown opcode byte halts (INVALID semantics),
    so it terminates its block too.
    """
    insns = scan(code)
    if not insns:
        return [], [], {}
    leaders = {insns[0].pc}
    for i, insn in enumerate(insns):
        if insn.op == JUMPDEST:
            leaders.add(insn.pc)
        ends_block = (
            insn.op in (JUMP, JUMPI)
            or insn.op in HALTS
            or insn.op not in OPCODES
        )
        if ends_block and i + 1 < len(insns):
            leaders.add(insns[i + 1].pc)

    blocks: List[BasicBlock] = []
    block_of: dict = {}
    current: List[Insn] = []
    for i, insn in enumerate(insns):
        if insn.pc in leaders and current:
            blocks.append(_close(len(blocks), current))
            current = []
        current.append(insn)
        block_of[insn.pc] = len(blocks)
    blocks.append(_close(len(blocks), current))
    return insns, blocks, block_of


def _close(index: int, insns: List[Insn]) -> BasicBlock:
    last = insns[-1]
    width = last.op - 0x5F if PUSH1 <= last.op <= PUSH32 else 0
    return BasicBlock(index, insns[0].pc, last.pc + 1 + width, tuple(insns))
