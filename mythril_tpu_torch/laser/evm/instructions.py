"""EVM instruction semantics over symbolic state (reference surface:
mythril/laser/ethereum/instructions.py).

Instruction.evaluate dispatches `<opcode>_` / `<opcode>_post` mutators; the
StateTransition decorator copies the state, accounts gas, enforces static
-call write protection and increments the pc. JUMPI is the path fork: it
emits up to two successor states with the branch condition / its negation
appended to the path constraints."""

import logging
from copy import copy, deepcopy
from typing import Callable, List, Union, cast

from mythril_tpu_torch.laser.evm import util
from mythril_tpu_torch.laser.evm.call import (
    get_call_data,
    get_call_parameters,
    native_call,
)
from mythril_tpu_torch.laser.evm.evm_exceptions import (
    InvalidInstruction,
    InvalidJumpDestination,
    OutOfGasException,
    StackUnderflowException,
    VmException,
    WriteProtection,
)
from mythril_tpu_torch.laser.evm.keccak_function_manager import keccak_function_manager
from mythril_tpu_torch.laser.evm.state.calldata import ConcreteCalldata, SymbolicCalldata
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionStartSignal,
    get_next_transaction_id,
    transfer_ether,
)
from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.support.opcodes import calculate_sha3_gas, get_opcode_gas
from mythril_tpu_torch.support.support_utils import get_code_hash
from mythril_tpu_torch.smt import (
    BitVec,
    Bool,
    Concat,
    Expression,
    Extract,
    If,
    LShR,
    Not,
    UDiv,
    UGT,
    ULT,
    URem,
    SRem,
    is_false,
    simplify,
    symbol_factory,
)

log = logging.getLogger(__name__)

TT256 = 2**256
TT256M1 = 2**256 - 1


def _static_jump_index(global_state: GlobalState):
    """Instruction index of a MUST-resolved jump destination, else None.

    Consults the static pre-analysis (analysis/static_pass/): when the
    current JUMP/JUMPI site's destination was constant-folded to a single
    verified JUMPDEST on every path, the concrete destination is known
    without concretizing the (by construction concrete) stack operand."""
    disassembly = global_state.environment.code
    analysis = getattr(disassembly, "static_analysis", None)
    if analysis is None:
        return None
    instr_list = disassembly.instruction_list
    pc = global_state.mstate.pc
    if pc >= len(instr_list):
        return None
    site = instr_list[pc]["address"]
    if site >= analysis.code_len:
        return None
    dest = int(analysis.resolved_target[site])
    if dest < 0:
        return None
    return disassembly.jumpdest_index.get(dest)


def _as_bitvec(value: Union[int, bool, BitVec, Bool]) -> BitVec:
    if isinstance(value, Bool):
        return If(value, symbol_factory.BitVecVal(1, 256), symbol_factory.BitVecVal(0, 256))
    if isinstance(value, bool):
        return symbol_factory.BitVecVal(int(value), 256)
    if isinstance(value, int):
        return symbol_factory.BitVecVal(value, 256)
    return value


class StateTransition(object):
    """Decorator handling the per-instruction state copy, gas accounting,
    static-call write protection and pc increment."""

    def __init__(
        self, increment_pc=True, enable_gas=True, is_state_mutation_instruction=False
    ):
        self.increment_pc = increment_pc
        self.enable_gas = enable_gas
        self.is_state_mutation_instruction = is_state_mutation_instruction

    @staticmethod
    def call_on_state_copy(func: Callable, func_obj: "Instruction", state: GlobalState):
        global_state_copy = copy(state)
        return func(func_obj, global_state_copy)

    def increment_states_pc(self, states: List[GlobalState]) -> List[GlobalState]:
        if self.increment_pc:
            for state in states:
                state.mstate.pc += 1
        return states

    @staticmethod
    def check_gas_usage_limit(global_state: GlobalState):
        global_state.mstate.check_gas()
        if isinstance(global_state.current_transaction.gas_limit, BitVec):
            value = global_state.current_transaction.gas_limit.value
            if value is None:
                return
            global_state.current_transaction.gas_limit = value
        if (
            global_state.mstate.min_gas_used
            >= global_state.current_transaction.gas_limit
        ):
            raise OutOfGasException()

    def accumulate_gas(self, global_state: GlobalState):
        if not self.enable_gas:
            return global_state
        opcode = global_state.instruction["opcode"]
        min_gas, max_gas = get_opcode_gas(opcode)
        global_state.mstate.min_gas_used += min_gas
        global_state.mstate.max_gas_used += max_gas
        self.check_gas_usage_limit(global_state)
        return global_state

    def __call__(self, func: Callable) -> Callable:
        def wrapper(func_obj: "Instruction", global_state: GlobalState) -> List[GlobalState]:
            if self.is_state_mutation_instruction and global_state.environment.static:
                raise WriteProtection(
                    "The function {} cannot be executed in a static call".format(
                        func.__name__[:-1]
                    )
                )
            new_global_states = self.call_on_state_copy(func, func_obj, global_state)
            new_global_states = [self.accumulate_gas(state) for state in new_global_states]
            return self.increment_states_pc(new_global_states)

        return wrapper


class Instruction:
    """Mutates a state according to the current instruction."""

    def __init__(self, op_code: str, dynamic_loader=None, iprof=None) -> None:
        self.dynamic_loader = dynamic_loader
        self.op_code = op_code.upper()
        self.iprof = iprof

    def evaluate(self, global_state: GlobalState, post=False) -> List[GlobalState]:
        """Perform the mutation for this instruction."""
        op = self.op_code.lower()
        if self.op_code.startswith("PUSH"):
            op = "push"
        elif self.op_code.startswith("DUP"):
            op = "dup"
        elif self.op_code.startswith("SWAP"):
            op = "swap"
        elif self.op_code.startswith("LOG"):
            op = "log"

        instruction_mutator = (
            getattr(self, op + "_", None)
            if not post
            else getattr(self, op + "_post", None)
        )
        if instruction_mutator is None:
            raise NotImplementedError

        if self.iprof is None:
            return instruction_mutator(global_state)
        import time as _time

        start_time = _time.time()
        result = instruction_mutator(global_state)
        self.iprof.record(op, start_time, _time.time())
        return result

    # -- stack manipulation ---------------------------------------------------

    @StateTransition()
    def jumpdest_(self, global_state: GlobalState) -> List[GlobalState]:
        return [global_state]

    @StateTransition()
    def push_(self, global_state: GlobalState) -> List[GlobalState]:
        push_instruction = global_state.get_current_instruction()
        try:
            length_of_value = 2 * int(push_instruction["opcode"][4:])
        except ValueError:
            raise VmException("Invalid Push instruction")
        if length_of_value == 0:  # PUSH0
            global_state.mstate.stack.append(symbol_factory.BitVecVal(0, 256))
            return [global_state]
        push_value = push_instruction["argument"][2:]
        # code truncated mid-push reads as zero bytes
        push_value += "0" * max(length_of_value - len(push_value), 0)
        global_state.mstate.stack.append(
            symbol_factory.BitVecVal(int(push_value, 16), 256)
        )
        return [global_state]

    @StateTransition()
    def dup_(self, global_state: GlobalState) -> List[GlobalState]:
        value = int(global_state.get_current_instruction()["opcode"][3:], 10)
        global_state.mstate.stack.append(global_state.mstate.stack[-value])
        return [global_state]

    @StateTransition()
    def swap_(self, global_state: GlobalState) -> List[GlobalState]:
        depth = int(self.op_code[4:])
        stack = global_state.mstate.stack
        stack[-depth - 1], stack[-1] = stack[-1], stack[-depth - 1]
        return [global_state]

    @StateTransition()
    def pop_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.pop()
        return [global_state]

    # -- storage --------------------------------------------------------------

    @StateTransition()
    def sload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        index = state.stack.pop()
        state.stack.append(global_state.environment.active_account.storage[index])
        return [global_state]

    @StateTransition(is_state_mutation_instruction=True)
    def sstore_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        index, value = state.stack.pop(), state.stack.pop()
        global_state.environment.active_account.storage[index] = value
        return [global_state]

    # -- control flow ---------------------------------------------------------

    @StateTransition(increment_pc=False, enable_gas=False)
    def jump_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        disassembly = global_state.environment.code
        # static fast path: a MUST-resolved site skips concretization and
        # destination validation (the pass already verified the JUMPDEST)
        index = _static_jump_index(global_state)
        try:
            operand = state.stack.pop()
        except IndexError:
            raise StackUnderflowException()
        if index is None:
            try:
                jump_addr = util.get_concrete_int(operand)
            except TypeError:
                raise InvalidJumpDestination(
                    "Invalid jump argument (symbolic address)"
                )

            index = util.get_instruction_index(
                disassembly.instruction_list, jump_addr
            )
            if index is None:
                raise InvalidJumpDestination("JUMP to invalid address")
            op_code = disassembly.instruction_list[index]["opcode"]
            if op_code != "JUMPDEST":
                raise InvalidJumpDestination(
                    "Skipping JUMP to invalid destination (not JUMPDEST): "
                    + str(jump_addr)
                )

        new_state = copy(global_state)
        min_gas, max_gas = get_opcode_gas("JUMP")
        new_state.mstate.min_gas_used += min_gas
        new_state.mstate.max_gas_used += max_gas
        new_state.mstate.pc = index
        new_state.mstate.depth += 1
        return [new_state]

    @StateTransition(increment_pc=False, enable_gas=False)
    def jumpi_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        disassembly = global_state.environment.code
        min_gas, max_gas = get_opcode_gas("JUMPI")
        states = []

        # static fast path (see jump_): resolved sites skip concretization
        # and the JUMPDEST re-validation below
        index = _static_jump_index(global_state)
        op0, condition = state.stack.pop(), state.stack.pop()
        if index is None:
            try:
                jump_addr = util.get_concrete_int(op0)
            except TypeError:
                log.debug("Skipping JUMPI to invalid destination.")
                global_state.mstate.pc += 1
                global_state.mstate.min_gas_used += min_gas
                global_state.mstate.max_gas_used += max_gas
                return [global_state]

        negated = (
            simplify(Not(condition)) if isinstance(condition, Bool) else condition == 0
        )
        condi = simplify(condition) if isinstance(condition, Bool) else condition != 0

        negated_cond = (type(negated) == bool and negated) or (
            isinstance(negated, Bool) and not is_false(negated)
        )
        positive_cond = (type(condi) == bool and condi) or (
            isinstance(condi, Bool) and not is_false(condi)
        )

        # fall-through case
        if negated_cond:
            new_state = copy(global_state)
            new_state.mstate.min_gas_used += min_gas
            new_state.mstate.max_gas_used += max_gas
            new_state.mstate.depth += 1
            new_state.mstate.pc += 1
            new_state.world_state.constraints.append(negated)
            states.append(new_state)
        else:
            log.debug("Pruned unreachable states.")

        # jump-taken case (index already resolved on the static fast path)
        if index is None:
            index = util.get_instruction_index(
                disassembly.instruction_list, jump_addr
            )
            if index is None:
                log.debug("Invalid jump destination: %s", jump_addr)
                return states
            if disassembly.instruction_list[index]["opcode"] != "JUMPDEST":
                return states
        if positive_cond:
            new_state = copy(global_state)
            new_state.mstate.min_gas_used += min_gas
            new_state.mstate.max_gas_used += max_gas
            new_state.mstate.pc = index
            new_state.mstate.depth += 1
            new_state.world_state.constraints.append(condi)
            states.append(new_state)
        else:
            log.debug("Pruned unreachable states.")
        return states

    @StateTransition()
    def pc_(self, global_state: GlobalState) -> List[GlobalState]:
        index = global_state.mstate.pc
        program_counter = global_state.environment.code.instruction_list[index]["address"]
        global_state.mstate.stack.append(program_counter)
        return [global_state]

    @StateTransition(is_state_mutation_instruction=True)
    def log_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        depth = int(self.op_code[3:])
        state.stack.pop(), state.stack.pop()
        _ = [state.stack.pop() for _ in range(depth)]
        # event logs are not tracked
        return [global_state]

    # -- memory ---------------------------------------------------------------

    @StateTransition()
    def mload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        offset = state.stack.pop()
        state.mem_extend(offset, 32)
        state.stack.append(state.memory.get_word_at(offset))
        return [global_state]

    @StateTransition()
    def mstore_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        mstart, value = state.stack.pop(), state.stack.pop()
        try:
            state.mem_extend(mstart, 32)
        except Exception:
            log.debug("Error extending memory")
        state.memory.write_word_at(mstart, value)
        return [global_state]

    @StateTransition()
    def mstore8_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        offset, value = state.stack.pop(), state.stack.pop()
        state.mem_extend(offset, 1)
        try:
            value_to_write: Union[int, BitVec] = util.get_concrete_int(value) % 256
        except TypeError:
            value_to_write = Extract(7, 0, value)
        state.memory[offset] = value_to_write
        return [global_state]

    # -- arithmetic -----------------------------------------------------------

    @StateTransition()
    def addmod_(self, global_state: GlobalState) -> List[GlobalState]:
        mstate = global_state.mstate
        s0, s1, s2 = (
            util.pop_bitvec(mstate),
            util.pop_bitvec(mstate),
            util.pop_bitvec(mstate),
        )
        if s2.value == 0:
            mstate.stack.append(symbol_factory.BitVecVal(0, 256))
        elif s2.symbolic:
            mstate.stack.append(
                If(
                    s2 == 0,
                    symbol_factory.BitVecVal(0, 256),
                    URem(URem(s0, s2) + URem(s1, s2), s2),
                )
            )
        else:
            # widen to 257 bits so the intermediate sum cannot wrap
            from mythril_tpu_torch.smt import ZeroExt

            wide = URem(
                cast(BitVec, ZeroExt(1, URem(s0, s2)) + ZeroExt(1, URem(s1, s2))),
                ZeroExt(1, s2),
            )
            mstate.stack.append(Extract(255, 0, wide))
        return [global_state]

    @StateTransition()
    def mulmod_(self, global_state: GlobalState) -> List[GlobalState]:
        mstate = global_state.mstate
        s0, s1, s2 = (
            util.pop_bitvec(mstate),
            util.pop_bitvec(mstate),
            util.pop_bitvec(mstate),
        )
        if s2.value == 0:
            mstate.stack.append(symbol_factory.BitVecVal(0, 256))
        elif s2.symbolic:
            mstate.stack.append(
                If(
                    s2 == 0,
                    symbol_factory.BitVecVal(0, 256),
                    URem(URem(s0, s2) * URem(s1, s2), s2),
                )
            )
        else:
            from mythril_tpu_torch.smt import ZeroExt

            wide = URem(
                cast(BitVec, ZeroExt(256, URem(s0, s2)) * ZeroExt(256, URem(s1, s2))),
                ZeroExt(256, s2),
            )
            mstate.stack.append(Extract(255, 0, wide))
        return [global_state]

    @StateTransition()
    def exp_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        base, exponent = util.pop_bitvec(state), util.pop_bitvec(state)
        if base.symbolic or exponent.symbolic:
            state.stack.append(
                global_state.new_bitvec(
                    "invhash(" + str(hash(simplify(base))) + ")**invhash("
                    + str(hash(simplify(exponent))) + ")",
                    256,
                    base.annotations.union(exponent.annotations),
                )
            )
        else:
            state.stack.append(
                symbol_factory.BitVecVal(
                    pow(base.value, exponent.value, 2**256),
                    256,
                    annotations=base.annotations.union(exponent.annotations),
                )
            )
        return [global_state]

    @StateTransition()
    def signextend_(self, global_state: GlobalState) -> List[GlobalState]:
        mstate = global_state.mstate
        s0, s1 = mstate.stack.pop(), mstate.stack.pop()
        try:
            s0 = util.get_concrete_int(s0)
            s1 = util.get_concrete_int(s1)
        except TypeError:
            log.debug("Unsupported symbolic argument for SIGNEXTEND")
            mstate.stack.append(
                global_state.new_bitvec("SIGNEXTEND({},{})".format(hash(s0), hash(s1)), 256)
            )
            return [global_state]
        if s0 <= 31:
            testbit = s0 * 8 + 7
            if s1 & (1 << testbit):
                mstate.stack.append(s1 | (TT256 - (1 << testbit)))
            else:
                mstate.stack.append(s1 & ((1 << testbit) - 1))
        else:
            mstate.stack.append(s1)
        return [global_state]

    # -- bitwise --------------------------------------------------------------

    @StateTransition()
    def not_(self, global_state: GlobalState):
        mstate = global_state.mstate
        mstate.stack.append(symbol_factory.BitVecVal(TT256M1, 256) - util.pop_bitvec(mstate))
        return [global_state]

    @StateTransition()
    def byte_(self, global_state: GlobalState) -> List[GlobalState]:
        mstate = global_state.mstate
        op0, op1 = mstate.stack.pop(), mstate.stack.pop()
        if not isinstance(op1, Expression):
            op1 = symbol_factory.BitVecVal(op1, 256)
        try:
            index = util.get_concrete_int(op0)
            offset = (31 - index) * 8
            if offset >= 0:
                result: Union[int, Expression] = simplify(
                    Concat(
                        symbol_factory.BitVecVal(0, 248),
                        Extract(offset + 7, offset, op1),
                    )
                )
            else:
                result = 0
        except TypeError:
            log.debug("BYTE: Unsupported symbolic byte offset")
            result = global_state.new_bitvec(
                str(simplify(op1)) + "[" + str(simplify(op0)) + "]", 256
            )
        mstate.stack.append(result)
        return [global_state]

    # -- comparisons ----------------------------------------------------------

    @StateTransition()
    def iszero_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        val = state.stack.pop()
        exp = Not(val) if isinstance(val, Bool) else val == 0
        exp = If(exp, symbol_factory.BitVecVal(1, 256), symbol_factory.BitVecVal(0, 256))
        state.stack.append(simplify(exp))
        return [global_state]

    # -- call family ----------------------------------------------------------

    @staticmethod
    def _write_symbolic_returndata(global_state, memory_out_offset, memory_out_size):
        """Write fresh symbols as return data (concrete offsets only)."""
        if memory_out_offset.symbolic is True or memory_out_size.symbolic is True:
            return
        for i in range(memory_out_size.value):
            global_state.mstate.memory[memory_out_offset + i] = global_state.new_bitvec(
                "call_output_var({})_{}".format(
                    simplify(memory_out_offset + i), global_state.mstate.pc
                ),
                8,
            )

    @StateTransition()
    def call_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        environment = global_state.environment
        memory_out_size, memory_out_offset = global_state.mstate.stack[-7:-5]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(global_state, self.dynamic_loader, True)

            if callee_account is not None and callee_account.code.bytecode == "":
                log.debug("The call is related to ether transfer between accounts")
                sender = environment.active_account.address
                receiver = callee_account.address
                transfer_ether(global_state, sender, receiver, value)
                global_state.mstate.stack.append(
                    global_state.new_bitvec("retval_" + str(instr["address"]), 256)
                )
                return [global_state]
        except ValueError as e:
            log.debug("Could not determine required parameters for call: %s", e)
            self._write_symbolic_returndata(global_state, memory_out_offset, memory_out_size)
            global_state.mstate.stack.append(
                global_state.new_bitvec("retval_" + str(instr["address"]), 256)
            )
            return [global_state]

        if environment.static:
            if isinstance(value, int) and value > 0:
                raise WriteProtection("Cannot call with non zero value in a static call")
            if isinstance(value, BitVec):
                if value.symbolic:
                    global_state.world_state.constraints.append(
                        value == symbol_factory.BitVecVal(0, 256)
                    )
                elif value.value > 0:
                    raise WriteProtection("Cannot call with non zero value in a static call")

        native_result = native_call(
            global_state, callee_address, call_data, memory_out_offset, memory_out_size
        )
        if native_result:
            return native_result

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            caller=environment.active_account.address,
            callee_account=callee_account,
            call_data=call_data,
            call_value=value,
            static=environment.static,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition()
    def call_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="call")

    @StateTransition()
    def callcode_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        environment = global_state.environment
        memory_out_size, memory_out_offset = global_state.mstate.stack[-7:-5]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                _,
                _,
            ) = get_call_parameters(global_state, self.dynamic_loader, True)
            if callee_account is not None and callee_account.code.bytecode == "":
                log.debug("The call is related to ether transfer between accounts")
                sender = environment.active_account.address
                receiver = callee_account.address
                transfer_ether(global_state, sender, receiver, value)
                global_state.mstate.stack.append(
                    global_state.new_bitvec("retval_" + str(instr["address"]), 256)
                )
                return [global_state]
        except ValueError as e:
            log.debug("Could not determine required parameters for callcode: %s", e)
            self._write_symbolic_returndata(global_state, memory_out_offset, memory_out_size)
            global_state.mstate.stack.append(
                global_state.new_bitvec("retval_" + str(instr["address"]), 256)
            )
            return [global_state]

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code,
            caller=environment.address,
            callee_account=environment.active_account,
            call_data=call_data,
            call_value=value,
            static=environment.static,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition()
    def callcode_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="callcode")

    @StateTransition()
    def delegatecall_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        environment = global_state.environment
        memory_out_size, memory_out_offset = global_state.mstate.stack[-6:-4]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                _,
                _,
            ) = get_call_parameters(global_state, self.dynamic_loader)
            if callee_account is not None and callee_account.code.bytecode == "":
                log.debug("The call is related to ether transfer between accounts")
                sender = environment.active_account.address
                receiver = callee_account.address
                transfer_ether(global_state, sender, receiver, value)
                global_state.mstate.stack.append(
                    global_state.new_bitvec("retval_" + str(instr["address"]), 256)
                )
                return [global_state]
        except ValueError as e:
            log.debug("Could not determine required parameters for delegatecall: %s", e)
            self._write_symbolic_returndata(global_state, memory_out_offset, memory_out_size)
            global_state.mstate.stack.append(
                global_state.new_bitvec("retval_" + str(instr["address"]), 256)
            )
            return [global_state]

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code,
            caller=environment.sender,
            callee_account=environment.active_account,
            call_data=call_data,
            call_value=environment.callvalue,
            static=environment.static,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition()
    def delegatecall_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="delegatecall")

    @StateTransition()
    def staticcall_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        environment = global_state.environment
        memory_out_size, memory_out_offset = global_state.mstate.stack[-6:-4]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(global_state, self.dynamic_loader)
            if callee_account is not None and callee_account.code.bytecode == "":
                log.debug("The call is related to ether transfer between accounts")
                sender = environment.active_account.address
                receiver = callee_account.address
                transfer_ether(global_state, sender, receiver, value)
                global_state.mstate.stack.append(
                    global_state.new_bitvec("retval_" + str(instr["address"]), 256)
                )
                return [global_state]
        except ValueError as e:
            log.debug("Could not determine required parameters for staticcall: %s", e)
            self._write_symbolic_returndata(global_state, memory_out_offset, memory_out_size)
            global_state.mstate.stack.append(
                global_state.new_bitvec("retval_" + str(instr["address"]), 256)
            )
            return [global_state]

        native_result = native_call(
            global_state, callee_address, call_data, memory_out_offset, memory_out_size
        )
        if native_result:
            return native_result

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code,
            caller=environment.address,
            callee_account=callee_account,
            call_data=call_data,
            call_value=value,
            static=True,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition()
    def staticcall_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="staticcall")

    def post_handler(self, global_state, function_name: str):
        instr = global_state.get_current_instruction()
        if function_name in ("staticcall", "delegatecall"):
            memory_out_size, memory_out_offset = global_state.mstate.stack[-6:-4]
        else:
            memory_out_size, memory_out_offset = global_state.mstate.stack[-7:-5]

        try:
            with_value = function_name not in ("staticcall", "delegatecall")
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(global_state, self.dynamic_loader, with_value)
        except ValueError as e:
            log.debug(
                "Could not determine required parameters for %s: %s", function_name, e
            )
            self._write_symbolic_returndata(global_state, memory_out_offset, memory_out_size)
            global_state.mstate.stack.append(
                global_state.new_bitvec("retval_" + str(instr["address"]), 256)
            )
            return [global_state]

        if global_state.last_return_data is None:
            return_value = global_state.new_bitvec("retval_" + str(instr["address"]), 256)
            global_state.mstate.stack.append(return_value)
            global_state.world_state.constraints.append(return_value == 0)
            return [global_state]

        try:
            memory_out_offset = (
                util.get_concrete_int(memory_out_offset)
                if isinstance(memory_out_offset, Expression)
                else memory_out_offset
            )
            memory_out_size = (
                util.get_concrete_int(memory_out_size)
                if isinstance(memory_out_size, Expression)
                else memory_out_size
            )
        except TypeError:
            global_state.mstate.stack.append(
                global_state.new_bitvec("retval_" + str(instr["address"]), 256)
            )
            return [global_state]

        # copy the return data to memory
        global_state.mstate.mem_extend(
            memory_out_offset, min(memory_out_size, len(global_state.last_return_data))
        )
        for i in range(min(memory_out_size, len(global_state.last_return_data))):
            global_state.mstate.memory[i + memory_out_offset] = global_state.last_return_data[i]

        return_value = global_state.new_bitvec("retval_" + str(instr["address"]), 256)
        global_state.mstate.stack.append(return_value)
        global_state.world_state.constraints.append(return_value == 1)
        return [global_state]


    # -- transaction end ------------------------------------------------------

    @StateTransition()
    def return_(self, global_state: GlobalState):
        state = global_state.mstate
        offset, length = state.stack.pop(), state.stack.pop()
        if length.symbolic:
            return_data = [global_state.new_bitvec("return_data", 8)]
            log.debug("Return with symbolic length or offset. Not supported")
        else:
            state.mem_extend(offset, length)
            StateTransition.check_gas_usage_limit(global_state)
            return_data = [
                b.value if isinstance(b, BitVec) and b.value is not None else b
                for b in state.memory[offset : offset + length]
            ]
        global_state.current_transaction.end(global_state, return_data)

    @StateTransition(is_state_mutation_instruction=True)
    def suicide_(self, global_state: GlobalState):
        target = global_state.mstate.stack.pop()
        transfer_amount = global_state.environment.active_account.balance()
        global_state.world_state.balances[_as_bitvec(target)] = (
            global_state.world_state.balances[_as_bitvec(target)] + transfer_amount
        )
        global_state.environment.active_account = deepcopy(
            global_state.environment.active_account
        )
        global_state.accounts[
            global_state.environment.active_account.address.value
        ] = global_state.environment.active_account
        global_state.environment.active_account.set_balance(0)
        global_state.environment.active_account.deleted = True
        global_state.current_transaction.end(global_state)

    @StateTransition()
    def revert_(self, global_state: GlobalState) -> None:
        state = global_state.mstate
        offset, length = state.stack.pop(), state.stack.pop()
        return_data = [global_state.new_bitvec("return_data", 8)]
        try:
            return_data = [
                b.value if isinstance(b, BitVec) and b.value is not None else b
                for b in state.memory[
                    util.get_concrete_int(offset) : util.get_concrete_int(offset + length)
                ]
            ]
        except TypeError:
            log.debug("Revert with symbolic length or offset. Not supported")
        global_state.current_transaction.end(
            global_state, return_data=return_data, revert=True
        )

    @StateTransition()
    def assert_fail_(self, global_state: GlobalState):
        # 0xfe: designated invalid opcode
        raise InvalidInstruction

    @StateTransition()
    def invalid_(self, global_state: GlobalState):
        raise InvalidInstruction

    @StateTransition()
    def stop_(self, global_state: GlobalState):
        global_state.current_transaction.end(global_state)

    # -- create ---------------------------------------------------------------

    def _create_transaction_helper(
        self, global_state, call_value, mem_offset, mem_size, create2_salt=None
    ) -> List[GlobalState]:
        mstate = global_state.mstate
        environment = global_state.environment
        world_state = global_state.world_state

        call_data = get_call_data(global_state, mem_offset, mem_offset + mem_size)

        code_raw = []
        code_end = call_data.size
        size = call_data.size
        if isinstance(size, BitVec):
            if size.symbolic:
                size = 10**5
            else:
                size = size.value
        for i in range(size):
            if call_data[i].symbolic:
                code_end = i
                break
            code_raw.append(call_data[i].value)

        if len(code_raw) < 1:
            global_state.mstate.stack.append(1)
            log.debug("No code found for trying to execute a create type instruction.")
            return [global_state]

        code_str = bytes(code_raw).hex()
        next_transaction_id = get_next_transaction_id()
        constructor_arguments = ConcreteCalldata(next_transaction_id, call_data[code_end:])
        code = Disassembly(code_str)

        caller = environment.active_account.address
        gas_price = environment.gasprice
        origin = environment.origin

        contract_address: Union[BitVec, int, None] = None
        Instruction._sha3_gas_helper(global_state, len(code_str) // 2)

        if create2_salt is not None:
            if create2_salt.symbolic:
                if create2_salt.size() != 256:
                    pad = symbol_factory.BitVecVal(0, 256 - create2_salt.size())
                    create2_salt = Concat(pad, create2_salt)
                address, constraint = keccak_function_manager.create_keccak(
                    Concat(
                        symbol_factory.BitVecVal(255, 8),
                        Extract(159, 0, caller),
                        create2_salt,
                        symbol_factory.BitVecVal(int(get_code_hash(code_str), 16), 256),
                    )
                )
                contract_address = Extract(159, 0, address)
                global_state.world_state.constraints.append(constraint)
            else:
                salt = hex(create2_salt.value)[2:]
                salt = "0" * (64 - len(salt)) + salt
                addr = hex(caller.value)[2:]
                addr = "0" * (40 - len(addr)) + addr
                contract_address = int(
                    get_code_hash("0xff" + addr + salt + get_code_hash(code_str)[2:])[26:],
                    16,
                )
        transaction = ContractCreationTransaction(
            world_state=world_state,
            caller=caller,
            code=code,
            call_data=constructor_arguments,
            gas_price=gas_price,
            gas_limit=mstate.gas_limit,
            origin=origin,
            call_value=call_value,
            contract_address=contract_address,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition(is_state_mutation_instruction=True)
    def create_(self, global_state: GlobalState) -> List[GlobalState]:
        call_value, mem_offset, mem_size = global_state.mstate.pop(3)
        return self._create_transaction_helper(global_state, call_value, mem_offset, mem_size)

    @StateTransition()
    def create_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._handle_create_type_post(global_state)

    @StateTransition(is_state_mutation_instruction=True)
    def create2_(self, global_state: GlobalState) -> List[GlobalState]:
        call_value, mem_offset, mem_size, salt = global_state.mstate.pop(4)
        return self._create_transaction_helper(
            global_state, call_value, mem_offset, mem_size, salt
        )

    @StateTransition()
    def create2_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._handle_create_type_post(global_state, opcode="create2")

    @staticmethod
    def _handle_create_type_post(global_state, opcode="create"):
        if opcode == "create2":
            global_state.mstate.pop(4)
        else:
            global_state.mstate.pop(3)
        if global_state.last_return_data:
            return_val = symbol_factory.BitVecVal(int(global_state.last_return_data, 16), 256)
        else:
            return_val = symbol_factory.BitVecVal(0, 256)
        global_state.mstate.stack.append(return_val)
        return [global_state]

    # -- call data ------------------------------------------------------------

    @StateTransition()
    def calldataload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        op0 = state.stack.pop()
        # concretize the offset when possible so the word read follows the
        # natural-number (no 256-bit wrap) slice path in BaseCalldata
        try:
            op0 = util.get_concrete_int(op0)
        except TypeError:
            pass
        try:
            value = global_state.environment.calldata.get_word_at(op0)
        except IndexError:
            # pathological symbolic offset (structural walk didn't close):
            # same pressure valve as the reference's concretize-or-bail
            value = global_state.new_bitvec(
                "calldata_{}[{}]".format(
                    global_state.environment.active_account.contract_name,
                    hash(simplify(op0)) if isinstance(op0, Expression) else op0,
                ),
                256,
            )
        state.stack.append(value)
        return [global_state]

    @StateTransition()
    def calldatasize_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        if isinstance(global_state.current_transaction, ContractCreationTransaction):
            log.debug("Attempt to use CALLDATASIZE in creation transaction")
            state.stack.append(0)
        else:
            state.stack.append(global_state.environment.calldata.calldatasize)
        return [global_state]

    @staticmethod
    def _calldata_copy_helper(global_state, mstate, mstart, dstart, size):
        environment = global_state.environment
        try:
            mstart = util.get_concrete_int(mstart)
        except TypeError:
            log.debug("Unsupported symbolic memory offset in CALLDATACOPY")
            return [global_state]
        try:
            dstart = util.get_concrete_int(dstart)
        except TypeError:
            log.debug("Unsupported symbolic calldata offset in CALLDATACOPY")
            dstart = simplify(dstart)
        try:
            size = util.get_concrete_int(size)
        except TypeError:
            log.debug("Unsupported symbolic size in CALLDATACOPY")
            size = 320  # excess gets overwritten
        if size > 0:
            try:
                mstate.mem_extend(mstart, size)
            except TypeError as e:
                log.debug("Memory allocation error: %s", e)
                mstate.mem_extend(mstart, 1)
                mstate.memory[mstart] = global_state.new_bitvec(
                    "calldata_" + str(environment.active_account.contract_name)
                    + "[" + str(dstart) + ": + " + str(size) + "]",
                    8,
                )
                return [global_state]
            try:
                i_data = dstart
                new_memory = []
                for i in range(size):
                    # natural-number offsets: beyond 2^256 nothing aliases
                    # back into calldata (no 256-bit wraparound) — reads 0
                    if isinstance(i_data, int) and i_data >= 2 ** 256:
                        new_memory.append(symbol_factory.BitVecVal(0, 8))
                    else:
                        new_memory.append(environment.calldata[i_data])
                    i_data = (
                        i_data + 1
                        if isinstance(i_data, int)
                        else simplify(cast(BitVec, i_data) + 1)
                    )
                for i in range(len(new_memory)):
                    mstate.memory[i + mstart] = new_memory[i]
            except IndexError:
                log.debug("Exception copying calldata to memory")
                mstate.memory[mstart] = global_state.new_bitvec(
                    "calldata_" + str(environment.active_account.contract_name)
                    + "[" + str(dstart) + ": + " + str(size) + "]",
                    8,
                )
        return [global_state]

    @StateTransition()
    def calldatacopy_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        op0, op1, op2 = state.stack.pop(), state.stack.pop(), state.stack.pop()
        if isinstance(global_state.current_transaction, ContractCreationTransaction):
            log.debug("Attempt to use CALLDATACOPY in creation transaction")
            return [global_state]
        return self._calldata_copy_helper(global_state, state, op0, op1, op2)

    # -- environment ----------------------------------------------------------

    @StateTransition()
    def balance_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        address = state.stack.pop()
        if isinstance(address, BitVec) and address.value is not None and self.dynamic_loader:
            try:
                account = global_state.world_state.accounts_exist_or_load(
                    address.value, self.dynamic_loader
                )
                state.stack.append(account.balance())
                return [global_state]
            except (ValueError, AttributeError):
                pass
        # balances array handles both known and symbolic addresses
        state.stack.append(global_state.world_state.balances[_as_bitvec(address)])
        return [global_state]

    @StateTransition()
    def codesize_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        environment = global_state.environment
        disassembly = environment.code
        calldata = environment.calldata
        if isinstance(global_state.current_transaction, ContractCreationTransaction):
            # creation code followed by constructor arguments
            no_of_bytes = len(disassembly.bytecode) // 2
            if isinstance(calldata, ConcreteCalldata):
                no_of_bytes += calldata.size
            else:
                no_of_bytes += 0x200  # space for 16 32-byte arguments
                global_state.world_state.constraints.append(
                    environment.calldata.calldatasize == no_of_bytes
                )
        else:
            no_of_bytes = len(disassembly.bytecode) // 2
        state.stack.append(no_of_bytes)
        return [global_state]

    @staticmethod
    def _sha3_gas_helper(global_state, length):
        min_gas, max_gas = calculate_sha3_gas(length)
        global_state.mstate.min_gas_used += min_gas
        global_state.mstate.max_gas_used += max_gas
        StateTransition.check_gas_usage_limit(global_state)
        return global_state

    @StateTransition(enable_gas=False)
    def sha3_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        op0, op1 = state.stack.pop(), state.stack.pop()
        try:
            index, length = util.get_concrete_int(op0), util.get_concrete_int(op1)
        except TypeError:
            # symbolic memory offset
            if isinstance(op0, Expression):
                op0 = simplify(op0)
            state.stack.append(
                symbol_factory.BitVecSym("KECCAC_mem[{}]".format(hash(op0)), 256)
            )
            gas_tuple = get_opcode_gas("SHA3")
            state.min_gas_used += gas_tuple[0]
            state.max_gas_used += gas_tuple[1]
            return [global_state]

        Instruction._sha3_gas_helper(global_state, length)
        state.mem_extend(index, length)
        data_list = [
            b if isinstance(b, BitVec) else symbol_factory.BitVecVal(b, 8)
            for b in state.memory[index : index + length]
        ]
        if len(data_list) > 1:
            data = simplify(Concat(data_list))
        elif len(data_list) == 1:
            data = data_list[0]
        else:
            result = keccak_function_manager.get_empty_keccak_hash()
            state.stack.append(result)
            return [global_state]

        result, condition = keccak_function_manager.create_keccak(data)
        state.stack.append(result)
        global_state.world_state.constraints.append(condition)
        return [global_state]

    @staticmethod
    def _code_copy_helper(code, memory_offset, code_offset, size, op, global_state) -> List[GlobalState]:
        try:
            concrete_memory_offset = util.get_concrete_int(memory_offset)
        except TypeError:
            log.debug("Unsupported symbolic memory offset in %s", op)
            return [global_state]
        try:
            concrete_size = util.get_concrete_int(size)
            global_state.mstate.mem_extend(concrete_memory_offset, concrete_size)
        except TypeError:
            global_state.mstate.mem_extend(concrete_memory_offset, 1)
            global_state.mstate.memory[concrete_memory_offset] = global_state.new_bitvec(
                "code({})".format(global_state.environment.active_account.contract_name), 8
            )
            return [global_state]
        try:
            concrete_code_offset = util.get_concrete_int(code_offset)
        except TypeError:
            log.debug("Unsupported symbolic code offset in %s", op)
            global_state.mstate.mem_extend(concrete_memory_offset, concrete_size)
            for i in range(concrete_size):
                global_state.mstate.memory[concrete_memory_offset + i] = global_state.new_bitvec(
                    "code({})".format(global_state.environment.active_account.contract_name), 8
                )
            return [global_state]
        if code[0:2] == "0x":
            code = code[2:]
        for i in range(concrete_size):
            if 2 * (concrete_code_offset + i + 1) > len(code):
                break
            global_state.mstate.memory[concrete_memory_offset + i] = int(
                code[2 * (concrete_code_offset + i) : 2 * (concrete_code_offset + i + 1)], 16
            )
        return [global_state]

    @StateTransition()
    def codecopy_(self, global_state: GlobalState) -> List[GlobalState]:
        memory_offset, code_offset, size = (
            global_state.mstate.stack.pop(),
            global_state.mstate.stack.pop(),
            global_state.mstate.stack.pop(),
        )
        code = global_state.environment.code.bytecode
        if code[0:2] == "0x":
            code = code[2:]
        code_size = len(code) // 2
        if isinstance(global_state.current_transaction, ContractCreationTransaction):
            # creation code is followed by constructor arguments (modeled as
            # calldata); copies past the code end read from there
            mstate = global_state.mstate
            offset = code_offset - code_size
            if isinstance(global_state.environment.calldata, SymbolicCalldata):
                if code_offset >= code_size:
                    return self._calldata_copy_helper(
                        global_state, mstate, memory_offset, offset, size
                    )
            else:
                concrete_code_offset = util.get_concrete_int(code_offset)
                concrete_size = util.get_concrete_int(size)
                code_copy_offset = concrete_code_offset
                code_copy_size = (
                    concrete_size
                    if concrete_code_offset + concrete_size <= code_size
                    else code_size - concrete_code_offset
                )
                code_copy_size = code_copy_size if code_copy_size >= 0 else 0
                calldata_copy_offset = (
                    concrete_code_offset - code_size
                    if concrete_code_offset - code_size > 0
                    else 0
                )
                calldata_copy_size = concrete_code_offset + concrete_size - code_size
                calldata_copy_size = calldata_copy_size if calldata_copy_size >= 0 else 0
                [global_state] = self._code_copy_helper(
                    code=global_state.environment.code.bytecode,
                    memory_offset=memory_offset,
                    code_offset=code_copy_offset,
                    size=code_copy_size,
                    op="CODECOPY",
                    global_state=global_state,
                )
                return self._calldata_copy_helper(
                    global_state=global_state,
                    mstate=mstate,
                    mstart=memory_offset + code_copy_size,
                    dstart=calldata_copy_offset,
                    size=calldata_copy_size,
                )
        return self._code_copy_helper(
            code=global_state.environment.code.bytecode,
            memory_offset=memory_offset,
            code_offset=code_offset,
            size=size,
            op="CODECOPY",
            global_state=global_state,
        )

    @StateTransition()
    def extcodesize_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        addr = state.stack.pop()
        try:
            addr = hex(util.get_concrete_int(addr))
        except TypeError:
            log.debug("unsupported symbolic address for EXTCODESIZE")
            state.stack.append(global_state.new_bitvec("extcodesize_" + str(addr), 256))
            return [global_state]
        try:
            code = global_state.world_state.accounts_exist_or_load(
                addr, self.dynamic_loader
            ).code.bytecode
        except (ValueError, AttributeError) as e:
            log.debug("error accessing contract storage due to: %s", e)
            state.stack.append(global_state.new_bitvec("extcodesize_" + str(addr), 256))
            return [global_state]
        state.stack.append(len(code) // 2)
        return [global_state]

    @StateTransition()
    def extcodecopy_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        addr, memory_offset, code_offset, size = (
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
        )
        try:
            addr = hex(util.get_concrete_int(addr))
        except TypeError:
            log.debug("unsupported symbolic address for EXTCODECOPY")
            return [global_state]
        try:
            code = global_state.world_state.accounts_exist_or_load(
                addr, self.dynamic_loader
            ).code.bytecode
        except (ValueError, AttributeError) as e:
            log.debug("error accessing contract storage due to: %s", e)
            return [global_state]
        return self._code_copy_helper(
            code=code,
            memory_offset=memory_offset,
            code_offset=code_offset,
            size=size,
            op="EXTCODECOPY",
            global_state=global_state,
        )

    @StateTransition()
    def extcodehash_(self, global_state: GlobalState) -> List[GlobalState]:
        world_state = global_state.world_state
        stack = global_state.mstate.stack
        address = Extract(159, 0, stack.pop())
        if address.symbolic:
            code_hash = symbol_factory.BitVecVal(int(get_code_hash(""), 16), 256)
        elif address.value not in world_state.accounts:
            code_hash = symbol_factory.BitVecVal(0, 256)
        else:
            addr = "0" * (40 - len(hex(address.value)[2:])) + hex(address.value)[2:]
            code = world_state.accounts_exist_or_load(addr, self.dynamic_loader).code.bytecode
            code_hash = symbol_factory.BitVecVal(int(get_code_hash(code), 16), 256)
        stack.append(code_hash)
        return [global_state]

    @StateTransition()
    def returndatacopy_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        memory_offset, return_offset, size = (
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
        )
        try:
            concrete_memory_offset = util.get_concrete_int(memory_offset)
            concrete_return_offset = util.get_concrete_int(return_offset)
            concrete_size = util.get_concrete_int(size)
        except TypeError:
            log.debug("Unsupported symbolic argument in RETURNDATACOPY")
            return [global_state]
        if global_state.last_return_data is None:
            return [global_state]
        global_state.mstate.mem_extend(concrete_memory_offset, concrete_size)
        for i in range(concrete_size):
            global_state.mstate.memory[concrete_memory_offset + i] = (
                global_state.last_return_data[concrete_return_offset + i]
                if concrete_return_offset + i < len(global_state.last_return_data)
                else 0
            )
        return [global_state]

    @StateTransition()
    def returndatasize_(self, global_state: GlobalState) -> List[GlobalState]:
        if global_state.last_return_data is None:
            log.debug("No last_return_data found, adding an unconstrained bitvec")
            global_state.mstate.stack.append(global_state.new_bitvec("returndatasize", 256))
        else:
            global_state.mstate.stack.append(len(global_state.last_return_data))
        return [global_state]

    # -- block ----------------------------------------------------------------

    @StateTransition()
    def blockhash_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        blocknumber = state.stack.pop()
        state.stack.append(
            global_state.new_bitvec("blockhash_block_" + str(blocknumber), 256)
        )
        return [global_state]

    @StateTransition()
    def number_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.block_number)
        return [global_state]

# ---------------------------------------------------------------------------
# Table-generated opcode families. The simple two-operand words all share
# one shape — pop twice, combine, push — so the semantics live in a table
# and the handlers are stamped onto Instruction below (evaluate() finds
# them by the usual `<opcode>_` reflection).


def _stamp_binary(name: str, combine) -> None:
    @StateTransition()
    def handler(self, global_state: GlobalState) -> List[GlobalState]:
        mstate = global_state.mstate
        first = util.pop_bitvec(mstate)
        second = util.pop_bitvec(mstate)
        mstate.stack.append(combine(first, second))
        return [global_state]

    handler.__name__ = name
    setattr(Instruction, name, handler)


def _stamp_div_family(name: str, combine) -> None:
    """EVM division semantics: anything / 0 == 0 (unlike SMT-LIB)."""

    @StateTransition()
    def handler(self, global_state: GlobalState) -> List[GlobalState]:
        mstate = global_state.mstate
        numerator = util.pop_bitvec(mstate)
        denominator = util.pop_bitvec(mstate)
        zero = symbol_factory.BitVecVal(0, 256)
        if denominator.value == 0:
            result = zero
        elif denominator.symbolic:
            result = If(denominator == 0, zero, combine(numerator, denominator))
        else:
            result = combine(numerator, denominator)
        mstate.stack.append(result)
        return [global_state]

    handler.__name__ = name
    setattr(Instruction, name, handler)


# (stack top, second) -> pushed word
_BINARY_WORD_OPS = {
    "add_": lambda a, b: a + b,
    "sub_": lambda a, b: a - b,
    "mul_": lambda a, b: a * b,
    "and_": lambda a, b: a & b,
    "or_": lambda a, b: a | b,
    "xor_": lambda a, b: a ^ b,
    # shifts pop the AMOUNT first (EIP-145)
    "shl_": lambda shift, value: value << shift,
    "shr_": lambda shift, value: LShR(value, shift),
    "sar_": lambda shift, value: value >> shift,
    # comparisons push the raw Bool (consumers coerce as needed)
    "lt_": lambda a, b: ULT(a, b),
    "gt_": lambda a, b: UGT(a, b),
    "slt_": lambda a, b: a < b,
    "sgt_": lambda a, b: a > b,
    "eq_": lambda a, b: a == b,
}

_DIV_FAMILY_OPS = {
    "div_": lambda num, den: UDiv(num, den),
    "sdiv_": lambda num, den: num / den,
    "mod_": lambda num, den: URem(num, den),
    "smod_": lambda num, den: SRem(num, den),
}

for _name, _combine in _BINARY_WORD_OPS.items():
    _stamp_binary(_name, _combine)
for _name, _combine in _DIV_FAMILY_OPS.items():
    _stamp_div_family(_name, _combine)


def _stamp_nullary_push(name: str, produce) -> None:
    """Opcodes that just push one environment/machine value."""

    @StateTransition()
    def handler(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(produce(global_state))
        return [global_state]

    handler.__name__ = name
    setattr(Instruction, name, handler)


_NULLARY_PUSH_OPS = {
    "callvalue_": lambda gs: gs.environment.callvalue,
    "caller_": lambda gs: gs.environment.sender,
    "origin_": lambda gs: gs.environment.origin,
    "address_": lambda gs: gs.environment.address,
    "gasprice_": lambda gs: gs.environment.gasprice,
    "chainid_": lambda gs: gs.environment.chainid,
    "selfbalance_": lambda gs: gs.environment.active_account.balance(),
    "gaslimit_": lambda gs: gs.mstate.gas_limit,
    "msize_": lambda gs: gs.mstate.memory_size,
    # remaining gas is unknowable mid-path: fresh symbol per occurrence
    "gas_": lambda gs: gs.new_bitvec("gas", 256),
}

for _name, _produce in _NULLARY_PUSH_OPS.items():
    _stamp_nullary_push(_name, _produce)


def _stamp_block_context(name: str, symbol_name: str) -> None:
    """Block-context opcodes: symbolic by default, concrete when a
    concolic replay pinned the block environment
    (laser/evm/transaction/dispatch.py)."""

    @StateTransition()
    def handler(self, global_state: GlobalState) -> List[GlobalState]:
        pinned = global_state.environment.block_context.get(name[:-1])
        global_state.mstate.stack.append(
            pinned
            if pinned is not None
            else global_state.new_bitvec(symbol_name, 256)
        )
        return [global_state]

    handler.__name__ = name
    setattr(Instruction, name, handler)


for _name, _symbol in (
    ("coinbase_", "coinbase"),
    ("timestamp_", "timestamp"),
    ("difficulty_", "block_difficulty"),
    ("basefee_", "basefee"),
):
    _stamp_block_context(_name, _symbol)
