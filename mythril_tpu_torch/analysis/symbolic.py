"""Engine assembly for an analysis run.

Parity surface: mythril/analysis/symbolic.py (SymExecWrapper). One object
wires everything a run needs: strategy selection (including the tpu-batch
device backend), the ACTORS world, pruning/coverage plugins, detection
module hooks — then executes and post-parses CALL-family operations from
the statespace for POST-style modules."""

import logging
from typing import List, Optional, Type, Union

from mythril_tpu_torch.analysis.module import (
    EntryPoint,
    ModuleLoader,
    get_detection_module_hooks,
)
from mythril_tpu_torch.analysis.ops import Call, VarType, get_variable
from mythril_tpu_torch.laser.evm import svm
from mythril_tpu_torch.laser.evm.iprof import InstructionProfiler
from mythril_tpu_torch.laser.evm.natives import PRECOMPILE_COUNT
from mythril_tpu_torch.laser.evm.plugins.plugin_factory import PluginFactory
from mythril_tpu_torch.laser.evm.plugins.plugin_loader import LaserPluginLoader
from mythril_tpu_torch.laser.evm.state.account import Account
from mythril_tpu_torch.laser.evm.state.world_state import WorldState
from mythril_tpu_torch.laser.evm.strategy.basic import (
    BasicSearchStrategy,
    BreadthFirstSearchStrategy,
    DepthFirstSearchStrategy,
    ReturnRandomNaivelyStrategy,
    ReturnWeightedRandomStrategy,
    StaticDistanceWeightedStrategy,
)
from mythril_tpu_torch.laser.evm.strategy.extensions.bounded_loops import (
    BoundedLoopsStrategy,
)
from mythril_tpu_torch.laser.evm.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import BitVec, symbol_factory

log = logging.getLogger(__name__)

CALL_FAMILY = ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL")


def _pick_strategy(name: str) -> Type[BasicSearchStrategy]:
    if name == "dfs":
        return DepthFirstSearchStrategy
    if name == "bfs":
        return BreadthFirstSearchStrategy
    if name == "naive-random":
        return ReturnRandomNaivelyStrategy
    if name == "weighted-random":
        return ReturnWeightedRandomStrategy
    if name == "static-weighted":
        # biases selection toward states statically close to SSTORE /
        # CALL-family / SELFDESTRUCT sites (analysis/static_pass/)
        return StaticDistanceWeightedStrategy
    if name == "cuda-batch":
        # the hybrid host/device backend (laser/cuda/backend.py):
        # LaserEVM.exec delegates message-call rounds to the batched
        # device engine behind this strategy marker
        from mythril_tpu_torch.laser.cuda.backend import CudaBatchStrategy

        return CudaBatchStrategy
    raise ValueError("Invalid strategy argument supplied")


def _as_address(address: Union[int, str, BitVec]) -> BitVec:
    if isinstance(address, str):
        return symbol_factory.BitVecVal(int(address, 16), 256)
    if isinstance(address, int):
        return symbol_factory.BitVecVal(address, 256)
    return address


class SymExecWrapper:
    """Runs symbolic execution and pre-parses calls for POST modules."""

    def __init__(
        self,
        contract,
        address: Union[int, str, BitVec],
        strategy: str,
        dynloader=None,
        max_depth: int = 22,
        execution_timeout: Optional[int] = None,
        loop_bound: int = 3,
        create_timeout: Optional[int] = None,
        transaction_count: int = 2,
        modules: Optional[List[str]] = None,
        compulsory_statespace: bool = True,
        iprof: Optional[InstructionProfiler] = None,
        disable_dependency_pruning: bool = False,
        run_analysis_modules: bool = True,
        enable_coverage_strategy: bool = False,
        custom_modules_directory: str = "",
        checkpoint_dir: Optional[str] = None,
        pre_exec_hook=None,
        fresh_solver_core: bool = True,
        resume_from=None,
    ):
        # every analysis starts from a fresh incremental solver core:
        # clause-database growth from prior contracts/runs in the same
        # process would slow budgeted feasibility checks unpredictably
        # (order-dependent false negatives otherwise). The multi-tenant
        # analysis service opts OUT (fresh_solver_core=False): resetting
        # here would drop the learned clauses of every other job in
        # flight, and the service bounds core growth itself.
        if fresh_solver_core:
            from mythril_tpu_torch.smt.solver.incremental import reset_core

            reset_core()

        address = _as_address(address)
        requires_statespace = (
            compulsory_statespace
            or len(ModuleLoader().get_detection_modules(EntryPoint.POST, modules)) > 0
        )

        # the fixed-actor accounts every analysis world starts from
        attacker = Account(
            hex(ACTORS.attacker.value), "", dynamic_loader=None, contract_name=None
        )
        self.accounts = {hex(ACTORS.attacker.value): attacker}
        if contract.creation_code:
            creator = Account(
                hex(ACTORS.creator.value), "", dynamic_loader=None, contract_name=None
            )
            self.accounts[hex(ACTORS.creator.value)] = creator

        coverage_plugin = PluginFactory.build_instruction_coverage_plugin()

        self.laser = svm.LaserEVM(
            dynamic_loader=dynloader,
            max_depth=max_depth,
            execution_timeout=execution_timeout,
            strategy=_pick_strategy(strategy),
            create_timeout=create_timeout,
            transaction_count=transaction_count,
            requires_statespace=requires_statespace,
            iprof=iprof,
            enable_coverage_strategy=enable_coverage_strategy,
            instruction_laser_plugin=coverage_plugin,
        )
        if loop_bound is not None:
            self.laser.extend_strategy(BoundedLoopsStrategy, loop_bound)

        plugin_loader = LaserPluginLoader(self.laser)
        plugin_loader.load(PluginFactory.build_mutation_pruner_plugin())
        plugin_loader.load(coverage_plugin)
        # The dependency pruner's hooks are batch-aware (tape_replay_safe):
        # under tpu-batch its SLOAD/SSTORE records replay from the tape and
        # event ring, block entries from the jumpdest ring, and its prune
        # decision applies at lift (PluginSkipState drops the lane).
        if not disable_dependency_pruning:
            plugin_loader.load(PluginFactory.build_dependency_pruner_plugin())
        if checkpoint_dir:
            from mythril_tpu_torch.support.checkpoint import CheckpointPlugin

            plugin_loader.load(CheckpointPlugin(checkpoint_dir))

        if run_analysis_modules:
            detectors = ModuleLoader().get_detection_modules(
                EntryPoint.CALLBACK, modules
            )
            for hook_type in ("pre", "post"):
                self.laser.register_hooks(
                    hook_type=hook_type,
                    hook_dict=get_detection_module_hooks(detectors, hook_type),
                )

        world_state = WorldState()
        for account in self.accounts.values():
            world_state.put_account(account)

        # measurement/instrumentation seam: called with the fully
        # configured LaserEVM (plugins + detection hooks loaded) right
        # before execution, e.g. to install a SteadyStateMeter
        if pre_exec_hook is not None:
            pre_exec_hook(self.laser)
        # ``resume_from`` (a robustness.checkpoint.FrontierCheckpoint)
        # replaces the creation transaction and the already-completed
        # message-call rounds with the journaled frontier
        self._resume_from = resume_from
        self._execute(contract, address, world_state, dynloader)

        if requires_statespace:
            self.nodes = self.laser.nodes
            self.edges = self.laser.edges
            self.calls = self._collect_calls()

    # -- execution ------------------------------------------------------------

    def _execute(self, contract, address, world_state, dynloader) -> None:
        ckpt = self._resume_from
        if ckpt is not None:
            self.laser.sym_exec_resume(
                ckpt.restore(),
                ckpt.address,
                rounds_done=ckpt.rounds_done,
            )
            return
        if getattr(contract, "creation_code", None):
            self.laser.sym_exec(
                creation_code=contract.creation_code,
                contract_name=contract.name,
                world_state=world_state,
            )
            return
        target = Account(
            address,
            contract.disassembly,
            dynamic_loader=dynloader,
            contract_name=contract.name,
            balances=world_state.balances,
            concrete_storage=bool(dynloader is not None and dynloader.active),
        )
        if dynloader is not None and address.value is not None:
            try:
                target.set_balance(
                    dynloader.read_balance("{0:#0{1}x}".format(address.value, 42))
                )
            except Exception as e:
                log.debug("balance fetch failed (%s); stays symbolic", e)
        world_state.put_account(target)
        self.laser.sym_exec(world_state=world_state, target_address=address.value)

    # -- statespace post-pass ---------------------------------------------------

    def _collect_calls(self) -> List[Call]:
        """Extract every CALL-family operation from the explored statespace
        (the input POST modules scan)."""
        calls: List[Call] = []
        for node in self.nodes.values():
            for state_index, state in enumerate(node.states):
                opcode = state.get_current_instruction()["opcode"]
                if opcode not in CALL_FAMILY:
                    continue
                call = self._parse_call(node, state, state_index, opcode)
                if call is not None:
                    calls.append(call)
        return calls

    @staticmethod
    def _parse_call(node, state, state_index, opcode) -> Optional[Call]:
        stack = state.mstate.stack
        if opcode in ("DELEGATECALL", "STATICCALL"):
            gas, to = get_variable(stack[-1]), get_variable(stack[-2])
            return Call(node, state, state_index, opcode, to, gas)

        gas = get_variable(stack[-1])
        to = get_variable(stack[-2])
        value = get_variable(stack[-3])
        data_start = get_variable(stack[-4])
        data_size = get_variable(stack[-5])
        if to.type == VarType.CONCRETE and 0 < to.val <= PRECOMPILE_COUNT:
            return None  # precompile targets aren't interesting calls
        if data_start.type == VarType.CONCRETE and data_size.type == VarType.CONCRETE:
            payload = state.mstate.memory[
                data_start.val : data_start.val + data_size.val
            ]
            return Call(node, state, state_index, opcode, to, gas, value, payload)
        return Call(node, state, state_index, opcode, to, gas, value)
