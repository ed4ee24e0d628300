"""SWC-124: write to a caller-controlled storage slot.

Parity surface: mythril/analysis/module/modules/arbitrary_write.py — at
every SSTORE, defer a potential issue constrained so the written slot
equals an arbitrary sentinel value; promotion at transaction end proves
the slot is truly caller-controlled."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import WRITE_TO_ARBITRARY_STORAGE
from mythril_tpu_torch.smt import symbol_factory

# any value a compiler-derived slot layout would never produce by itself
SLOT_SENTINEL = 324345425435


class ArbitraryStorage(ProbeModule):
    name = "Caller can write to arbitrary storage locations"
    swc_id = WRITE_TO_ARBITRARY_STORAGE
    description = "Search for any writes to an arbitrary storage slot"
    pre_hooks = ["SSTORE"]
    # the probe only reads the written slot; the bridge re-fires it per
    # recorded device SSTORE event with the lifted key term
    tape_replay_hooks = frozenset({"SSTORE"})

    deferred = True
    title = "The caller can write to arbitrary storage locations."
    severity = "High"
    description_head = "Any storage slot can be written by the caller."
    description_tail = (
        "It is possible to write to arbitrary storage locations. By modifying the values of "
        "storage variables, attackers may bypass security controls or manipulate the business logic of "
        "the smart contract."
    )

    def probe(self, state):
        slot = state.mstate.stack[-1]
        yield Finding(
            constraints=[slot == symbol_factory.BitVecVal(SLOT_SENTINEL, 256)]
        )


detector = ArbitraryStorage()
