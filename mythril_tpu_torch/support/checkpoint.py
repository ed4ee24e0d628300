"""Open-state checkpointing between transaction rounds.

SURVEY §5: the reference has no checkpoint/resume; its natural
serialization boundary is the open_states handoff between message-call
rounds (mythril/laser/ethereum/svm.py:79). Here that boundary is explicit:
the whole open-state set (world states with their accounts, storage
terms, path conditions and annotations) pickles through the term DAG's
re-interning __reduce__, so an interrupted multi-transaction analysis can
resume on another process — or another host — from the last round.

Automatic use: CheckpointPlugin writes <dir>/round_<n>.ckpt after every
transaction round when loaded (wired to --checkpoint-dir in the CLI).
"""

import logging
import os
import pickle
from typing import List

from mythril_tpu_torch.laser.evm.plugins.plugin import LaserPlugin
from mythril_tpu_torch.laser.evm.state.world_state import WorldState

log = logging.getLogger(__name__)

FORMAT_VERSION = 1


def save_checkpoint(path: str, open_states: List[WorldState], round_index: int = 0) -> None:
    """Serialize an open-state set (atomic rename)."""
    payload = {
        "version": FORMAT_VERSION,
        "round": round_index,
        "open_states": open_states,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """-> (open_states, round_index)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("version") != FORMAT_VERSION:
        raise ValueError(
            "checkpoint version %r not supported" % payload.get("version")
        )
    return payload["open_states"], payload["round"]


def resume_analysis(laser, path: str) -> int:
    """Install a checkpoint into a LaserEVM and return the next round
    index; drive remaining rounds with laser._execute_transactions."""
    open_states, round_index = load_checkpoint(path)
    laser.open_states = open_states
    return round_index + 1


class CheckpointPlugin(LaserPlugin):
    """Writes the open-state set after every transaction round."""

    def __init__(self, directory: str):
        self.directory = directory
        self.round_index = 0

    def initialize(self, symbolic_vm):
        os.makedirs(self.directory, exist_ok=True)

        @symbolic_vm.laser_hook("stop_sym_trans")
        def checkpoint_hook():
            path = os.path.join(
                self.directory, "round_{:03d}.ckpt".format(self.round_index)
            )
            try:
                save_checkpoint(path, symbolic_vm.open_states, self.round_index)
                log.info("checkpointed %d open states to %s",
                         len(symbolic_vm.open_states), path)
            except Exception as e:
                log.warning("checkpoint failed: %s", e)
            self.round_index += 1
