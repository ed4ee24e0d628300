"""SWC-110: user-defined assertion failures (AssertionFailed events).

Parity surface: mythril/analysis/module/modules/user_assertions.py — a
LOG1 whose topic is the AssertionFailed(string) hash is a reachable
user assertion; the ABI-encoded message is decoded when concrete."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.laser.evm import util

ASSERTION_FAILED_TOPIC = (
    0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0
)


def decode_event_string(memory, start: int, size: int):
    """ABI string payload from a LOG1 memory range; None if symbolic."""
    try:
        length = util.get_concrete_int(memory.get_word_at(start + 32))
        # the event size operand bounds the payload; never trust the
        # in-memory length word alone (attacker-chosen, can be astronomical)
        length = min(length, max(size - 64, 0))
        raw = memory[start + 64 : start + 64 + length]
        return bytes(util.get_concrete_int(b) for b in raw).decode(
            "utf8", errors="replace"
        )
    except (TypeError, IndexError):
        return None


class UserAssertions(ProbeModule):
    name = "A user-defined assertion has been triggered"
    swc_id = ASSERT_VIOLATION
    description = "Search for reachable user-supplied exceptions (AssertionFailed events)."
    pre_hooks = ["LOG1"]

    deferred = True
    title = "Assertion Failed"
    severity = "Medium"
    description_head = "A user-provided assertion failed."

    def probe(self, state):
        mem_start, size, topic = (
            state.mstate.stack[-1],
            state.mstate.stack[-2],
            state.mstate.stack[-3],
        )
        if topic.symbolic or topic.value != ASSERTION_FAILED_TOPIC:
            return
        message = None
        if not mem_start.symbolic and not size.symbolic:
            message = decode_event_string(
                state.mstate.memory, mem_start.value, size.value
            )
        tail = (
            "A user-provided assertion failed with the message '{}'".format(message)
            if message
            else "A user-provided assertion failed."
        )
        yield Finding(description_tail=tail)


detector = UserAssertions()
