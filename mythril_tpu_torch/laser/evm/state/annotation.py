"""State / expression annotations.

Parity surface: mythril/laser/ethereum/state/annotation.py — annotations
ride along with states and expressions; plugins and detection modules use
them as taint tags and path-scoped scratch space. Three orthogonal
behaviors are expressed as overridable properties: whether an annotation
survives into the world state (and thus later transactions), whether it
crosses inter-contract call boundaries, and whether forking copies it."""


class StateAnnotation:
    """Attachable to a GlobalState; copied on fork by default."""

    @property
    def persist_to_world_state(self) -> bool:
        """Propagate to the world state and all following transactions."""
        return False

    @property
    def persist_over_calls(self) -> bool:
        """Propagate into the global states of inter-contract calls."""
        return False

    @property
    def pack_to_device(self) -> bool:
        """Whether a state carrying this annotation may enter the batched
        device pipeline. Annotations that need per-instruction host hooks
        to stay exact (e.g. an open reentrancy window observing every
        state access) return False; the bridge then keeps the state on
        the host path, where hooks fire with full fidelity."""
        return True


class NoCopyAnnotation(StateAnnotation):
    """Shared (never copied) across forks — for expensive immutable
    payloads."""

    def __copy__(self):
        return self

    def __deepcopy__(self, _):
        return self
