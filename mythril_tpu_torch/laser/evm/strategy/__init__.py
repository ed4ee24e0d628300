"""Search strategies over the work list (reference surface:
mythril/laser/ethereum/strategy/__init__.py). A strategy is an iterator that
yields the next GlobalState to execute; the max-depth filter lives in
__next__.

In the TPU batched engine the same interface is reused, but the strategy's
role becomes lane *selection*: the batch scheduler asks the strategy for up
to `batch_size` states at once (get_strategic_batch) and executes them as one
vectorized step."""

from abc import ABC, abstractmethod
from typing import List

from mythril_tpu_torch.laser.evm.state.global_state import GlobalState


class BasicSearchStrategy(ABC):
    def __init__(self, work_list, max_depth):
        self.work_list: List[GlobalState] = work_list
        self.max_depth = max_depth

    def __iter__(self):
        return self

    @abstractmethod
    def get_strategic_global_state(self) -> GlobalState:
        raise NotImplementedError("Must be implemented by a subclass")

    def get_strategic_batch(self, batch_size: int) -> List[GlobalState]:
        """Up to batch_size states for one vectorized step (TPU engine)."""
        batch = []
        while len(batch) < batch_size:
            try:
                batch.append(next(self))
            except StopIteration:
                break
        return batch

    def __next__(self) -> GlobalState:
        try:
            global_state = self.get_strategic_global_state()
            if global_state.mstate.depth >= self.max_depth:
                return self.__next__()
            return global_state
        except IndexError:
            raise StopIteration
