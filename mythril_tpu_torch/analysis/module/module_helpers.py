"""Helpers for detection modules (reference surface:
mythril/analysis/module/module_helpers.py)."""

import traceback
from contextlib import contextmanager
from typing import Optional

_forced_prehook: Optional[bool] = None


@contextmanager
def forced_hook_phase(prehook: bool):
    """Override what :func:`is_prehook` reports inside the block.

    The stack inspection below only recognizes the host engine's hook
    dispatcher frames; callers that replay hooks outside the engine (the
    device bridge's tape replay) declare the phase explicitly."""
    global _forced_prehook
    saved = _forced_prehook
    _forced_prehook = prehook
    try:
        yield
    finally:
        _forced_prehook = saved


def is_prehook() -> bool:
    """Whether the current callback was invoked from a pre-hook (inspects the
    call stack for the engine's hook dispatcher)."""
    if _forced_prehook is not None:
        return _forced_prehook
    stack = traceback.format_stack()[-8:]
    for frame in reversed(stack):
        if "_execute_pre_hook" in frame:
            return True
        if "_execute_post_hook" in frame:
            return False
    return False
