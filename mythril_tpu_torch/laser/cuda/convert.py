"""Carry reference planes across: numpy dicts <-> the port's tensors.

The state planes play the part of a model's weights here: the JAX
package and the port must agree on them byte for byte. This module turns
numpy dicts of the reference's planes (``StateBatch``, ``CodeBank``,
``InloopPool``; ``Env`` is empty) into the port's tensors and back.

Representation of u32 planes: ``torch.int32`` tensors holding the same
32 bits (``np.uint32`` is viewed, never converted), because torch's CPU
``uint32`` has no add, shift, compare or ``index_put``. Every other
dtype maps to its torch namesake (bool, uint8, int8, int32), so the
bytes of every plane are identical to the reference's.
"""

import numpy as np
import torch

_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.int32,
}

CODE_BANK_DTYPES = {
    "code": np.uint8,
    "code_len": np.int32,
    "jumpdest": np.bool_,
    "push_imm": np.uint32,
    "host_ops": np.bool_,
    "freeze_errors": np.bool_,
    "record_storage_events": np.bool_,
    "must_revert": np.bool_,
    "prune_revert": np.bool_,
    "swc_mask": np.uint8,
    "jumpi_verdict": np.int8,
}

POOL_DTYPES = {
    "var_h1": np.uint32,
    "var_h2": np.uint32,
    "lit_var": np.int32,
    "lit_neg": np.bool_,
    "lit_used": np.bool_,
}


def torch_dtype(np_dtype) -> torch.dtype:
    return _TORCH[np.dtype(np_dtype)]


def to_tensor(x, np_dtype, device) -> torch.Tensor:
    """numpy array -> tensor with the same bytes (u32 viewed as int32)."""
    a = np.array(x, dtype=np_dtype, order="C")  # a copy; keeps 0-d scalars 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor, np_dtype) -> np.ndarray:
    """tensor -> numpy array in the reference's dtype (same bytes)."""
    a = t.detach().cpu().numpy()
    if np.dtype(np_dtype) == np.uint32:
        return a.view(np.uint32)
    return a.astype(np_dtype, copy=False)


def _batch_dtypes(planes: dict) -> dict:
    from mythril_tpu_torch.laser.cuda.batch import BatchConfig, batch_shapes

    # dtypes do not depend on the sizes
    return {k: dt for k, (_shape, dt) in batch_shapes(BatchConfig()).items() if k in planes}


def batch_to_torch(planes: dict, device):
    from mythril_tpu_torch.laser.cuda.batch import StateBatch

    dts = _batch_dtypes(planes)
    return StateBatch(**{k: to_tensor(planes[k], dts[k], device) for k in StateBatch._fields})


def batch_to_numpy(st) -> dict:
    dts = _batch_dtypes(st._asdict())
    return {k: to_numpy(v, dts[k]) for k, v in st._asdict().items()}


def code_bank_to_torch(planes: dict, device):
    from mythril_tpu_torch.laser.cuda.batch import CodeBank

    return CodeBank(**{k: to_tensor(planes[k], CODE_BANK_DTYPES[k], device) for k in CodeBank._fields})


def code_bank_to_numpy(cb) -> dict:
    return {k: to_numpy(v, CODE_BANK_DTYPES[k]) for k, v in cb._asdict().items()}


def pool_to_torch(planes: dict, device):
    from mythril_tpu_torch.laser.cuda.inloop_solve import InloopPool

    return InloopPool(**{k: to_tensor(planes[k], POOL_DTYPES[k], device) for k in InloopPool._fields})


def pool_to_numpy(pool) -> dict:
    return {k: to_numpy(v, POOL_DTYPES[k]) for k, v in pool._asdict().items()}
