"""Port vs reference: batched Keccak-256 (mythril_tpu_torch/laser/cuda/keccak.py
against mythril_tpu/laser/tpu/keccak_tpu.py and the host keccak), bit for
bit on the CPU, on the padding edge lengths and all-empty batches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser.tpu.keccak_tpu import keccak256_batch as ref_keccak
from mythril_tpu.support.keccak import keccak256 as ref_host
from mythril_tpu_torch.laser.cuda import keccak as pk
from mythril_tpu_torch.support.keccak import keccak256 as port_host

LENGTHS = [0, 1, 31, 32, 135, 136, 137, 271, 272, 273, 543, 544]


def _data(n_rows, width, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n_rows, width), dtype=np.uint8)


@pytest.mark.parametrize("width", [544, 132])
def test_edge_lengths_match_reference_and_host(width):
    lens = [n for n in LENGTHS if n <= width]
    data = _data(len(lens), width)
    ref = np.asarray(ref_keccak(jnp.asarray(data), jnp.asarray(np.array(lens, np.int32))))
    port = pk.keccak256_batch(torch.as_tensor(data), torch.tensor(lens, dtype=torch.int32), device="cpu")
    assert np.array_equal(ref, port.numpy())
    for i, n in enumerate(lens):
        want = ref_host(bytes(data[i, :n]))
        assert bytes(port[i].numpy()) == want == port_host(bytes(data[i, :n]))


def test_all_lanes_empty_batch():
    data = np.zeros((16, 544), np.uint8)
    lens = np.zeros(16, np.int32)
    ref = np.asarray(ref_keccak(jnp.asarray(data), jnp.asarray(lens)))
    port = pk.keccak256_batch(torch.as_tensor(data), torch.as_tensor(lens), device="cpu")
    assert np.array_equal(ref, port.numpy())
    assert bytes(port[0].numpy()) == ref_host(b"")


def test_explicit_max_blocks_matches_reference():
    # more blocks than the lengths need: the extra blocks are not absorbed
    data = _data(3, 200, seed=3)
    lens = np.array([10, 199, 150], np.int32)
    ref = np.asarray(ref_keccak(jnp.asarray(data), jnp.asarray(lens), max_blocks=3))
    port = pk.keccak256_batch(torch.as_tensor(data), torch.as_tensor(lens), max_blocks=3, device="cpu")
    assert np.array_equal(ref, port.numpy())


def test_window_form_matches_flat_form():
    # the step's SHA3 path: a window of each lane's memory plane
    mem = torch.as_tensor(_data(6, 256, seed=5))
    off = torch.tensor([0, 10, 200, 224, 255, 0], dtype=torch.int32)
    avail = 256 - off
    length = torch.tensor([32, 64, 100, 32, 0, 256], dtype=torch.int32)
    got = pk.keccak256_window_plain(mem, off, avail, length)
    for r in range(6):
        o, n = int(off[r]), int(length[r])
        msg = bytes(mem[r, o : o + n].numpy()).ljust(n, b"\0")
        assert bytes(got[r].numpy()) == ref_host(msg)
