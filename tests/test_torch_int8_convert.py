"""K7's int8-to-float32 conversion (``ops/cuda_spmm_int8.py``), on the CPU.

K7 turns each int8 byte q of its table into float32 without the
int-to-float conversion instruction: one XOR of a 4-byte word flips each
byte's sign bit (q + 128), ``__byte_perm(u, 0x4B000000, 0x7650 | i)`` puts
byte i under the exponent of 2**23 (the float 2**23 + q + 128), and an
add of -(2**23 + 128) leaves q exactly. Here:

- ``int8_to_float``, the plain version's steps in torch integer ops, equals
  ``q.float()`` and the JAX package's ``astype(float32)`` on all 256 byte
  values;
- the kernel's word-level steps, with ``__byte_perm`` written out from its
  definition in the CUDA math API (byte n of the result is byte s<4n+2:4n>
  of the 8 bytes y:x), equal the sign-extended bytes on random words;
- ``spmm_int8_plain`` gives the same bits with this conversion as with
  ``q.float()``, in both scale modes, on a graph of split and unsplit rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu_torch.ops import cuda_spmm_int8
from maxk_tpu_torch.ops.cuda_spmm_int8 import int8_to_float, spmm_int8_plain
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR


def byte_perm(x: np.ndarray, y: int, s: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, s) on uint32 words: the input bytes are
    x's four (0-3) then y's (4-7); byte n of the result is input byte
    s<4n+2:4n>."""
    y_bytes = [(y >> (8 * b)) & 0xFF for b in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        byte = ((x >> np.uint32(8 * sel)) & np.uint32(0xFF) if sel < 4
                else np.full_like(x, y_bytes[sel - 4]))
        out |= byte.astype(np.uint32) << np.uint32(8 * n)
    return out


def test_all_byte_values():
    q = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    got = int8_to_float(q)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), q.float().view(torch.int32))
    jax_ref = np.asarray(jnp.asarray(q.numpy()).astype(jnp.float32))
    assert np.array_equal(got.numpy().view(np.int32), jax_ref.view(np.int32))


def test_kernel_word_steps_on_random_words():
    rng = np.random.default_rng(15)
    r = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    u = r ^ np.uint32(0x80808080)
    signed = r.view(np.int8).reshape(-1, 4)   # little-endian bytes 0..3
    for i in range(4):
        bits = byte_perm(u, 0x4B000000, 0x7650 | i)
        value = bits.view(np.float32) - np.float32(8388736.0)
        assert value.dtype == np.float32
        assert np.array_equal(value, signed[:, i].astype(np.float32))
    words = torch.from_numpy(r.view(np.int8).copy())
    assert torch.equal(int8_to_float(words),
                       torch.from_numpy(signed.reshape(-1).astype(np.float32)))


@pytest.mark.parametrize("row_scale", [False, True])
def test_spmm_int8_plain_bits_unchanged(monkeypatch, row_scale):
    rng = np.random.default_rng(7)
    n, e, d = 96, 900, 12
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    src[:120] = 5   # one row of 120 edges: 15 segments of 8
    csr = CSRGraph.from_coo(src, dst, n, values=rng.uniform(
        -1, 1, size=e).astype(np.float32))
    g = DeviceCSR.from_csr(csr, "cpu", seg_len=8)
    q = torch.from_numpy(rng.integers(-128, 128, size=(n, d)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(
        0.01, 1, size=n if row_scale else d).astype(np.float32))
    after = spmm_int8_plain(g, q, scale, row_scale)
    monkeypatch.setattr(cuda_spmm_int8, "int8_to_float", lambda t: t.float())
    before = spmm_int8_plain(g, q, scale, row_scale)
    assert g.plan.n_partials > 0
    assert torch.equal(after.view(torch.int32), before.view(torch.int32))
