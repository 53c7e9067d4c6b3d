"""The wide top-k kernel's plan (``ops/cuda_topk.py::wide_plan``), on the
CPU: which rows csrc/topk_wide.cu holds in shared memory, with how many
bytes, and which it loads with 16-byte vectors; and what the wrapper
passes the kernel. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu_torch.ops import cuda_topk
from maxk_tpu_torch.ops.cuda_topk import MAX_D, WIDE_SMEM_CAP, wide_plan

CAP_D = WIDE_SMEM_CAP // 4
# A block's shared memory on the H100, with the opt-in.
H100_SMEM_PER_BLOCK = 232_448


def test_cap_is_48_kb_of_keys():
    assert (WIDE_SMEM_CAP, CAP_D) == (48 * 1024, 12288)


@pytest.mark.parametrize("d", [MAX_D + 1, 1100, 2048, 4096, 8192,
                               CAP_D - 1, CAP_D])
def test_row_sits_in_shared_memory_up_to_the_cap(d):
    plan = wide_plan(d)
    assert plan.in_smem
    # The keys, zero-padded to whole 16-byte quads, and no more.
    assert 4 * d <= plan.smem_bytes == 16 * -(-d // 4) <= WIDE_SMEM_CAP
    assert plan.smem_bytes % 16 == 0


@pytest.mark.parametrize("d", [CAP_D + 1, CAP_D + 4, 20000, 1 << 20])
def test_row_past_the_cap_is_streamed(d):
    plan = wide_plan(d)
    assert not plan.in_smem and plan.smem_bytes == 0


def test_shared_bytes_never_exceed_a_block():
    for d in range(MAX_D + 1, CAP_D + 64):
        plan = wide_plan(d)
        assert plan.smem_bytes <= H100_SMEM_PER_BLOCK
        assert plan.in_smem == (d <= CAP_D)


@pytest.mark.parametrize("d,aligned", [(1025, False), (1100, True),
                                       (1026, False), (2048, True),
                                       (CAP_D + 1, False), (20000, True)])
def test_alignment(d, aligned):
    assert wide_plan(d).aligned is aligned


@pytest.mark.parametrize("d,offset,vec", [(2048, 0, 1), (2048, 1, 0),
                                          (2048, 4, 1), (1025, 0, 0),
                                          (CAP_D + 4, 0, 1)])
def test_wrapper_passes_the_plan(monkeypatch, d, offset, vec):
    """The wrapper asks for the 16-byte path only when D % 4 == 0 and x
    starts on a 16-byte boundary (x here starts `offset` floats into its
    storage), passes the plan's shared bytes, and counts the launch, and
    a streamed one apart."""
    plans = []
    monkeypatch.setattr(cuda_topk, "_launch",
                        lambda lib, entry, x, k, a, b, *plan:
                        plans.append(plan) or True)
    x = torch.zeros(offset + 4 * d)[offset:].view(4, d)
    op = SimpleNamespace(launches=0, streamed=0)
    cuda_topk._launch_wide(op, "maxk_wide_f32", x, 1, *cuda_topk._maxk_out(x))
    plan = wide_plan(d)
    assert plans == [(vec, plan.smem_bytes)]
    assert (op.launches, op.streamed) == (1, int(not plan.in_smem))
    assert plan.threads == 128
