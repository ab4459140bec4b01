"""The port's recovery from a really killed render-client process, on the
CPU: the counterpart of tests/test_recovery_child.py.

tools/loop_recovery_smoke.run_smoke serves frozen frames from a child
process, SIGKILLs it mid-stream, and the loop's recover hook must start a
fresh child whose frames equal the healthy pass's bit for bit. On a card
the same harness is how a sticky CUDA error (a poisoned context) is healed:
by a new process (chip_smoke.py phase 7c runs it on cuda:0).
"""

import pytest
import torch

from distributed_raytracer_tpu_torch.tools.loop_recovery_smoke import (
    ChildRenderer, run_smoke)


def test_child_kill_recovery_cpu():
    ok, detail = run_smoke(w=64, h=48, n_ticks=16, kill_at=4, device="cpu",
                           log=lambda *a: None)
    assert ok, detail


def test_cuda_child_without_a_card_raises():
    """A child asked for a card it does not have fails to start, with its
    stderr in the error: it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the child would start")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ChildRenderer(64, 48, "cuda:0")
