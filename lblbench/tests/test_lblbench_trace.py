"""The trace's reduction on a made-up timeline."""
from types import SimpleNamespace

import pytest
import torch

from lblbench.harness import trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def event(name, start, end, device=CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def test_reduction():
    prof = SimpleNamespace(events=lambda: [
        event(trace.CALL, 0, 100, annotation=True),
        event(trace.CALL, 0, 100, CUDA, annotation=True),
        event("aten::add", 10, 20),
        event("void lorentz_walk_kernel<4, 0>()", 5, 25, CUDA),
        event("elementwise_kernel", 20, 40, CUDA),
        event("Memcpy DtoH (Device -> Pageable)", 60, 90, CUDA),
        event(trace.CALL, 100, 200, annotation=True),
        event("void lorentz_walk_kernel<4, 0>()", 110, 130, CUDA),
        event("cudaStreamSynchronize", 150, 199),
    ])
    t = trace.from_profile(prof, 2)
    assert t.window == (0, 200)
    assert t.busy_s == pytest.approx((35 + 30 + 20) / 1e6)
    assert t.kernel_s(lambda n: "lorentz_walk_kernel" in n) \
        == pytest.approx(40e-6)
    assert t.copy_s("DtoH") == pytest.approx(30e-6)
    assert t.device_ops()[0] == ["void lorentz_walk_kernel<4, 0>()",
                                 pytest.approx(40e-6)]
    gaps = dict(t.idle_gaps())
    # Gaps: 0-5, 40-60 and 90-110 in the calls' Python, 130-200 in the
    # synchronize (open at its middle, 165).
    assert gaps["cudaStreamSynchronize"] == pytest.approx(70e-6)
    assert gaps["host Python inside the call (no torch op open)"] \
        == pytest.approx(45e-6)
    assert sum(gaps.values()) == pytest.approx((200 - 85) / 1e6)
