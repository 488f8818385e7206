"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and skips with a reason where
``torch.cuda.is_available()`` is false (CUDA kernels have no CPU mode).
The file imports only ``torch`` and the port, so it also runs on a machine
without JAX; there, skip the JAX test harness's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances: the kernels sum in another order than the plain versions'
library products (and the apply's KL partials with float atomics), so
products are held to ``|got − want| ≤ rtol·max|want|`` — 1e-5 for the
covariances (sums of up to ~10⁵ rows), 1e-4 for the apply, whose damped
divide amplifies rounding by up to 1/λ. The SGD kernel rounds each product
and sum separately, as the plain version does: 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch.ops import apply_kernels as tapply
from kfac_pytorch_tpu_torch.ops import factor_kernels as tfk


@pytest.fixture
def cuda_device():
    """The first GPU, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close_scaled(got, want, rtol):
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    bound = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _orth(r, n):
    q, _ = np.linalg.qr(r.randn(n, n))
    return q.astype(np.float32)


# (NCHW shape, kernel, strides, padding, bias): small edge cases and the
# ResNet-32 batch-128 geometries of each stage
CONV_CASES = [
    ((3, 4, 8, 8), (1, 1), (1, 1), "VALID", False),
    ((3, 4, 9, 9), (3, 3), (2, 2), ((1, 1), (1, 1)), True),
    ((2, 5, 8, 8), (3, 3), (1, 1), ((1, 2), (0, 1)), True),
    ((128, 3, 32, 32), (3, 3), (1, 1), ((1, 1), (1, 1)), False),
    ((128, 16, 32, 32), (3, 3), (1, 1), ((1, 1), (1, 1)), False),
    ((128, 16, 32, 32), (3, 3), (2, 2), ((1, 1), (1, 1)), False),
    ((128, 64, 8, 8), (3, 3), (1, 1), ((1, 1), (1, 1)), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ks,st,pad,bias", CONV_CASES)
def test_conv_a_kernel_matches_plain(cuda_device, shape, ks, st, pad, bias):
    x = torch.from_numpy(np.random.RandomState(40).randn(*shape).astype(np.float32))
    x = x.to(cuda_device)
    before = tfk.compute_a_conv_fused.launches
    got = tfk.compute_a_conv_fused(x, ks, st, pad, bias)
    torch.cuda.synchronize()
    assert tfk.compute_a_conv_fused.launches == before + 1
    want = tfk.compute_a_conv_fused_plain(x, ks, st, pad, bias)
    assert got.shape == want.shape
    _close_scaled(got, want, rtol=1e-5)
    # symmetric by construction (upper triangle mirrored)
    assert torch.equal(got, got.T)


def _apply_inputs(seed, k, g, a, device):
    r = np.random.RandomState(seed)
    arrs = (
        r.randn(k, g, a).astype(np.float32),
        np.stack([_orth(r, a) for _ in range(k)]),
        (r.rand(k, a) + 0.1).astype(np.float32),
        np.stack([_orth(r, g) for _ in range(k)]),
        (r.rand(k, g) + 0.1).astype(np.float32),
    )
    return [torch.from_numpy(x).to(device) for x in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,g,a", [(1, 16, 27), (10, 16, 144), (1, 32, 144), (9, 32, 288), (9, 64, 576), (1, 10, 65)]
)
def test_fused_apply_kernel_matches_plain(cuda_device, k, g, a):
    arrs = _apply_inputs(50 + a, k, g, a, cuda_device)
    before = tapply.fused_precondition_stack.launches
    v, vg = tapply.fused_precondition_stack(*arrs, 0.003)
    torch.cuda.synchronize()
    assert tapply.fused_precondition_stack.launches == before + 1
    v_p, vg_p = tapply.fused_precondition_stack_plain(*arrs, 0.003)
    _close_scaled(v, v_p, rtol=1e-4)
    _close_scaled(vg, vg_p, rtol=1e-4)


@pytest.mark.cuda
def test_fused_sgd_kernel_matches_plain(cuda_device):
    r = np.random.RandomState(60)
    shapes = [(16, 3, 3, 3), (16,), (16,), (64, 64, 3, 3), (10, 64), (10,)] * 40
    make = lambda: [torch.from_numpy(r.randn(*s).astype(np.float32)).to(cuda_device) for s in shapes]  # noqa: E731
    params, grads, trace = make(), make(), make()
    kp, km = [p.clone() for p in params], [m.clone() for m in trace]
    before = tapply.fused_sgd_apply.launches
    tapply.fused_sgd_apply(kp, grads, km, 0.1, 0.9, 5e-4)  # 240 leaves: 3 table chunks
    torch.cuda.synchronize()
    assert tapply.fused_sgd_apply.launches == before + 1
    tapply.fused_sgd_apply_plain(params, grads, trace, 0.1, 0.9, 5e-4)
    for a, b in zip(kp + km, params + trace):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(2, 3, 4, 4, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        tfk.compute_a_conv_fused(x, (3, 3), (1, 1), "SAME", False)
    p = torch.zeros(8, 2, device=cuda_device)[:, 0]  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tapply.fused_sgd_apply([p], [torch.zeros(8, device=cuda_device)], [torch.zeros(8, device=cuda_device)], 0.1, 0.9, 0.0)
