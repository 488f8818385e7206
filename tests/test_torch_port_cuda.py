"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and skips with a reason where
``torch.cuda.is_available()`` is false (CUDA kernels have no CPU mode).
The file imports only ``torch`` and the port, so it also runs on a machine
without JAX; there, skip the JAX test harness's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances: the kernels sum in another order than the plain versions'
library products, so
products are held to ``|got − want| ≤ rtol·max|want|`` — 1e-5 for the
covariances (sums of up to ~10⁵ rows; per group for grouped convs), 1e-4 for the apply, whose damped
divide amplifies rounding by up to 1/λ (its KL partials are summed per
tile, then in tile order). The SGD kernel rounds each product
and sum separately, in the plain version's order: bitwise. The token
counts are integers divided once by N: bitwise. Flash attention: 2e-5 for
the forward (softmax-weighted sums of at most T values in float32), 1e-4
for the gradients, whose dS = p ⊙ (dP − Δ) cancels. The products of the
conv A factors, the apply and the three flash kernels run as 3xTF32 on the
tensor cores (about float32 accuracy); two launches of any of them agree
bit for bit. The bf16 routes hold the same tolerances: the conv A
factors of bfloat16 activations (one bf16 MMA per product, exact in
float32) at 1e-5, the apply with bfloat16 eigenvectors (exact in TF32: two
TF32 products per product) at 1e-4, against the plain versions, which
upcast the bfloat16 inputs.
"""

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch.ops import apply_kernels as tapply
from kfac_pytorch_tpu_torch.ops import factor_kernels as tfk
from kfac_pytorch_tpu_torch.ops import factors as tf
from kfac_pytorch_tpu_torch.ops import flash_attention as tflash
from kfac_pytorch_tpu_torch.parallel.context import full_attention


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


# (NCHW shape, kernel, strides, padding, bias): small edge cases, the
# ResNet-32 batch-128 geometries of each stage, and every branch of the
# kernel's plan (patch_cov_route): ResNeXt's 7x7 stride-2 stem (F = 147, a
# window of 8-byte copies at 66 columns), a 1x1 stride-2 downsample (a
# window of input rows, 128-wide tiles), 1x1 convs at F = 2048 (7 x 7: a
# whole image's channels as one slab) and with a bias at F = 1025 (flat
# stages), a slab with a bias, flat 4-byte copies (65 channels of 7 x 7:
# no slab), a ragged image (13 columns: 4-byte copies; 17 output rows,
# no divisor near a stage), and images whose one output row's window does
# not fit in shared memory, staged in column tiles: ResNet-50's 1x1 convs
# on 256 channels at 112 x 112 (two tiles of 56), a 7x7 stride-2 stem at
# 512 x 512 (two of 128), and ragged tiles of a 1x1 (64 + 52 columns) and
# of a 3x3 conv with a bias (304 + 296)
CONV_CASES = [
    ((3, 4, 8, 8), (1, 1), (1, 1), "VALID", False),
    ((3, 4, 9, 9), (3, 3), (2, 2), ((1, 1), (1, 1)), True),
    ((2, 5, 8, 8), (3, 3), (1, 1), ((1, 2), (0, 1)), True),
    ((128, 3, 32, 32), (3, 3), (1, 1), ((1, 1), (1, 1)), False),
    ((128, 16, 32, 32), (3, 3), (1, 1), ((1, 1), (1, 1)), False),
    ((128, 16, 32, 32), (3, 3), (2, 2), ((1, 1), (1, 1)), False),
    ((128, 64, 8, 8), (3, 3), (1, 1), ((1, 1), (1, 1)), False),
    ((4, 3, 66, 66), (7, 7), (2, 2), ((3, 3), (3, 3)), False),
    ((4, 256, 14, 14), (1, 1), (2, 2), "VALID", False),
    ((2, 2048, 7, 7), (1, 1), (1, 1), "VALID", False),
    ((2, 1024, 14, 14), (1, 1), (1, 1), "VALID", True),
    ((3, 64, 7, 7), (1, 1), (1, 1), "VALID", True),
    ((3, 65, 7, 7), (1, 1), (1, 1), "VALID", False),
    ((3, 16, 17, 13), (3, 3), (1, 1), ((1, 1), (1, 1)), True),
    ((2, 256, 112, 112), (1, 1), (1, 1), "VALID", False),
    ((2, 3, 512, 512), (7, 7), (2, 2), ((3, 3), (3, 3)), False),
    ((1, 256, 4, 116), (1, 1), (1, 1), "VALID", False),
    ((1, 64, 4, 600), (3, 3), (1, 1), ((1, 1), (1, 1)), True),
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


# (NCHW shape, kernel, padding, bias, dilation): dilated convs, whose stage
# of several output rows reads every dh-th window row (20 x 20), and whose
# one-row stage (23 rows: no divisor near a stage) holds only the kh input
# rows its taps read, which lets a dilation of 24 fit
DILATED_CASES = [
    ((2, 16, 20, 20), (3, 3), ((2, 2), (2, 2)), True, (2, 2)),
    ((2, 16, 23, 23), (3, 3), ((2, 2), (2, 2)), False, (2, 2)),
    ((1, 64, 40, 40), (3, 3), ((24, 24), (24, 24)), False, (24, 24)),
    ((2, 8, 21, 30), (2, 3), ((1, 1), (2, 2)), True, (2, 1)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ks,pad,bias,dil", DILATED_CASES)
def test_conv_a_kernel_dilated_matches_plain(cuda_device, shape, ks, pad, bias, dil):
    x = torch.from_numpy(np.random.RandomState(43).randn(*shape).astype(np.float32))
    x = x.to(cuda_device)
    got = tfk.compute_a_conv_fused(x, ks, (1, 1), pad, bias, dil)
    want = tfk.compute_a_conv_fused_plain(x, ks, (1, 1), pad, bias, dil)
    assert got.shape == want.shape
    _close_scaled(got, want, rtol=1e-5)
    assert torch.equal(got, got.T)


# (NCHW shape, groups, stride, bias): ResNeXt-50's grouped 3×3 convs have
# C/G = 4 … 32 at G = 32; small batches give one row split, the larger a
# ragged one (rows no multiple of the split's length)
GROUPED_CASES = [
    ((2, 8, 9, 9), 2, 1, True),
    ((2, 8, 9, 9), 2, 2, False),
    ((3, 64, 7, 7), 2, 1, False),
    ((4, 128, 14, 14), 32, 1, False),
    ((4, 128, 14, 14), 32, 2, True),
    ((2, 1024, 7, 7), 32, 1, True),
    ((8, 1024, 14, 14), 32, 2, False),
    ((9, 128, 23, 23), 32, 1, False),
    # ResNeXt's stage-1 groups (a = 36, whole in one 48 x 48 block) at their
    # 56-wide rows, and its stage-4 groups (a = 288, 48-wide tiles) at 7 x 7
    ((3, 128, 56, 56), 32, 1, False),
    ((4, 1024, 7, 7), 32, 1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,stride,bias", GROUPED_CASES)
def test_grouped_conv_a_kernel_matches_plain(cuda_device, shape, groups, stride, bias):
    x = torch.from_numpy(np.random.RandomState(41).randn(*shape).astype(np.float32))
    x = x.to(cuda_device)
    args = (groups, (3, 3), (stride, stride), ((1, 1), (1, 1)), bias)
    before = tfk.compute_a_conv_grouped_fused.launches
    got = tfk.compute_a_conv_grouped_fused(x, *args)
    torch.cuda.synchronize()
    assert tfk.compute_a_conv_grouped_fused.launches == before + 1
    want = tfk.compute_a_conv_grouped_fused_plain(x, *args)
    assert got.shape == want.shape == (groups,) + (shape[1] // groups * 9 + bias,) * 2
    for k in range(groups):
        _close_scaled(got[k], want[k], rtol=1e-5)
    assert torch.equal(got, got.transpose(1, 2))
    _close_scaled(got, tf.compute_a_conv_grouped(x, *args), rtol=1e-5)


@pytest.mark.cuda
def test_conv_a_kernels_repeat_bitwise(cuda_device):
    """Each output tile has one owning block per row split, which sums its
    stages in a fixed order; the reduce pass adds the splits in split
    order: two launches of kernel 1 and of kernel 1g agree bit for bit."""
    r = np.random.RandomState(42)
    x = torch.from_numpy(r.randn(16, 16, 32, 32).astype(np.float32)).to(cuda_device)
    args = ((3, 3), (1, 1), ((1, 1), (1, 1)), True)
    assert tfk.patch_cov_route(x, 1, *args)["splits"] > 1
    assert torch.equal(tfk.compute_a_conv_fused(x, *args), tfk.compute_a_conv_fused(x, *args))
    xg = torch.from_numpy(r.randn(8, 128, 28, 28).astype(np.float32)).to(cuda_device)
    assert torch.equal(tfk.compute_a_conv_grouped_fused(xg, 32, *args),
                       tfk.compute_a_conv_grouped_fused(xg, 32, *args))


@pytest.mark.cuda
def test_conv_a_routes_of_the_paths_shapes(cuda_device):
    """The plan per conv: 48-wide tiles for narrow groups and for 3x3 convs
    whose F' they divide far better than 64 (144, 288), 128-wide for wide
    1x1 convs, 64-wide otherwise; flat stages for 1x1 stride-1 convs; the
    widest copy that divides the image rows, or a whole image's channels
    as one slab of 16-byte copies."""
    def route(shape, ks, st, pad, groups=1, bias=False):
        return tfk.patch_cov_route(torch.zeros(shape, device=cuda_device), groups, ks, st, pad, bias)

    same = ((1, 1), (1, 1))
    r = route((128, 3, 32, 32), (3, 3), (1, 1), same)
    assert (r["tile"], r["copy"], r["window"], r["stage_positions"]) == ("48x48", 16, "rows", 256)
    assert route((128, 16, 32, 32), (3, 3), (1, 1), same)["tile"] == "48x48"
    assert route((128, 64, 8, 8), (3, 3), (1, 1), same)["tile"] == "64x64"
    assert route((32, 128, 56, 56), (3, 3), (1, 1), same, groups=32)["tile"] == "48x48"
    stem = route((32, 3, 224, 224), (7, 7), (2, 2), ((3, 3), (3, 3)))
    assert (stem["tile"], stem["copy"], stem["window"]) == ("64x64", 16, "rows")
    flat = route((32, 256, 56, 56), (1, 1), (1, 1), "VALID")
    assert (flat["tile"], flat["copy"], flat["window"]) == ("128x128", 16, "flat")
    slab = route((32, 2048, 7, 7), (1, 1), (1, 1), "VALID")
    assert (slab["copy"], slab["window"]) == (16, "slab")
    assert route((3, 65, 7, 7), (1, 1), (1, 1), "VALID")["copy"] == 4
    assert route((32, 256, 56, 56), (1, 1), (2, 2), "VALID")["window"] == "rows"


@pytest.mark.cuda
def test_conv_a_routes_of_wide_images(cuda_device):
    """Where one output row's window does not fit in shared memory at the
    preferred tile, the stage is one row in column tiles (multiples of 8
    columns); where even 8 columns do not fit, the next narrower tile."""
    def route(shape, ks, st, pad, groups=1, bias=False):
        return tfk.patch_cov_route(torch.zeros(shape, device=cuda_device), groups, ks, st, pad, bias)

    wide = route((2, 256, 112, 112), (1, 1), (1, 1), "VALID")
    assert (wide["tile"], wide["window"], wide["stage_rows"], wide["stage_columns"]) == (
        "128x128", "rows", 1, 56)
    stem = route((2, 3, 512, 512), (7, 7), (2, 2), ((3, 3), (3, 3)))
    assert (stem["tile"], stem["stage_rows"], stem["stage_columns"]) == ("64x64", 1, 128)
    ragged = route((1, 64, 4, 600), (3, 3), (1, 1), ((1, 1), (1, 1)))
    assert (ragged["stage_rows"], ragged["stage_columns"]) == (1, 304)
    # a whole row still fits: one stage per row, as before
    assert route((32, 256, 56, 56), (1, 1), (1, 1), "VALID")["stage_columns"] == 56


@pytest.mark.cuda
def test_conv_a_kernel_route_refuses_a_cpu_tensor(cuda_device):
    """``kind="kernel"`` insists on the kernel: a CPU tensor raises there
    even on a machine with a GPU, and never falls back."""
    x = torch.zeros(2, 3, 6, 6)
    args = ((3, 3), (1, 1), ((1, 1), (1, 1)), False)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.dispatch_compute_a_conv(x, *args, kind="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tfk.dispatch_compute_a_conv_grouped(x, 3, *args, kind="kernel")
    with pytest.raises(ValueError, match="unsupported device"):
        tfk.patch_cov_route(x, 1, *args)


def _bf16_case(shape, seed, device):
    """Seeded normal activations of ``shape``, bfloat16 on ``device``."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    return x.to(device=device, dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ks,st,pad,bias", CONV_CASES)
def test_conv_a_bf16_route_matches_plain(cuda_device, shape, ks, st, pad, bias):
    """Kernel 1's bf16 route on every branch of the plan, in bf16 copy
    widths (16-byte copies of 8 values, 8, 4, and 2-byte loads for odd
    rows such as 7 x 7 and 13 columns): within 1e-5 of the plain version
    on the upcast input, and two launches bitwise equal."""
    x = _bf16_case(shape, 43, cuda_device)
    before = (tfk.compute_a_conv_fused.launches, tfk.compute_a_conv_fused.launches_bf16)
    got = tfk.compute_a_conv_fused(x, ks, st, pad, bias)
    torch.cuda.synchronize()
    assert (tfk.compute_a_conv_fused.launches, tfk.compute_a_conv_fused.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    assert tfk.patch_cov_route(x, 1, ks, st, pad, bias)["route"] == "bf16"
    want = tfk.compute_a_conv_fused_plain(x, ks, st, pad, bias)
    _close_scaled(got, want, rtol=1e-5)
    assert torch.equal(got, got.T)
    assert torch.equal(got, tfk.compute_a_conv_fused(x, ks, st, pad, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,stride,bias", GROUPED_CASES)
def test_grouped_conv_a_bf16_route_matches_plain(cuda_device, shape, groups, stride, bias):
    x = _bf16_case(shape, 44, cuda_device)
    args = (groups, (3, 3), (stride, stride), ((1, 1), (1, 1)), bias)
    before = tfk.compute_a_conv_grouped_fused.launches_bf16
    got = tfk.compute_a_conv_grouped_fused(x, *args)
    torch.cuda.synchronize()
    assert tfk.compute_a_conv_grouped_fused.launches_bf16 == before + 1
    want = tfk.compute_a_conv_grouped_fused_plain(x, *args)
    for k in range(groups):
        _close_scaled(got[k], want[k], rtol=1e-5)
    assert torch.equal(got, tfk.compute_a_conv_grouped_fused(x, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["resnet32", "resnext50_32x4d"])
def test_conv_a_bf16_route_on_the_paths_geometries(cuda_device, arch):
    """Every conv geometry of the bf16 ResNet-32 (batch 16) and ResNeXt-50
    (batch 2, 224 x 224) forwards, grouped and not, with the activations
    the bf16 model feeds each conv (the stem's float32 input takes the
    3xTF32 route): within 1e-5 of the plain version, bitwise repeatable."""
    from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet
    from kfac_pytorch_tpu_torch.models.layers import KFACConv

    gen = torch.Generator().manual_seed(0)
    if arch == "resnet32":
        model = cifar_resnet.get_model(arch, generator=gen, dtype=torch.bfloat16)
        x = torch.randn(16, 3, 32, 32, generator=gen)
    else:
        model = imagenet_resnet.get_model(arch, generator=gen, dtype=torch.bfloat16)
        x = torch.randn(2, 3, 224, 224, generator=gen)
    model.to(cuda_device)
    calls = {}

    def record(mod, inp):  # one call per geometry and input type
        key = (tuple(inp[0].shape), inp[0].dtype, mod.kernel_size, mod.stride, mod.groups)
        calls.setdefault(key, (inp[0].detach().contiguous(), mod))

    hooks = [m.register_forward_pre_hook(record)
             for m in model.modules() if isinstance(m, KFACConv)]
    with torch.no_grad():
        model(x.to(cuda_device))
    for h in hooks:
        h.remove()
    dtypes = set()
    for x, mod in calls.values():
        dtypes.add(x.dtype)
        args = (mod.kernel_size, mod.stride, mod.factor_padding(), False)
        if mod.groups > 1:
            got = tfk.compute_a_conv_grouped_fused(x, mod.groups, *args)
            want = tfk.compute_a_conv_grouped_fused_plain(x, mod.groups, *args)
            again = tfk.compute_a_conv_grouped_fused(x, mod.groups, *args)
            for k in range(mod.groups):
                _close_scaled(got[k], want[k], rtol=1e-5)
        else:
            got = tfk.compute_a_conv_fused(x, *args)
            _close_scaled(got, tfk.compute_a_conv_fused_plain(x, *args), rtol=1e-5)
            again = tfk.compute_a_conv_fused(x, *args)
        assert torch.equal(got, again)
    assert dtypes == {torch.float32, torch.bfloat16}


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


# ResNet-32's groups (g 10 … 64, a 27 … 576), ResNeXt's pseudo-layer
# stacks (96 × [4, 36], 128 × [8, 72]), and the wide groups with odd A
# sides (a bias column): the classifier [1000, 2049], the LM's MLP
# [512, 2049] and QKV [1536, 513], ResNeXt's [2048, 1024]
@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,g,a", [(1, 16, 27), (10, 16, 144), (1, 32, 144), (9, 32, 288), (9, 64, 576), (1, 10, 65),
              (96, 4, 36), (128, 8, 72), (1, 1000, 2049), (4, 512, 2049), (4, 1536, 513),
              (2, 2048, 1024)]
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
@pytest.mark.parametrize(
    "k,g,a", [(1, 16, 27), (10, 16, 144), (9, 64, 576), (1, 10, 65), (96, 4, 36), (128, 8, 72),
              (96, 16, 144), (96, 32, 288), (1, 1000, 2049), (4, 512, 2049), (4, 1536, 513),
              (2, 2048, 1024)]
)
def test_fused_apply_bf16_q_route_matches_plain(cuda_device, k, g, a):
    """Kernel 3 with bfloat16 QA and QG (the ResNet-32, ResNeXt and LM
    groups; odd sides read Q with 2-byte loads) at the kernel's 1e-4, and
    two launches bitwise equal."""
    gm, qa, da, qg, dg = _apply_inputs(60 + a, k, g, a, cuda_device)
    qa, qg = qa.bfloat16(), qg.bfloat16()
    before = tapply.fused_precondition_stack.launches_bf16
    v, vg = tapply.fused_precondition_stack(gm, qa, da, qg, dg, 0.003)
    torch.cuda.synchronize()
    assert tapply.fused_precondition_stack.launches_bf16 == before + 1
    v_p, vg_p = tapply.fused_precondition_stack_plain(gm, qa, da, qg, dg, 0.003)
    _close_scaled(v, v_p, rtol=1e-4)
    _close_scaled(vg, vg_p, rtol=1e-4)
    v2, vg2 = tapply.fused_precondition_stack(gm, qa, da, qg, dg, 0.003)
    assert torch.equal(v, v2) and torch.equal(vg, vg2)


@pytest.mark.cuda
def test_fused_apply_bf16_q_copy_widths(cuda_device):
    """bfloat16 Q rows of a multiple of 8 values take 16-byte copies, other
    rows (a = 36, 65; or unaligned data) 2-byte loads; both routes fill
    shared memory with the same values, so they agree bit for bit; mixed
    Q types are refused."""
    gm, qa, da, qg, dg = _apply_inputs(61, 3, 64, 576, cuda_device)
    qa, qg = qa.bfloat16(), qg.bfloat16()
    assert tapply.fused_apply_route(gm, qa, qg) == {"tile": "64x64", "G": 16, "QA": 16, "QG": 16}
    odd = [_unaligned_copy(x) for x in (gm, qa, qg)]
    assert tapply.fused_apply_route(*odd) == {"tile": "64x64", "G": 4, "QA": 2, "QG": 2}
    v, vg = tapply.fused_precondition_stack(gm, qa, da, qg, dg, 0.003)
    v_odd, vg_odd = tapply.fused_precondition_stack(odd[0], odd[1], da, odd[2], dg, 0.003)
    assert torch.equal(v, v_odd) and torch.equal(vg, vg_odd)
    small = _apply_inputs(62, 96, 4, 36, cuda_device)
    r = tapply.fused_apply_route(small[0], small[1].bfloat16(), small[3].bfloat16())
    assert (r["QA"], r["QG"]) == (2, 2)
    with pytest.raises(ValueError, match="both float32 or both"):
        tapply.fused_precondition_stack(gm, qa, da, qg.float(), dg, 0.003)


def _unaligned_copy(x):
    """A contiguous copy of ``x`` whose data starts one element (4 or 2
    bytes) past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return flat.view(x.shape).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("k,g,a", [(2, 64, 576), (3, 300, 512)])
def test_fused_apply_copy_widths_agree_bitwise(cuda_device, k, g, a):
    """Rows that start 16-byte aligned stream through 16-byte cp.async,
    others through 4-byte copies; both fill shared memory with the same
    values, so the two routes agree bit for bit."""
    gm, qa, da, qg, dg = _apply_inputs(55, k, g, a, cuda_device)
    assert {key: tapply.fused_apply_route(gm, qa, qg)[key] for key in ("G", "QA", "QG")} == {
        "G": 16, "QA": 16, "QG": 16}
    odd = [_unaligned_copy(x) for x in (gm, qa, qg)]
    assert {key: tapply.fused_apply_route(*odd)[key] for key in ("G", "QA", "QG")} == {
        "G": 4, "QA": 4, "QG": 4}
    v, vg = tapply.fused_precondition_stack(gm, qa, da, qg, dg, 0.003)
    v_odd, vg_odd = tapply.fused_precondition_stack(odd[0], odd[1], da, odd[2], dg, 0.003)
    assert torch.equal(v, v_odd) and torch.equal(vg, vg_odd)
    _close_scaled(v, tapply.fused_precondition_stack_plain(gm, qa, da, qg, dg, 0.003)[0], rtol=1e-4)


@pytest.mark.cuda
def test_fused_apply_routes_of_the_paths_shapes(cuda_device):
    """The plan per group: odd sides take 4-byte copies; the tile follows
    the G side and how well the group's 128 x 128 blocks fill the waves
    they need on the card's SMs (132 on an H100 SXM)."""
    def route(k, g, a):
        gm, qa, _, qg, _ = (torch.zeros(s, device=cuda_device)
                            for s in ((k, g, a), (k, a, a), (k, a), (k, g, g), (k, g)))
        return tapply.fused_apply_route(gm, qa, qg)

    assert route(1, 10, 65) == {"tile": "32x32", "G": 4, "QA": 4, "QG": 4}
    assert route(96, 4, 36) == {"tile": "32x32", "G": 16, "QA": 16, "QG": 16}
    # 320 blocks of 128 x 128 take 3 waves of 132, the last 42% full
    assert route(4, 2048, 513) == {"tile": "64x64", "G": 4, "QA": 4, "QG": 16}
    # 512 blocks: 4 waves, 97% full
    assert route(4, 2048, 1024) == {"tile": "128x128", "G": 16, "QA": 16, "QG": 16}
    # the 128 x 128 tile takes aligned QG rows only
    assert route(4, 2046, 1024) == {"tile": "64x64", "G": 16, "QA": 16, "QG": 4}
    assert route(1, 1000, 513)["tile"] == "64x64"


# The WikiText LSTM's decoder (650 inputs and a bias column, one output per
# word): the synthetic corpus's 1,000 words, a ragged 1,003, and one group
# of QG width 8,192 (the 33,278 of WikiText-2 is chip_smoke.py's phase 19b).
# The eigenbases come from torch.linalg.qr on the card: numpy's QR of an
# 8,192-wide matrix takes the host tens of seconds.
@pytest.mark.cuda
@pytest.mark.parametrize("g", [1000, 1003, 8192])
def test_fused_apply_kernel_at_the_wikitext_decoder(cuda_device, g):
    a = 651
    gen = torch.Generator(device=cuda_device).manual_seed(g)

    def orth(n):
        return torch.linalg.qr(torch.randn(1, n, n, device=cuda_device, generator=gen))[0].contiguous()

    arrs = (torch.randn(1, g, a, device=cuda_device, generator=gen), orth(a),
            torch.rand(1, a, device=cuda_device, generator=gen) + 0.1, orth(g),
            torch.rand(1, g, device=cuda_device, generator=gen) + 0.1)
    before = tapply.fused_precondition_stack.launches
    v, vg = tapply.fused_precondition_stack(*arrs, 0.003)
    torch.cuda.synchronize()
    assert tapply.fused_precondition_stack.launches == before + 1
    v_p, vg_p = tapply.fused_precondition_stack_plain(*arrs, 0.003)
    _close_scaled(v, v_p, rtol=1e-4)
    _close_scaled(vg, vg_p, rtol=1e-4)
    again = tapply.fused_precondition_stack(*arrs, 0.003)
    assert torch.equal(v, again[0]) and torch.equal(vg, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k,g,a", [(4, 1024, 520), (3, 300, 513), (96, 4, 36)])
def test_fused_apply_kernel_is_deterministic(cuda_device, k, g, a):
    """Each v entry has one owning block; vg sums the per-tile partials in
    tile order in the last block of its layer: two launches agree bit for
    bit (for each of the three tiles)."""
    arrs = _apply_inputs(57, k, g, a, cuda_device)
    v1, vg1 = tapply.fused_precondition_stack(*arrs, 0.003)
    v2, vg2 = tapply.fused_precondition_stack(*arrs, 0.003)
    assert torch.equal(v1, v2) and torch.equal(vg1, vg2)
    _close_scaled(vg1, tapply.fused_precondition_stack_plain(*arrs, 0.003)[1], rtol=1e-4)


def _sgd_leaves(r, shapes, device):
    return [torch.from_numpy(r.randn(*s).astype(np.float32)).to(device) for s in shapes]


def _sgd_matches_plain_bitwise(params, grads, trace, launches, with_plan=False):
    """One fused SGD call on ``params``/``trace`` in place (through an
    :class:`SGDPlan` of them with ``with_plan=True``) is bitwise equal to
    the plain version on copies, and makes ``launches`` device launches."""
    want_p, want_m = [p.clone() for p in params], [m.clone() for m in trace]
    before = tapply.fused_sgd_apply.launches
    if with_plan:
        plan = tapply.SGDPlan(params, trace)
        assert plan.launches_per_call == launches
        plan.launch(grads, 0.1, 0.9, 5e-4)
    else:
        tapply.fused_sgd_apply(params, grads, trace, 0.1, 0.9, 5e-4)
    torch.cuda.synchronize()
    assert tapply.fused_sgd_apply.launches == before + launches
    tapply.fused_sgd_apply_plain(want_p, grads, want_m, 0.1, 0.9, 5e-4)
    for a, b in zip(params + trace, want_p + want_m):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_sgd_kernel_matches_plain(cuda_device):
    r = np.random.RandomState(60)
    shapes = [(16, 3, 3, 3), (16,), (16,), (64, 64, 3, 3), (10, 64), (10,)] * 40
    params, grads, trace = (_sgd_leaves(r, shapes, cuda_device) for _ in range(3))
    # 240 leaves: one launch, bitwise equal (each product and sum rounded
    # on its own, in the plain version's order)
    _sgd_matches_plain_bitwise(params, grads, trace, launches=1)


@pytest.mark.cuda
@pytest.mark.parametrize("with_plan", [False, True])
def test_fused_sgd_kernel_at_momentum_zero(cuda_device, with_plan):
    """The WikiText recipe's SGD (momentum 0, weight decay 0, lr 20) over a
    2-layer LSTM's leaves and its decoder: still one launch, bitwise equal
    to the plain version (the momentum buffer holds the last update)."""
    r = np.random.RandomState(62)
    shapes = [(1000, 650), (2600, 650), (2600, 650), (2600,), (2600, 650), (2600, 650),
              (2600,), (1000, 650), (1000,)]
    params, grads, trace = (_sgd_leaves(r, shapes, cuda_device) for _ in range(3))
    want_p, want_m = [p.clone() for p in params], [m.clone() for m in trace]
    before = tapply.fused_sgd_apply.launches
    if with_plan:
        tapply.SGDPlan(params, trace).launch(grads, 20.0, 0.0, 0.0)
    else:
        tapply.fused_sgd_apply(params, grads, trace, 20.0, 0.0, 0.0)
    torch.cuda.synchronize()
    assert tapply.fused_sgd_apply.launches == before + 1
    tapply.fused_sgd_apply_plain(want_p, grads, want_m, 20.0, 0.0, 0.0)
    for x, y in zip(params + trace, want_p + want_m):
        assert torch.equal(x, y)
    for m, g in zip(trace, grads):
        assert torch.equal(m, g)


@pytest.mark.cuda
def test_fused_sgd_kernel_beyond_one_table(cuda_device):
    r = np.random.RandomState(61)
    shapes = [(3, 5), (7,), (1,), (4100,)] * 250  # 1000 leaves: 896 + 104
    params, grads, trace = (_sgd_leaves(r, shapes, cuda_device) for _ in range(3))
    assert [k for _, k, _, _ in tapply.plan_sgd_tables([p.numel() for p in params])] == [896, 104]
    _sgd_matches_plain_bitwise(params, grads, trace, launches=2, with_plan=True)


@pytest.mark.cuda
def test_fused_sgd_kernel_scalar_path_odd_sizes_and_empty_leaves(cuda_device):
    r = np.random.RandomState(62)
    sizes = [4096 * 3 + 3, 1, 0, 9, 8192, 4097, 0, 5]
    # views at 4-byte offsets of one buffer: no leaf but the first of each
    # set starts 16-byte aligned, and the sets are offset from each other
    def leaves(shift):
        buf = torch.from_numpy(r.randn(sum(sizes) + 8).astype(np.float32)).to(cuda_device)
        out, at = [], shift
        for n in sizes:
            out.append(buf[at:at + n])
            at += n
        return out

    params, grads, trace = leaves(0), leaves(1), leaves(0)
    vec = tapply.sgd_vector_leaves(*([t.data_ptr() for t in ts] for ts in (params, grads, trace)))
    # the grads are 4 bytes off: every leaf takes the scalar path (an empty
    # leaf's data_ptr is 0; it launches no block)
    assert not any(v for v, n in zip(vec, sizes) if n)
    _sgd_matches_plain_bitwise(params, grads, trace, launches=1)
    grads = leaves(0)
    vec = tapply.sgd_vector_leaves(*([t.data_ptr() for t in ts] for ts in (params, grads, trace)))
    assert vec[0] and vec[3] and not all(vec)  # float4s where all three align, scalars elsewhere
    _sgd_matches_plain_bitwise(params, grads, trace, launches=1)


@pytest.mark.cuda
def test_fused_sgd_plan_notices_replaced_storage(cuda_device):
    r = np.random.RandomState(63)
    shapes = [(64, 3, 3, 3), (64,), (10, 64)]
    params, grads, trace = (_sgd_leaves(r, shapes, cuda_device) for _ in range(3))
    plan = tapply.SGDPlan(params, trace)
    plan.launch(grads, 0.1, 0.9, 0.0)
    assert not plan.stale
    params[1].data = params[1].data.clone()  # the old storage is freed
    assert plan.stale
    with pytest.raises(ValueError, match="build a new plan"):
        plan.launch(grads, 0.1, 0.9, 0.0)
    plan = tapply.SGDPlan(params, trace)
    trace[2].set_(torch.zeros(10, 64, device=cuda_device))
    assert plan.stale
    # the train step's dispatch rebuilds its plan and updates the new storage
    names = [f"w{i}" for i in range(len(shapes))]
    pd, gd, td = (dict(zip(names, ts)) for ts in (params, grads, trace))
    plans = {}
    tapply.dispatch_sgd_apply(pd, gd, td, 0.1, 0.9, 0.0, kind="auto", plans=plans)
    first = plans["plan"]
    td["w0"] = td["w0"].clone()  # a new momentum tensor ...
    trace[0] = td["w0"]  # ... and the old one dropped: its storage is freed
    want_p, want_m = [p.clone() for p in params], [td[n].clone() for n in names]
    tapply.fused_sgd_apply_plain(want_p, grads, want_m, 0.1, 0.9, 0.0)
    tapply.dispatch_sgd_apply(pd, gd, td, 0.1, 0.9, 0.0, kind="auto", plans=plans)
    assert plans["plan"] is not first
    for a, b in zip(params + [td[n] for n in names], want_p + want_m):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shaped like its param"):
        plans["plan"].launch([g.reshape(-1) for g in grads], 0.1, 0.9, 0.0)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(2, 3, 4, 4, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        tfk.compute_a_conv_fused(x, (3, 3), (1, 1), "SAME", False)
    with pytest.raises(ValueError, match="groups"):
        tfk.compute_a_conv_grouped_fused(x.float(), 2, (3, 3), (1, 1), "SAME", False)
    p = torch.zeros(8, 2, device=cuda_device)[:, 0]  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tapply.fused_sgd_apply([p], [torch.zeros(8, device=cuda_device)], [torch.zeros(8, device=cuda_device)], 0.1, 0.9, 0.0)


# (ids shape, vocab, dtype): the LM path's [4, 2048] int64 batch, a count
# that is no multiple of the 8 blocks of a cluster, a wider vocabulary, a
# single short row, and vocabularies over 98,304 ids that take 3 clusters
TOKEN_CASES = [
    ((4, 2048), 1000, torch.int64),
    ((3, 700), 1000, torch.int32),
    ((8, 4096), 10000, torch.int64),
    ((5,), 7, torch.int32),
    ((8, 4096), 200000, torch.int64),
    ((3, 1001), 250000, torch.int32),
    # the WikiText LSTM's [batch 20, BPTT 35] segment: the synthetic
    # corpus's vocabulary and WikiText-2's
    ((20, 35), 1000, torch.int64),
    ((20, 35), 33278, torch.int64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,vocab,dtype", TOKEN_CASES)
def test_token_count_kernel_matches_plain_bitwise(cuda_device, shape, vocab, dtype):
    r = np.random.RandomState(70)
    # Zipf-distributed, like the synthetic corpus: a few heavily hit bins
    probs = 1.0 / np.arange(1, vocab + 1)
    ids = r.choice(vocab, size=shape, p=probs / probs.sum())
    ids = torch.from_numpy(ids).to(dtype).to(cuda_device)
    before = tfk.compute_a_embed_fused.launches
    got = tfk.compute_a_embed_fused(ids, vocab)
    torch.cuda.synchronize()
    assert tfk.compute_a_embed_fused.launches == before + 1
    assert torch.equal(got, tfk.compute_a_embed_fused_plain(ids, vocab))
    assert torch.equal(got, tf.compute_a_embed(ids, vocab))
    tfk.check_token_ids(cuda_device)  # every id in range: nothing to raise


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_token_count_kernel_defers_the_range_check(cuda_device, dtype):
    ids = np.random.RandomState(71).randint(0, 300, size=(4, 1000))
    ids[0, 3], ids[2, 7], ids[3, 999] = -1, 300, 12345
    t_ids = torch.from_numpy(ids).to(dtype).to(cuda_device)
    got = tfk.compute_a_embed_fused(t_ids, 300)  # no sync: nothing raised yet
    # out-of-range ids are counted nowhere; N is still every id
    ok = ids[(ids >= 0) & (ids < 300)]
    want = np.bincount(ok, minlength=300).astype(np.float32) / np.float32(ids.size)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 300\), got 3 ids outside it, in \[-1, 12345\]"):
        tfk.check_token_ids(cuda_device)
    tfk.check_token_ids(cuda_device)  # the check reset the tally


@pytest.mark.cuda
@pytest.mark.parametrize("experts,skew", [(4, False), (4, True), (2, False), (8, True)])
def test_token_count_kernel_at_moe_expert_counts(cuda_device, experts, skew):
    """Kernel 2 as the MoE bank's expert fractions (``vocab = E``): the
    phase-8 LM's 8192 top-1 expert ids meet in a few bins, bitwise against
    the plain version, through the MoE dispatch and counted once per call;
    an expert that receives no id gets an exact zero."""
    r = np.random.RandomState(72)
    if skew:  # one expert takes most tokens, the last none
        ids = r.choice(experts - 1, size=(4, 2048), p=[0.9] + [0.1 / (experts - 2)] * (experts - 2))
    else:
        ids = r.randint(0, experts, size=(4, 2048))
    t_ids = torch.from_numpy(ids.reshape(-1)).to(cuda_device)  # argmax ids: int64
    before = tfk.compute_a_embed_fused.launches
    got = tfk.dispatch_compute_a_moe(t_ids, experts)
    torch.cuda.synchronize()
    assert tfk.compute_a_embed_fused.launches == before + 1
    assert torch.equal(got, tfk.compute_a_embed_fused_plain(t_ids, experts))
    assert torch.equal(got, tf.compute_a_embed(t_ids, experts))
    if skew:
        assert float(got[-1]) == 0.0
    assert torch.equal(tfk.dispatch_compute_a_moe(t_ids, experts, kind="dense"), got)
    tfk.check_token_ids(cuda_device)


# (B, T, H, D, causal): the LM path's head width at several lengths,
# ragged lengths (no multiple of the 64-row tile), the other head widths
FLASH_CASES = [
    (2, 256, 2, 64, True),
    (2, 256, 2, 64, False),
    (1, 200, 3, 64, True),
    (2, 200, 2, 64, False),
    (1, 130, 2, 32, True),
    (1, 96, 2, 128, True),
    (2, 1024, 4, 64, True),
    (2, 200, 2, 128, False),
    (1, 72, 3, 32, False),
    (1, 5, 1, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,causal", FLASH_CASES)
def test_flash_kernels_match_plain(cuda_device, b, t, h, d, causal):
    r = np.random.RandomState(80 + t)
    # q, k, v as strided views of one fused projection, as the model has them
    qkv = torch.from_numpy(r.randn(b, t, 3 * h * d).astype(np.float32)).to(cuda_device)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.from_numpy(r.randn(b, t, h, d).astype(np.float32)).to(cuda_device)
    counts = (tflash.flash_forward.launches, tflash.flash_backward_dq.launches,
              tflash.flash_backward_dkv.launches)
    out, lse = tflash.flash_forward(q, k, v, causal)
    out_p, lse_p = tflash.flash_forward_plain(q, k, v, causal)
    delta = (do * out_p).sum(dim=-1).transpose(1, 2).contiguous()
    dq = tflash.flash_backward_dq(q, k, v, do, lse_p, delta, causal)
    dk, dv = tflash.flash_backward_dkv(q, k, v, do, lse_p, delta, causal)
    torch.cuda.synchronize()
    assert (tflash.flash_forward.launches, tflash.flash_backward_dq.launches,
            tflash.flash_backward_dkv.launches) == tuple(c + 1 for c in counts)
    _close_scaled(out, out_p, rtol=2e-5)
    _close_scaled(lse, lse_p, rtol=2e-5)
    for got, want in zip((dq, dk, dv), tflash.flash_backward_plain(q, k, v, do, lse_p, delta, causal)):
        _close_scaled(got, want, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_kernels_are_deterministic(cuda_device, d):
    """Each dq, dk, dv row has one owning block that sums in a fixed order:
    two launches agree bit for bit."""
    r = np.random.RandomState(85)
    b, t, h = 2, 640, 2
    q, k, v, do = (torch.from_numpy(r.randn(b, t, h, d).astype(np.float32)).to(cuda_device)
                   for _ in range(4))
    out, lse = tflash.flash_forward(q, k, v, True)
    delta = (do * out).sum(dim=-1).transpose(1, 2).contiguous()
    first = (tflash.flash_backward_dq(q, k, v, do, lse, delta, True),
             *tflash.flash_backward_dkv(q, k, v, do, lse, delta, True))
    second = (tflash.flash_backward_dq(q, k, v, do, lse, delta, True),
              *tflash.flash_backward_dkv(q, k, v, do, lse, delta, True))
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal", [(64, True), (128, True), (32, False)])
def test_flash_dkv_long_sequences_sum_their_query_chunks(cuda_device, d, causal):
    """Past ``DKV_CHUNK_ROWS`` query rows (here 3 chunks, the last ragged)
    dK/dV sum each chunk on the tensor cores, one launch a chunk, each
    adding its sums to the earlier chunks': one counted call, within 1e-4
    of the plain version, bitwise on a repeat."""
    r = np.random.RandomState(87)
    b, t, h = 1, 2 * tflash.DKV_CHUNK_ROWS + 136, 2
    q, k, v, do = (torch.from_numpy(r.randn(b, t, h, d).astype(np.float32)).to(cuda_device)
                   for _ in range(4))
    out_p, lse_p = tflash.flash_forward_plain(q, k, v, causal)
    delta = (do * out_p).sum(dim=-1).transpose(1, 2).contiguous()
    before = tflash.flash_backward_dkv.launches
    dk, dv = tflash.flash_backward_dkv(q, k, v, do, lse_p, delta, causal)
    torch.cuda.synchronize()
    assert tflash.flash_backward_dkv.launches == before + 1
    _, dk_p, dv_p = tflash.flash_backward_plain(q, k, v, do, lse_p, delta, causal)
    _close_scaled(dk, dk_p, rtol=1e-4)
    _close_scaled(dv, dv_p, rtol=1e-4)
    again = tflash.flash_backward_dkv(q, k, v, do, lse_p, delta, causal)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,causal", [(1, 200, 2, 64, False), (1, 2048, 2, 64, True),
                                            (1, 136, 1, 128, False), (1, 200, 2, 32, True)])
def test_flash_forward_matches_sdpa_and_repeats_bitwise(cuda_device, b, t, h, d, causal):
    """The forward kernel against SDPA in float32 (a second oracle) and
    against itself: each output row has one owning block that sums over
    keys in a fixed order, so two launches agree bit for bit."""
    import torch.nn.functional as F

    r = np.random.RandomState(95 + t)
    q, k, v = (torch.from_numpy(r.randn(b, t, h, d).astype(np.float32)).to(cuda_device)
               for _ in range(3))
    out, lse = tflash.flash_forward(q, k, v, causal)
    again = tflash.flash_forward(q, k, v, causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)), is_causal=causal)
    _close_scaled(out, ref.transpose(1, 2), rtol=2e-5)
    out_p, lse_p = tflash.flash_forward_plain(q, k, v, causal)
    _close_scaled(out, out_p, rtol=2e-5)
    _close_scaled(lse, lse_p, rtol=2e-5)


@pytest.mark.cuda
def test_flash_backward_refuses_misaligned_rows(cuda_device):
    """cp.async copies 16-byte rows: a view whose data pointer or [B, T, H]
    strides are no multiple of 4 floats is refused, never run."""
    b, t, h, d = 1, 64, 2, 64
    q = torch.zeros(b, t, h, d, device=cuda_device)
    lse = torch.zeros(b, h, t, device=cuda_device)
    shifted = torch.zeros(b * t * h * d + 1, device=cuda_device)[1:].view(b, t, h, d)
    odd_stride = torch.zeros(b, t, h, d + 2, device=cuda_device)[..., :d]
    for bad in (shifted, odd_stride):
        with pytest.raises(ValueError, match="aligned"):
            tflash.flash_backward_dq(q, bad, q, q, lse, lse)
        with pytest.raises(ValueError, match="aligned"):
            tflash.flash_backward_dkv(q, q, q, bad, lse, lse)


@pytest.mark.cuda
def test_flash_attention_autograd_matches_exact_attention(cuda_device):
    r = np.random.RandomState(90)
    arrs = [r.randn(2, 192, 4, 64).astype(np.float32) for _ in range(3)]
    w = torch.from_numpy(r.randn(2, 192, 4, 64).astype(np.float32)).to(cuda_device)

    def run(fn):
        ts = [torch.from_numpy(a).to(cuda_device).requires_grad_(True) for a in arrs]
        out = fn(*ts, causal=True)
        return out.detach(), torch.autograd.grad((out * w).sum(), ts)

    out, grads = run(tflash.flash_attention)
    ref, ref_grads = run(full_attention)
    _close_scaled(out, ref, rtol=2e-5)
    for got, want in zip(grads, ref_grads):
        _close_scaled(got, want, rtol=1e-4)


@pytest.mark.cuda
def test_lm_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    ids = torch.tensor([[0, 3, 9]], device=cuda_device)
    tfk.compute_a_embed_fused(ids, 5)  # deferred: the card keeps a tally
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 5\)"):
        tfk.check_token_ids(cuda_device)
    q = torch.zeros(1, 8, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dimensions"):
        tflash.flash_forward(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tflash.flash_forward(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous last dimension"):
        tflash.flash_forward(q, q, q.transpose(2, 3).contiguous().transpose(2, 3))


# ------------------------------------- the CIFAR path's options on the card


def _resnet20(device, seed=0):
    from kfac_pytorch_tpu_torch.models import cifar_resnet

    return cifar_resnet.get_model(
        "resnet20", generator=torch.Generator().manual_seed(seed)).to(device)


def _spd_t(r, n, device):
    m = r.randn(n, 2 * n).astype(np.float32)
    return torch.from_numpy(m @ m.T / (2 * n)).to(device)


@pytest.mark.cuda
def test_inverse_method_runs_kernel_1_and_not_3_or_4(cuda_device):
    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.training.step import (
        TrainState, kfac_flags_for_step, make_sgd, make_train_step)

    with pytest.raises(ValueError, match="Cholesky inverses"):
        KFAC(precond_method="inverse", apply_kernel="kernel", device=cuda_device)
    model = _resnet20(cuda_device)
    kfac = KFAC(layers=capture.discover_layers(model), precond_method="inverse",
                fac_update_freq=1, kfac_update_freq=2, damping=0.003, device=cuda_device)
    assert kfac.apply_kernel == "dense" and kfac.factor_kernel == "auto"
    tx = make_sgd(0.9, 5e-4)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    step_fn = make_train_step(model, tx, kfac, sgd_hyper=(0.9, 5e-4))
    counted = (tfk.compute_a_conv_fused, tapply.fused_precondition_stack, tapply.fused_sgd_apply)
    for fn in counted:
        fn.launches = 0
    r = np.random.RandomState(90)
    losses = []
    for i in range(3):
        x = torch.from_numpy(r.randn(16, 3, 32, 32).astype(np.float32)).to(cuda_device)
        y = torch.from_numpy(r.randint(0, 10, 16)).to(cuda_device)
        state, m = step_fn(state, (x, y), 0.1, 0.003, **kfac_flags_for_step(i, kfac))
        losses.append(float(m["loss"]))
    convs = sum(1 for n in kfac.layers if n != "linear")
    assert [fn.launches for fn in counted] == [3 * convs, 0, 0]
    assert all(np.isfinite(losses))


@pytest.mark.cuda
def test_blocked_refresh_feeds_the_apply_kernel(cuda_device):
    """``diag_blocks=4``: the refresh's block-diagonal Q goes into kernel 3
    as it is, and the kernel matches the dense apply (1e-4, as above)."""
    from kfac_pytorch_tpu_torch import KFAC, capture

    model = _resnet20(cuda_device)
    names = capture.discover_layers(model)
    r = np.random.RandomState(91)
    kfacs = {kind: KFAC(layers=names, diag_blocks=4, damping=0.003, apply_kernel=kind,
                        device=cuda_device) for kind in ("kernel", "dense")}
    facs = kfacs["dense"]._identity_factors(model)
    a_c = {n: _spd_t(r, f["A"].shape[0], cuda_device) for n, f in facs.items()}
    g_s = {n: _spd_t(r, f["G"].shape[0], cuda_device) for n, f in facs.items()}
    grads = {n: torch.from_numpy(r.randn(*p.shape).astype(np.float32)).to(cuda_device)
             for n, p in model.named_parameters()}
    tapply.fused_precondition_stack.launches = 0
    out = {}
    for kind, kfac in kfacs.items():
        out[kind], state = kfac.update(
            grads, kfac.init(model), a_contribs=a_c, g_factor_stats=g_s, lr=0.1,
            damping=0.003, update_factors=True, update_eigen=True)
    groups = len(state["eigen_stacked"]) + len(state["eigen"])
    assert tapply.fused_precondition_stack.launches == groups
    qa = state["eigen_stacked"]["16x144"]["QA"]  # 144 = 4 blocks of 36
    assert not qa[:, :36, 36:].any() and qa[:, :36, :36].any()
    assert state["eigen"]["linear"]["QA"][:16, 16:].any()  # dense layers: one block
    for n in grads:
        _close_scaled(out["kernel"][n], out["dense"][n], 1e-4)


@pytest.mark.cuda
def test_checkpoint_restore_keeps_the_sgd_plan(cuda_device, tmp_path):
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd

    model = _resnet20(cuda_device)
    params = {n: p for n, p in model.named_parameters()}
    opt = make_sgd(0.9, 5e-4).init(params)
    r = np.random.RandomState(92)
    grads = {n: torch.from_numpy(r.randn(*p.shape).astype(np.float32)).to(cuda_device)
             for n, p in params.items()}
    plans = {}
    tapply.dispatch_sgd_apply(params, grads, opt, 0.1, 0.9, 5e-4, kind="auto", plans=plans)
    plan = plans["plan"]
    state = TrainState(step=1, model=model, opt_state=opt)
    ckpt.save_checkpoint(str(tmp_path), 0, state)
    saved_p = [p.detach().clone() for p in params.values()]
    saved_m = [m.clone() for m in opt.values()]
    tapply.dispatch_sgd_apply(params, grads, opt, 0.1, 0.9, 5e-4, kind="auto", plans=plans)
    restored = ckpt.restore_checkpoint(str(tmp_path), 0, state)
    assert restored.opt_state is opt and not plan.stale
    for a, b in zip(list(params.values()) + list(opt.values()), saved_p + saved_m):
        assert torch.equal(a.detach(), b)
    want_p, want_m = [p.clone() for p in saved_p], [m.clone() for m in saved_m]
    tapply.fused_sgd_apply_plain(want_p, list(grads.values()), want_m, 0.1, 0.9, 5e-4)
    tapply.dispatch_sgd_apply(params, grads, opt, 0.1, 0.9, 5e-4, kind="auto", plans=plans)
    assert plans["plan"] is plan  # kept: the restore copied into its storages
    for a, b in zip(list(params.values()) + list(opt.values()), want_p + want_m):
        assert torch.equal(a.detach(), b)


# ---------------------------------------------------------------------------
# The compiled step: kernel 4's device lr, the graphed train step
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_fused_sgd_device_lr_matches_plain_and_repeats(cuda_device):
    """Kernel 4 reads lr from device memory: bitwise the plain version at
    each rate, two launches on the same inputs bitwise equal, and a launch
    captured in a CUDA graph takes the rate of each replay."""
    r = np.random.RandomState(64)
    shapes = [(16, 3, 3, 3), (16,), (64, 64, 3, 3), (10, 64), (10,), (4097,)] * 16
    params, grads, trace = (_sgd_leaves(r, shapes, cuda_device) for _ in range(3))
    lr = torch.zeros((), device=cuda_device)
    for rate in (0.1, 0.0123456789, 3.3):
        lr.fill_(rate)
        runs = []
        for _ in range(2):
            p, m = [x.clone() for x in params], [x.clone() for x in trace]
            tapply.SGDPlan(p, m).launch(grads, lr, 0.9, 5e-4)
            runs.append(p + m)
        want_p, want_m = [x.clone() for x in params], [x.clone() for x in trace]
        tapply.fused_sgd_apply_plain(want_p, grads, want_m, rate, 0.9, 5e-4)
        for a, b, c in zip(runs[0], runs[1], want_p + want_m):
            assert torch.equal(a, b) and torch.equal(a, c)
    p, m = [x.clone() for x in params], [x.clone() for x in trace]
    plan = tapply.SGDPlan(p, m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        plan.launch(grads, lr, 0.9, 5e-4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        plan.launch(grads, lr, 0.9, 5e-4)
    for rate in (0.05, 0.2):
        want_p, want_m = [x.clone() for x in p], [x.clone() for x in m]
        lr.fill_(rate)
        graph.replay()
        tapply.fused_sgd_apply_plain(want_p, grads, want_m, rate, 0.9, 5e-4)
        for a, b in zip(p + m, want_p + want_m):
            assert torch.equal(a, b)


@pytest.fixture
def deterministic_cudnn(cuda_device):
    """cuDNN's deterministic algorithms: two runs of a step give the same
    bits only when its convolutions' backward sums in a fixed order."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield cuda_device
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _graph_run(device, kfac_kw, graphed, steps, seed=0, state_from=None, start=0):
    """``steps`` ResNet-8 steps on ``device`` through the eager step or
    :class:`GraphedTrainStep`, with the cadence's flags and an lr and
    damping that change every step: ``(per-step metrics, final state,
    launch counts, the step)``. ``state_from`` (a :func:`_snapshot`)
    replaces the starting weights, momentum and K-FAC state with new
    tensors, as a restore from outside the step hands them over."""
    import copy

    from kfac_pytorch_tpu_torch import KFAC, EigenRefreshCadence, capture
    from kfac_pytorch_tpu_torch.models import cifar_resnet
    from kfac_pytorch_tpu_torch.training.graphs import GraphedTrainStep, launch_counters
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step

    torch.manual_seed(seed)
    model = cifar_resnet.CifarResNet(1, 10).to(device)
    tx = make_sgd(0.9, 5e-4)
    kfac = KFAC(layers=capture.discover_layers(model), lr=0.1, damping=0.003,
                track_diagnostics=True, device=device, **kfac_kw)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    if state_from is not None:
        sd, opt, kstate, cad = state_from
        model.load_state_dict(sd)
        state = TrainState(step=start, model=model,
                           opt_state={n: t.clone() for n, t in opt.items()},
                           kfac_state=copy.deepcopy(kstate))
    step_fn = make_train_step(model, tx, kfac, sgd_hyper=(0.9, 5e-4))
    if graphed:
        step_fn = GraphedTrainStep(step_fn, device)
    cadence = EigenRefreshCadence(kfac)
    if state_from is not None:
        cadence.load_state_dict(state_from[3])
    for fn, attr in launch_counters():
        setattr(fn, attr, 0)
    g = torch.Generator().manual_seed(seed + 1)
    out = []
    for i in range(start + steps):
        x = torch.randn(8, 3, 8, 8, generator=g).to(device)
        y = torch.randint(0, 10, (8,), generator=g).to(device)
        if i < start:
            continue
        flags = cadence.flags_for_step(i)
        state, metrics = step_fn(state, (x, y), 0.1 * (1 + 0.1 * i), 0.003 * (1 + (i >= 5)),
                                 **flags)
        out.append({k: v.clone() for k, v in metrics.items()})
    torch.cuda.synchronize()
    return out, state, _counts(), step_fn, cadence


def _snapshot(state, cadence):
    import copy

    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {n: t.clone() for n, t in state.opt_state.items()},
            copy.deepcopy(state.kfac_state), cadence.state_dict())


def _assert_states_equal(a, b):
    from kfac_pytorch_tpu_torch.training.graphs import _flatten

    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    for n in a.opt_state:
        assert torch.equal(a.opt_state[n], b.opt_state[n]), n
    la, lb = _flatten(a.kfac_state), _flatten(b.kfac_state)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), p
        else:
            assert x == y, p


# the cadences of the graphed-step tests: refreshes, capture and plain
# steps; and the pipelined refresh, whose chunks run eagerly and whose
# last chunk swaps
GRAPH_CADENCES = {
    "plain_capture_refresh": dict(fac_update_freq=2, kfac_update_freq=4),
    "chunks": dict(fac_update_freq=1, kfac_update_freq=4, eigh_chunks=2),
    "warmup_blocks": dict(fac_update_freq=1, kfac_update_freq=3, diag_blocks=2, diag_warmup=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cadence", list(GRAPH_CADENCES))
def test_graphed_step_is_the_eager_step_bitwise(deterministic_cudnn, cadence):
    """Every variant of the cadence, captured or eager by rule, gives the
    eager step's metrics at each step and its weights, momentum and K-FAC
    state at the end, bit for bit; the launch counters grow per replay as
    the eager run's per step; one graph per captured variant."""
    from kfac_pytorch_tpu_torch.training.graphs import eager_variant_reason

    device = deterministic_cudnn
    kw = GRAPH_CADENCES[cadence]
    want, wstate, wcounts, _, _ = _graph_run(device, kw, False, 10)
    got, gstate, gcounts, step, _ = _graph_run(device, kw, True, 10)
    for i, (a, b) in enumerate(zip(got, want)):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k)
    _assert_states_equal(gstate, wstate)
    assert gcounts == wcounts
    assert step.replays > 0 and step._cache_size() == len(step.capture_ms)
    assert all(eager_variant_reason(dict(k)) is not None for k in step.eager_calls)
    assert step.eager_calls  # the refreshes (and chunks) ran eagerly


@pytest.mark.cuda
def test_graphed_replay_reads_new_lr_and_damping(deterministic_cudnn):
    """Replays of one captured variant at rates and dampings it was not
    captured with equal the eager step at those values."""
    device = deterministic_cudnn
    kw = dict(fac_update_freq=1, kfac_update_freq=100)  # one refresh, then capture steps
    want, wstate, _, _, _ = _graph_run(device, kw, False, 8)
    got, gstate, _, step, _ = _graph_run(device, kw, True, 8)
    assert step._cache_size() == 1 and step.replays == 6
    for a, b in zip(got, want):
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["kfac_nu"], b["kfac_nu"])
    _assert_states_equal(gstate, wstate)


@pytest.mark.cuda
def test_graphed_step_copies_a_state_handed_in(deterministic_cudnn):
    """A state from outside the graphed step (a restore: new weights copied
    in place, new momentum and K-FAC tensors) is copied into the captured
    buffers before the replay, not ignored: the run continues as the
    eager step does from the same state."""
    device = deterministic_cudnn
    kw = GRAPH_CADENCES["plain_capture_refresh"]
    _, mid, _, _, cad = _graph_run(device, kw, False, 6, seed=3)
    snap = _snapshot(mid, cad)
    want, wstate, _, _, _ = _graph_run(device, kw, False, 5, seed=3, state_from=snap, start=6)
    # a graphed run that captured its variants on other values first
    got_first, gstate, _, step, gcad = _graph_run(device, kw, True, 6, seed=11)
    gstate.model.load_state_dict(snap[0])
    from kfac_pytorch_tpu_torch.training.step import TrainState
    import copy

    state = TrainState(step=6, model=gstate.model,
                       opt_state={n: t.clone() for n, t in snap[1].items()},
                       kfac_state=copy.deepcopy(snap[2]))
    gcad.load_state_dict(snap[3])
    g = torch.Generator().manual_seed(4)
    got = []
    for i in range(11):
        x = torch.randn(8, 3, 8, 8, generator=g).to(device)
        y = torch.randint(0, 10, (8,), generator=g).to(device)
        if i < 6:
            continue
        state, metrics = step(state, (x, y), 0.1 * (1 + 0.1 * i), 0.003 * (1 + (i >= 5)),
                              **gcad.flags_for_step(i))
        got.append(metrics)
    assert step.replays > 0
    for a, b in zip(got, want):
        assert torch.equal(a["loss"], b["loss"])
    _assert_states_equal(state, wstate)


@pytest.mark.cuda
def test_eigh_refuses_capture(cuda_device):
    """The premise of ``training.graphs.EAGER_VARIANTS``: ``torch.linalg.eigh``
    reads cuSOLVER's info on the host, which a CUDA-graph capture refuses.
    Probed in a process of its own: a refused capture leaves the process's
    CUDA generator mid-capture."""
    import subprocess
    import sys

    probe = (
        "import torch\n"
        "a = (torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64) % 7).cuda()\n"
        "a = a @ a.T + 64 * torch.eye(64, device='cuda')\n"
        "s = torch.cuda.Stream(); s.wait_stream(torch.cuda.current_stream())\n"
        "with torch.cuda.stream(s):\n"
        "    torch.linalg.eigh(a)\n"
        "torch.cuda.current_stream().wait_stream(s)\n"
        "g = torch.cuda.CUDAGraph()\n"
        "try:\n"
        "    with torch.cuda.graph(g):\n"
        "        torch.linalg.eigh(a)\n"
        "    print('captured')\n"
        "except RuntimeError as e:\n"
        "    print('refused:', str(e).splitlines()[0])\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.startswith("refused:"), out.stdout + out.stderr


# The LM and ImageNet twins' steps graphed: each built by its twin's
# ``build`` at a small size, driven through a refresh, plain and capture
# steps by the twin's own cadence, eager and graphed from the same seed.
LM_GRAPH_ARGV = ["--synthetic", "--d-model", "128", "--n-heads", "2", "--n-layers", "2",
                 "--seq-len", "4096", "--batch-size", "1", "--kfac-embedding",
                 "--kfac-cov-update-freq", "2", "--kfac-update-freq", "4",
                 "--seed", "0", "--device", "cuda"]
LM_GRAPH_CASES = {
    "recipe": [],
    "remat": ["--remat"],
    "lens_moe": ["--qkv-lens", "--moe-experts", "2"],
}
RESNEXT_GRAPH_ARGV = ["--synthetic", "--model", "tiny_resnext32", "--image-size", "32",
                      "--batch-size", "4", "--kfac-cov-update-freq", "2",
                      "--kfac-update-freq", "4", "--seed", "0", "--device", "cuda"]
RESNEXT_GRAPH_CASES = {
    "float32": [],
    "bf16": ["--bf16"],
    "accum2": ["--batches-per-allreduce", "2"],
}


def _counts():
    """Every launch counter, by ``wrapper.attribute``."""
    from kfac_pytorch_tpu_torch.training.graphs import launch_counters

    return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in launch_counters()}


def _twin_graph_run(device, twin, argv, graphed, steps):
    """``steps`` train steps of ``twin`` (``"lm"`` or ``"imagenet"``) built
    by its ``build`` from ``argv``, with the twin's flags per step, through
    the eager step or ``GraphedTrainStep``: ``(per-step metrics, final
    state, launch counts, the step)``."""
    from kfac_pytorch_tpu_torch import EigenRefreshCadence
    from kfac_pytorch_tpu_torch.training import data as data_lib
    from kfac_pytorch_tpu_torch.training.graphs import GraphedTrainStep, launch_counters
    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step

    if twin == "lm":
        from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

        args = trainer.parse_args(argv)
        _, kfac, state, step_fn, splits = trainer.build(args, device)
        stream = data_lib.batchify_tokens(splits["train"], args.batch_size)
        batches = [trainer.device_batch(t, y, device)
                   for _, (t, y) in zip(range(steps),
                                        data_lib.bptt_batches(stream, args.seq_len))]
        cadence = EigenRefreshCadence(kfac)
        flags = [cadence.flags_for_step(i, 0) for i in range(steps)]
        lrs = [args.base_lr] * steps
    else:
        from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer
        from kfac_pytorch_tpu_torch.parallel.mesh import put_global_batch

        args = trainer.parse_args(argv)
        _, kfac, state, step_fn = trainer.build(args, device)
        accum, im = args.batches_per_allreduce, args.image_size
        batches = [put_global_batch(b, device, accum) for b in data_lib.synthetic_batches(
            args.batch_size * accum, (3, im, im), trainer.NUM_CLASSES, steps, seed=args.seed)]
        flags = [kfac_flags_for_step(i, kfac, 0) for i in range(steps)]
        lrs = [args.base_lr * (1 + 0.1 * i) for i in range(steps)]  # a warmup's rates
    if graphed:
        step_fn = GraphedTrainStep(step_fn, device)
    for fn, attr in launch_counters():
        setattr(fn, attr, 0)
    out = []
    for i in range(steps):
        state, metrics = step_fn(state, tuple(batches[i]), lrs[i],
                                 kfac.hparams.damping if kfac else 0.0, **flags[i])
        out.append({k: v.clone() for k, v in metrics.items()})
    torch.cuda.synchronize()
    return out, state, _counts(), step_fn


def _assert_graphed_is_eager(device, twin, argv, steps):
    """The graphed run's metrics at every step, final state and launch
    counts equal the eager run's bit for bit; the refreshes ran eagerly
    and every other step was captured once and then replayed."""
    from kfac_pytorch_tpu_torch.training.graphs import eager_variant_reason

    want, wstate, wcounts, _ = _twin_graph_run(device, twin, argv, False, steps)
    got, gstate, gcounts, step = _twin_graph_run(device, twin, argv, True, steps)
    for i, (a, b) in enumerate(zip(got, want)):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k)
    _assert_states_equal(gstate, wstate)
    assert gcounts == wcounts
    assert step.replays > 0 and step._cache_size() == len(step.capture_ms)
    assert step.eager_calls and all(eager_variant_reason(dict(k)) is not None
                                    for k in step.eager_calls)
    return gcounts


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LM_GRAPH_CASES))
def test_graphed_lm_step_is_the_eager_step_bitwise(deterministic_cudnn, case):
    """The LM twin's step at T 4096 (dK/dV in two 2048-row query chunks)
    over a refresh, plain and capture steps: graphed, bitwise the eager
    step; kernels 2 and 5-7 launched inside the replays as often as
    eagerly. ``--remat`` captures its recomputed blocks (``checkpoint``
    saving and restoring the CUDA generator's state); the QKV lens and
    the MoE bank (its token-weighted EMA) capture their statistics."""
    counts = _assert_graphed_is_eager(deterministic_cudnn, "lm",
                                      [*LM_GRAPH_ARGV, *LM_GRAPH_CASES[case]], 7)
    layers = 2
    # flash forward per layer and step (twice under --remat), its backward
    # once; the token counts (and each layer's MoE fractions) on the 4
    # steps that capture statistics, 0, 2, 4 and 6
    assert counts["flash_forward.launches"] == layers * 7 * (2 if case == "remat" else 1)
    assert counts["flash_backward_dq.launches"] == counts["flash_backward_dkv.launches"] == 14
    per_capture = 1 + (layers if case == "lens_moe" else 0)
    assert counts["compute_a_embed_fused.launches"] == 4 * per_capture


@pytest.fixture
def tiny_resnext32(monkeypatch):
    """A ResNeXt of one bottleneck per stage pair with 32 groups of width
    4, under a zoo name, so the ImageNet twin's ``build`` takes it."""
    from kfac_pytorch_tpu_torch.models import imagenet_resnet

    monkeypatch.setitem(imagenet_resnet._MODELS, "tiny_resnext32",
                        (imagenet_resnet.Bottleneck, (1, 1), 32, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RESNEXT_GRAPH_CASES))
def test_graphed_resnext_step_is_the_eager_step_bitwise(deterministic_cudnn, tiny_resnext32,
                                                       case):
    """The ImageNet twin's step on a small ResNeXt (grouped convolutions:
    kernel 1g; float32, its bf16 route under ``--bf16``, and two
    accumulated micro-batches), graphed, bitwise the eager step over a
    refresh, plain and capture steps at a changing lr."""
    counts = _assert_graphed_is_eager(deterministic_cudnn, "imagenet",
                                      [*RESNEXT_GRAPH_ARGV, *RESNEXT_GRAPH_CASES[case]], 7)
    route = "launches_bf16" if case == "bf16" else "launches"
    assert counts[f"compute_a_conv_grouped_fused.{route}"] > 0
    assert counts["fused_sgd_apply.launches"] == 7


@pytest.mark.cuda
def test_out_of_range_id_in_a_replay_is_raised_by_the_epoch_check(cuda_device):
    """Kernel 2 inside a captured step tallies an id outside the vocabulary
    on the device: the replay itself reads nothing on the host, and
    ``check_token_ids`` raises for it afterwards, once."""
    from kfac_pytorch_tpu_torch.training.graphs import GraphedTrainStep
    from kfac_pytorch_tpu_torch.training.step import TrainState

    vocab = 1000
    model = torch.nn.Linear(4, 4).to(cuda_device)

    def step_fn(state, batch, lr, damping, **flags):
        freq = tfk.compute_a_embed_fused(batch[0], vocab)
        return (TrainState(step=state.step + 1, model=state.model, opt_state=state.opt_state,
                           kfac_state=None), {"freq": freq * lr})

    step = GraphedTrainStep(step_fn, cuda_device)
    state = TrainState(step=0, model=model, opt_state={}, kfac_state=None)
    g = torch.Generator().manual_seed(9)
    ids = [torch.randint(0, vocab, (2, 4096), generator=g).to(cuda_device) for _ in range(3)]
    ids[2][1, 77] = vocab + 3
    tfk.check_token_ids(cuda_device)
    for i in range(2):  # the capture, then a replay, all in range
        state, m = step(state, (ids[i],), 1.0, 0.0, update_factors=True)
        tfk.check_token_ids(cuda_device)
        assert torch.equal(m["freq"], tfk.compute_a_embed_fused_plain(ids[i], vocab))
    state, m = step(state, (ids[2],), 1.0, 0.0, update_factors=True)
    assert step.replays == 2
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match=r"1 ids outside it, in \[1003, 1003\]"):
        tfk.check_token_ids(cuda_device)
    tfk.check_token_ids(cuda_device)  # the tally was reset
