"""``--bf16`` compute: the bfloat16 models against the JAX package's, on the CPU.

One forward, backward and statistics capture of a CIFAR ResNet with one
block per stage (``resnet8``: the stem, a plain and two strided blocks,
option-A shortcuts, the dense head) and of the tiny ResNeXt of
``tests/test_torch_port_imagenet.py`` (grouped convs, downsamples, max
pool), both built with ``dtype=bfloat16`` in both packages from the same
float32 weights and fed the same numpy batch. No JAX train step is jitted:
the JAX side is its train step's capture (``capture.a_contribs`` and
``capture.g_factors`` on the ``kfac_acts`` and perturbation cotangents).

Checked: the logits and the loss, every A and G factor, and the
BatchNorm running statistics; the parameters, the gradients, the factors
and BatchNorm's buffers are float32 on both sides, and the port's capture
hooks see bfloat16 activations at every conv but the stem (whose input is
the float32 batch, as in JAX) and bfloat16 output gradients at every conv.

Tolerances. Each layer rounds its output to bfloat16, a relative step of
2⁻⁸, and the two frameworks' CPU convolutions sum in different orders, so
an activation may land one bf16 step apart. The forward quantities hold
to a few steps of their largest entry: the logits, the loss and the
BatchNorm statistics to ``4·2⁻⁸``, every A factor (averaged products of
the activations) to ``4·2⁻⁸``. The G factors are covariances of
cotangents that the backward pass rounds at every layer, and a ReLU whose
input lies within a step of zero passes the gradient in one package and
blocks it in the other: bf16 moves a G factor by several percent from its
float32 value (measured: up to 9% of its largest entry in these models).
So each G factor is held to the distance bf16 itself puts between the
JAX package's bf16 and float32 results: ``|port − jax_bf16| ≤ 2·|jax_bf16
− jax_f32| + 4·2⁻⁸`` of the largest entry, per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import capture as jcapture
from kfac_pytorch_tpu.models import cifar_resnet as jresnet
from kfac_pytorch_tpu.models import imagenet_resnet as jir
from kfac_pytorch_tpu.models.layers import KFAC_ACTS, PERTURBATIONS
from kfac_pytorch_tpu.models.layers import KFACDense as JKFACDense
from kfac_pytorch_tpu.training.step import softmax_cross_entropy as jce
from kfac_pytorch_tpu_torch import capture
from kfac_pytorch_tpu_torch.interop import imagenet_state_dict_from_jax, state_dict_from_jax
from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet
from kfac_pytorch_tpu_torch.models.layers import KFACConv, KFACDense
from kfac_pytorch_tpu_torch.training.step import softmax_cross_entropy
from tests.test_torch_port_imagenet import _port_name

STEP = 2.0 ** -8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_scaled(got, want, rtol, what=""):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    bound = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=what)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_capture(model, params, stats, x, y, smooth):
    """The JAX train step's forward + backward + capture, without K-FAC."""
    names = jcapture.discover_layers(model, x, train=True)

    def run(params, stats, x, y):
        perts = jcapture.perturbation_zeros(model, x, train=True)

        def loss_fn(params, perts):
            logits, mut = model.apply(
                {"params": params, "batch_stats": stats, PERTURBATIONS: perts}, x,
                mutable=["batch_stats", KFAC_ACTS], train=True)
            return jce(logits, y, smooth), (mut, logits)

        (loss, (mut, logits)), (grads, gperts) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(params, perts)
        a_c = jcapture.a_contribs(mut[KFAC_ACTS], names, perturb_grads=gperts)
        g_s = jcapture.g_factors(gperts, names, batch_averaged=True, captured=mut[KFAC_ACTS])
        return loss, logits, grads, mut["batch_stats"], a_c, g_s

    return names, jax.jit(run)(params, stats, jnp.asarray(x), jnp.asarray(y))


def _port_capture(model, x, y, smooth):
    """The port's forward + backward + capture; the hooks' input and output
    gradient dtypes per K-FAC layer."""
    seen_in, seen_grad = {}, {}

    def record_in(name):
        def hook(mod, inp):
            seen_in[name] = inp[0].dtype
        return hook

    def record_grad(name):
        def hook(mod, grad_in, grad_out):
            seen_grad[name] = grad_out[0].dtype
        return hook

    cap = capture.Capture(model)
    handles = []
    for name, mod in cap.modules.items():
        handles.append(mod.register_forward_pre_hook(record_in(name)))
        handles.append(mod.register_full_backward_hook(record_grad(name)))
    model.train()
    with cap.capturing():
        logits = model(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
        loss = softmax_cross_entropy(logits, torch.from_numpy(y), smooth)
        loss.backward()
    for h in handles:
        h.remove()
    cap.remove()
    return loss, logits, cap, seen_in, seen_grad


def _compare(jout, jout32, tout, model, names, to_port, first_conv):
    loss_j, logits_j, _, _, a_j, g_j = jout
    loss_t, logits_t, cap, seen_in, seen_grad = tout
    assert logits_t.dtype == torch.float32 and loss_t.dtype == torch.float32
    _close_scaled(logits_t.detach(), logits_j, 4 * STEP, "logits")
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=4 * STEP)
    assert {to_port(n) for n in names} == set(cap.a_contribs) == set(cap.g_factor_stats)
    for n in names:
        p = to_port(n)
        a, g = cap.a_contribs[p], cap.g_factor_stats[p]
        assert a.dtype == g.dtype == torch.float32
        _close_scaled(a, a_j[n], 4 * STEP, f"A of {p}")
        want, ref = np.asarray(g_j[n]), np.asarray(jout32[5][n])
        spread = float(np.abs(want - ref).max() / np.abs(want).max())
        _close_scaled(g, want, 2 * spread + 4 * STEP, f"G of {p}")
    convs = [n for n, m in model.named_modules() if isinstance(m, KFACConv)]
    for base in convs:
        assert seen_in[base] == (torch.float32 if base == first_conv else torch.bfloat16), base
        assert seen_grad[base] == torch.bfloat16, base
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32


def _jax_pair(make, shape, seed, smooth):
    """The JAX model in bfloat16 and in float32 from the same float32
    weights, on one numpy batch: ``(x, y, params, stats, names, bf16 out,
    float32 out)``."""
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    y = r.randint(0, 10, size=shape[0]).astype(np.int32)
    jmodel = make(jnp.bfloat16)
    variables = jax.jit(lambda k, v: jmodel.init(k, v, train=True))(jax.random.PRNGKey(seed),
                                                                     jnp.asarray(x))
    params, stats = variables["params"], variables["batch_stats"]
    assert all(v.dtype == jnp.float32 for v in jax.tree_util.tree_leaves(params))
    names, jout = _jax_capture(jmodel, params, stats, x, y, smooth)
    _, jout32 = _jax_capture(make(None), params, stats, x, y, smooth)
    return x, y, params, stats, names, jout, jout32


def test_bf16_cifar_resnet_forward_backward_capture_matches_jax():
    x, y, params, stats, names, jout, jout32 = _jax_pair(
        lambda dt: jresnet.CifarResNet(stage_sizes=(1, 1, 1), dtype=dt), (8, 16, 16, 3), 160, 0.0)
    model = cifar_resnet.CifarResNet(1, 10, dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(_np_tree(params), _np_tree(stats), "resnet8"))
    tout = _port_capture(model, x, y, 0.0)
    jmap = {"KFACConv_0": "conv1", "KFACDense_0": "linear"}
    for b, layer in enumerate(("layer1.0", "layer2.0", "layer3.0")):
        for j in (0, 1):
            jmap[f"BasicBlock_{b}/KFACConv_{j}"] = f"{layer}.conv{j + 1}"
    _compare(jout, jout32, tout, model, names, jmap.__getitem__, "conv1")
    # BatchNorm's running statistics: float32, from float32 batch statistics
    want = state_dict_from_jax(_np_tree(params), _np_tree(jout[3]), "resnet8")
    for key, w in want.items():
        if "running" in key:
            got = model.state_dict()[key]
            assert got.dtype == torch.float32
            _close_scaled(got, w, 4 * STEP, key)


def test_bf16_tiny_resnext_forward_backward_capture_matches_jax():
    stages = (1, 1)
    x, y, params, stats, names, jout, jout32 = _jax_pair(
        lambda dt: jir.ImageNetResNet(block=jir.Bottleneck, stage_sizes=stages, groups=4,
                                      width_per_group=4, num_classes=10, dtype=dt),
        (4, 32, 32, 3), 161, 0.1)
    model = imagenet_resnet.ImageNetResNet(imagenet_resnet.Bottleneck, stages, 10, 4, 4,
                                           dtype=torch.bfloat16)
    model.load_state_dict(imagenet_state_dict_from_jax(_np_tree(params), _np_tree(stats),
                                                       ("bottleneck", stages)))
    tout = _port_capture(model, x, y, 0.1)
    grouped = [n for n, m in model.named_modules() if isinstance(m, KFACConv) and m.groups > 1]
    assert grouped == ["layer1.0.conv2", "layer2.0.conv2"]
    _compare(jout, jout32, tout, model, names, lambda n: _port_name(n, stages), "conv1")


def test_bf16_dense_layer_matches_flax():
    """``KFACDense(compute_dtype=bfloat16)`` against the flax layer with
    ``dtype=bfloat16``: input and kernel cast to bf16, the bias added after
    the product, a bf16 output; the weight stays float32."""
    r = np.random.RandomState(162)
    x = r.randn(6, 12).astype(np.float32)
    jlayer = JKFACDense(5, dtype=jnp.bfloat16)
    params = jlayer.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"], "bias": jnp.asarray(r.randn(5).astype(np.float32))}
    want = jlayer.apply({"params": params}, jnp.asarray(x))
    layer = KFACDense(12, 5, compute_dtype=torch.bfloat16)
    layer.load_state_dict({"weight": torch.from_numpy(np.asarray(params["kernel"]).T.copy()),
                           "bias": torch.from_numpy(np.array(params["bias"]))})
    got = layer(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert layer.weight.dtype == torch.float32
    _close_scaled(got.detach().float(), np.asarray(want.astype(jnp.float32)), 2 * STEP)
