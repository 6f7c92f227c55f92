"""The port's ``fit_a_line``, ``mnist`` and ``resnet50`` against the JAX
package's, on the CPU.

JAX initializes the params (``jax.random.key(0)``, the tiny shapes of
the JAX tests); ``convert.py`` carries them across; the same numpy
``synth_batch`` goes through both.  Compared: the loss and its aux,
every gradient (``jax.grad`` against autograd) and ``predict_fn``.
Float32 agrees at 1e-4 of the reference's scale; bf16 (the families'
own compute dtype) at 2e-2 of scale, as ``test_torch_transformer_lm.py``
states it.  The float32 variants are the flax modules built with
``dtype=float32`` beside the port's modules with ``dtype=float32``:
they hold the layout traps (SAME padding under stride 2, the NHWC
flatten, GroupNorm's eps) to float32 rounding.  The bf16 gradients
scatter too far between the two frameworks to hold where each family
casts; that is held module by module instead: every flax submodule's
input goes through the port's counterpart, whose output must have the
flax output's dtype and value (1e-4 of scale where flax computes in
float32, 2e-2 where in bf16), and planted bf16 faults must fail it.
Labels are held where the top-2 margin exceeds 2e-2 of the row's
largest |logit|.

Also: the padding traps one by one, the FLOP counts from the layer
shapes, and every family built at full width and ``tiny``.
"""

import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from edl_tpu.models import get_model as jax_get_model
from edl_tpu.models.mnist import ConvNet as FlaxConvNet
from edl_tpu.models.resnet import ResNet as FlaxResNet
from edl_tpu_torch.convert import fit_a_line_from_flax, mnist_from_flax, resnet_from_flax
from edl_tpu_torch.models import get_model, registered_models
from edl_tpu_torch.models.layers import GN_EPS, Conv, GroupNorm, max_pool_same, same_pads
from edl_tpu_torch.models.mnist import ConvNet, mnist_flops, xent_loss
from edl_tpu_torch.models.resnet import ResNet, resnet_flops

F32, BF16 = 1e-4, 2e-2
N = 4
TINY_RESNET = dict(stage_sizes=(1, 1, 1), num_classes=10, width=32)
#: family -> (JAX factory kwargs, converter, flax module class and kwargs,
#: port module class and kwargs)
FAMILIES = {
    "mnist": ({}, mnist_from_flax, (FlaxConvNet, {}), (ConvNet, {})),
    "resnet50": ({"tiny": True}, resnet_from_flax, (FlaxResNet, TINY_RESNET),
                 (ResNet, TINY_RESNET)),
}


def _close(got, want, tol, what=""):
    """``tol`` of the reference's largest magnitude, elementwise."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _grads(module):
    return {n: p.grad.detach().numpy() for n, p in module.named_parameters()}


def _labels_agree(got_logits, want_logits, got_labels, want_labels):
    """Labels equal wherever the reference's top-2 margin exceeds 2e-2
    of the row's largest |logit| (bf16 cannot flip such a row)."""
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    sure = margin > BF16 * np.abs(want_logits).max(axis=-1)
    np.testing.assert_array_equal(np.asarray(got_labels)[sure], np.asarray(want_labels)[sure])
    return int(sure.sum())


@pytest.fixture(scope="module")
def jax_side():
    """Per family: the JAX model, its params (numpy leaves), a batch, and
    the JAX loss, aux, gradients and predictions in bf16, and the float32
    module's loss and gradients."""
    out = {}
    for name, (kwargs, _, (flax_cls, flax_kw), _) in FAMILIES.items():
        jm = jax_get_model(name, **kwargs)
        params = jax.jit(jm.init_params)(jax.random.key(0))
        batch = jm.synth_batch(np.random.RandomState(1), N)
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(p, batch, jax.random.key(0)), has_aux=True))(params)
        pred = jax.jit(jm.predict_fn)(params, {k: batch[k] for k in jm.predict_inputs})
        f32_module = flax_cls(**flax_kw, dtype=jnp.float32)

        def f32_loss(p, module=f32_module):
            logits = module.apply({"params": p}, batch["image"])
            labels = jax.nn.one_hot(batch["label"], logits.shape[-1])
            return jnp.mean(-jnp.sum(labels * jax.nn.log_softmax(logits), axis=-1)), logits

        (f32_l, f32_logits), f32_g = jax.jit(jax.value_and_grad(f32_loss, has_aux=True))(params)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        out[name] = {
            "params": np_tree(params), "batch": batch, "loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()}, "grads": np_tree(grads),
            "pred": np_tree(pred), "f32": (float(f32_l), np.asarray(f32_logits), np_tree(f32_g)),
        }
    return out


def _norm_err(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_aux_and_grads_match_jax_in_bf16(jax_side, name):
    """The families in their own dtype (bf16 compute): loss and accuracy
    at 2e-2.  The bf16 gradients of these conv nets are far from their
    float32 values on both sides (the JAX package's: up to 9% of the
    float32 gradient's norm for ``mnist``, 30% for the tiny ``resnet50``;
    each framework rounds the bf16 activations and cotangents in its own
    places), so no two bf16 gradients agree to 2e-2 of scale.  Each
    gradient is held against the JAX float32 gradient instead: the port's
    bf16 error (in norm) within twice the JAX package's bf16 error, plus
    1e-2.  The float32 modules hold the same gradients to 1e-4 of scale
    (``test_float32_modules_match_flax_at_float32_rounding``).  This rule
    is within bf16's scatter and lets a misplaced cast through; the casts
    are held by ``test_bf16_casts_sit_where_flax_puts_them``."""
    ref = jax_side[name]
    _, convert, _, _ = FAMILIES[name]
    model = get_model(name, tiny=True)
    params = model.train_params(convert(ref["params"]), "cpu")
    loss, aux = model.loss_fn(params, _tensors(ref["batch"]))
    loss.backward()
    assert set(aux) == set(ref["aux"])
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=BF16)
    np.testing.assert_allclose(aux["accuracy"].item(), ref["aux"]["accuracy"])
    jax_bf16 = convert(ref["grads"])
    truth = convert(ref["f32"][2])
    got = _grads(params)
    assert set(got) == set(truth)
    for n, g in got.items():
        want = truth[n].numpy()
        port_err, jax_err = _norm_err(g, want), _norm_err(jax_bf16[n].numpy(), want)
        assert port_err <= 2 * jax_err + 1e-2, (n, port_err, jax_err)


def _flax_calls(name, ref):
    """Every flax module call of the family's bf16 forward on the
    batch: (path, the module's compute dtype, its input, its output)."""
    _, _, (flax_cls, flax_kw), _ = FAMILIES[name]
    calls = []

    def record(fn, args, kwargs, context):
        out = fn(*args, **kwargs)
        if context.method_name == "__call__":
            calls.append((context.module.path, context.module.dtype, np.asarray(args[0]),
                          np.asarray(out)))
        return out

    with nn.intercept_methods(record):
        flax_cls(**flax_kw).apply({"params": ref["params"]}, ref["batch"]["image"])
    return calls


def _hold_bf16_placement(name, ref, model, module):
    """Each flax module's input through the port's module of the same
    path (NHWC -> NCHW below the top): the output's dtype is flax's, and
    its value agrees at 1e-4 of scale where flax computes in float32
    (GroupNorm, the head), 2e-2 where in bf16.  Then the port's loss on
    flax's float32 logits against the float64 softmax cross entropy at
    1e-6, float32's rounding of one scalar (bf16-rounded logits move it
    by ~4e-5 at these sizes)."""
    calls = _flax_calls(name, ref)
    for path, dtype, x, y in calls:
        sub = module.get_submodule(".".join(path))
        inner = bool(path) and x.ndim == 4
        xt = torch.from_numpy(x.astype(np.float32))
        xt = xt.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else xt
        with torch.no_grad():
            got = sub(xt.permute(0, 3, 1, 2) if inner else xt)
        got = got.permute(0, 2, 3, 1) if inner and got.ndim == 4 else got
        assert str(got.dtype).removeprefix("torch.") == str(y.dtype), (path, got.dtype, y.dtype)
        tol = F32 if dtype == jnp.float32 else BF16
        _close(got.float().numpy(), y.astype(np.float32), tol, f"{path} ({dtype.__name__})")
    logits = calls[-1][3].astype(np.float64)
    label = ref["batch"]["label"]
    shifted = logits - logits.max(-1, keepdims=True)
    want = np.mean(np.log(np.exp(shifted).sum(-1)) - shifted[np.arange(len(label)), label])
    loss, _ = model.loss_fn(lambda image: torch.tensor(calls[-1][3]), _tensors(ref["batch"]))
    np.testing.assert_allclose(loss.item(), want, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bf16_casts_sit_where_flax_puts_them(jax_side, name):
    ref = jax_side[name]
    model = get_model(name, tiny=True)
    module = model.train_params(FAMILIES[name][1](ref["params"]), "cpu")
    _hold_bf16_placement(name, ref, model, module)


def _group_norm_in_bf16(name, module):
    def forward(self, x):
        dt = torch.bfloat16
        return F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt), self.bias.to(dt),
                            self.eps)

    return mock.patch.object(GroupNorm, "forward", forward)


def _head_in_bf16(name, module):
    head = module.get_submodule("head" if name == "resnet50" else "Dense_1")
    bf16 = torch.bfloat16
    return mock.patch.object(head, "forward", lambda x: F.linear(
        x.to(bf16), head.weight.to(bf16), head.bias.to(bf16)).float())


def _loss_on_bf16_logits(name, module):
    family = sys.modules[type(module).__module__]
    xent = family.xent_loss
    return mock.patch.object(family, "xent_loss", lambda logits, label: xent(
        logits.to(torch.bfloat16).float(), label))


@pytest.mark.parametrize("name,fault", [
    ("mnist", _head_in_bf16), ("mnist", _loss_on_bf16_logits),
    ("resnet50", _group_norm_in_bf16), ("resnet50", _head_in_bf16),
    ("resnet50", _loss_on_bf16_logits)], ids=lambda v: getattr(v, "__name__", v))
def test_bf16_placement_check_fails_planted_faults(jax_side, name, fault):
    """Faults that only the bf16 path has, which the gradient rule of
    ``test_loss_aux_and_grads_match_jax_in_bf16`` lets through at these
    shapes: the module-by-module check fails every one."""
    ref = jax_side[name]
    model = get_model(name, tiny=True)
    module = model.train_params(FAMILIES[name][1](ref["params"]), "cpu")
    with fault(name, module), pytest.raises(AssertionError):
        _hold_bf16_placement(name, ref, model, module)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_float32_modules_match_flax_at_float32_rounding(jax_side, name):
    """The same architecture in float32 on both sides: logits, loss and
    every gradient at 1e-4 of scale.  A wrong SAME pad, flatten order or
    GroupNorm eps fails here."""
    ref = jax_side[name]
    _, convert, _, (cls, kw) = FAMILIES[name]
    module = cls(**kw, dtype=torch.float32)
    module.load_state_dict(convert(ref["params"]))
    batch = _tensors(ref["batch"])
    logits = module(batch["image"])
    loss, _ = xent_loss(logits, batch["label"])
    loss.backward()
    want_loss, want_logits, want_grads = ref["f32"]
    _close(logits.detach().numpy(), want_logits, F32, "logits")
    np.testing.assert_allclose(loss.item(), want_loss, rtol=F32)
    want = convert(want_grads)
    for n, g in _grads(module).items():
        _close(g, want[n].numpy(), F32, n)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_predict_fn_matches_jax(jax_side, name):
    ref = jax_side[name]
    _, convert, _, _ = FAMILIES[name]
    model = get_model(name, tiny=True)
    params = model.bind_params(convert(ref["params"]), "cpu")
    with torch.no_grad():
        got = model.predict_fn(params, {"image": torch.from_numpy(ref["batch"]["image"])})
    assert set(got) == {"logits", "label"} and got["logits"].dtype == torch.float32
    _close(got["logits"].numpy(), ref["pred"]["logits"], BF16, "logits")
    sure = _labels_agree(got["logits"].numpy(), ref["pred"]["logits"], got["label"].numpy(),
                         ref["pred"]["label"])
    assert sure >= N // 2


def test_fit_a_line_matches_jax_in_float32():
    jm = jax_get_model("fit_a_line")
    params = jm.init_params(jax.random.key(0))
    batch = jm.synth_batch(np.random.RandomState(1), 16)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, batch, None), has_aux=True)(params)
    model = get_model("fit_a_line")
    sd = fit_a_line_from_flax(jax.tree_util.tree_map(np.asarray, params))
    module = model.train_params(sd, "cpu")
    got_loss, got_aux = model.loss_fn(module, _tensors(batch))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=F32)
    np.testing.assert_allclose(got_aux["mse"].item(), float(aux["mse"]), rtol=F32)
    want = fit_a_line_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for n, g in _grads(module).items():
        _close(g, want[n].numpy(), F32, n)
    with torch.no_grad():
        pred = model.predict_fn(model.bind_params(sd, "cpu"), {"x": torch.from_numpy(batch["x"])})
    _close(pred["pred"].numpy(), np.asarray(jm.predict_fn(params, {"x": batch["x"]})["pred"]),
           F32)
    assert model.predict_inputs == jm.predict_inputs == ("x",)
    assert model.flops_per_example == jm.flops_per_example == 78


@pytest.mark.parametrize("name", ["fit_a_line", "mnist", "resnet50", "transformer_base"])
def test_synth_batch_bytes_equal_the_jax_packages(name):
    kw = {"tiny": True} if name in ("resnet50", "transformer_base") else {}
    want = jax_get_model(name, **kw).synth_batch(np.random.RandomState(3), 5)
    got = get_model(name, **kw).synth_batch(np.random.RandomState(3), 5)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# -- the padding traps ------------------------------------------------------


@pytest.mark.parametrize("size", [7, 8, 224, 56])
@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (3, 1), (1, 2)])
def test_stride2_same_conv_pads_like_flax(size, k, stride):
    """flax's SAME puts the odd pixel after the image: under stride 2
    the pad is asymmetric ((2, 3) for the 7x7/2 stem on 224, (0, 1) for a
    3x3/2 on 56), which ``nn.Conv2d(padding=k // 2)`` does not reproduce."""
    rng = np.random.RandomState(size + k)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    fconv = nn.Conv(5, (k, k), (stride, stride), padding="SAME", dtype=jnp.float32)
    p = fconv.init(jax.random.key(0), x)["params"]
    want = np.asarray(fconv.apply({"params": p}, x)).transpose(0, 3, 1, 2)
    conv = Conv(3, 5, k, stride, dtype=torch.float32)
    kernel = np.array(p["kernel"]).transpose(3, 2, 0, 1).copy()
    conv.load_state_dict({"weight": torch.from_numpy(kernel),
                          "bias": torch.from_numpy(np.array(p["bias"]))})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = conv(xt).numpy()
        naive = F.conv2d(xt, conv.weight, conv.bias, stride, k // 2).numpy()
    _close(got, want, F32)
    lo, hi = same_pads(size, k, stride)
    if lo != hi:  # the symmetric pad shifts the sampling grid: wrong numbers
        assert not np.allclose(naive, want, atol=1e-3)
    assert (size, k, stride) != (224, 7, 2) or (lo, hi) == (2, 3)
    assert (size, k, stride) != (56, 3, 2) or (lo, hi) == (0, 1)


@pytest.mark.parametrize("size", [7, 8, 112])
def test_same_max_pool_pads_with_minus_inf_like_flax(size):
    """ResNet's 3x3/2 ``max_pool(padding="SAME")`` pads (0, 1) with -inf
    at an even size; on all-negative inputs a zero pad would win."""
    x = -np.abs(np.random.RandomState(size).randn(2, size, size, 4)).astype(np.float32) - 1.0
    want = np.asarray(nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")).transpose(0, 3, 1, 2)
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 0).all()


def test_mnist_flattens_nhwc_as_flax_does(jax_side):
    """``Dense_0``'s 3136 rows are in flax's (h, w, c) order: the port
    permutes its NCHW activations back to NHWC before the flatten; a
    plain NCHW flatten with the same kernel gives other logits."""
    ref = jax_side["mnist"]
    module = ConvNet(dtype=torch.float32)
    module.load_state_dict(mnist_from_flax(ref["params"]))
    x = torch.from_numpy(ref["batch"]["image"])
    with torch.no_grad():
        got = module(x)
        h = x.permute(0, 3, 1, 2)
        h = F.avg_pool2d(F.relu(module.Conv_0(h)), 2, 2)
        h = F.avg_pool2d(F.relu(module.Conv_1(h)), 2, 2)
        nchw = module.Dense_1(F.relu(module.Dense_0(h.reshape(h.shape[0], -1))))
    _close(got.numpy(), ref["f32"][1], F32)
    assert not np.allclose(nchw.numpy(), ref["f32"][1], atol=1e-2)
    assert module.Dense_0.weight.shape == (256, 7 * 7 * 64)


def test_group_norm_uses_flax_eps_in_float32():
    """flax GroupNorm: eps 1e-6 (torch's default is 1e-5), float32
    statistics and output on a bf16 input.  At a variance near 1e-6 the
    eps decides the output."""
    x = (1e-3 * np.random.RandomState(0).randn(2, 6, 6, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    fgn = nn.GroupNorm(num_groups=32, dtype=jnp.float32)
    p = fgn.init(jax.random.key(0), xb)["params"]
    want = np.asarray(fgn.apply({"params": p}, xb)).transpose(0, 3, 1, 2)
    gn = GroupNorm(32, 64)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = gn(xt)
        torch_default = torch.nn.GroupNorm(32, 64)(xt.float())
    assert gn.eps == GN_EPS == 1e-6 and got.dtype == torch.float32
    _close(got.numpy(), want, F32)
    assert not np.allclose(torch_default.numpy(), want, rtol=1e-2, atol=1e-2)


# -- FLOP counts and full-width builds -------------------------------------


def _hook_flops(module, image):
    """fwd+bwd FLOPs counted from the layers' shapes: 2 per multiply-add
    of every convolution and dense layer, at one example on the meta
    device, x3 for the backward."""
    total = 0

    def hook(layer, inputs, out):
        nonlocal total
        fan_in = (layer.in_channels * layer.kernel_size[0] * layer.kernel_size[1]
                  if isinstance(layer, torch.nn.Conv2d) else layer.in_features)
        total += 2 * fan_in * out.numel()

    for m in module.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        module(torch.empty((1, *image), device="meta"))
    return 3 * total


def test_flops_are_counted_from_the_layer_shapes():
    """The port counts the SAME network's work (``edl_tpu/models/mnist.py:111-112``
    counts VALID shapes; ``resnet.py:120`` counts 4.1 G multiply-adds as
    FLOPs): a difference by design (ROADMAP)."""
    with torch.device("meta"):
        convnet, resnet, tiny = ConvNet(), ResNet(), ResNet(**TINY_RESNET)
    assert _hook_flops(convnet, (28, 28, 1)) == mnist_flops() == 68_806_656
    assert get_model("mnist").flops_per_example == 68_806_656
    assert jax_get_model("mnist").flops_per_example == 24_013_824
    assert _hook_flops(resnet, (224, 224, 3)) == resnet_flops(224, 1000, (3, 4, 6, 3), 64)
    assert get_model("resnet50").flops_per_example == 24_535_105_536
    assert jax_get_model("resnet50").flops_per_example == int(3 * 4.1e9)
    assert _hook_flops(tiny, (32, 32, 3)) == get_model("resnet50", tiny=True).flops_per_example


#: the port's modules at full width, on the meta device (no weights)
FULL_WIDTH = {
    "resnet50": lambda: ResNet(),
    "transformer_base": lambda: __import__(
        "edl_tpu_torch.models.transformer", fromlist=["Transformer"]).Transformer(),
}


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", ["fit_a_line", "mnist", "resnet50", "transformer_base"])
def test_every_family_builds_at_full_width_and_tiny(name, tiny):
    """The port's parameters, shape for shape, are the JAX package's
    (``jax.eval_shape``: no JAX weights made), and the model declares
    the same serving schema and token count.  The full-width
    ``resnet50`` and ``transformer_base`` are built on the meta device;
    the others through their seeded ``init_params``."""
    from edl_tpu_torch import convert

    kw = {"tiny": True} if tiny and name in FULL_WIDTH else {}
    jm = jax_get_model(name, **kw)
    model = get_model(name, tiny=tiny)
    assert name in registered_models() and model.name == jm.name == name
    shapes = jax.eval_shape(jm.init_params, jax.random.key(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    to_sd = {"fit_a_line": convert.fit_a_line_from_flax, "mnist": convert.mnist_from_flax,
             "resnet50": convert.resnet_from_flax,
             "transformer_base": convert.transformer_from_flax}[name]
    want = {k: tuple(v.shape) for k, v in to_sd(zeros).items()}
    del zeros
    if name in FULL_WIDTH and not tiny:
        with torch.device("meta"):
            sd = FULL_WIDTH[name]().state_dict()
    else:
        sd = model.init_params(torch.Generator().manual_seed(0))
        assert all(v.dtype == torch.float32 for v in sd.values())
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert model.predict_inputs == jm.predict_inputs
    assert model.tokens_per_example == jm.tokens_per_example
    if name in ("fit_a_line", "transformer_base"):
        assert model.flops_per_example == jm.flops_per_example
