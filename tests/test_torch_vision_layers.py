"""The vision tier's nn.functional functions and dygraph layers against
the JAX package's on the CPU: each on the same numpy inputs, the layers
with the JAX layer's weights carried over (`set_state_dict(jax_layer.
state_dict())`), outputs and the gradients of a sum(out * ct) loss for
the inputs and parameters (1e-5, fp32), and train-mode running stats.
Under `jit.to_static` a small vision net records the JAX package's
program.  The reference behaviours the port keeps are pinned at the end
(ROADMAP.md Queue 3 items 57-58)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import dygraph as jdg
from paddle_tpu import jit as jjit
from paddle_tpu.core.program import _reset_unique_names as jreset

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import _reset_unique_names as treset

from test_torch_gpt import jax_generator_restored  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu(jax_generator_restored):  # noqa: F811
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with tdg.guard(CPUPlace()):
        yield
    torch.set_num_threads(threads)


def _x(*shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _grad_of(t):
    if isinstance(t, torch.Tensor):
        return None if t.grad is None else t.grad.numpy()
    g = t.gradient()
    return None if g is None else np.asarray(g)


def run_both(jfn, tfn, arrays, jparams=(), tparams=(), grad=True):
    """Outputs of jfn / tfn on the arrays (float ones differentiable),
    then the gradients of sum(first output * ct) for the float inputs and
    the parameters, each held to the JAX package's.  Without `grad` the
    inputs do not require a gradient."""
    jin = [paddle_tpu.to_tensor(a, stop_gradient=not grad or
                                a.dtype.kind != "f") for a in arrays]
    tin = [tdg.to_tensor(a, place=CPUPlace(), stop_gradient=not grad or
                         a.dtype.kind != "f") for a in arrays]
    jo, to = jfn(*jin), tfn(*tin)
    jo = jo if isinstance(jo, tuple) else (jo,)
    to = to if isinstance(to, tuple) else (to,)
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        assert tuple(_np(b).shape) == tuple(_np(a).shape)
        np.testing.assert_allclose(_np(b), _np(a), **TOL)
    if not grad:
        return jo, to
    ct = _x(*_np(jo[0]).shape, seed=7, dtype=_np(jo[0]).dtype)
    (jo[0] * paddle_tpu.to_tensor(ct)).sum().backward()
    tdg.backward((to[0] * torch.from_numpy(ct)).sum())
    n = 0
    for j, t in zip(list(jin) + list(jparams), list(tin) + list(tparams)):
        gj, gt = _grad_of(j), _grad_of(t)
        if gj is None:
            continue
        if gt is None:  # not on the tape (SpectralNorm's V): JAX's zeros
            assert not np.abs(gj).any()
            continue
        np.testing.assert_allclose(gt, gj, **TOL)
        n += 1
    assert n, "no gradient compared"
    return jo, to


FUNCS = {
    "conv2d_transpose": (lambda F, x, w, b: F.conv2d_transpose(
        x, w, b, stride=2, padding=1), [_x(2, 3, 5, 5), _x(3, 4, 3, 3, seed=1),
                                          _x(4, seed=2)]),
    "conv3d": (lambda F, x, w, b: F.conv3d(x, w, b, stride=[1, 2, 1],
                                           padding=1),
               [_x(2, 2, 4, 5, 4), _x(3, 2, 3, 3, 3, seed=1), _x(3, seed=2)]),
    "max_pool2d_mask": (lambda F, x: F.max_pool2d(x, 2, return_mask=True),
                        [_x(2, 3, 6, 6)]),
    "adaptive_max_pool2d": (lambda F, x: F.adaptive_max_pool2d(x, 3),
                            [_x(2, 3, 7, 6)]),
    "instance_norm": (lambda F, x, w, b: F.instance_norm(x, weight=w,
                                                         bias=b),
                      [_x(2, 3, 4, 5), _x(3, seed=1), _x(3, seed=2)]),
    "group_norm": (lambda F, x, w, b: F.group_norm(x, 2, weight=w, bias=b),
                   [_x(2, 4, 3, 5), _x(4, seed=1), _x(4, seed=2)]),
    "normalize_p2": (lambda F, x: F.normalize(x, axis=1), [_x(3, 5, 2)]),
    "normalize_p3": (lambda F, x: F.normalize(x, p=3, axis=-1),
                     [_x(3, 5)]),
    "dropout2d_eval": (lambda F, x: F.dropout2d(x, 0.3, training=False),
                       [_x(2, 3, 4, 4)]),
    "pad_last_dims": (lambda F, x: F.pad(x, [1, 2, 0, 1], value=0.5),
                      [_x(2, 3, 4, 5)]),
    "pad_all_dims": (lambda F, x: F.pad(x, [0, 1, 1, 0, 2, 0]),
                     [_x(2, 3, 4)]),
    "interpolate_bilinear": (lambda F, x: F.interpolate(
        x, size=[7, 9], mode="bilinear"), [_x(2, 2, 4, 5)]),
    "interpolate_bilinear_down_ac": (lambda F, x: F.interpolate(
        x, size=[3, 2], mode="bilinear", align_corners=True),
        [_x(1, 2, 8, 7)]),
    "interpolate_nearest_scale": (lambda F, x: F.interpolate(
        x, scale_factor=2, mode="nearest"), [_x(1, 2, 3, 4)]),
    "interpolate_bicubic_down": (lambda F, x: F.interpolate(
        x, size=[4, 3], mode="bicubic"), [_x(1, 2, 9, 8)]),
    "interpolate_linear": (lambda F, x: F.interpolate(
        x, size=9, mode="linear"), [_x(2, 3, 5)]),
    "interpolate_trilinear": (lambda F, x: F.interpolate(
        x, scale_factor=1.5, mode="trilinear"), [_x(1, 2, 4, 3, 4)]),
    "upsample": (lambda F, x: F.upsample(x, size=[6, 6], mode="nearest"),
                 [_x(1, 2, 3, 3)]),
    "pixel_shuffle": (lambda F, x: F.pixel_shuffle(x, 2), [_x(2, 8, 3, 3)]),
    "unfold": (lambda F, x: F.unfold(x, 2, strides=1, paddings=1),
               [_x(2, 3, 4, 4)]),
    "grid_sample": (lambda F, x, g: F.grid_sample(x, g),
                    [_x(2, 3, 5, 4), np.tanh(_x(2, 3, 6, 2, seed=1))]),
    "affine_grid": (lambda F, t: F.affine_grid(t, [2, 3, 4, 5]),
                    [_x(2, 2, 3, dtype=np.float64)]),
    "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b),
                          [_x(4, 6, 3), _x(4, 6, 3, seed=1)]),
    "temporal_shift": (lambda F, x: F.temporal_shift(x, 2, 0.25),
                       [_x(4, 8, 2, 2)]),
    "relu6": (lambda F, x: F.relu6(x), [4 * _x(3, 7)]),
}


@pytest.mark.parametrize("name", list(FUNCS))
def test_functional_matches_jax(name):
    fn, arrays = FUNCS[name]
    # jax.grad of max_pool2d_with_index raises (Queue 3 item 55): its
    # gradient is held to pool2d's in test_torch_pool_norm_ops.py
    with jdg.guard():
        run_both(lambda *a: fn(JF, *a), lambda *a: fn(TF, *a), arrays,
                 grad="mask" not in name)


def _pair(make):
    """The JAX layer (built under paddle_tpu.seed(0)) and the port's, with
    the JAX weights and buffers carried over."""
    paddle_tpu.seed(0)
    with jdg.guard():
        jl = make(jnn)
    tl = make(tnn)
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert tl.set_state_dict(jl.state_dict()) == ([], [])
    return jl, tl


LAYERS = {
    "Conv1D": (lambda nn: nn.Conv1D(3, 4, 3, padding=1, stride=2),
               [_x(2, 3, 9)]),
    "Conv3D": (lambda nn: nn.Conv3D(2, 3, 3, padding=1),
               [_x(2, 2, 4, 4, 3)]),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(3, 2, 3, stride=2,
                                                      padding=1),
                        [_x(2, 3, 4, 5)]),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(2, 4, 2, stride=2,
                                                      groups=2),
                        [_x(1, 2, 3, 2, 3)]),
    "BatchNorm1D": (lambda nn: nn.BatchNorm1D(5), [_x(6, 5)]),
    "BatchNorm3D": (lambda nn: nn.BatchNorm3D(3), [_x(2, 3, 2, 3, 2)]),
    "SyncBatchNorm": (lambda nn: nn.SyncBatchNorm(3), [_x(4, 3, 3, 3)]),
    "GroupNorm": (lambda nn: nn.GroupNorm(2, 4), [_x(2, 4, 3, 3)]),
    "InstanceNorm1D": (lambda nn: nn.InstanceNorm1D(3), [_x(2, 3, 7)]),
    "InstanceNorm2D": (lambda nn: nn.InstanceNorm2D(3), [_x(2, 3, 4, 4)]),
    "InstanceNorm3D": (lambda nn: nn.InstanceNorm3D(2),
                       [_x(2, 2, 3, 3, 3)]),
    "LocalResponseNorm": (lambda nn: nn.LocalResponseNorm(3, k=2.0),
                          [_x(2, 5, 3, 3)]),
    "SpectralNorm": (lambda nn: nn.SpectralNorm([4, 6], power_iters=2),
                     [_x(4, 6)]),
    "MaxPool2D_mask": (lambda nn: nn.MaxPool2D(2, 2, return_mask=True),
                       [_x(2, 3, 6, 6)]),
    "AdaptiveMaxPool2D": (lambda nn: nn.AdaptiveMaxPool2D(2),
                          [_x(2, 3, 6, 5)]),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(2), [_x(2, 3, 8)]),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(3, 2, 1), [_x(2, 3, 9)]),
    "Dropout2D_eval": (lambda nn: nn.Dropout2D(0.5), [_x(2, 3, 4, 4)]),
    "Flatten": (lambda nn: nn.Flatten(), [_x(2, 3, 4, 4)]),
    "Pad2D": (lambda nn: nn.Pad2D([1, 0, 2, 1], value=0.25),
              [_x(2, 3, 4, 4)]),
    "Upsample": (lambda nn: nn.Upsample(size=[6, 7], mode="bilinear"),
                 [_x(2, 2, 4, 4)]),
    "UpsamplingBilinear2D": (lambda nn: nn.UpsamplingBilinear2D(
        scale_factor=2), [_x(1, 2, 3, 4)]),
    "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(size=[5, 7]),
                            [_x(1, 2, 3, 4)]),
    "PixelShuffle": (lambda nn: nn.PixelShuffle(2), [_x(2, 8, 3, 3)]),
    "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=1),
                         [_x(4, 5), _x(4, 5, seed=1)]),
    "Bilinear": (lambda nn: nn.Bilinear(3, 4, 5),
                 [_x(6, 3), _x(6, 4, seed=1)]),
    "ReLU6": (lambda nn: nn.ReLU6(), [4 * _x(3, 7)]),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name):
    make, arrays = LAYERS[name]
    jl, tl = _pair(make)
    if name.endswith("_eval"):
        jl.eval()
        tl.eval()
    with jdg.guard():
        run_both(jl, tl, arrays, jl.parameters(), tl.parameters(),
                 grad="mask" not in name)
    # train-mode running statistics, where the layer keeps them
    jsd, tsd = jl.state_dict(), tl.state_dict()
    for k in jsd:
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(_np(tsd[k]), _np(jsd[k]), **TOL)


def test_convert_sync_batchnorm_shares_the_parameters():
    """Every BatchNorm* sublayer becomes a SyncBatchNorm over the same
    parameters and buffers; the model's outputs are unchanged off a
    process group (local statistics)."""
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4),
                         tnn.ReLU(), tnn.Sequential(tnn.BatchNorm2D(4)))
    x = torch.from_numpy(_x(2, 3, 6, 6))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    want = net(x)
    for k, v in before.items():  # the forward moved the running stats
        net.state_dict()[k].data.copy_(v)
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert conv is net
    kinds = [type(m).__name__ for m in net.sublayers()]
    assert kinds.count("SyncBatchNorm") == 2 and "BatchNorm2D" not in kinds
    assert list(net.state_dict()) == list(before)
    np.testing.assert_allclose(_np(net(x)), _np(want), **TOL)


def _vision_net(nn, F):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv3D(2, 4, 3, padding=1)
            self.norm = nn.GroupNorm(2, 4)
            self.up = nn.Conv2DTranspose(4, 4, 2, stride=2)

        def forward(self, x):
            h = self.norm(self.conv(x))                # [N, 4, D, H, W]
            h = F.pad(h.mean(axis=2), [1, 1, 1, 1])    # [N, 4, H+2, W+2]
            h = F.interpolate(self.up(h), size=[7, 7], mode="bilinear",
                              align_corners=False)
            return F.pixel_shuffle(F.instance_norm(h), 2)

    return Net()


def test_vision_net_records_the_jax_program_under_to_static():
    """conv3d, group_norm, pad, conv2d_transpose, bilinear_interp_v2,
    instance_norm and pixel_shuffle recorded by `jit.to_static` as the
    JAX package records them (to_dict equal), the outputs equal."""
    jreset()
    paddle_tpu.seed(0)
    with jdg.guard():
        jm = _vision_net(jnn, JF)
    treset()
    tm = _vision_net(tnn, TF)
    tm.set_state_dict({k: _np(v) for k, v in jm.state_dict().items()})
    x = _x(2, 2, 3, 3, 3)
    jf = jjit.StaticFunction(jm.forward, layer=jm)
    tf = tjit.StaticFunction(tm.forward, layer=tm)
    jt, tt = paddle_tpu.to_tensor(x), pt.to_tensor(x)
    jreset()
    jo = jf(jt)
    treset()
    to = tf(tt)
    jcp = next(iter(jf._cache.values()))
    tcp = next(iter(tf._cache.values()))
    assert tcp.program.to_dict() == jcp.program.to_dict()
    types = {op.type for op in tcp.program.global_block().ops}
    assert {"conv3d", "group_norm", "pad", "conv2d_transpose",
            "bilinear_interp_v2", "instance_norm",
            "pixel_shuffle"} <= types
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)


# ---------------------------------------------------------------------------
# reference behaviours the port keeps (ROADMAP.md Queue 3)
# ---------------------------------------------------------------------------
def test_functional_unfold_is_im2sequence_and_pad_ignores_mode_item_57():
    """Queue 3 item 57: F.unfold dispatches im2sequence ([N oh ow,
    C kh kw], not paddle's [N, C kh kw, L]; `dilations` not read), F.pad
    pads with `value` whatever `mode` says, Pad2D with it, and
    F.dropout2d drops elements, not channels."""
    x = _x(2, 3, 4, 4)
    with jdg.guard():
        jo, to = run_both(lambda t: JF.unfold(t, 2, dilations=2),
                          lambda t: TF.unfold(t, 2, dilations=2), [x],
                          grad=False)
    assert tuple(to[0].shape) == (2 * 3 * 3, 3 * 2 * 2)
    with jdg.guard():
        run_both(lambda t: JF.pad(t, [1, 1, 1, 1], mode="reflect"),
                 lambda t: TF.pad(t, [1, 1, 1, 1], mode="reflect"), [x])
    got = TF.pad(torch.from_numpy(x), [1, 1, 1, 1], mode="reflect")
    assert float(got[0, 0, 0, 0]) == 0.0
    with jdg.guard():
        run_both(lambda t: JF.dropout2d(t, 0.0), lambda t: TF.dropout2d(
            t, 0.0), [x])


def test_interpolate_sizes_the_1d_and_3d_modes_by_scale_only_item_58():
    """Queue 3 item 58: F.interpolate writes `size` to out_h / out_w, so
    a 3-d `size` leaves out_d unset and trilinear raises in both (the
    ops read out_d, out_h, out_w), and a one-element 1-d size raises an
    IndexError; `scale_factor` sizes them."""
    x3 = _x(1, 1, 2, 3, 4)
    for F, wrap in ((JF, paddle_tpu.to_tensor), (TF, torch.from_numpy)):
        ctx = jdg.guard() if F is JF else tdg.guard(CPUPlace())
        with ctx:
            with pytest.raises(ValueError, match="no target size"):
                F.interpolate(wrap(x3), size=[4, 6, 8], mode="trilinear")
            with pytest.raises(IndexError):
                F.interpolate(wrap(_x(1, 2, 5)), size=[9], mode="linear")
