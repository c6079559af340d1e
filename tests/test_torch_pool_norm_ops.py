"""The pooling, norm, embedding and rearrangement ops of the slice
against the JAX package's kernels, forward and grad: pool3d,
max_pool2d_with_index, max_pool3d_with_index, spp, unpool,
sync_batch_norm (off a process group: the local computation),
instance_norm, group_norm, lrn, data_norm, spectral_norm, embedding,
add_position_encoding, pixel_shuffle, space_to_depth, temporal_shift,
shuffle_channel, pad2d, pad3d, bilinear_tensor_product, norm and relu6.
Index outputs are compared by value.  Max-pool inputs have no ties.
Tolerances in tests/torch_nn_cases.py.  The reference behaviours the
port keeps are pinned at the end (ROADMAP.md Queue 3)."""
import numpy as np
import pytest

from test_torch_train_ops import _run_jax, _run_torch
from torch_nn_cases import R, bf16, check_case, f, grad_slots_match


def _p3(x, **attrs):
    return ("pool3d", {"X": x}, attrs, ["Out"])


def _bn(x, c, **attrs):
    return ("sync_batch_norm",
            {"X": x, "Scale": f(c), "Bias": f(c), "Mean": f(c),
             "Variance": np.abs(f(c)) + 0.5}, attrs, ["Y"])


def _idx(n, c, h, w, oh, ow):
    """Distinct flat indices into [oh, ow] for each (n, c)."""
    return np.stack([np.stack([R.permutation(oh * ow)[:h * w].reshape(h, w)
                               for _ in range(c)]) for _ in range(n)]) \
        .astype(np.int64)


CASES = {
    "pool3d_max": _p3(f(2, 3, 6, 6, 5), pooling_type="max",
                      ksize=[2, 2, 2], strides=[2, 2, 1]),
    "pool3d_max_pad": _p3(f(2, 2, 5, 6, 5), pooling_type="max",
                          ksize=[3, 3, 2], strides=[2, 2, 2],
                          paddings=[1, 1, 0]),
    "pool3d_avg_exclusive": _p3(f(2, 2, 5, 5, 5), pooling_type="avg",
                                ksize=[3, 3, 3], strides=[2, 2, 2],
                                paddings=[1, 1, 1], exclusive=True),
    "pool3d_avg_inclusive": _p3(f(2, 2, 5, 5, 5), pooling_type="avg",
                                ksize=[3, 3, 3], strides=[2, 2, 2],
                                paddings=[1, 1, 1], exclusive=False),
    "pool3d_avg_pad6": _p3(f(1, 2, 6, 5, 5), pooling_type="avg",
                           ksize=[2, 3, 3], strides=[2, 2, 2],
                           paddings=[0, 1, 2, 0, 1, 1]),
    "pool3d_same": _p3(f(1, 2, 5, 6, 7), pooling_type="max",
                       ksize=[2, 3, 3], strides=[2, 2, 3],
                       padding_algorithm="SAME"),
    "pool3d_global": _p3(f(2, 3, 4, 4, 4), pooling_type="avg",
                         global_pooling=True),
    "pool3d_adaptive": _p3(f(2, 2, 6, 7, 8), pooling_type="max",
                           ksize=[2, 3, 2], adaptive=True),
    "pool3d_bf16": _p3(bf16(2, 2, 4, 4, 4), pooling_type="avg",
                       ksize=[2, 2, 2], strides=[2, 2, 2]),
    "max_idx2d": ("max_pool2d_with_index", {"X": f(2, 3, 8, 8)},
                  {"ksize": [2, 2], "strides": [2, 2]}, None),
    "max_idx2d_s1": ("max_pool2d_with_index", {"X": f(2, 2, 7, 6)},
                     {"ksize": [3, 2], "strides": [1, 2]}, None),
    "max_idx3d": ("max_pool3d_with_index", {"X": f(2, 2, 4, 6, 6)},
                  {"ksize": [2, 2, 2], "strides": [2, 2, 2]}, None),
    "max_idx3d_pad": ("max_pool3d_with_index", {"X": f(1, 2, 5, 5, 6)},
                      {"ksize": [3, 3, 3], "strides": [2, 2, 2],
                       "paddings": [1, 1, 1]}, None),
    "max_idx3d_global": ("max_pool3d_with_index", {"X": f(2, 2, 3, 4, 3)},
                         {"ksize": [1, 1, 1], "global_pooling": True},
                         None),
    "spp_max": ("spp", {"X": f(2, 3, 8, 8)},
                {"pyramid_height": 3, "pooling_type": "max"}, ["Out"]),
    "spp_avg": ("spp", {"X": f(2, 2, 9, 7)},
                {"pyramid_height": 2, "pooling_type": "avg"}, ["Out"]),
    "unpool": ("unpool", {"X": f(2, 3, 3, 3),
                          "Indices": _idx(2, 3, 3, 3, 6, 6)}, {}, ["Out"]),
    "unpool_size": ("unpool", {"X": f(1, 2, 2, 3),
                               "Indices": _idx(1, 2, 2, 3, 5, 7)},
                    {"output_size": [5, 7]}, ["Out"]),
    "sync_bn_train": _bn(f(4, 3, 5, 5), 3, momentum=0.9, epsilon=1e-5),
    "sync_bn_nhwc": _bn(f(3, 4, 5, 6), 6, momentum=0.8,
                        data_format="NHWC"),
    "sync_bn_2d": _bn(f(8, 6), 6, epsilon=1e-3),
    "sync_bn_is_test": _bn(f(4, 3, 5, 5), 3, is_test=True),
    "instance_norm": ("instance_norm", {"X": f(2, 3, 5, 6), "Scale": f(3),
                                        "Bias": f(3)}, {"epsilon": 1e-5},
                      ["Y"]),
    "instance_norm_3d_noaffine": ("instance_norm", {"X": f(2, 3, 3, 4, 4)},
                                  {"epsilon": 1e-3}, ["Y"]),
    "instance_norm_bf16": ("instance_norm", {"X": bf16(2, 4, 6, 6)}, {},
                           ["Y"]),
    "group_norm": ("group_norm", {"X": f(2, 6, 4, 5), "Scale": f(6),
                                  "Bias": f(6)}, {"groups": 3}, ["Y"]),
    "group_norm_1d_eps": ("group_norm", {"X": f(3, 8, 7)},
                          {"groups": 2, "epsilon": 1e-3}, ["Y"]),
    "lrn": ("lrn", {"X": f(2, 7, 4, 4)}, {"n": 5, "k": 2.0, "alpha": 1e-2,
                                          "beta": 0.75}, ["Out"]),
    "lrn_n3": ("lrn", {"X": f(1, 4, 3, 5)}, {"n": 3}, ["Out"]),
    "data_norm": ("data_norm", {"X": f(6, 4), "BatchSize": np.abs(f(4)) + 5,
                                "BatchSum": f(4),
                                "BatchSquareSum": np.abs(f(4)) + 5},
                  {}, ["Y"]),
    "data_norm_nchw_affine": ("data_norm",
                              {"X": f(2, 3, 4, 4),
                               "BatchSize": np.abs(f(3)) + 5,
                               "BatchSum": f(3),
                               "BatchSquareSum": np.abs(f(3)) + 5,
                               "scale_w": f(3), "bias": f(3)}, {}, ["Y"]),
    "spectral_norm": ("spectral_norm", {"Weight": f(4, 6), "U": f(4),
                                        "V": f(6)},
                      {"power_iters": 2}, ["Out"]),
    "spectral_norm_dim1": ("spectral_norm", {"Weight": f(3, 5, 2),
                                             "U": f(5), "V": f(6)},
                           {"dim": 1, "power_iters": 1}, ["Out"]),
    "embedding": ("embedding", {"W": f(10, 4),
                                "Ids": np.array([[1, 3], [9, 3]])},
                  {"padding_idx": 3}, ["Out"]),
    "add_position_encoding": ("add_position_encoding", {"X": f(2, 6, 8)},
                              {"alpha": 0.5, "beta": 2.0}, ["Out"]),
    "add_position_encoding_odd": ("add_position_encoding", {"X": f(1, 5, 7)},
                                  {}, ["Out"]),
    "pixel_shuffle": ("pixel_shuffle", {"X": f(2, 8, 3, 4)},
                      {"upscale_factor": 2}, ["Out"]),
    "space_to_depth": ("space_to_depth", {"X": f(2, 3, 6, 4)},
                       {"blocksize": 2}, ["Out"]),
    "temporal_shift": ("temporal_shift", {"X": f(6, 8, 3, 3)},
                       {"seg_num": 3, "shift_ratio": 0.25}, ["Out"]),
    "shuffle_channel": ("shuffle_channel", {"X": f(2, 6, 3, 3)},
                        {"group": 3}, ["Out"]),
    "pad2d_constant": ("pad2d", {"X": f(2, 3, 4, 5)},
                       {"paddings": [1, 2, 0, 3], "pad_value": 0.5},
                       ["Out"]),
    "pad2d_reflect_nhwc": ("pad2d", {"X": f(2, 5, 6, 3)},
                           {"paddings": [2, 1, 3, 0], "mode": "reflect",
                            "data_format": "NHWC"}, ["Out"]),
    "pad2d_edge": ("pad2d", {"X": f(1, 2, 3, 4)},
                   {"paddings": [2, 2, 1, 3], "mode": "edge"}, ["Out"]),
    "pad3d_constant": ("pad3d", {"X": f(1, 2, 3, 4, 5)},
                       {"paddings": [1, 0, 2, 1, 0, 2], "value": -1.0},
                       ["Out"]),
    "pad3d_reflect": ("pad3d", {"X": f(1, 2, 4, 4, 5)},
                      {"paddings": [2, 1, 1, 2, 1, 0], "mode": "reflect"},
                      ["Out"]),
    "pad3d_replicate": ("pad3d", {"X": f(1, 1, 3, 3, 3)},
                        {"paddings": [2, 1, 0, 2, 1, 1],
                         "mode": "replicate"}, ["Out"]),
    "pad3d_circular": ("pad3d", {"X": f(1, 2, 3, 4, 4)},
                       {"paddings": [1, 2, 2, 1, 1, 1], "mode": "circular"},
                       ["Out"]),
    "bilinear_tensor_product": ("bilinear_tensor_product",
                                {"X": f(3, 4), "Y": f(3, 5),
                                 "Weight": f(2, 4, 5), "Bias": f(1, 2)},
                                {}, ["Out"]),
    "norm": ("norm", {"X": f(3, 4, 5)}, {"axis": 1, "epsilon": 1e-10},
             ["Out", "Norm"]),
    "relu6": ("relu6", {"X": 4 * f(4, 9)}, {}, ["Out"]),
    # ties at 0 and 6 (a depthwise conv over a relu6'd zero patch): the
    # gradient there is 1/2, jnp.clip's
    "relu6_ties": ("relu6", {"X": np.array([[0.0, 6.0, 3.0, -1.0, 7.0,
                                             0.0]], np.float32)}, {},
                   ["Out"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_op_and_grad_match_jax(name):
    op, ins, attrs, ct = CASES[name]
    skip = {"Mean@GRAD", "Variance@GRAD"} if op == "sync_batch_norm" else ()
    # V is overwritten by the first power iteration: its gradient is 0
    zero = {"V@GRAD"} if op == "spectral_norm" else ()
    check_case(op, ins, attrs, ct, skip=skip, zero=zero)


@pytest.mark.parametrize("op", ["pool3d", "max_pool2d_with_index", "spp",
                                "unpool", "sync_batch_norm", "instance_norm",
                                "group_norm", "lrn", "data_norm",
                                "spectral_norm", "embedding", "pad2d",
                                "pad3d", "bilinear_tensor_product"])
def test_grad_slots_follow_the_reference_convention(op):
    grad_slots_match(op)


@pytest.mark.parametrize("attrs", [{"ksize": [2, 2], "strides": [2, 2]},
                                   {"ksize": [3, 2], "strides": [1, 2],
                                    "paddings": [1, 0]}])
def test_max_pool2d_with_index_grad_is_pool2d_max_grad(attrs):
    """jax.grad of the JAX kernel raises (its paired reduce_window;
    ROADMAP.md Queue 3 item 55): the port's X@GRAD is the max pool2d's,
    held to the JAX package's pool2d_grad on the same cotangent."""
    x = f(2, 3, 7, 6)
    out = _run_torch("max_pool2d_with_index", {"X": x}, attrs)
    ct = np.random.RandomState(4).randn(*out["Out"].shape) \
        .astype(np.float32)
    got = _run_torch("max_pool2d_with_index_grad",
                     {"X": x, "Out": out["Out"].numpy(),
                      "Mask": out["Mask"].numpy(), "Out@GRAD": ct}, attrs)
    pattrs = dict(attrs, pooling_type="max")
    want = _run_jax("pool2d_grad", {"X": x, "Out": out["Out"].numpy(),
                                    "Out@GRAD": ct}, pattrs)
    np.testing.assert_allclose(got["X@GRAD"].numpy(), want["X@GRAD"],
                               rtol=1e-5, atol=1e-5)


def test_max_pool3d_with_index_grad_is_the_max_pool_gradient():
    """The JAX package cannot differentiate its paired reduce_window
    (jax.grad raises; ROADMAP.md Queue 3 item 55): the port's gradient is
    the max pool's, each window's dOut on its Mask element."""
    x = f(2, 2, 4, 6, 6)
    attrs = {"ksize": [2, 2, 2], "strides": [2, 2, 2]}
    out = _run_torch("max_pool3d_with_index", {"X": x}, attrs)
    ct = np.random.RandomState(3).randn(*out["Out"].shape) \
        .astype(np.float32)
    g = _run_torch("max_pool3d_with_index_grad",
                   {"X": x, "Out": out["Out"].numpy(),
                    "Mask": out["Mask"].numpy(), "Out@GRAD": ct}, attrs)
    want = np.zeros((2, 2, 4 * 6 * 6), np.float32)
    np.put_along_axis(want, out["Mask"].numpy().reshape(2, 2, -1),
                      ct.reshape(2, 2, -1), axis=2)
    np.testing.assert_allclose(g["X@GRAD"].numpy(), want.reshape(x.shape),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# reference behaviours the port keeps (ROADMAP.md Queue 3)
# ---------------------------------------------------------------------------
def test_max_pool2d_with_index_mask_ignores_paddings_item_54():
    """Queue 3 item 54: with nonzero paddings Out is pooled over the padded
    input, Mask over the unpadded one (their shapes differ), and a tie
    goes to the smallest flat index."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 0, 1] = x[0, 0, 1, 0] = 2.0  # a tie in the first window
    attrs = {"ksize": [2, 2], "strides": [2, 2], "paddings": [1, 1]}
    ref, got = check_case("max_pool2d_with_index", {"X": x}, attrs, None)
    assert ref["Out"].shape == (1, 1, 3, 3)
    assert ref["Mask"].shape == tuple(got["Mask"].shape) == (1, 1, 2, 2)
    assert int(got["Mask"][0, 0, 0, 0]) == 1


def test_max_pool3d_with_index_refuses_adaptive():
    for run in (_run_jax, _run_torch):
        with pytest.raises(NotImplementedError):
            run("max_pool3d_with_index", {"X": f(1, 1, 4, 4, 4)},
                {"ksize": [2, 2, 2], "adaptive": True})


def test_sync_batch_norm_reads_is_test_only_item_56():
    """Queue 3 item 56: sync_batch_norm reads `is_test` only, never
    `use_global_stats`: with it set it still normalizes with the batch
    statistics (batch_norm uses the running ones), in both packages; its
    variance is the one-pass s2 / n - m^2 of the summed squares."""
    x = f(4, 3, 2, 2) + 3.0
    ins = {"X": x, "Scale": np.ones(3, np.float32),
           "Bias": np.zeros(3, np.float32), "Mean": np.zeros(3, np.float32),
           "Variance": np.ones(3, np.float32)}
    attrs = {"use_global_stats": True}
    _, got = check_case("sync_batch_norm", ins, attrs, None)
    bn = _run_torch("batch_norm", ins, attrs)["Y"].numpy()
    np.testing.assert_allclose(bn, x / np.sqrt(1 + 1e-5), rtol=1e-6)
    xd = x.astype(np.float64)
    m = xd.mean(axis=(0, 2, 3))
    v = (xd * xd).mean(axis=(0, 2, 3)) - m * m
    want = (xd - m[:, None, None]) / np.sqrt(v[:, None, None] + 1e-5)
    np.testing.assert_allclose(got["Y"].numpy(), want, rtol=1e-4,
                               atol=1e-4)


def test_group_norm_stats_n_by_groups_instance_norm_saves_inverse_std():
    ref, got = check_case("group_norm", {"X": f(2, 6, 3, 3)},
                          {"groups": 3}, None)
    assert tuple(got["Mean"].shape) == ref["Mean"].shape == (2, 3)
    x = f(2, 3, 4, 4)
    _, got = check_case("instance_norm", {"X": x}, {"epsilon": 1e-5}, None)
    v = x.reshape(6, -1).var(axis=1)
    np.testing.assert_allclose(got["SavedVariance"].numpy(),
                               1 / np.sqrt(v + 1e-5), rtol=1e-5)
