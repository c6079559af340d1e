"""vision.models.resnet18 at img 32 with 10 classes in dygraph, the port
against the JAX package (the helpers and the gates' reasons are in
test_torch_vision_models.py): the eval forward, 3 train-mode Momentum
steps each from the JAX package's state, and one O1 step."""
import numpy as np

from test_torch_amp_dygraph import jax_amp_cotangents  # noqa: F401
from test_torch_vision_ops import contained_state  # noqa: F401
from test_torch_vision_models import (_eval, _state, _steps, batch,
                                      o1_step_check, vision_pair)


def test_resnet18_eval_forward_and_momentum_steps_match_jax():
    """resnet18 at img 32: layer4 is 1x1, so its batch norms normalise 4
    values a channel, and fp32 gradients are good to ~1e-4 relative only
    (measured: the JAX package's are 1.2e-4 and the port's 6.9e-5 off a
    float64 run of the port).  Momentum amplifies that 10-200x a step
    (measured at lr 1e-3 to 1e-2), so two fp32 runs of 3 free steps part
    (by 0.18 in a running variance at lr 1e-2).  Each step is therefore
    held from the JAX package's state (`forced`):
    losses rtol 1e-5, running stats rtol = atol = 1e-5, updates within a
    normalised 1e-3; the eval forward equal before training and, with
    the trained running stats, after it."""
    jm, tm = vision_pair("resnet18")
    x, y = batch("resnet18")
    ref, got = _eval(jm, tm, x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    rl, gl = _steps(jm, tm, x, y, 3, forced=True)
    assert np.all(np.isfinite(gl)) and gl[-1] < gl[0]
    np.testing.assert_allclose(gl, rl, rtol=1e-5)
    tm.set_state_dict(jm.state_dict())
    assert not np.array_equal(_state(tm)["bn1._mean"], 0)
    ref, got = _eval(jm, tm, x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_resnet18_o1_step_matches_jax(jax_amp_cotangents):  # noqa: F811
    """bf16 noise in layer4's 1x1 batch norms moves each package's O1 loss
    1.7-9% off its fp32 loss (seeds 2-3); the two O1 losses are 0.4-1.2%
    apart, so rtol 3e-2."""
    o1_step_check("resnet18", 3e-2)
