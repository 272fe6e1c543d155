"""Port parity of ``repro_torch.models.classifier`` against
``repro.models.classifier``: the forward (GELU in its tanh form, as
``jax.nn.gelu``), ``train_classifier`` and ``train_parity_model`` (ParM's
distillation) from the same initial parameters, and the same minibatch
draws (both take their indices from ``np.random.RandomState(seed)``), and
``accuracy``.

Tolerances: logits within rtol 1e-5, atol 1e-5 (fp32 products in another
order); trained parameters within rtol 1e-4, atol 1e-5 after 40 AdamW
steps (every gradient here sits far above rounding, so Adam's sign-like
first step does not split the two), final losses within rtol 1e-4.
Accuracy is a count of argmaxes: held to within one sample.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import classifier as jcls  # noqa: E402
from repro_torch.models import classifier as tcls  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

CFG = dict(dim=8, hidden=32, depth=2, num_classes=5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    ds = jsyn.SyntheticClassification(num_classes=5, dim=8, seed=0)
    return ds.train_test(256, 64, seed=1)


def _t(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _assert_params(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **PARAM_TOL)


def test_init_and_apply():
    jc, tc = jcls.ClassifierConfig(**CFG), tcls.ClassifierConfig(**CFG)
    params = tcls.init_classifier(tc, torch.Generator().manual_seed(0),
                                  device="cpu")
    assert sorted(params) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    assert params["w1"].shape == (32, 32) and not params["b2"].any()
    assert 0.5 < float(params["w0"].std() * np.sqrt(8)) < 1.5
    jp = jcls.init_classifier(jc, jax.random.PRNGKey(3))
    x = np.random.RandomState(2).randn(7, 8).astype(np.float32)
    np.testing.assert_allclose(
        tcls.classifier_apply(tc, _t(jp), torch.from_numpy(x)).numpy(),
        np.asarray(jcls.classifier_apply(jc, jp, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_train_classifier_matches_reference(data):
    (xs, ys), (xt, yt) = data
    jc, tc = jcls.ClassifierConfig(**CFG), tcls.ClassifierConfig(**CFG)
    kw = dict(steps=40, batch=32, lr=5e-3, seed=4)
    jp, jacc = jcls.train_classifier(jc, xs, ys, **kw)
    init = _t(jcls.init_classifier(jc, jax.random.PRNGKey(4)))
    tp, tacc = tcls.train_classifier(tc, xs, ys, params=init, device="cpu",
                                     **kw)
    _assert_params(tp, jp)
    assert abs(tacc - jacc) <= 1.0 / len(ys)
    assert tacc > 0.5                       # it learned something
    assert abs(tcls.accuracy(tc, tp, xt, yt)
               - jcls.accuracy(jc, jp, xt, yt)) <= 1.0 / len(yt)


def test_train_parity_model_matches_reference(data):
    (xs, _), _ = data
    jc, tc = jcls.ClassifierConfig(**CFG), tcls.ClassifierConfig(**CFG)
    base = jcls.init_classifier(jc, jax.random.PRNGKey(7))
    kw = dict(steps=40, batch=16, lr=5e-3, seed=1)
    jpar, jloss = jcls.train_parity_model(jc, base, xs, 3, **kw)
    init = _t(jcls.init_classifier(jc, jax.random.PRNGKey(1 + 100)))
    tpar, tloss = tcls.train_parity_model(tc, _t(base), xs, 3, parity=init,
                                          device="cpu", **kw)
    _assert_params(tpar, jpar)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


def test_defaults_draw_their_own_parameters(data):
    """Without initial parameters each side draws its own from ``seed``
    (the port from a torch generator): training still runs and learns."""
    (xs, ys), _ = data
    tc = tcls.ClassifierConfig(**CFG)
    tp, acc = tcls.train_classifier(tc, xs, ys, steps=60, batch=32, lr=5e-3,
                                    device="cpu")
    assert acc > 0.5 and sorted(tp) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    par, loss = tcls.train_parity_model(tc, tp, xs, 2, steps=5, batch=8,
                                        device="cpu")
    assert np.isfinite(loss) and par["w0"].shape == (8, 32)
