"""Port parity of ``repro_torch.optim.adamw`` against ``repro.optim``:
the three LR schedules, the global norm and clipping, the weight-decay
mask over parameter paths, and ``adamw_update`` (one and several steps,
fp32 and bf16 leaves), on the same numpy values.

Tolerances: fp32 values within rtol 1e-6, atol 1e-7 (the same fp32
formulas evaluated by two libraries: a few ulps); a bf16 leaf within one
bf16 ulp (rtol 2 ** -7), since the updated fp32 value rounds to bf16 on
each side and can land on either neighbour when it sits at a midpoint.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import flatten_with_path, keystr  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-7)


def _tree(seed: int, dtype=np.float32):
    """A parameter tree with every kind of path the decay mask reads."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return rng.randn(*shape).astype(dtype)

    return {"embeddings": {"embed": r(6, 4)},
            "blocks": {"runs": [{"attn": {"wq": r(2, 4, 3), "q_norm": r(3),
                                          "k_norm": r(3)},
                                 "norm1": {"scale": r(2, 4),
                                           "bias": r(2, 4)}},
                                {"ssm": {"a_log": r(2, 5), "d_skip": r(2, 5),
                                         "dt_bias": r(2, 5),
                                         "gate_norm": r(2, 4),
                                         "conv_b": r(2, 4),
                                         "in_proj": r(2, 4, 5)}}]},
            "final_norm": {"scale": r(4)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return params_from_jax(tree, device="cpu")


def _assert_trees(got, want, tol=TOL):
    gflat = {keystr(p): v for p, v in flatten_with_path(got)}
    wflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(gflat) == sorted(wflat)
    for key, w in wflat.items():
        g = gflat[key]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), key
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=key,
                                   **tol)


@pytest.mark.parametrize("schedule", ["cosine", "constant", "linear"])
def test_learning_rate_schedules(schedule):
    cfg = dict(learning_rate=3e-3, warmup_steps=20, total_steps=70,
               schedule=schedule)
    jcfg, tcfg = jadamw.OptimizerConfig(**cfg), tadamw.OptimizerConfig(**cfg)
    for step in (0, 1, 7, 19, 20, 21, 44, 69, 70, 90):
        want = jadamw.learning_rate(jcfg, jnp.asarray(step, jnp.int32))
        got = tadamw.learning_rate(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_global_norm_and_clipping():
    tree = _tree(0)
    np.testing.assert_allclose(float(tadamw.global_norm(_t(tree))),
                               float(jadamw.global_norm(_j(tree))), **TOL)
    for max_norm in (1.0, 1e3):       # clipped, and left as it is
        jclip, jnorm = jadamw.clip_by_global_norm(_j(tree), max_norm)
        tclip, tnorm = tadamw.clip_by_global_norm(_t(tree), max_norm)
        np.testing.assert_allclose(float(tnorm), float(jnorm), **TOL)
        _assert_trees(tclip, jclip)


def test_decay_mask_follows_the_reference_paths():
    tree = _tree(1)
    want = {jax.tree_util.keystr(p): jadamw._is_decayed(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(_j(tree))[0]}
    got = {keystr(p): tadamw._is_decayed(p)
           for p, _ in flatten_with_path(_t(tree))}
    assert got == want
    assert not got["['blocks']['runs'][0]['attn']['q_norm']"]
    assert got["['blocks']['runs'][1]['ssm']['in_proj']"]
    # a list index enters the names too, as the reference's path does
    assert tadamw._is_decayed((("key", "runs"), ("idx", 3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Three steps from the same params and grads (clipped once, the
    decayed and undecayed leaves, the warmup's first steps), the state
    carried over: params, mu, nu, step, lr and grad_norm."""
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
               weight_decay=0.1, grad_clip_norm=20.0)
    jcfg, tcfg = jadamw.OptimizerConfig(**cfg), tadamw.OptimizerConfig(**cfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), _tree(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    js, ts = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    norms = []
    for i in range(3):
        g = _tree(10 + i)
        if i == 0:
            g = jax.tree.map(lambda a: 5 * a, g)    # over the clip norm
        jp, js, jm = jadamw.adamw_update(jcfg, jp, _j(g), js)
        tp, ts, tm = tadamw.adamw_update(tcfg, tp, _t(g), ts)
        _assert_trees(tp, jp, tol)
        _assert_trees(ts.mu, js.mu)
        _assert_trees(ts.nu, js.nu)
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.step.dtype == torch.int32
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL)
        norms.append(float(jm["grad_norm"]))
    # the first step is clipped, the others are not
    assert norms[0] > 20.0 > max(norms[1:])


def test_opt_state_crosses_from_the_reference():
    jp = _j(_tree(3))
    js = jadamw.adamw_update(jadamw.OptimizerConfig(), jp, _j(_tree(4)),
                             jadamw.init_opt_state(jp))[1]
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert isinstance(ts, tadamw.OptState)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 1
    _assert_trees(ts.mu, js.mu, dict(rtol=0, atol=0))
    _assert_trees(ts.nu, js.nu, dict(rtol=0, atol=0))


def test_init_opt_state_is_fp32_zeros_of_the_params_shape():
    tp = params_from_jax(jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), _j(_tree(5))), device="cpu")
    state = tadamw.init_opt_state(tp)
    assert int(state.step) == 0
    for (path, p), (_, m), (_, v) in zip(flatten_with_path(tp),
                                         flatten_with_path(state.mu),
                                         flatten_with_path(state.nu)):
        assert m.shape == p.shape and m.dtype == torch.float32, path
        assert not m.any() and not v.any()
        assert m.data_ptr() != v.data_ptr()


def test_an_update_leaves_no_cycle_holding_tensors():
    """``adamw_update`` and the tree walks under it return every tensor
    they touched to plain reference counting: nothing waits in a reference
    cycle for Python's collector (on the card such cycles held a step's
    old parameters, gradients and moments: tens of GB for zamba2-1.2b)."""
    import gc
    params = params_from_jax(_tree(5), device="cpu")
    grads = params_from_jax(_tree(6), device="cpu")
    state = tadamw.init_opt_state(params)
    gc.collect()
    flags = gc.get_debug()
    gc.disable()
    try:
        for _ in range(2):
            params, state, _ = tadamw.adamw_update(tadamw.OptimizerConfig(),
                                                   params, grads, state)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [x for x in gc.garbage if isinstance(x, torch.Tensor)]
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        gc.enable()
    assert held == []
