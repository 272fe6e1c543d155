"""The gradient of prefill attention, against the reference's.

The reference trains through XLA's autodiff of
``repro.kernels.ref.attention_ref`` (its Pallas kernel has no backward),
so that is the gradient the port must give.  On the same numpy inputs:
``ref.attention_bwd_ref`` (the plain version of B3's backward kernel,
written out from the row log-sum-exp) and autograd of the port's
``ref.attention_ref`` against ``jax.grad`` of the reference's, over the
causal, sliding-window, prefix-LM, softcap and ``q_offset`` rules, GQA at
1, 2 and 8 q-heads a kv-head, and head dims 64 and 80;
``ref.attention_lse_ref`` against the log-sum-exp of the reference's
masked scores.  Then the wiring the card uses, on the CPU:
``FlashAttentionFn`` with its two launches replaced by their plain
versions, ``ops.attention``'s choice of it under grad, and the guard that
makes every kernel without a backward raise under grad on the card (the
SSD scan's gradient is ``tests/test_torch_ssd_grad.py``'s).

Tolerances: gradients within rtol 1e-5 and atol 1e-5 x max |grad| (fp32
sums of up to 40 terms taken in another order, and the plain backward
rebuilds P from the log-sum-exp where autodiff keeps the softmax); the
log-sum-exp within rtol 1e-6, atol 1e-6.  A row that sees no key is held
apart: B3 gives it a zero output and gradient, ``attention_ref`` a
uniform mean.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402

LSE_TOL = dict(rtol=1e-6, atol=1e-6)
RULES = [dict(), dict(window=7), dict(prefix=9), dict(softcap=3.0),
         dict(q_offset=5), dict(causal=False), dict(prefix=5, window=11),
         dict(softcap=2.0, q_offset=3, window=6)]
HEADS = [(4, 4), (4, 2), (8, 1)]       # GQA at rep 1, 2 and 8


def _inputs(seed, b, s, h, kv, d, q_offset=0):
    rng = np.random.RandomState(seed)
    l_len = s + q_offset
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, l_len, kv, d).astype(np.float32)
    v = rng.randn(b, l_len, kv, d).astype(np.float32)
    do = rng.randn(b, s, h, d).astype(np.float32)
    return q, k, v, do


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=1e-5,
        atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _reference_grads(q, k, v, do, rule):
    def f(q, k, v):
        return jnp.vdot(jref.attention_ref(q, k, v, **rule), do)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("heads", HEADS, ids=lambda t: f"{t[0]}-{t[1]}")
@pytest.mark.parametrize("rule", RULES, ids=lambda r: str(r) or "causal")
def test_backward_matches_jax_grad(rule, heads, d):
    h, kv = heads
    q, k, v, do = _inputs(d + h, 2, 24, h, kv, d, rule.get("q_offset", 0))
    want = _reference_grads(q, k, v, do, rule)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = ref.attention_ref(tq, tk, tv, **rule)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    lse = ref.attention_lse_ref(tq, tk, **rule)
    plain = ref.attention_bwd_ref(tq, tk, tv, out.detach(), lse,
                                  torch.from_numpy(do), **rule)
    for got_auto, got_plain, w in zip(auto, plain, want):
        _close(got_auto, w)
        _close(got_plain, w)


@pytest.mark.parametrize("rule", RULES, ids=lambda r: str(r) or "causal")
def test_lse_matches_reference_scores(rule):
    q, k, _, _ = _inputs(7, 2, 24, 4, 2, 64, rule.get("q_offset", 0))
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = (jnp.asarray(q) / jnp.sqrt(d).astype(jnp.float32)).reshape(
        b, s, kv, h // kv, d)
    scores = jnp.einsum("bsgrd,blgd->bgrsl", qg, jnp.asarray(k))
    cap = rule.get("softcap", 0.0)
    if cap:
        scores = cap * jnp.tanh(scores / cap)
    bias = jref._mask_bias(s, k.shape[1], causal=rule.get("causal", True),
                           window=rule.get("window"),
                           prefix=rule.get("prefix", 0),
                           q_offset=rule.get("q_offset", 0))
    want = jax.nn.logsumexp(jnp.where(bias == 0.0, scores, -jnp.inf), -1)
    got = ref.attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                **rule)
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(b, h, s), **LSE_TOL)


def test_rows_that_see_no_key():
    """q_offset -5: the first five rows see no key.  Their log-sum-exp is
    -inf and the plain backward gives them dq = 0 and nothing to dk, dv;
    the other rows' gradients are the reference's on the seen rows."""
    q, k, v, do = _inputs(3, 1, 20, 4, 2, 64)
    do[:, :5] = 0.0        # the reference's uniform rows then add nothing
    rule = dict(q_offset=-5)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = ref.attention_lse_ref(tq, tk, **rule)
    assert torch.isneginf(lse[:, :, :5]).all()
    assert torch.isfinite(lse[:, :, 5:]).all()
    out = ref.attention_ref(tq, tk, tv, **rule)
    out[:, :5] = 0.0                    # B3's output for those rows
    dq, dk, dv = ref.attention_bwd_ref(tq, tk, tv, out, lse,
                                       torch.from_numpy(
                                           _inputs(4, 1, 20, 4, 2, 64)[3]),
                                       **rule)
    assert not dq[:, :5].any()
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    want = _reference_grads(q, k, v, do, rule)
    got = ref.attention_bwd_ref(tq, tk, tv, out, lse, tdo, **rule)
    _close(got[0][:, 5:], np.asarray(want[0])[:, 5:])
    _close(got[1], want[1])
    _close(got[2], want[2])


@pytest.mark.parametrize("heads", HEADS, ids=lambda t: f"{t[0]}-{t[1]}")
@pytest.mark.parametrize("rule", RULES, ids=lambda r: str(r) or "causal")
def test_delta_matches_reference(rule, heads):
    """``ref.attention_delta_ref`` (the plain version of the backward's
    first launch) on the reference's output: each row's rowsum(dO * o)
    equals sum_j P_ij dP_ij built from the reference's masked softmax and
    dO v^T, and each kv-head's rows add up to sum_j dv_j . v_j with dv
    from ``jax.grad`` of the reference's ``attention_ref``."""
    h, kv = heads
    q, k, v, do = _inputs(31 + h, 2, 16, h, kv, 64, rule.get("q_offset", 0))
    b, s, _, d = q.shape
    out = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **rule)
    got = ref.attention_delta_ref(torch.from_numpy(np.array(out)),
                                  torch.from_numpy(do))
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    qg = (jnp.asarray(q) / jnp.sqrt(d).astype(jnp.float32)).reshape(
        b, s, kv, h // kv, d)
    scores = jnp.einsum("bsgrd,blgd->bgrsl", qg, jnp.asarray(k))
    cap = rule.get("softcap", 0.0)
    if cap:
        scores = cap * jnp.tanh(scores / cap)
    bias = jref._mask_bias(s, k.shape[1], causal=rule.get("causal", True),
                           window=rule.get("window"),
                           prefix=rule.get("prefix", 0),
                           q_offset=rule.get("q_offset", 0))
    probs = jax.nn.softmax(jnp.where(bias == 0.0, scores, -jnp.inf), -1)
    dp = jnp.einsum("bsgrd,blgd->bgrsl",
                    jnp.asarray(do).reshape(b, s, kv, h // kv, d),
                    jnp.asarray(v))
    want = np.asarray((probs * dp).sum(-1)).reshape(b, h, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    _, _, dv = _reference_grads(q, k, v, do, rule)
    per_group = np.einsum("blgd,blgd->bg", np.asarray(dv), v)
    np.testing.assert_allclose(got.numpy().reshape(b, kv, -1).sum(-1),
                               per_group, rtol=1e-4, atol=1e-4)


def test_backward_wrappers_refuse_cpu_tensors():
    """The Delta launch, the backward and ``bwd_info`` run on the card
    only: CPU tensors are refused before any build (``ops`` takes the
    plain versions for them)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, 1, 8, 4, 2, 64))
    lse = ref.attention_lse_ref(q, k)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention.flash_attention_bwd_delta(q, do)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention.flash_attention_bwd(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention.bwd_info(64, torch.float32, torch.device("cpu"))


def _plain_launches(monkeypatch):
    """Replace B3's two launches by their plain versions, counting calls."""
    calls = {"forward": 0, "backward": 0}

    def forward(q, k, v, return_lse=False, **rule):
        calls["forward"] += 1
        out = ref.attention_ref(q, k, v, **rule)
        return (out, ref.attention_lse_ref(q, k, **rule)) if return_lse \
            else out

    def backward(q, k, v, o, lse, do, **rule):
        calls["backward"] += 1
        return ref.attention_bwd_ref(q, k, v, o, lse, do, **rule)

    monkeypatch.setattr(flash_attention, "flash_attention", forward)
    monkeypatch.setattr(flash_attention, "flash_attention_bwd", backward)
    return calls


@pytest.mark.parametrize("rule", [dict(), dict(window=5, softcap=2.0),
                                  dict(prefix=6)],
                         ids=["causal", "window-softcap", "prefix"])
def test_autograd_function_wiring(monkeypatch, rule):
    """``FlashAttentionFn`` saves what its backward launch reads and hands
    the gradients back in order: with plain launches it gives autograd's
    gradients of ``attention_ref``, one launch each way."""
    calls = _plain_launches(monkeypatch)
    q, k, v, do = _inputs(11, 2, 16, 8, 2, 64)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    rule_args = (rule.get("causal", True), rule.get("window"),
                 rule.get("prefix", 0), rule.get("softcap", 0.0), 0)
    out = flash_attention.FlashAttentionFn.apply(*args, *rule_args)
    got = torch.autograd.grad(out, args, torch.from_numpy(do))
    assert calls == {"forward": 1, "backward": 1}
    want = _reference_grads(q, k, v, do, rule)
    for g, w in zip(got, want):
        _close(g, w)


def test_autograd_function_refuses_double_backward(monkeypatch):
    """The backward kernel writes its gradients by pointer and has no
    backward of its own: a second-order gradient through
    ``FlashAttentionFn`` raises instead of silently losing its terms."""
    _plain_launches(monkeypatch)
    q, k, v, do = _inputs(13, 1, 8, 4, 2, 64)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention.FlashAttentionFn.apply(*args, True, None, 0,
                                                 0.0, 0)
    # dO comes from the graph above attention, as in a gradient penalty
    do = torch.from_numpy(do).requires_grad_(True)
    dq, _, _ = torch.autograd.grad(out, args, do, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_ops_routes_grad_to_the_autograd_function(monkeypatch):
    """On the card ``ops.attention`` takes ``FlashAttentionFn`` when grad is
    enabled and an input requires it, and the plain launch otherwise."""
    calls = _plain_launches(monkeypatch)
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(12, 1, 8, 4, 2, 64))
    ops.attention(q, k, v)
    assert calls == {"forward": 1, "backward": 0}
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        out = ops.attention(qg, k, v)
    assert out.grad_fn is None
    out = ops.attention(qg, k, v)
    assert out.grad_fn is not None
    out.backward(do)
    assert calls == {"forward": 3, "backward": 1}
    assert qg.grad is not None and qg.grad.abs().sum() > 0


GUARDED = {
    "berrut_apply": lambda x: ops.berrut_apply(torch.ones(3, 2), x),
    "berrut_encode_dispatch": lambda x: ops.berrut_encode_dispatch(
        torch.ones(3, 2), x),
    "fused_group_decode": lambda x: ops.fused_group_decode(
        x, torch.ones(2), torch.zeros(1), torch.zeros(2)),
    "flash_decode": lambda x: ops.decode_attention(
        x[..., None], x[..., None], x[..., None], torch.ones(1, 2)),
    "pool_flash_decode": lambda x: ops.pool_decode_attention(
        x[..., None], x[..., None], x[..., None], torch.zeros(1)),
    "ssd_chunk_scores": lambda x: ops.ssd_chunk_scores(x, x),
}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernels_without_backward_raise_under_grad_on_the_card(monkeypatch,
                                                               name):
    """Every kernel entry but attention and the SSD scan refuses, on the
    card, an input that requires grad while grad is enabled, naming itself
    and its ROADMAP queue entry; under ``no_grad`` it goes on to its
    launch."""
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    x = torch.ones(1, 2, 2).requires_grad_(True)
    with pytest.raises(RuntimeError, match=rf"{name} has no backward kernel "
                                           r"on the card \(ROADMAP B"):
        GUARDED[name](x)
    with torch.no_grad(), pytest.raises(ValueError, match="one CUDA device"):
        GUARDED[name](x)            # past the guard: the launch's checks
