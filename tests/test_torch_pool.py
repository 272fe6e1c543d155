"""Port parity of the slot-pool decode: the plain version of
``pool_flash_decode``, the per-stream branch of ``attention_decode`` and
the pool serving steps, against the JAX reference on the same numpy
inputs.

``ref.pool_decode_attention_ref`` is held against the reference's
oracle of the Pallas kernel on every row (rows that see no key are exact
zeros in both); ``ops.pool_decode_attention`` against the reference's
XLA path on live rows only, since that path gives a uniform softmax on a
dead row.  fp32 agrees to float32 rounding of another summation order
(rtol 1e-5, atol 1e-6).  The pool steps run several rounds with
admissions mid-flight and stragglers, at E=0 and at E=1 with an attacker
whose noise is the reference's own draw: decoded logits within rtol 1e-5
and atol 1e-4, greedy tokens, ``located`` and the slot positions exactly.
The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.configs import qwen3_0_6b as jcfg  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch.configs import qwen3_0_6b as tcfg  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.kernels import flash_decode, ops, ref  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)

# (B, W, H, KV, D, pos, live): mixed depths, ring wraps, dead rows
ATTN_CASES = {
    "mixed_pos": (5, 40, 8, 2, 64, [0, 7, 16, 31, 39], None),
    "ring_wrap": (4, 24, 8, 2, 64, [23, 24, 30, 55], None),
    "dead_rows": (5, 40, 8, 2, 64, [3, 12, 39, 50, 0], [1, 0, 1, 0, 1]),
    "mha": (3, 33, 4, 4, 64, [1, 20, 40], [1, 1, 0]),
    "gqa2": (3, 33, 8, 4, 128, [5, 32, 9], None),
    "gqa4": (3, 33, 16, 4, 128, [0, 15, 60], [0, 1, 1]),
    "mqa": (3, 33, 8, 1, 64, [2, 17, 32], [1, 0, 1]),
}


def _attn_inputs(case, seed=0):
    b, w, h, kv, d, pos, live = ATTN_CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, w, kv, d).astype(np.float32)
    v = rng.randn(b, w, kv, d).astype(np.float32)
    live = None if live is None else np.asarray(live, np.int32)
    return q, k, v, np.asarray(pos, np.int32), live


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_pool_attention_plain_matches_reference_oracle(case):
    q, k, v, pos, live = _attn_inputs(case)
    got = ref.pool_decode_attention_ref(_t(q), _t(k), _t(v), _t(pos),
                                        _t(live))
    want = jref.pool_decode_attention_ref(_j(q), _j(k), _j(v), _j(pos),
                                          _j(live))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if live is not None:
        assert not got.numpy()[live == 0].any()       # exact zeros


def test_pool_attention_plain_int8_softcap_matches_reference_oracle():
    q, k, v, pos, live = _attn_inputs("dead_rows", seed=1)
    k8 = np.clip(np.round(k * 32.0), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(v * 32.0), -127, 127).astype(np.int8)
    kw = dict(softcap=15.0, kv_scale=32.0)
    got = ops.pool_decode_attention(_t(q), _t(k8), _t(v8), _t(pos),
                                    _t(live), **kw)
    want = jref.pool_decode_attention_ref(_j(q), _j(k8), _j(v8), _j(pos),
                                          _j(live), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_pool_attention_dispatch_matches_xla_path_on_live_rows(case):
    q, k, v, pos, live = _attn_inputs(case, seed=2)
    got = ops.pool_decode_attention(_t(q), _t(k), _t(v), _t(pos), _t(live))
    with jops.force_kernel("xla"):
        want = np.asarray(jops.pool_decode_attention(
            _j(q), _j(k), _j(v), _j(pos), _j(live)))
    rows = np.ones(len(pos), bool) if live is None else live > 0
    np.testing.assert_allclose(got.numpy()[rows], want[rows], **TOL)


def test_pool_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, pos, live = (_t(a) for a in _attn_inputs("dead_rows"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode.pool_flash_decode(q, k, v, pos, live)


# ------------------------------------------------------------ pool steps

K, P, PROMPT = 2, 2, 8
MAX_LEN = PROMPT + 6


@pytest.fixture(scope="module")
def model():
    jc, tc = jcfg.reduced(), tcfg.reduced()
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


# per round: (admitted slots, active slots); slot 0 retires after round 2
# and is re-admitted while slot 1 decodes
ROUNDS = [((0,), ()), ((1,), (0,)), ((), (0, 1)), ((0,), (1,)),
          ((), (0, 1))]


def _jit_pool_steps(jc, coding):
    prefill = jax.jit(
        lambda p, st, t, a, m, bm, br: jcs.coded_pool_prefill(
            jc, coding, p, st, {"tokens": t}, MAX_LEN, a, straggler_mask=m,
            byz_mask=bm, byz_rng=br, byz_sigma=10.0, with_report=True))
    decode = jax.jit(
        lambda p, st, t, a, m, bm, br: jcs.coded_pool_decode_step(
            jc, coding, p, st, t, a, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True))
    return prefill, decode


@pytest.mark.parametrize("e", [0, 1])
def test_pool_steps_match_reference(model, e):
    jc, tc, jp, tp = model
    jcoding, tcoding = JCoding(k=K, s=1, e=e), TCoding(k=K, s=1, e=e)
    n1 = jcoding.num_workers
    rng = np.random.RandomState(20 + e)
    byz = np.zeros(n1, np.float32)
    if e:
        byz[4] = 1.0
    jprefill, jdecode = _jit_pool_steps(jc, jcoding)
    jstate = jcs.init_pool_state(jc, jcoding, P, MAX_LEN)
    tstate = tcs.init_pool_state(tc, tcoding, P, MAX_LEN, "cpu")
    fresh = tcs.init_caches(tc, P * n1, MAX_LEN, torch.float32, "cpu")
    prompts = np.zeros((P * K, PROMPT), np.int32)
    nxt = np.zeros((P * K, 1), np.int32)
    key = jax.random.PRNGKey(9)
    with jops.force_kernel("xla"):
        for admitted, active in ROUNDS:
            m = np.ones(n1, np.float32)
            m[rng.choice([i for i in range(n1) if not byz[i]])] = 0.0
            key, sub = jax.random.split(key)
            noise = np.array(jax.random.normal(
                sub, (P, n1, jc.vocab_size), jnp.float32))
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
                         with_report=True)
            jargs = (jnp.asarray(m), jnp.asarray(byz), sub)
            calls = []
            if admitted:
                a = np.zeros(P, np.float32)
                a[list(admitted)] = 1.0
                for s in admitted:
                    prompts[s * K:(s + 1) * K] = rng.randint(
                        0, jc.vocab_size, (K, PROMPT))
                jl, jstate, jrep = jprefill(jp, jstate, jnp.asarray(prompts),
                                            jnp.asarray(a), *jargs)
                tl, tstate, trep = tcs.coded_pool_prefill(
                    tc, tcoding, tp, tstate,
                    {"tokens": torch.from_numpy(prompts)}, a, fresh,
                    **targs)
                calls.append((a, jl, jrep, tl, trep))
            if active:
                a = np.zeros(P, np.float32)
                a[list(active)] = 1.0
                jl, jstate, jrep = jdecode(jp, jstate, jnp.asarray(nxt),
                                           jnp.asarray(a), *jargs)
                tl, tstate, trep = tcs.coded_pool_decode_step(
                    tc, tcoding, tp, tstate, torch.from_numpy(nxt), a,
                    **targs)
                calls.append((a, jl, jrep, tl, trep))
            for a, jl, (jloc, jvotes), tl, (tloc, tvotes) in calls:
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           **LOGITS_TOL)
                toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
                np.testing.assert_array_equal(tl.argmax(-1).numpy(), toks)
                np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
                np.testing.assert_array_equal(tvotes.numpy(),
                                              np.asarray(jvotes))
                rows = np.repeat(a > 0, K)
                nxt[rows, 0] = toks[rows]
                if e:
                    # the attacker is located in every live group
                    assert tloc.numpy()[a > 0, 4].all()
            np.testing.assert_array_equal(tstate.pos.numpy(),
                                          np.asarray(jstate.pos))
    assert tstate.pos.dtype == torch.int32


def test_pool_prefill_copies_only_admitted_streams(model):
    _, tc, _, tp = model
    coding = TCoding(k=K, s=1)
    n1 = coding.num_workers
    state = tcs.init_pool_state(tc, coding, P, MAX_LEN, "cpu")
    for leaf in state.caches[0].values():
        leaf.fill_(7.0)
    # scratch reused from an earlier call: stale values everywhere
    fresh = tcs.init_caches(tc, P * n1, MAX_LEN, torch.float32, "cpu")
    for cache in fresh:
        for leaf in cache.values():
            leaf.fill_(-3.0)
    prompts = torch.from_numpy(np.random.RandomState(1).randint(
        0, tc.vocab_size, (P * K, PROMPT)))
    _, state = tcs.coded_pool_prefill(tc, coding, tp, state,
                                      {"tokens": prompts},
                                      np.array([0.0, 1.0], np.float32), fresh)
    k = state.caches[0]["k"]
    assert (k[:, :n1] == 7.0).all()                  # slot 0 untouched
    assert not (k[:, n1:, :PROMPT] == 7.0).any()     # slot 1 prefilled
    assert not k[:, n1:, PROMPT:].any()              # zeroed beyond
    assert state.pos.tolist() == [0, PROMPT]
