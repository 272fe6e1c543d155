"""Port parity of the vlm and audio frontends: paligemma-3b (SigLIP patch
embeddings projected in front of the text, prefix-LM attention over the
patches, MQA, GeGLU, tied embeddings) and hubert-xlarge (frame
embeddings projected into a non-causal encoder, LayerNorm, GELU) in
their ``reduced()`` sizes, against ``repro.models`` and
``repro.serving.coded_serving`` on the reference's XLA path.

Both vision tower and conv feature extractor are stubs in the reference
itself: the inputs are precomputed patch and frame embeddings, drawn
here from a numpy seed.  The port runs on the reference's own parameters
(``params_from_jax``).  Tolerances: fp32 logits, caches and losses
within ``LOGITS_TOL`` (rtol 1e-5, atol 1e-4, ``tests/_torch_parity.py``'s
``COLUMN_TOL``: a different summation order in every product), the
residual-stream inputs within ``EMBED_TOL`` (one product each), greedy
tokens and locator verdicts exactly, raw vote tallies within one pick
(ROADMAP C).  The port's decode against its own full forward within
``DECODE_TOL`` (rtol 1e-4, atol 1e-4; the reference's own test allows
2e-2).
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import COLUMN_TOL  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import embed_inputs as j_embed_inputs  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import predict_fn as j_predict_fn  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import multihost, serve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402
from test_torch_serving import _rounds  # noqa: E402

VLM, AUDIO = "paligemma-3b", "hubert-xlarge"
ARCHS = [VLM, AUDIO]
LOGITS_TOL = COLUMN_TOL
EMBED_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
TEXT, FRAMES = 8, 20            # reduced text length; hubert frames
STEPS = 3                       # decode steps (``_rounds`` gives 1 + 3)
POOL = 2


@pytest.fixture(scope="module")
def models():
    """(reference config, port config, reference params, port params) of
    each reduced frontend, built once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = jconfigs.get_reduced(arch), configs.get_reduced(arch)
            jp = j_init_params(jc, jax.random.PRNGKey(0))
            tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
            cache[arch] = (jc, tc, jp, tp)
        return cache[arch]

    return get


def _inputs(cfg, batch: int, seed: int, text: int = TEXT) -> dict:
    """numpy modality inputs of a reduced frontend: vlm patches and text
    tokens, or audio frames with their per-frame cluster targets."""
    rng = np.random.RandomState(seed)
    if cfg.modality == "vlm":
        return {"patches": rng.randn(batch, cfg.num_patches,
                                     cfg.frontend_dim).astype(np.float32),
                "tokens": rng.randint(0, cfg.vocab_size, (batch, text))}
    return {"frames": rng.randn(batch, FRAMES,
                                cfg.frontend_dim).astype(np.float32),
            "targets": rng.randint(0, cfg.vocab_size, (batch, FRAMES))}


def _torch(inputs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _jax(inputs: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in inputs.items()}


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_and_param_counts_match_reference(arch, models):
    for jc, tc in ((jconfigs.get_config(arch), configs.get_config(arch)),
                   (jconfigs.get_reduced(arch), configs.get_reduced(arch))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
    full = configs.get_config(arch)
    if arch == VLM:
        assert (full.head_dim, full.num_kv_heads, full.num_patches,
                full.prefix_lm, full.tie_embeddings) == (256, 1, 256, True,
                                                        True)
    else:
        assert (full.head_dim, full.causal, full.frontend_dim) == (80, False,
                                                                   512)
        # reduced() sets head_dim=0: d_model // num_heads is derived
        assert configs.get_reduced(arch).head_dim == 64
    # the port's own draw has the reference's tree and shapes, and the
    # analytic count is its matrices' (norms not counted)
    _, tc, jp, _ = models(arch)
    own = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), own,
                        is_leaf=torch.is_tensor) == shapes
    emb = own["embeddings"]
    assert tuple(emb["frontend_proj"].shape) == (tc.frontend_dim, tc.d_model)
    assert ("lm_head" in emb) == (not tc.tie_embeddings)
    counted = sum(t.numel() for name, t in emb.items())
    for run in own["blocks"]["runs"]:
        for block in ("attn", "mlp"):
            counted += sum(t.numel() for t in run[block].values())
    assert counted == tc.param_count()


# ------------------------------------------------------------- embeddings

@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_and_project_frontend_match_reference(arch, models):
    """``project_frontend`` alone, and ``embed_inputs`` on the modality
    dict: audio frames projected; vlm patches projected, then the scaled
    token embeddings after them (and the patches alone without text);
    ``"embeddings"`` bypasses the frontend.  ``frontend_proj`` crosses
    through ``params_from_jax`` as it is."""
    jc, tc, jp, tp = models(arch)
    np.testing.assert_array_equal(
        tp["embeddings"]["frontend_proj"].numpy(),
        np.asarray(jp["embeddings"]["frontend_proj"]))
    inputs = _inputs(tc, 3, 1)
    key = "patches" if tc.modality == "vlm" else "frames"
    got = tlayers.project_frontend(tc, tp["embeddings"],
                                   torch.from_numpy(inputs[key]).double())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayers.project_frontend(
            jc, jp["embeddings"], jnp.asarray(inputs[key]))), **EMBED_TOL)
    cases = [inputs]
    if tc.modality == "vlm":
        cases.append({"patches": inputs["patches"]})
    for case in cases:
        got = tmodel.embed_inputs(tc, tp, _torch(case))
        want = np.asarray(j_embed_inputs(jc, jp, _jax(case)))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, **EMBED_TOL)
    length = tc.num_patches + TEXT if tc.modality == "vlm" else FRAMES
    assert tuple(tmodel.embed_inputs(tc, tp, _torch(inputs)).shape) == (
        3, length, tc.d_model)
    emb = np.random.RandomState(2).randn(3, 5, tc.d_model).astype(np.float32)
    np.testing.assert_array_equal(
        tmodel.embed_inputs(tc, tp, {"embeddings": torch.from_numpy(emb),
                                     key: torch.from_numpy(inputs[key])})
        .numpy(), emb)


# ------------------------------------------------------------- forward, loss

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_predict_and_loss_match_reference(arch, models):
    """``forward`` on the modality dict (logits and the zero aux),
    ``predict_fn`` on embeddings, and ``lm_loss``: the vlm's next-token
    loss over the text suffix only (no targets), with targets and with a
    loss mask; hubert's per-frame CE against its cluster targets, with
    and without a loss mask."""
    jc, tc, jp, tp = models(arch)
    b = 2
    inputs = _inputs(tc, b, 3)
    rng = np.random.RandomState(4)
    if tc.modality == "vlm":
        t = 5
        targets = rng.randint(0, tc.vocab_size, (b, t))
        model_in = inputs
        batches = {"suffix": inputs,
                   "targets": {**inputs, "targets": targets},
                   "loss_mask": {**inputs, "targets": targets,
                                 "loss_mask": (rng.rand(b, t) < 0.6).astype(
                                     np.float32)}}
    else:
        model_in = {"frames": inputs["frames"]}
        batches = {"targets": inputs,
                   "loss_mask": {**inputs, "loss_mask": (rng.rand(
                       b, FRAMES) < 0.6).astype(np.float32)}}
    emb = rng.randn(b, 11, tc.d_model).astype(np.float32)
    with jops.force_kernel("xla"):
        jl, jaux = j_forward(jc, jp, _jax(model_in))
        jpred = j_predict_fn(jc, jp)(jnp.asarray(emb))
        jloss = {k: j_lm_loss(jc, jp, _jax(v)) for k, v in batches.items()}
    tl, taux = tmodel.forward(tc, tp, _torch(model_in))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    assert sorted(taux) == sorted(jaux)
    assert all(float(v) == float(jaux[k]) == 0.0 for k, v in taux.items())
    tpred = tmodel.predict_fn(tc, tp)(torch.from_numpy(emb))
    assert tpred.dtype == torch.float32 and tpred.shape == (b, tc.vocab_size)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               **LOGITS_TOL)
    for key, batch in batches.items():
        total, metrics = tmodel.lm_loss(tc, tp, _torch(batch))
        jtotal, jmetrics = jloss[key]
        assert sorted(metrics) == sorted(jmetrics)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
        for name, val in metrics.items():
            np.testing.assert_allclose(float(val), float(jmetrics[name]),
                                       rtol=1e-5, atol=1e-7)
    if tc.modality == "vlm":
        # the suffix loss is the text positions' CE, by hand
        logp = torch.log_softmax(tl[:, -TEXT:-1].double(), -1)
        nxt = torch.from_numpy(inputs["tokens"][:, 1:])
        by_hand = -logp.gather(-1, nxt[..., None])[..., 0].mean()
        np.testing.assert_allclose(
            float(tmodel.lm_loss(tc, tp, _torch(inputs))[0]),
            float(by_hand), rtol=1e-5)


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("rule,h,kvh,d,s", [
    ("prefix", 8, 1, 256, 40), ("prefix", 4, 1, 64, 33),
    ("noncausal", 4, 4, 80, 37), ("noncausal", 4, 4, 64, 20)],
    ids=["prefix-d256-mqa", "prefix-d64", "noncausal-d80", "noncausal-d64"])
def test_plain_attention_matches_reference(rule, h, kvh, d, s):
    """The port's plain attention (a CPU tensor's path of
    ``ops.attention``) under the two frontends' rules, against
    ``repro.kernels.ops.attention`` on its XLA path: prefix-LM at the
    reduced ``num_patches`` (rows inside the prefix see every prefix key,
    keys ahead of them included) and non-causal; paligemma's full heads
    (8 q-heads on 1 kv-head of 256) and hubert's head_dim 80 among them."""
    prefix = 16 if rule == "prefix" else 0
    causal = rule == "prefix"
    rng = np.random.RandomState(5)
    q = rng.randn(2, s, h, d).astype(np.float32)
    k = rng.randn(2, s, kvh, d).astype(np.float32)
    v = rng.randn(2, s, kvh, d).astype(np.float32)
    with jops.force_kernel("xla"):
        want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, prefix=prefix)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal, prefix=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # a prefix row is not the causal one: the rule is really applied
    if prefix:
        plain = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v))
        assert not torch.allclose(plain[:, :prefix - 1], got[:, :prefix - 1])
        torch.testing.assert_close(plain[:, prefix:], got[:, prefix:])


# ------------------------------------------------------------- serving path

def test_vlm_prefill_decode_and_caches_match_reference(models):
    """paligemma's prefill over patches and text (prefix-LM), then decode
    steps of text tokens from position ``num_patches + text``: logits,
    greedy tokens and every layer's KV cache against the reference's."""
    jc, tc, jp, tp = models(VLM)
    b = 3
    inputs = _inputs(tc, b, 6)
    s = tc.num_patches + TEXT
    max_len = s + STEPS + 1
    with jops.force_kernel("xla"):
        jl, jcache = j_prefill(jc, jp, _jax(inputs),
                               j_init_caches(jc, b, max_len))
        tl, tcache = tmodel.prefill(
            tc, tp, _torch(inputs),
            tmodel.init_caches(tc, b, max_len, torch.float32, "cpu"))
        for step in range(STEPS + 1):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1))
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            if step == STEPS:
                break
            jl, jcache = j_decode_step(jc, jp, jcache,
                                       {"tokens": jnp.asarray(nxt)[:, None]},
                                       jnp.asarray(s + step, jnp.int32))
            tl, tcache = tmodel.decode_step(
                tc, tp, tcache, {"tokens": torch.tensor(nxt)[:, None]},
                s + step)
    for jr, tr in zip(jcache, tcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(tr[name].numpy(),
                                       np.asarray(jr[name]), **LOGITS_TOL)


def test_vlm_prefill_decode_matches_forward(models):
    """The port's serving path against its own full forward: prefill the
    patches and T text tokens, decode one more."""
    _, tc, _, tp = models(VLM)
    inputs = _torch(_inputs(tc, 2, 7, text=TEXT + 1))
    full, _ = tmodel.forward(tc, tp, inputs)
    caches = tmodel.init_caches(tc, 2, 64, torch.float32, "cpu")
    pre, caches = tmodel.prefill(
        tc, tp, {"patches": inputs["patches"],
                 "tokens": inputs["tokens"][:, :-1]}, caches)
    torch.testing.assert_close(pre, full[:, -2], **DECODE_TOL)
    dec, _ = tmodel.decode_step(tc, tp, caches,
                                {"tokens": inputs["tokens"][:, -1:]},
                                tc.num_patches + TEXT)
    torch.testing.assert_close(dec, full[:, -1], **DECODE_TOL)


def _jit_steps(jc, coding, max_len, keys):
    """The reference's coded steps jitted as its executor jits them, the
    prefill taking the modality dict's ``keys``."""
    prefill = jax.jit(
        lambda p, xs, m, bm, br, live, lq: jcs.coded_prefill(
            jc, coding, p, dict(zip(keys, xs)), max_len=max_len,
            straggler_mask=m, byz_mask=bm, byz_rng=br, byz_sigma=10.0,
            with_report=True, live_mask=live, locate_quorum=lq))
    decode = jax.jit(
        lambda p, st, t, m, bm, br, live, lq: jcs.coded_decode_step(
            jc, coding, p, st, t, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True, live_mask=live,
            locate_quorum=lq))
    return prefill, decode


def _coded_rounds(arch, models, rounds):
    """``rounds`` coded rounds (the prefill on the modality dict, then
    decode steps of text tokens) at K=2 S=1 E=1 on both packages, with
    the reference's noise handed to the port, stragglers every round, a
    persistent attacker on worker 4 and a narrowing live mask: logits,
    greedy tokens and verdicts equal, each vote tally within one pick.
    Returns the port's last state."""
    jc, tc, jp, tp = models(arch)
    k, s, e, g = 2, 1, 1, 2
    jcoding, tcoding = JCoding(k=k, s=s, e=e), TCoding(k=k, s=s, e=e)
    inputs = _inputs(tc, g * k, 8)
    inputs.pop("targets", None)
    keys = sorted(inputs)
    seq = tc.num_patches + TEXT if tc.modality == "vlm" else FRAMES
    max_len = seq + STEPS + 2
    jprefill, jdecode = _jit_steps(jc, jcoding, max_len, keys)
    key = jax.random.PRNGKey(7)
    nxt = jstate = tstate = None
    with jops.force_kernel("xla"):
        for r, (m, live, byz) in enumerate(_rounds(k, s, e)[:rounds]):
            key, sub = jax.random.split(key)
            noise = np.array(jax.random.normal(
                sub, (g, jcoding.num_workers, jc.vocab_size), jnp.float32))
            lq = jcoding.decode_quorum
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
                         with_report=True, live_mask=torch.from_numpy(live),
                         locate_quorum=lq)
            jargs = (jnp.asarray(m), jnp.asarray(byz), sub,
                     jnp.asarray(live), jnp.asarray(lq, jnp.int32))
            if r == 0:
                jl, jstate, (jloc, jvotes) = jprefill(
                    jp, [jnp.asarray(inputs[n]) for n in keys], *jargs)
                tl, tstate, (tloc, tvotes) = tcs.coded_prefill(
                    tc, tcoding, tp, _torch(inputs), max_len, **targs)
            else:
                jl, jstate, (jloc, jvotes) = jdecode(
                    jp, jstate, jnp.asarray(nxt)[:, None], *jargs)
                tl, tstate, (tloc, tvotes) = tcs.coded_decode_step(
                    tc, tcoding, tp, tstate, torch.tensor(nxt)[:, None],
                    **targs)
            assert tstate.pos == int(jstate.pos) == seq + r
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
            assert np.abs(tvotes.numpy() - np.asarray(jvotes)).max() <= 1
            assert tloc.numpy()[:, 4].all()
    return tstate, jstate


def test_vlm_coded_rounds_match_reference(models):
    """paligemma at E=1: ``coded_prefill`` Berrut-encodes the (patches ||
    tokens) residual stream, then 3 ``coded_decode_step``s of text
    tokens from position ``num_patches + text``; the caches after the
    last step equal the reference's."""
    tstate, jstate = _coded_rounds(VLM, models, 1 + STEPS)
    for jr, tr in zip(jstate.caches, tstate.caches):
        for name in ("k", "v"):
            np.testing.assert_allclose(tr[name].numpy(),
                                       np.asarray(jr[name]), **LOGITS_TOL)


def test_audio_coded_prefill_matches_reference(models):
    """hubert's coded round: ``coded_prefill`` on frames (the encoder's
    last-position logits, non-causal attention over every frame)."""
    _coded_rounds(AUDIO, models, 1)


def test_audio_engine_matches_reference(models):
    """The black-box path the reference serves an encoder by:
    ``core.engine.coded_inference`` of ``predict_fn`` over the rows of
    ``embed_inputs`` on frames, K=2 S=1 at E=0 with a straggler and at
    E=1 with an attacker (the reference's noise handed in)."""
    jc, tc, jp, tp = models(AUDIO)
    frames = _inputs(tc, 4, 9)["frames"]
    temb = tmodel.embed_inputs(tc, tp, {"frames": torch.from_numpy(frames)})
    jemb = j_embed_inputs(jc, jp, {"frames": jnp.asarray(frames)})
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **EMBED_TOL)
    for e, straggle in ((0, 2), (1, 5)):
        jcoding, tcoding = JCoding(k=2, s=1, e=e), TCoding(k=2, s=1, e=e)
        n1 = jcoding.num_workers
        mask = np.ones(n1, np.float32)
        mask[straggle] = 0.0
        byz = np.zeros(n1, np.float32)
        byz[min(3, n1 - 1)] = float(e)
        key = jax.random.PRNGKey(11)
        noise = np.array(jax.random.normal(key, (2, n1, jc.vocab_size),
                                           jnp.float32))
        with jops.force_kernel("xla"):
            want = jengine.coded_inference(
                jax.jit(j_predict_fn(jc, jp)), jcoding, jemb,
                straggler_mask=jnp.asarray(mask), byz_mask=jnp.asarray(byz),
                byz_rng=key, byz_sigma=10.0)
        got = tengine.coded_inference(
            tmodel.predict_fn(tc, tp), tcoding, temb,
            straggler_mask=torch.from_numpy(mask),
            byz_mask=torch.from_numpy(byz), byz_noise=torch.from_numpy(noise),
            byz_sigma=10.0)
        assert got.shape == (4, tc.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGITS_TOL)


def test_vlm_pool_steps_match_reference_with_every_slot_live(models):
    """paligemma's slot pool at E=1: both group slots admitted with
    their patches and text in the first call, then decoding together
    from position ``num_patches + text``; logits, tokens, verdicts and
    slot positions equal.  A free slot holds other garbage than the
    reference's (ROADMAP C), so every slot is live."""
    jc, tc, jp, tp = models(VLM)
    k = 2
    jcoding, tcoding = JCoding(k=k, s=1, e=1), TCoding(k=k, s=1, e=1)
    n1 = jcoding.num_workers
    max_len = tc.num_patches + TEXT + STEPS + 2
    rng = np.random.RandomState(12)
    byz = np.zeros(n1, np.float32)
    byz[4] = 1.0
    jprefill = jax.jit(
        lambda p, st, pa, t, a, m, bm, br: jcs.coded_pool_prefill(
            jc, jcoding, p, st, {"patches": pa, "tokens": t}, max_len, a,
            straggler_mask=m, byz_mask=bm, byz_rng=br, byz_sigma=10.0,
            with_report=True))
    jdecode = jax.jit(
        lambda p, st, t, a, m, bm, br: jcs.coded_pool_decode_step(
            jc, jcoding, p, st, t, a, straggler_mask=m, byz_mask=bm,
            byz_rng=br, byz_sigma=10.0, with_report=True))
    jstate = jcs.init_pool_state(jc, jcoding, POOL, max_len)
    tstate = tcs.init_pool_state(tc, tcoding, POOL, max_len, "cpu")
    fresh = tcs.init_caches(tc, POOL * n1, max_len, torch.float32, "cpu")
    inputs = _inputs(tc, POOL * k, 13)
    admit = np.ones(POOL, np.float32)
    key = jax.random.PRNGKey(13)
    nxt = None
    with jops.force_kernel("xla"):
        for r in range(1 + STEPS):
            m = np.ones(n1, np.float32)
            m[rng.choice([i for i in range(n1) if not byz[i]])] = 0.0
            key, sub = jax.random.split(key)
            noise = np.array(jax.random.normal(
                sub, (POOL, n1, jc.vocab_size), jnp.float32))
            targs = dict(straggler_mask=torch.from_numpy(m),
                         byz_mask=torch.from_numpy(byz),
                         byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
                         with_report=True)
            jargs = (jnp.asarray(admit), jnp.asarray(m), jnp.asarray(byz),
                     sub)
            if r == 0:
                jl, jstate, jrep = jprefill(
                    jp, jstate, jnp.asarray(inputs["patches"]),
                    jnp.asarray(inputs["tokens"]), *jargs)
                tl, tstate, trep = tcs.coded_pool_prefill(
                    tc, tcoding, tp, tstate, _torch(inputs), admit, fresh,
                    **targs)
            else:
                jl, jstate, jrep = jdecode(jp, jstate, jnp.asarray(nxt),
                                           *jargs)
                tl, tstate, trep = tcs.coded_pool_decode_step(
                    tc, tcoding, tp, tstate, torch.from_numpy(nxt), admit,
                    **targs)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), toks)
            np.testing.assert_array_equal(trep[0].numpy(),
                                          np.asarray(jrep[0]))
            assert trep[0].numpy()[:, 4].all()
            np.testing.assert_array_equal(tstate.pos.numpy(),
                                          np.asarray(jstate.pos))
            assert (tstate.pos.numpy() == tc.num_patches + TEXT + r).all()
            nxt = toks[:, None]


# ------------------------------------------------------------- entry points

@pytest.mark.parametrize("arch", ARCHS)
def test_check_ported_admits_the_frontends(arch):
    """``check_ported`` takes both frontends (full and reduced); a block
    kind, norm or MLP the reference lacks is still refused."""
    for cfg in (configs.get_config(arch), configs.get_reduced(arch)):
        transformer.check_ported(cfg)
    cfg = configs.get_reduced(arch)
    for bad in (dict(norm_type="batchnorm"), dict(mlp_activation="relu")):
        with pytest.raises(NotImplementedError, match="not ported"):
            transformer.check_ported(cfg.with_updates(**bad))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_refuses_the_frontends(arch, monkeypatch, tmp_path):
    """The launchers build token prompts only.  The reference's
    ``serve.run`` fails inside ``embed_inputs`` (``KeyError`` for the
    frontend's input); the port's ``serve.run``, ``run_fixed_masks``,
    ``main`` and ``multihost --mode serve`` raise before any weights are
    built, naming the modality."""
    want = "patches" if arch == VLM else "frames"
    with pytest.raises(KeyError, match=want):
        jserve.run(arch, True, 4, 2, 1, 0, 6, 1, 10.0)

    def no_weights(*a, **kw):
        raise AssertionError("weights built before the refusal")

    monkeypatch.setattr(serve, "init_params", no_weights)
    modality = configs.get_config(arch).modality
    for call in (lambda: serve.run(arch, reduced=True, device="cpu"),
                 lambda: serve.run_fixed_masks(arch, reduced=True,
                                               device="cpu"),
                 lambda: serve.run(arch, reduced=True, device="cpu",
                                   scheme="uncoded"),
                 lambda: serve.main(["--arch", arch, "--reduced",
                                     "--device", "cpu"]),
                 lambda: multihost.main([
                     "--mode", "serve", "--arch", arch, "--reduced",
                     "--device", "cpu", "--num-processes", "1",
                     "--process-id", "0",
                     "--coordinator", f"file://{tmp_path / 'store'}"])):
        with pytest.raises(ValueError, match=f"{modality} frontend takes "
                                             f"'{want}'"):
            call()
