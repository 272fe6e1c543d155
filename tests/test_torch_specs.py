"""Port parity of the shapes and specs (the dry run's inputs):
``configs.supported_shapes`` / ``shape_config_for``,
``ModelConfig.sliding_variant`` / ``attn_layers`` / ``ssm_layers``,
``models.model.abstract_params``, ``optim.abstract_opt_state`` and the
five functions of ``launch.specs`` against the reference's, for every
arch's full config at each of its shapes.  The port's stand-ins are
tensors on the meta device (nothing allocated), held leaf by leaf to the
shapes and dtypes of the reference's ``jax.eval_shape``.  The coded
decode state is held at K=2, S=1, E=1, K capped by the shape's batch as
the reference's ``serving_coding`` caps it (long_500k serves one query).

Also one reduced qwen3 coded round at ``sliding_variant(window=8)`` with
a 16-token prompt, so that the window masks the prefill and the ring
wraps on the CPU: logits within rtol 1e-5, atol 1e-4 of the reference's
and greedy tokens equal, and logits other than the model's without a
window.
"""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.configs import qwen3_0_6b as jqwen3  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import qwen3_0_6b as tqwen3  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.core.berrut import CodingConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import abstract_params  # noqa: E402
from repro_torch.optim import abstract_opt_state  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402
from repro_torch.tree import flatten_with_path, keystr  # noqa: E402

ARCHS = configs.list_archs()
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
WINDOW, PROMPT, STEPS = 8, 16, 3


def _jleaves(tree) -> dict:
    """{path: (shape, dtype name)} of a reference tree of
    ShapeDtypeStructs."""
    return {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree) -> dict:
    """{path: (shape, dtype name)} of a port tree, every leaf on meta."""
    out = {}
    for p, t in flatten_with_path(tree):
        assert t.is_meta, keystr(p)
        out[keystr(p)] = (tuple(t.shape), str(t.dtype).split(".")[-1])
    return out


def test_archs_and_their_shapes_match_reference():
    """Every arch: the same supported shapes, and at each the same
    config field by field (the sliding variant at long_500k), the same
    attention and SSM layer counts."""
    assert sorted(ARCHS) == sorted(jconfigs.list_archs())
    for arch in ARCHS:
        assert configs.supported_shapes(arch) == \
            jconfigs.supported_shapes(arch), arch
        for shape in configs.supported_shapes(arch):
            got = configs.shape_config_for(arch, shape)
            want = jconfigs.shape_config_for(arch, shape)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (arch, shape)
            assert (got.attn_layers, got.ssm_layers) == \
                (want.attn_layers, want.ssm_layers), (arch, shape)


@pytest.mark.parametrize("window", [8, 4096, 1 << 20])
def test_sliding_variant_matches_reference(window):
    """The variant of every arch's full and reduced config, one already
    narrower than ``window`` left as it is."""
    for arch in ARCHS:
        for tc, jc in ((configs.get_config(arch), jconfigs.get_config(arch)),
                       (configs.get_reduced(arch),
                        jconfigs.get_reduced(arch))):
            for t, j in ((tc, jc), (tc.sliding_variant(64),
                                    jc.sliding_variant(64))):
                got, want = t.sliding_variant(window), \
                    j.sliding_variant(window)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = configs.get_config("qwen3-0.6b")
    assert cfg.sliding_variant(window).sliding_window == window
    assert cfg.sliding_variant(window).name == "qwen3-0.6b-swa"


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """At each supported shape of ``arch``'s full config: the parameters
    and the optimizer state (``model_state_specs``, and
    ``abstract_params`` / ``abstract_opt_state`` directly), the train
    batch, the prefill inputs, the coded stream count and the coded
    decode state with its tokens, leaf by leaf, on meta."""
    for shape_name in configs.supported_shapes(arch):
        cfg = configs.shape_config_for(arch, shape_name)
        jc = jconfigs.shape_config_for(arch, shape_name)
        shape, jshape = shapes.SHAPES[shape_name], jshapes.SHAPES[shape_name]
        where = f"{arch} {shape_name}"
        params, opt = specs.model_state_specs(cfg)
        jparams, jopt = jspecs.model_state_specs(jc)
        assert _tleaves(params) == _jleaves(jparams), where
        assert _tleaves(abstract_params(cfg)) == _jleaves(jparams), where
        assert _tleaves(tuple(opt)) == _jleaves(tuple(jopt)), where
        assert _tleaves(tuple(abstract_opt_state(params))) == \
            _jleaves(tuple(jopt)), where
        assert _tleaves(specs.train_batch_specs(cfg, shape)) == \
            _jleaves(jspecs.train_batch_specs(jc, jshape)), where
        assert _tleaves(specs.prefill_input_specs(cfg, shape)) == \
            _jleaves(jspecs.prefill_input_specs(jc, jshape)), where
        k = min(2, shape.global_batch)
        coding, jcoding = CodingConfig(k, 1, 1), JCoding(k, 1, 1)
        assert specs.coded_stream_count(shape, coding) == \
            jspecs.coded_stream_count(jshape, jcoding), where
        if jc.causal:
            state, tokens = specs.decode_state_specs(cfg, shape, coding)
            jstate, jtokens = jspecs.decode_state_specs(jc, jshape, jcoding)
            assert _tleaves(state.caches) == _jleaves(jstate.caches), where
            assert _tleaves([state.pos, tokens]) == \
                _jleaves([jstate.pos, jtokens]), where


def test_long_500k_caches_are_ring_bounded():
    """long_500k's decode caches hold the window's 4096 slots, not the
    shape's 524288 positions."""
    cfg = configs.shape_config_for("qwen3-0.6b", "long_500k")
    shape = shapes.SHAPES["long_500k"]
    state, _ = specs.decode_state_specs(cfg, shape, CodingConfig(1, 1, 1))
    assert state.caches[0]["k"].shape[2] == 4096


def test_sliding_coded_round_matches_reference():
    """Reduced qwen3 at ``sliding_variant(WINDOW)``: a K=2 S=1 E=0 coded
    prefill of a PROMPT-token prompt past the window, then STEPS decode
    steps on the WINDOW-slot ring, one straggler a round, against the
    reference's jitted steps."""
    jc = jqwen3.reduced().sliding_variant(WINDOW)
    tc = tqwen3.reduced().sliding_variant(WINDOW)
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jcoding, tcoding = JCoding(k=2, s=1), CodingConfig(k=2, s=1)
    g, max_len = 2, PROMPT + STEPS + 1
    tokens = np.random.RandomState(3).randint(0, jc.vocab_size,
                                              (g * 2, PROMPT))
    rng = np.random.RandomState(4)
    jprefill = jax.jit(lambda p, t, m: jcs.coded_prefill(
        jc, jcoding, p, {"tokens": t}, max_len=max_len, straggler_mask=m))
    jdecode = jax.jit(lambda p, st, t, m: jcs.coded_decode_step(
        jc, jcoding, p, st, t, straggler_mask=m))
    wide = tqwen3.reduced()          # the same weights, no window
    nxt, logits = None, []
    with jops.force_kernel("xla"):
        for r in range(1 + STEPS):
            m = np.ones(jcoding.num_workers, np.float32)
            m[rng.randint(jcoding.num_workers)] = 0.0
            tm = torch.from_numpy(m)
            if r == 0:
                jl, jstate = jprefill(jp, jnp.asarray(tokens),
                                      jnp.asarray(m))
                prompt = {"tokens": torch.from_numpy(tokens)}
                tl, tstate = tcs.coded_prefill(tc, tcoding, tp, prompt,
                                               max_len, straggler_mask=tm)
                wl, wstate = tcs.coded_prefill(wide, tcoding, tp, prompt,
                                               max_len, straggler_mask=tm)
                assert tstate.caches[0]["k"].shape[2] == WINDOW
            else:
                step = torch.tensor(nxt)[:, None]
                jl, jstate = jdecode(jp, jstate, jnp.asarray(nxt)[:, None],
                                     jnp.asarray(m))
                tl, tstate = tcs.coded_decode_step(tc, tcoding, tp, tstate,
                                                   step, straggler_mask=tm)
                wl, wstate = tcs.coded_decode_step(wide, tcoding, tp, wstate,
                                                   step, straggler_mask=tm)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            logits.append((tl, wl))
    assert tstate.pos == PROMPT + STEPS
    # the window changed what the model saw, in every round
    for tl, wl in logits:
        assert (tl - wl).abs().max() > 100 * LOGITS_TOL["atol"]
