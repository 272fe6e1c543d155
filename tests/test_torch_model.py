"""Port parity of the dense decoder: ``repro_torch.models`` against
``repro.models`` at qwen3-0.6b ``reduced()`` size (2 layers, d 256,
vocab 512) on the plain CPU path.

The port runs on the reference's own parameters (``params_from_jax``).
fp32 logits agree within rtol 1e-5, atol 1e-4 (a different summation
order in every product); greedy tokens exactly.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro.configs import qwen3_0_6b as jcfg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch.configs import qwen3_0_6b as tcfg  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)

VARIANTS = {
    "qwen3": {},
    "sliding_window": dict(sliding_window=6),
    "int8_kv": dict(kv_cache_dtype="int8"),
    "softcap_prefix": dict(attn_logit_softcap=30.0, prefix_lm=True,
                           num_patches=4),
}


def _configs(variant):
    kw = VARIANTS[variant]
    return (jcfg.reduced().with_updates(**kw),
            tcfg.reduced().with_updates(**kw))


def _jax_params(cfg, seed=0):
    return j_init_params(cfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(variant):
    jc, tc = _configs(variant)
    jp = _jax_params(jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    b, s, steps = 3, 10, 3
    max_len = s + steps + 1
    tokens = np.random.RandomState(1).randint(0, jc.vocab_size, (b, s))
    with jops.force_kernel("xla"):
        jl, jcache = j_prefill(jc, jp, {"tokens": jnp.asarray(tokens)},
                               j_init_caches(jc, b, max_len))
        tl, tcache = tmodel.prefill(
            tc, tp, {"tokens": torch.from_numpy(tokens)},
            tmodel.init_caches(tc, b, max_len, torch.float32, "cpu"))
        for step in range(steps + 1):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGITS_TOL)
            nxt = np.asarray(jnp.argmax(jl, -1))
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
            if step == steps:
                break
            jl, jcache = j_decode_step(jc, jp, jcache,
                                       {"tokens": jnp.asarray(nxt)[:, None]},
                                       jnp.asarray(s + step, jnp.int32))
            tl, tcache = tmodel.decode_step(
                tc, tp, tcache, {"tokens": torch.tensor(nxt)[:, None]},
                s + step)
    for jr, tr in zip(jcache, tcache):
        for name in ("k", "v"):
            assert tr[name].dtype == getattr(torch, str(jr[name].dtype))
            np.testing.assert_allclose(
                tr[name].to(torch.float32).numpy(),
                np.asarray(jr[name], np.float32),
                **({"atol": 1} if variant == "int8_kv" else LOGITS_TOL))


def test_config_copy_matches_reference():
    import dataclasses
    for jc, tc in ((jcfg.CONFIG, tcfg.CONFIG),
                   (jcfg.reduced(), tcfg.reduced())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jsw, tsw = (c.with_updates(num_layers=3, sliding_window=8)
                for c in (jcfg.reduced(), tcfg.reduced()))
    assert dataclasses.asdict(tsw) == dataclasses.asdict(jsw)


def test_embeddings_input_matches_tokens_input():
    _, tc = _configs("qwen3")
    tp = tmodel.init_params(tc, torch.Generator("cpu").manual_seed(0), "cpu")
    tokens = torch.randint(0, tc.vocab_size, (2, 5))
    caches = tmodel.init_caches(tc, 2, 8, torch.float32, "cpu")
    a, _ = tmodel.prefill(tc, tp, {"tokens": tokens}, caches)
    emb = tmodel.embed_inputs(tc, tp, {"tokens": tokens})
    caches = tmodel.init_caches(tc, 2, 8, torch.float32, "cpu")
    b, _ = tmodel.prefill(tc, tp, {"embeddings": emb}, caches)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_port_init_params_match_reference_structure_and_scales():
    jc, tc = _configs("qwen3")
    jp = jax.tree.map(np.asarray, _jax_params(jc))
    tp = tmodel.init_params(tc, torch.Generator("cpu").manual_seed(0), "cpu")
    jleaves, jtree = jax.tree.flatten(jp)
    tleaves, ttree = jax.tree.flatten(
        jax.tree.map(lambda t: t.numpy(), tp,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert jtree == ttree
    for jl, tl in zip(jleaves, tleaves):
        assert jl.shape == tl.shape and jl.dtype == tl.dtype
        np.testing.assert_allclose(tl.std(), jl.std(), rtol=0.1, atol=1e-6)
        np.testing.assert_allclose(np.abs(tl).max(), np.abs(jl).max(),
                                   rtol=0.1)


def test_entry_points_refuse_to_run_on_cpu_without_asking():
    """With no CUDA device, device=None raises instead of carrying on."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    _, tc = _configs("qwen3")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_params(tc, torch.Generator("cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="generator"):
        tmodel.init_params(tc, torch.Generator("cpu"), device="meta")
