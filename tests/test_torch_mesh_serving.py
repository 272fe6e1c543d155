"""Port parity of the serving mesh's model and data axes: the logical
axes of every family, ``resolve_spec`` / ``padded_batch`` /
``cache_rules`` / ``batch_sharding`` against the reference's on layout
meshes, ``local_shard``, and tensor-parallel coded serving of the dense
decoders on gloo.

The reference's partitioning functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so they run in this process on an object with
those two attributes (``_layout``), beside the port's on a ``Mesh``
without process groups.

The gloo runs spawn one process per rank, as
``tests/test_torch_worker_mesh.py`` does (a file store in the test's tmp
dir, one thread each, ``TIMEOUT_S`` a run), on four meshes: model 2,
model 4, worker 2 x model 2 and data 2 x model 2.  Each rank serves
reduced qwen3-0.6b and reduced h2o-danube-1.8b (its window of 64 over a
ring), and at model 2 also reduced phi4-mini-3.8b and stablelm-1.6b
(MHA, LayerNorm, a quarter of head_dim rotated), from the reference's
converted weights: the batch round
(``coded_prefill`` and two ``coded_decode_step``s on fixed next tokens,
K=2 S=2 E=1 over 2 groups, one straggler, a sigma-10 attacker; on the
data axis K=4 S=1 E=0 over one group, so that 5 streams are padded to
6) and the slot pool's worker-major prefill and two decode rounds (on
the data axis each rank holds its block of the worker-major streams).  At model 4 both reduced configs take 4 kv-heads (qwen3
8 q-heads, h2o its 8), the reference's too, so that the caches split by
kv-heads (the ring split is ``tests/test_torch_cache_split.py``'s).  Every run is held against the reference's
single-device steps (the batch round) and against the port's one-rank
path (both): logits within ``LOGITS_TOL`` (the port's serving tests'
fp32 tolerance), greedy tokens equal except where the reference's top
two logits lie within that tolerance (a near tie), verdicts equal or
explained by their exact tally (``_torch_parity.near_tie_walk``), each
rank's caches equal (``STATE_TOL``) to its block of the one-rank
caches (its kv-heads, and on the data axis its streams), and the model
axis's and the batch group's collective bytes by op equal to the
analytic count.  The
ranks also check what needs a process group: a world size unequal to
the mesh's product is refused, and a model-axis collective runs under
grad (its gradient passed through).
"""

import os
import subprocess
import sys
import types

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import shardings as jshardings  # noqa: E402
from repro.models import cache_axes as j_cache_axes  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import logical_axes as j_logical_axes  # noqa: E402
from repro.models import partitioning as jpart  # noqa: E402
from repro.serving import coded_serving as jcs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.berrut import CodingConfig as TCoding  # noqa: E402
from repro_torch.launch import shardings as tshardings  # noqa: E402
from repro_torch.launch.worker_mesh import WorkerShardConfig  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import partitioning as tpart  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import check_model_axis  # noqa: E402
from repro_torch.serving import coded_serving as tcs  # noqa: E402

from _torch_parity import capture_columns, near_tie_walk  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT_S = 240
DENSE = ("qwen3-0.6b", "h2o-danube-1.8b")
HELD = ("phi4-mini-3.8b", "stablelm-1.6b")      # held at model 2 only
# kv-heads that a 4-way model axis divides
WIDE_KV = {"qwen3-0.6b": dict(num_heads=8, num_kv_heads=4),
           "h2o-danube-1.8b": dict(num_kv_heads=4)}
# name -> (worker, data, model)
MESHES = {"model2": (1, 1, 2), "model4": (1, 1, 4),
          "worker2_model2": (2, 1, 2), "data2_model2": (1, 2, 2)}
# (K, S, E, groups): the batch round off and on the data axis
BATCH = (2, 2, 1, 2)               # 8 coded streams a group
DATA_BATCH = (4, 1, 0, 1)          # 5 streams, padded to 6 at data 2
POOL = 2
PLEN, STEPS = 8, 2
MAX_LEN = PLEN + STEPS + 4
STRAGGLER, ATTACKER = 6, 1
LAYOUTS = {"data4_model2": (("data", "model"), (4, 2)),
           "data2_model4": (("data", "model"), (2, 4)),
           "data1_model8": (("data", "model"), (1, 8)),
           "worker4_data2": (("worker", "data", "model"), (4, 2, 1)),
           "worker8_model1": (("worker", "model"), (8, 1))}


def _layout(names, shape):
    """The reference's view of a mesh: what its partitioning reads."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.zeros(shape))


def _spec(p):
    return tuple(p)


def _leaves(tree, path=()):
    """(path, leaf) of a tree of dicts, lists and axis tuples, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


# ------------------------------------------------------------ logical axes

@pytest.mark.parametrize("arch", tconfigs.list_archs())
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_logical_and_cache_axes_equal_reference(arch, size):
    get = "get_reduced" if size == "reduced" else "get_config"
    jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    for jtree, ttree in ((j_logical_axes(jc), tmodel.logical_axes(tc)),
                         (j_cache_axes(jc), tmodel.cache_axes(tc))):
        jl = list(_leaves(jax.tree.map(lambda t: t, jtree,
                                       is_leaf=tpart.is_axes)))
        tl = list(_leaves(ttree))
        assert [p for p, _ in tl] == [p for p, _ in jl]
        assert [a for _, a in tl] == [a for _, a in jl]


@pytest.fixture(scope="module")
def abstract_params():
    """Each arch's reduced parameter shapes, from the reference."""
    from repro.models import abstract_params as j_abstract
    out = {}
    for arch in tconfigs.list_archs():
        jc = jconfigs.get_reduced(arch)
        out[arch] = jax.tree.map(lambda s: tuple(s.shape), j_abstract(jc))
    return out


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's ``launch.shardings`` with ``NamedSharding`` giving
    back its spec: its own code then runs on a layout mesh."""
    monkeypatch.setattr(jshardings, "NamedSharding",
                        lambda mesh, spec: spec)
    return jshardings


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_specs_padding_and_cache_rules_equal_reference(layout, ref_specs,
                                                       abstract_params):
    names, shape = LAYOUTS[layout]
    jmesh, tmesh = _layout(names, shape), tpart.Mesh(names, shape)
    for arch in tconfigs.list_archs():
        jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        shapes = abstract_params[arch]
        jaxes = j_logical_axes(jc)
        ttree = dict(_leaves(tpart.param_sharding(
            tmesh, tmodel.logical_axes(tc), shapes)))
        jtree = dict(_leaves(jax.tree.map(
            _spec, ref_specs.tree_shardings(
                jmesh, jaxes, jax.tree.map(
                    lambda s: types.SimpleNamespace(shape=s), shapes,
                    is_leaf=lambda x: isinstance(x, tuple))),
            is_leaf=_is_spec)))
        assert ttree == jtree, arch
        # every parameter leaf through resolve_spec itself
        for path, axes in _leaves(jax.tree.map(lambda t: t, jaxes,
                                               is_leaf=tpart.is_axes)):
            leaf_shape = shapes
            for key in path:
                leaf_shape = leaf_shape[key]
            assert tpart.resolve_spec(tmesh, axes, leaf_shape) == _spec(
                jpart.resolve_spec(jmesh, axes, leaf_shape))
        assert tshardings.cache_rules(tmesh, tc) == \
            ref_specs.cache_rules(jmesh, jc)
        caches = tmodel.init_caches(tc, 8, 16, torch.float32, "cpu")
        want = ref_specs.cache_shardings(jmesh, jc, jax.tree.map(
            lambda t: types.SimpleNamespace(shape=tuple(t.shape)), caches))
        want = jax.tree.map(_spec, want, is_leaf=_is_spec)
        assert dict(_leaves(tshardings.cache_shardings(tmesh, tc, caches))) \
            == dict(_leaves(want)), arch
    for ndim, b in ((2, 8), (2, 6), (2, 1), (3, 16), (2, 2), (3, None)):
        assert tshardings.batch_sharding(tmesh, ndim, b) == _spec(
            ref_specs.batch_sharding(jmesh, ndim, b))
    with jpart.logical_sharding_context(jmesh), tpart.mesh_context(tmesh):
        for n in (1, 5, 8, 10, 12, 36):
            assert tpart.padded_batch(n) == jpart.padded_batch(n)
        for k, s, e, g in ((4, 1, 0, 2), (4, 1, 0, 1), (2, 2, 1, 2)):
            assert (tcs.num_padded_streams(TCoding(k=k, s=s, e=e), g)
                    == jcs.num_padded_streams(JCoding(k=k, s=s, e=e), g))


def test_reference_sharding_values():
    """The values ``tests/test_sharding.py`` asserts of the reference,
    asserted of the port."""
    mesh = tpart.Mesh(("data", "model"), (4, 2))
    assert tpart.resolve_spec(mesh, ("fsdp", "heads"),
                              shape=(128, 8)) == ("data", "model")
    assert tpart.resolve_spec(mesh, ("fsdp", "kv_heads"),
                              shape=(128, 3)) == ("data", None)
    with tpart.mesh_context(mesh):
        assert tpart.padded_batch(5) == 8 and tpart.padded_batch(8) == 8
        coding = TCoding(k=4, s=1, e=0)          # 2 groups x 5 = 10
        assert tcs.num_padded_streams(coding, 2) == 12
    assert tpart.padded_batch(5) == 5             # off any mesh
    assert tshardings.batch_sharding(mesh, 2, 8) == ("data", None)
    assert tshardings.batch_sharding(mesh, 2, 6) == (None, None)
    assert tshardings.batch_sharding(mesh, 2, 1) == (None, None)
    wmesh = tpart.Mesh(("worker", "data", "model"), (4, 2, 1))
    assert tshardings.batch_sharding(wmesh, 3, 16) == \
        (("worker", "data"), None, None)
    assert tshardings.batch_sharding(wmesh, 2, 2) == ("data", None)
    assert tshardings.replicated(wmesh) == ()
    tree = {"tokens": torch.zeros(16, 3), "mask": [torch.zeros(2, 1)]}
    assert tshardings.batch_tree_shardings(wmesh, tree) == {
        "tokens": (("worker", "data"), None), "mask": [("data", None)]}


def test_mesh_layout_is_row_major():
    """Ranks are row-major over the axes, as ``jax.make_mesh`` lays out
    devices: the last axis fastest."""
    assert tpart.axis_ranks(("worker", "model"), (2, 2), "model") == \
        [[0, 1], [2, 3]]
    assert tpart.axis_ranks(("worker", "model"), (2, 2), "worker") == \
        [[0, 2], [1, 3]]
    assert tpart.axis_ranks(("worker", "data", "model"), (2, 2, 2),
                            "data") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    mesh = tpart.Mesh(("worker", "data", "model"), (2, 3, 4), rank=17)
    assert mesh.coords == {"worker": 1, "data": 1, "model": 1}
    assert jnp.arange(24).reshape(2, 3, 4)[1, 1, 1] == 17


@pytest.mark.parametrize("kind,kwargs", [
    ("production", {}), ("production", {"multi_pod": True}),
    ("production_serving", {}), ("production_serving", {"multi_pod": True}),
    ("production_serving", {"workers": 8, "model": 4}),
])
def test_production_meshes_match_reference(kind, kwargs, monkeypatch):
    """The production meshes have the reference's axis names and shapes,
    and their groups are the reference's device grid read row-major."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    monkeypatch.setattr(jmesh, "_make_mesh",
                        lambda shape, axes: _layout(axes, shape))
    monkeypatch.setattr(tmesh, "build_mesh",
                        lambda names, shape: tpart.Mesh(names, shape))
    fn = "make_%s_mesh" % kind
    ref, port = getattr(jmesh, fn)(**kwargs), getattr(tmesh, fn)(**kwargs)
    assert port.axis_names == ref.axis_names
    assert port.shape == ref.devices.shape
    grid = np.arange(ref.devices.size).reshape(ref.devices.shape)
    for i, axis in enumerate(port.axis_names):
        rows = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
        assert tpart.axis_ranks(port.axis_names, port.shape, axis) == \
            sorted(rows.tolist())


def test_local_shard_blocks(cases):
    tc, params = cases["qwen3-0.6b", False][1::2]
    for rank in range(4):
        mesh = tpart.Mesh(("data", "model"), (2, 2), rank=rank)
        m = mesh.coord("model")
        local = tshardings.local_shard(
            params, tshardings.serving_param_specs(mesh, tc, params), mesh)
        run, lrun = params["blocks"]["runs"][0], local["blocks"]["runs"][0]
        assert torch.equal(lrun["attn"]["wq"],
                           run["attn"]["wq"][:, :, 2 * m:2 * m + 2])
        assert torch.equal(lrun["attn"]["wk"],
                           run["attn"]["wk"][:, :, m:m + 1])
        assert torch.equal(lrun["attn"]["wo"],
                           run["attn"]["wo"][:, 2 * m:2 * m + 2])
        assert torch.equal(lrun["mlp"]["w_out"],
                           run["mlp"]["w_out"][:, 256 * m:256 * (m + 1)])
        assert torch.equal(local["embeddings"]["embed"],
                           params["embeddings"]["embed"][256 * m:
                                                         256 * (m + 1)])
        # whole over the data axis, and the norms whole everywhere
        assert local["final_norm"]["scale"] is params["final_norm"]["scale"]
    # the reference's specs of the same leaves, on the same layout: the
    # serving specs only drop its FSDP axis
    jspec = jpart.resolve_spec(_layout(("data", "model"), (2, 2)),
                               ("fsdp", "heads", "head_dim"),
                               (256, 4, 64))
    assert _spec(jspec) == ("data", "model", None)


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_local_shard_is_identity_off_the_model_axis(arch):
    """At model 1 every family's serving specs split nothing, so
    ``local_shard`` hands back the very tensors (no copy of a full-depth
    model: ``multihost --mode serve`` at one rank a worker)."""
    from repro_torch.tree import leaves
    cfg = tconfigs.get_reduced(arch)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    mesh = tpart.Mesh(("worker", "model"), (2, 1), rank=1)
    local = tshardings.local_shard(
        params, tshardings.serving_param_specs(mesh, cfg, params), mesh)
    assert all(a is b for a, b in zip(leaves(local), leaves(params)))
    assert len(leaves(local)) == len(leaves(params))


def test_model_axis_refusals():
    """The model axis refuses no family: Mamba2's blocks allocate their
    rank's SSM caches on it (its heads' state and conv channels [x_r |
    B | C], ``tests/test_torch_ssm_axes.py`` serves them), as the MoE
    layer and the frontends their KV caches
    (``tests/test_torch_moe_axes.py``)."""
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        check_model_axis(tconfigs.get_reduced(arch), 2)
    mesh = tpart.Mesh(("worker", "model"), (1, 2))
    with tpart.mesh_context(mesh):
        tc = tconfigs.get_reduced("mamba2-780m")
        caches = tmodel.init_caches(tc, 4, 8, torch.float32, "cpu")
        h, din, n = tc.ssm_heads, tc.ssm_d_inner, tc.ssm_state
        assert caches[0]["state"].shape == (tc.num_layers, 4, h // 2,
                                            tc.ssm_head_dim, n)
        assert caches[0]["conv"].shape == (tc.num_layers, 4,
                                           tc.ssm_conv - 1, din // 2 + 2 * n)
        for arch in ("qwen3-moe-30b-a3b", "grok-1-314b", "paligemma-3b",
                     "hubert-xlarge"):
            tc = tconfigs.get_reduced(arch)
            check_model_axis(tc, 2)
            caches = tmodel.init_caches(tc, 4, 8, torch.float32, "cpu")
            kv = tc.num_kv_heads
            want = (kv // 2, 8) if kv % 2 == 0 else (kv, 4)
            assert tuple(caches[0]["k"].shape[3:1:-1]) == want, arch
    # 2 kv-heads on a 4-way model axis: the reference's cache-length
    # split, which runs (tests/test_torch_cache_split.py): no refusal
    tc = tconfigs.get_reduced("qwen3-0.6b")
    assert jshardings.cache_rules(_layout(("data", "model"), (1, 4)),
                                  jconfigs.get_reduced("qwen3-0.6b"))
    check_model_axis(tc, 4)
    with tpart.mesh_context(tpart.Mesh(("data", "model"), (1, 4))):
        caches = tmodel.init_caches(tc, 4, 8, torch.float32, "cpu")
    assert caches[0]["k"].shape == (tc.num_layers, 4, 2, 2, tc.head_dim)
    params = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert tshardings.serving_param_specs(
        tpart.Mesh(("worker", "model"), (1, 4)), tc,
        params)["embeddings"]["embed"] == ("model", None)
    # the pool on the data axis: each rank allocates its block of the
    # padded pool (5 streams padded to 6: 3 a rank)
    for rank in range(2):
        with tpart.mesh_context(tpart.Mesh(("data", "model"), (2, 1),
                                           rank=rank)):
            state = tcs.init_pool_state(tc, TCoding(k=4, s=1, e=0), 1, 8,
                                        "cpu")
        assert state.caches[0]["k"].shape[1] == 3
        assert tuple(state.pos.shape) == (1,)
    coding = TCoding(k=2, s=2, e=1)
    with tpart.mesh_context(tpart.Mesh(("worker", "model"), (2, 1))):
        with pytest.raises(ValueError, match="pass wshard"):
            tcs.coded_prefill(tc, coding, {}, {"tokens": None}, 8)


# ------------------------------------------------------------ gloo runs

def _case_cfg(arch, wide):
    upd = WIDE_KV[arch] if wide else {}
    return (jconfigs.get_reduced(arch).with_updates(**upd),
            tconfigs.get_reduced(arch).with_updates(**upd))


def _cases(mesh):
    """(arch, wide) served on ``mesh``."""
    wide = MESHES[mesh][2] == 4
    return [(arch, wide) for arch in DENSE + (HELD if mesh == "model2"
                                              else ())]


# (mesh, arch) of the gloo runs' tests
PAIRS = [(mesh, arch) for mesh in sorted(MESHES)
         for arch, _ in _cases(mesh)]


def _batch_coding(mesh):
    return DATA_BATCH if MESHES[mesh][1] > 1 else BATCH


def _inputs(jc, coding_args, seed):
    """Prompts, fixed next tokens, straggler mask, attacker mask, noise
    key of a batch round."""
    k, s, e, g = coding_args
    n1 = JCoding(k=k, s=s, e=e).num_workers
    rng = np.random.RandomState(seed)
    mask = np.ones(n1, np.float32)
    byz = np.zeros(n1, np.float32)
    if e:
        mask[STRAGGLER] = 0.0
        byz[ATTACKER] = 1.0
    return dict(
        tokens=rng.randint(0, jc.vocab_size, (g * k, PLEN)).astype(np.int32),
        steps=rng.randint(0, jc.vocab_size,
                          (STEPS, g * k, 1)).astype(np.int32),
        mask=mask, byz=byz, key=jax.random.PRNGKey(seed))


def _noise(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


@pytest.fixture(scope="module")
def cases():
    """Per (arch, wide): the reference's configs and parameters, the
    port's converted parameters."""
    out = {}
    for arch, wide in sorted({c for mesh in MESHES for c in _cases(mesh)}):
        jc, tc = _case_cfg(arch, wide)
        jp = j_init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        out[arch, wide] = (jc, tc, jp, tp)
    return out


def _port_batch(tc, tp, coding_args, inp, noise):
    """The port's batch round: per call (logits, located), the caches."""
    k, s, e, g = coding_args
    coding = TCoding(k=k, s=s, e=e)
    kw = dict(straggler_mask=torch.from_numpy(inp["mask"]),
              with_report=True)
    if e:
        kw.update(byz_mask=torch.from_numpy(inp["byz"]),
                  byz_noise=torch.from_numpy(noise), byz_sigma=10.0)
    out = []
    logits, state, rep = tcs.coded_prefill(
        tc, coding, tp, {"tokens": torch.from_numpy(inp["tokens"])},
        MAX_LEN, **kw)
    out.append((logits, rep[0]))
    for toks in inp["steps"]:
        logits, state, rep = tcs.coded_decode_step(
            tc, coding, tp, state, torch.from_numpy(toks), **kw)
        out.append((logits, rep[0]))
    return out, state.caches


def _port_pool(tc, tp, inp, noise, wshard=None):
    """The port's slot pool (worker-major): every slot prefilled, then
    STEPS decode rounds on the fixed next tokens."""
    k, s, e, _ = BATCH
    coding = TCoding(k=k, s=s, e=e)
    state = tcs.init_pool_state(tc, coding, POOL, MAX_LEN, "cpu",
                                wshard=wshard)
    fresh = tcs.init_caches(tc, tcs.pool_streams(coding, POOL, wshard),
                            MAX_LEN, torch.float32, "cpu")
    ones = np.ones(POOL, np.float32)
    kw = dict(straggler_mask=torch.from_numpy(inp["mask"]),
              byz_mask=torch.from_numpy(inp["byz"]),
              byz_noise=torch.from_numpy(noise), byz_sigma=10.0,
              with_report=True, wshard=wshard)
    out = []
    logits, state, rep = tcs.coded_pool_prefill(
        tc, coding, tp, state, {"tokens": torch.from_numpy(inp["tokens"])},
        ones, fresh, **kw)
    out.append((logits, rep[0]))
    for toks in inp["steps"]:
        logits, state, rep = tcs.coded_pool_decode_step(
            tc, coding, tp, state, torch.from_numpy(toks), ones, **kw)
        out.append((logits, rep[0]))
    return out, state.caches


@pytest.fixture(scope="module")
def references(cases):
    """Per (mesh coding, arch, wide): the reference's batch round (logits,
    located and vote columns a call), the port's one-rank batch round
    and pool (the same, and their caches)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jcols, tcols = capture_columns(mp, jcs, tcs)
        for coding_args in (BATCH, DATA_BATCH):
            k, s, e, g = coding_args
            jcoding = JCoding(k=k, s=s, e=e)
            for (arch, wide), (jc, tc, jp, tp) in cases.items():
                if coding_args == DATA_BATCH and (wide or arch in HELD):
                    continue
                inp = _inputs(jc, coding_args, 7)
                noise = _noise(inp["key"],
                               (g, jcoding.num_workers, jc.vocab_size))
                jkw = dict(straggler_mask=jnp.asarray(inp["mask"]),
                           with_report=True)
                if e:
                    jkw.update(byz_mask=jnp.asarray(inp["byz"]),
                               byz_rng=inp["key"], byz_sigma=10.0)
                del jcols[:], tcols[:]
                jout = []
                with jops.force_kernel("xla"):
                    jl, jst, rep = jax.jit(lambda p, t: jcs.coded_prefill(
                        jc, jcoding, p, {"tokens": t}, MAX_LEN, **jkw))(
                            jp, jnp.asarray(inp["tokens"]))
                    jout.append((np.asarray(jl), np.asarray(rep[0])))
                    step = jax.jit(lambda p, st, t: jcs.coded_decode_step(
                        jc, jcoding, p, st, t, **jkw))
                    for toks in inp["steps"]:
                        jl, jst, rep = step(jp, jst, jnp.asarray(toks))
                        jout.append((np.asarray(jl), np.asarray(rep[0])))
                jax.effects_barrier()
                ref_cols = list(jcols)
                port, caches = _port_batch(tc, tp, coding_args, inp, noise)
                entry = {"inputs": inp, "noise": noise, "ref": jout,
                         "ref_cols": ref_cols, "port": port,
                         "port_cols": list(tcols), "caches": caches}
                if coding_args == BATCH:
                    del tcols[:]
                    pool_inp = _inputs(jc, (k, s, e, POOL), 8)
                    pool_noise = _noise(pool_inp["key"],
                                        (POOL, jcoding.num_workers,
                                         jc.vocab_size))
                    entry["pool_inputs"] = pool_inp
                    entry["pool_noise"] = pool_noise
                    entry["pool"] = _port_pool(
                        tc, tp, pool_inp, pool_noise,
                        WorkerShardConfig(gather_width=jcoding.num_workers))
                    entry["pool_cols"] = list(tcols)
                out[coding_args, arch, wide] = entry
    return out


# One rank of a gloo mesh.  argv: rank, world, store, case file, output
# directory, "W,D,M", the cases as "arch:wide,...", batch K,S,E,G.
_RANK_SCRIPT = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
store, case_path, out_dir = sys.argv[3:6]
W, D, M = (int(v) for v in sys.argv[6].split(","))
cases = [(a, w == "1") for a, w in (c.split(":") for c in
                                    sys.argv[7].split(","))]
K, S, E, G = (int(v) for v in sys.argv[8].split(","))
POOL, MAX_LEN, WIDE_KV, POOL_CODING = %(consts)s
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)

from repro_torch import configs
from repro_torch.core.berrut import CodingConfig
from repro_torch.launch import shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.worker_mesh import WorkerShardConfig
from repro_torch.models import partitioning
from repro_torch.serving import coded_serving as cs

out = {}
try:
    make_host_mesh(data=world + 1)
except ValueError:
    out["refused_world"] = np.int32(1)
mesh = make_host_mesh(data=D, model=M, worker=W)
# a model-axis collective under grad runs: the sum forward, the gradient
# passed through unchanged
ones = torch.ones(3, requires_grad=True)
summed = mesh.group("model").all_reduce(ones)
summed.sum().backward()
out["grad_runs"] = np.int32(
    torch.equal(summed.detach(), torch.full((3,), float(M)))
    and torch.equal(ones.grad, torch.ones(3)))
# host-shard assembly: each rank's two rows hold its rank
from repro_torch.launch import multihost
rows = {"x": torch.full((2, 3), float(rank))}
out["pool_rows"] = multihost.global_pool_from_host_shard(mesh, rows)["x"]
out["batch_rows"] = multihost.global_batch_from_host_shard(mesh, rows)["x"]
out["worker_ranks"] = np.asarray(multihost.host_worker_ranks(mesh))
data = torch.load(case_path)
cols = []
real_locate = cs.locate_groups


def locate_groups(betas, vals, avail, **kw):
    cols.append((vals.clone(), avail.clone()))
    return real_locate(betas, vals, avail, **kw)


cs.locate_groups = locate_groups


def axis_bytes(tag):
    for axis, group in mesh.groups.items():
        for op, b in group.collective_bytes().items():
            out["bytes/%%s/%%s/%%s" %% (tag, axis, op)] = np.float64(b)
    mesh.reset_bytes()


def save_caches(tag, caches):
    for i, cache in enumerate(caches):
        for name, leaf in cache.items():
            out["%%s/cache%%d/%%s" %% (tag, i, name)] = leaf.numpy()


def run_calls(tag, first, step, steps):
    del cols[:]
    mesh.reset_bytes()
    logits, state, rep = first()
    calls = [(logits, rep)]
    axis_bytes("%%s/0" %% tag)
    for i, toks in enumerate(steps):
        logits, state, rep = step(state, toks)
        calls.append((logits, rep))
        axis_bytes("%%s/%%d" %% (tag, i + 1))
    for i, (logits, (located, votes)) in enumerate(calls):
        out["%%s/logits%%d" %% (tag, i)] = logits.numpy()
        out["%%s/located%%d" %% (tag, i)] = located.numpy()
    for i, (vals, avail) in enumerate(cols):
        out["%%s/vals%%d" %% (tag, i)] = vals.numpy()
        out["%%s/avail%%d" %% (tag, i)] = avail.numpy()
    save_caches(tag, state.caches)


with partitioning.mesh_context(mesh):
    for arch, wide in cases:
        cfg = configs.get_reduced(arch).with_updates(
            **(WIDE_KV[arch] if wide else {}))
        key = "%%s:%%d" %% (arch, wide)
        params = data[key + "/params"]
        params = shardings.local_shard(
            params, shardings.serving_param_specs(mesh, cfg, params), mesh)
        out[key + "/wq_shape"] = np.asarray(
            params["blocks"]["runs"][0]["attn"]["wq"].shape)
        coding = CodingConfig(k=K, s=S, e=E)
        wshard = (WorkerShardConfig(gather_width=coding.num_workers)
                  if W > 1 else None)
        kw = dict(straggler_mask=data[key + "/mask"], with_report=True,
                  wshard=wshard)
        if E:
            kw.update(byz_mask=data[key + "/byz"],
                      byz_noise=data[key + "/noise"], byz_sigma=10.0)
        steps = data[key + "/steps"]
        run_calls(key + "/batch", lambda: cs.coded_prefill(
            cfg, coding, params, {"tokens": data[key + "/tokens"]}, MAX_LEN,
            **kw), lambda st, t: cs.coded_decode_step(
                cfg, coding, params, st, t, **kw), steps)
        # the pool at the batch round's coding off the data axis, and at
        # BATCH's on it (its batch round takes a padded coding)
        coding = CodingConfig(*POOL_CODING)
        pool_ws = WorkerShardConfig(gather_width=coding.num_workers)
        state = cs.init_pool_state(cfg, coding, POOL, MAX_LEN, "cpu",
                                   wshard=pool_ws)
        fresh = cs.init_caches(cfg, cs.pool_streams(coding, POOL, pool_ws),
                               MAX_LEN, torch.float32, "cpu")
        ones = np.ones(POOL, np.float32)
        pkw = dict(straggler_mask=data[key + "/pool_mask"],
                   byz_mask=data[key + "/pool_byz"],
                   byz_noise=data[key + "/pool_noise"], byz_sigma=10.0,
                   with_report=True, wshard=pool_ws)
        run_calls(key + "/pool", lambda: cs.coded_pool_prefill(
            cfg, coding, params, state,
            {"tokens": data[key + "/pool_tokens"]}, ones, fresh, **pkw),
            lambda st, t: cs.coded_pool_decode_step(
                cfg, coding, params, st, t, ones, **pkw),
            data[key + "/pool_steps"])
np.savez("%%s/rank%%d.npz" %% (out_dir, rank), **out)
dist.destroy_process_group()
""" % {"consts": (POOL, MAX_LEN, WIDE_KV, BATCH[:3])}


def _spawn(script, args_of_rank, world, tmp_path):
    """Start ``world`` processes; a rank that fails or outlives TIMEOUT_S
    fails the test (every rank is killed).  Returns their logs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script] + args_of_rank(r), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world}:\n{logs[r][-3000:]}"
    return logs


@pytest.fixture(scope="module")
def mesh_runs(cases, references, tmp_path_factory):
    """``get(mesh)``: the per-rank outputs of ``mesh``'s gloo run, run
    once on first use."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = _run_mesh(name, cases, references,
                                   tmp_path_factory)
        return done[name]

    return get


def _run_mesh(name, cases, references, tmp_path_factory):
    w, d, m = MESHES[name]
    world = w * d * m
    coding_args = _batch_coding(name)
    tmp = tmp_path_factory.mktemp(name)
    data = {}
    for arch, wide in _cases(name):
        key = f"{arch}:{int(wide)}"
        ref = references[coding_args, arch, wide]
        inp = ref["inputs"]
        data[key + "/params"] = cases[arch, wide][3]
        data[key + "/tokens"] = torch.from_numpy(inp["tokens"])
        data[key + "/steps"] = torch.from_numpy(inp["steps"])
        data[key + "/mask"] = torch.from_numpy(inp["mask"])
        data[key + "/byz"] = torch.from_numpy(inp["byz"])
        data[key + "/noise"] = torch.from_numpy(ref["noise"])
        pool_ref = references[BATCH, arch, wide]
        pinp = pool_ref["pool_inputs"]
        for field in ("tokens", "steps", "mask", "byz"):
            data[f"{key}/pool_{field}"] = torch.from_numpy(pinp[field])
        data[key + "/pool_noise"] = torch.from_numpy(pool_ref["pool_noise"])
    torch.save(data, tmp / "case.pt")
    store = tmp / "store"
    _spawn(_RANK_SCRIPT, lambda r: [
        str(r), str(world), str(store), str(tmp / "case.pt"), str(tmp),
        f"{w},{d},{m}",
        ",".join(f"{a}:{int(wd)}" for a, wd in _cases(name)),
        ",".join(str(v) for v in coding_args)], world, tmp)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _tokens_up_to_near_tie(got, want, where):
    """Greedy tokens equal, except where ``want``'s top two logits lie
    within the logits' tolerance of each other (a near tie)."""
    gt, wt = got.argmax(-1), want.argmax(-1)
    for row in np.flatnonzero(gt != wt):
        top = np.sort(want[row])[-2:]
        tol = 2 * (LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * abs(top[1]))
        assert top[1] - top[0] <= tol, (where, row, top)
        print(f"{where}: row {row} a near tie ({top[1] - top[0]:.3g})")


def _block_of(leaf, mesh_shape, rank, streams_padded=None):
    """A rank's block of a one-rank (layers, streams, W, KV, D) cache:
    its data block of the (padded) streams, its kv-heads."""
    w, d, m = mesh_shape
    coords = np.unravel_index(rank, (w, d, m))
    if streams_padded is not None and streams_padded > leaf.shape[1]:
        pad = streams_padded - leaf.shape[1]
        leaf = np.concatenate([leaf, np.repeat(leaf[:, :1], pad, 1)], 1)
    n = leaf.shape[1] // d
    leaf = leaf[:, coords[1] * n:(coords[1] + 1) * n]
    kv = leaf.shape[3] // m
    return leaf[:, :, :, coords[2] * kv:(coords[2] + 1) * kv]


def _expected_model_bytes(cfg, mesh_shape, coding_args, call, pool):
    """Analytic per-rank bytes of one call on the model axis: the
    embedding's all-reduce, two all-reduces of (streams x S x d) a layer,
    and the logits' all-gather (ring accounting, fp32)."""
    w, d, m = mesh_shape
    k, s, e, g = coding_args
    n1 = TCoding(k=k, s=s, e=e).num_workers
    groups = POOL if pool else g
    seq = PLEN if call == 0 else 1
    padded = -(-groups * n1 // (w * d)) * (w * d)
    local = padded // (w * d)
    frac = (m - 1) / m
    ar = 2 * frac * 4 * (groups * k * seq * cfg.d_model
                         + 2 * cfg.num_layers * local * seq * cfg.d_model)
    ag = frac * 4 * local * cfg.vocab_size
    return {"all-reduce": ar, "all-gather": ag, "total": ar + ag}


@pytest.mark.parametrize("name, arch", PAIRS)
def test_mesh_batch_round_matches_reference_and_one_rank(name, arch,
                                                         mesh_runs,
                                                         references,
                                                         cases):
    ranks = mesh_runs(name)
    shape = MESHES[name]
    wide = shape[2] == 4
    coding_args = _batch_coding(name)
    k, s, e, g = coding_args
    coding = TCoding(k=k, s=s, e=e)
    ref = references[coding_args, arch, wide]
    jc, tc = cases[arch, wide][:2]
    key = f"{arch}:{int(wide)}/batch"
    for out in ranks:
        assert out["refused_world"] == 1 and out["grad_runs"] == 1
        assert tuple(out[f"{arch}:{int(wide)}/wq_shape"]) == (
            tc.num_layers, tc.d_model, tc.num_heads // shape[2],
            tc.head_dim)
    r0 = ranks[0]
    for i, ((jl, jloc), (pl, ploc)) in enumerate(zip(ref["ref"],
                                                     ref["port"])):
        got = r0[f"{key}/logits{i}"]
        for out in ranks[1:]:                  # the same on every rank
            np.testing.assert_array_equal(out[f"{key}/logits{i}"], got)
            np.testing.assert_array_equal(out[f"{key}/located{i}"],
                                          r0[f"{key}/located{i}"])
        np.testing.assert_allclose(got, jl, **LOGITS_TOL)
        np.testing.assert_allclose(got, pl.numpy(), **LOGITS_TOL)
        _tokens_up_to_near_tie(got, jl, f"{name} {arch} call {i}")
        _tokens_up_to_near_tie(got, pl.numpy(), f"{name} {arch} call {i}")
    calls = len(ref["ref"])
    jrounds = [(i, ref["ref"][i][1]) for i in range(calls)]
    trounds = [(i, r0[f"{key}/located{i}"]) for i in range(calls)]
    if e:
        tcols = [(torch.from_numpy(r0[f"{key}/vals{i}"]),
                  torch.from_numpy(r0[f"{key}/avail{i}"]))
                 for i in range(calls)]
        assert near_tie_walk(coding, jrounds, trounds, ref["ref_cols"],
                             tcols)[0] is None
        assert all(r0[f"{key}/located{i}"][:, ATTACKER].all()
                   for i in range(calls))
    else:
        for (_, jloc), (_, tloc) in zip(jrounds, trounds):
            assert not jloc.any() and not tloc.any()
    # each rank's caches: its block of the one-rank port's
    padded = -(-g * coding.num_workers // (shape[0] * shape[1])) \
        * shape[0] * shape[1]
    for rank, out in enumerate(ranks):
        for i, cache in enumerate(ref["caches"]):
            for leaf_name, leaf in cache.items():
                blk = leaf.numpy()
                if shape[0] > 1:
                    # worker-major rows (stream n*G + g): the rank's
                    # workers' rows
                    n1 = coding.num_workers
                    blk = blk.reshape(blk.shape[0], g, n1, *blk.shape[2:])
                    blk = blk.swapaxes(1, 2).reshape(leaf.shape)
                    nl = n1 // shape[0] * g
                    wr = rank // shape[2]
                    blk = blk[:, wr * nl:(wr + 1) * nl]
                    blk = _block_of(blk, (1, 1, shape[2]), rank % shape[2])
                else:
                    blk = _block_of(blk, shape, rank, padded)
                np.testing.assert_allclose(
                    out[f"{key}/cache{i}/{leaf_name}"], blk, **STATE_TOL)
    # the model and data axes' collective bytes, call by call
    for i in range(calls):
        want = _expected_model_bytes(tc, shape, coding_args, i, False)
        for op, b in want.items():
            assert r0[f"bytes/{key}/{i}/model/{op}"] == pytest.approx(b)
        if shape[1] > 1:          # the batch group's gather of the blocks
            v = (shape[1] - 1) / shape[1] * 4 * padded * tc.vocab_size
            assert r0[f"bytes/{key}/{i}/fsdp/all-gather"] == \
                pytest.approx(v)
            assert r0[f"bytes/{key}/{i}/fsdp/total"] == pytest.approx(v)
    if shape[1] > 1:                      # 5 streams padded to 6
        assert padded == 6 and g * coding.num_workers == 5
        assert r0[f"{key}/cache0/k"].shape[1] == 3


@pytest.mark.parametrize("name, arch", PAIRS)
def test_mesh_pool_matches_one_rank(name, arch, mesh_runs, references,
                                    cases):
    ranks = mesh_runs(name)
    shape = MESHES[name]
    wide = shape[2] == 4
    k, s, e, _ = BATCH
    coding = TCoding(k=k, s=s, e=e)
    n1 = coding.num_workers
    ref = references[BATCH, arch, wide]
    tc = cases[arch, wide][1]
    key = f"{arch}:{int(wide)}/pool"
    calls, caches = ref["pool"]
    r0 = ranks[0]
    for i, (pl, _) in enumerate(calls):
        got = r0[f"{key}/logits{i}"]
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[f"{key}/logits{i}"], got)
        np.testing.assert_allclose(got, pl.numpy(), **LOGITS_TOL)
        _tokens_up_to_near_tie(got, pl.numpy(), f"{name} {arch} pool {i}")
    jrounds = [(i, calls[i][1].numpy()) for i in range(len(calls))]
    trounds = [(i, r0[f"{key}/located{i}"]) for i in range(len(calls))]
    jcols = [(v.numpy(), a.numpy()) for v, a in ref["pool_cols"]]
    tcols = [(torch.from_numpy(r0[f"{key}/vals{i}"]),
              torch.from_numpy(r0[f"{key}/avail{i}"]))
             for i in range(len(calls))]
    assert near_tie_walk(coding, jrounds, trounds, jcols, tcols)[0] is None
    # the one-rank pool is worker-major (stream n*P + p): a rank holds
    # its block of the rows (its workers', then its data block of them)
    # and its kv-heads
    w, d, m = shape
    nl = n1 * POOL // (w * d)
    for rank, out in enumerate(ranks):
        wr, mr = divmod(rank, m)                  # wr: the block index
        for i, cache in enumerate(caches):
            for leaf_name, leaf in cache.items():
                kv = leaf.shape[3] // m
                blk = leaf.numpy()[:, wr * nl:(wr + 1) * nl, :,
                                   mr * kv:(mr + 1) * kv]
                np.testing.assert_allclose(
                    out[f"{key}/cache{i}/{leaf_name}"], blk, **STATE_TOL)
    for i in range(len(calls)):
        want = _expected_model_bytes(tc, shape, BATCH, i, True)
        for op, b in want.items():
            assert r0[f"bytes/{key}/{i}/model/{op}"] == pytest.approx(b)
        if w > 1:                  # the survivor tail runs on the worker axis
            assert r0[f"bytes/{key}/{i}/worker/total"] > 0
        if d > 1:                  # the batch group gathers the worker block
            v = (d - 1) / d * 4 * n1 * POOL * tc.vocab_size
            assert r0[f"bytes/{key}/{i}/fsdp/all-gather"] == \
                pytest.approx(v)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_host_shard_assembly(name, mesh_runs):
    """``global_pool_from_host_shard`` gathers each process's rows over
    the worker and data axes, worker outermost (the batch rule's block
    order), ``global_batch_from_host_shard`` over the data axis, in rank
    order; ``host_worker_ranks`` is the worker coordinate."""
    ranks = mesh_runs(name)
    w, d, m = MESHES[name]
    for rank, out in enumerate(ranks):
        wr, dr, mr = np.unravel_index(rank, (w, d, m))
        pool = [(i * d + j) * m + mr for i in range(w) for j in range(d)]
        batch = [wr * d * m + i * m + mr for i in range(d)]
        for key, want in (("pool_rows", pool), ("batch_rows", batch)):
            np.testing.assert_array_equal(
                out[key], np.repeat(np.asarray(want, np.float32), 2)[:, None]
                * np.ones((1, 3), np.float32))
        assert out["worker_ranks"].tolist() == [wr]


def test_host_shard_assembly_one_process():
    """With one process the pool and the batch come back unchanged."""
    from repro_torch.launch import multihost
    mesh = tpart.Mesh(("worker", "model"), (1, 1))
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(
        multihost.global_pool_from_host_shard(mesh, {"k": x})["k"], x)
    assert torch.equal(
        multihost.global_batch_from_host_shard(mesh, {"k": x})["k"], x)
    assert multihost.host_worker_ranks(mesh) == [0]


_MULTIHOST = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from repro_torch.launch import multihost

res = multihost.main(sys.argv[2:])
np.save(sys.argv[1], res["tokens"])
"""


def test_multihost_model_axis_tokens_equal_one_process(tmp_path):
    """``multihost --mode serve --model-par 2`` on two gloo processes
    (reduced qwen3, fp32, K=7 S=3: 10 streams over 8 slots) gives every
    rank the one process's tokens."""
    base = ["--mode", "serve", "--device", "cpu", "--reduced", "--dtype",
            "float32", "--s", "3", "--steps", "2", "--pool-groups", "2",
            "--max-len", "16"]
    runs = {}
    for world, extra in ((1, []), (2, ["--model-par", "2"])):
        store = tmp_path / f"store{world}"
        logs = _spawn(_MULTIHOST, lambda r, w=world, e=extra, st=store: [
            str(tmp_path / f"tokens{w}_{r}.npy"), "--coordinator",
            f"file://{st}", "--num-processes", str(w), "--process-id",
            str(r)] + base + e, world, tmp_path)
        runs[world] = [np.load(tmp_path / f"tokens{world}_{r}.npy")
                       for r in range(world)]
        if world == 2:
            assert "model rank 1 of 2" in logs[1]
    assert runs[1][0].shape == (3, 2 * 7)
    for toks in runs[2]:
        np.testing.assert_array_equal(toks, runs[1][0])
