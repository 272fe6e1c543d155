"""Port parity of the training substrate: checkpoints crossing between the
two packages both ways (fp32, bf16 and the optimizer state's int32 step),
the synthetic datasets drawing equal batches from a seed, the loader's
order and prefetch, and ``configs/shapes.py``.

Everything here is exact: a checkpoint stores the bytes it is given, and
the datasets are the same numpy code on the same seeds.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core.berrut import CodingConfig as JCoding  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.data import ShardedLoader  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.partitioning import Mesh  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.tree import flatten_with_path, keystr  # noqa: E402


@pytest.fixture(scope="module")
def reference_state():
    """Reduced qwen3's reference parameters with one leaf in bf16, and an
    optimizer state one step in."""
    cfg = jconfigs.get_reduced("qwen3-0.6b")
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    params["final_norm"]["scale"] = params["final_norm"]["scale"].astype(
        jnp.bfloat16) + jnp.asarray(0.375, jnp.bfloat16)
    grads = jax.tree.map(lambda p: jnp.ones(p.shape, jnp.float32) * 0.5,
                         params)
    _, opt, _ = jadamw.adamw_update(jadamw.OptimizerConfig(), params, grads,
                                    jadamw.init_opt_state(params))
    return params, opt


def _raw(x) -> np.ndarray:
    """The values' bytes as integers (bf16 and |V2 alike) or the array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    if x.dtype.str == "|V2" or x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x


def _assert_same(port_tree, ref_tree):
    got = {keystr(p): v for p, v in flatten_with_path(port_tree)}
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(_raw(got[key]), _raw(w), err_msg=key)


def test_reference_checkpoint_loads_into_the_port(reference_state, tmp_path):
    params, opt = reference_state
    jckpt.save(jckpt.step_path(str(tmp_path), 5), params,
               metadata={"arch": "qwen3-0.6b", "steps": 5})
    jckpt.save(str(tmp_path / "opt"), opt)
    like = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    got = tckpt.load(tckpt.step_path(str(tmp_path), 5), like)
    assert got["final_norm"]["scale"].dtype == torch.bfloat16
    _assert_same(got, params)
    like_opt = opt_state_from_jax(jax.tree.map(np.asarray, opt),
                                  device="cpu")
    got_opt = tckpt.load(str(tmp_path / "opt"), init_opt_state(like))
    assert got_opt.step.dtype == torch.int32 and int(got_opt.step) == 1
    _assert_same(got_opt, opt)
    _assert_same(like_opt, opt)
    assert tckpt.latest_step(str(tmp_path)) == 5
    assert tckpt.load_metadata(tckpt.step_path(str(tmp_path), 5)) == {
        "arch": "qwen3-0.6b", "steps": 5}


def test_port_checkpoint_loads_into_the_reference(reference_state, tmp_path):
    """The reference reads the port's entries under its own key names;
    a bf16 leaf comes back as its ``|V2`` bytes, unconverted, exactly as
    the reference's own bf16 writes do (its parity limit)."""
    params, opt = reference_state
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    topt = opt_state_from_jax(jax.tree.map(np.asarray, opt), device="cpu")
    tckpt.save(tckpt.step_path(str(tmp_path), 7), tparams)
    tckpt.save(str(tmp_path / "opt"), topt)
    got = jckpt.load(jckpt.step_path(str(tmp_path), 7), params)
    assert np.asarray(got["final_norm"]["scale"]).dtype.str == "|V2"
    _assert_same(tparams, got)
    _assert_same(tparams, params)
    got_opt = jckpt.load(str(tmp_path / "opt"), opt)
    assert np.asarray(got_opt.step).dtype == np.int32
    _assert_same(topt, got_opt)
    # the reference's own bf16 write reads back the same way
    jckpt.save(str(tmp_path / "ref"), params)
    own = jckpt.load(str(tmp_path / "ref"), params)
    assert np.asarray(own["final_norm"]["scale"]).dtype.str == "|V2"
    assert jckpt.latest_step(str(tmp_path)) == 7


def test_port_checkpoint_roundtrip_and_errors(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "runs": [{"b": torch.ones(4, dtype=torch.bfloat16) / 3}],
            "n": torch.tensor(3, dtype=torch.int32)}
    path = tckpt.step_path(str(tmp_path), 12)
    assert path.endswith("step_00000012")
    tckpt.save(path, tree, metadata={"steps": 12})
    back = tckpt.load(path + ".npz", tree)
    for (p, a), (_, b) in zip(flatten_with_path(tree),
                              flatten_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), keystr(p)
    assert tckpt.load_metadata(path) == {"steps": 12}
    assert tckpt.load_metadata(str(tmp_path / "none")) is None
    assert tckpt.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(ValueError, match="shape"):
        tckpt.load(path, {**tree, "w": torch.zeros(3, 3)})
    with pytest.raises(KeyError, match="missing"):
        tckpt.load(path, {**tree, "x": torch.zeros(1)})
    with pytest.raises(TypeError, match="bf16"):
        tckpt.load(path, {**tree, "runs": [{"b": torch.zeros(4)}]})


def test_lm_dataset_batches_equal_the_reference():
    jds = jsyn.SyntheticLMDataset(vocab_size=97, seq_len=24, seed=3)
    tds = tsyn.SyntheticLMDataset(vocab_size=97, seq_len=24, seed=3)
    np.testing.assert_array_equal(tds._next, jds._next)
    for jb, tb, _ in zip(jds.stream(5, seed=4), tds.stream(5, seed=4),
                         range(4)):
        assert tb["tokens"].dtype == np.int32
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    follow = (tds._next[tb["tokens"][:, :-1]] == tb["tokens"][:, 1:]).mean()
    assert follow > 0.5


def test_classification_and_modality_batches_equal_the_reference():
    jc, tc = (m.SyntheticClassification(num_classes=5, dim=8, seed=2)
              for m in (jsyn, tsyn))
    for (jx, jy), (tx, ty) in zip(jc.train_test(40, 10, seed=3),
                                  tc.train_test(40, 10, seed=3)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for arch in ("qwen3-0.6b", "hubert-xlarge", "paligemma-3b"):
        jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
        seq = 8 + tcfg.num_patches
        jb = jsyn.synthetic_batch(jcfg, jshapes.ShapeConfig("t", seq, 2,
                                                            "train"),
                                  np.random.RandomState(9))
        tb = tsyn.synthetic_batch(tcfg, tshapes.ShapeConfig("t", seq, 2,
                                                            "train"),
                                  np.random.RandomState(9))
        assert sorted(tb) == sorted(jb)
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=arch)


def test_loader_order_and_prefetch():
    """The port's loader hands out the reference loader's batches in the
    same order, as CPU tensors, with ``prefetch`` batches drawn ahead;
    given a mesh, a rank's rows of them (its block over the batch axes,
    ``tests/test_torch_train_mesh.py``)."""
    drawn = []

    def counted(stream):
        for b in stream:
            drawn.append(1)
            yield b

    ds = tsyn.SyntheticLMDataset(vocab_size=64, seq_len=8, seed=0)
    loader = ShardedLoader(counted(ds.stream(4)), prefetch=3, device="cpu")
    ref = jloader.ShardedLoader(ds.stream(4), mesh=None, prefetch=3)
    first = next(loader)
    assert len(drawn) == 3                  # two staged ahead of use
    for i in range(5):
        got = first if i == 0 else next(loader)
        want = next(ref)
        assert isinstance(got["tokens"], torch.Tensor)
        assert got["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    assert len(drawn) == 7
    mesh = Mesh(("data", "model"), (2, 2), rank=3)   # data rank 1
    rows = ShardedLoader(ds.stream(4), mesh=mesh, device="cpu")
    want = next(jloader.ShardedLoader(ds.stream(4), mesh=None))
    np.testing.assert_array_equal(next(rows)["tokens"].numpy(),
                                  np.asarray(want["tokens"])[2:])


def test_shapes_match_the_reference():
    assert sorted(tshapes.SHAPES) == sorted(jshapes.SHAPES)
    for name, jshape in jshapes.SHAPES.items():
        tshape = tshapes.SHAPES[name]
        assert (tshape.name, tshape.seq_len, tshape.global_batch,
                tshape.kind, tshape.is_decode) == (
            jshape.name, jshape.seq_len, jshape.global_batch, jshape.kind,
            jshape.is_decode)
        for k, s, e in ((8, 1, 0), (4, 2, 1), (16, 1, 2)):
            tcod = tshapes.serving_coding(tshape, k=k, s=s, e=e)
            jcod = jshapes.serving_coding(jshape, k=k, s=s, e=e)
            assert (tcod.k, tcod.s, tcod.e, tcod.num_workers) == (
                jcod.k, jcod.s, jcod.e, jcod.num_workers)
            assert tshapes.coded_batch(tshape, tcod) == \
                jshapes.coded_batch(jshape, JCoding(k=jcod.k, s=s, e=e))
    assert tshapes.serving_coding(tshapes.SHAPES["long_500k"]).k == 1
