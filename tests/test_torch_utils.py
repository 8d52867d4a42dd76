"""The port's checkpoints, profiling hooks and prefetch
(``bbbp_tpu_torch/utils/``, ``parallel/prefetch.py``) against the JAX
package's, on the CPU.

- A checkpoint round-trips bit-equal (every leaf's dtype, shape and bits);
  ``latest_step`` equals the JAX package's on the same directory names.
- ``run_regression``'s ``nn_checkpoint`` (a 72-row ``ProcessedData``, 3
  folds) holds the leaf paths and shapes of the JAX package's fold-axis
  parameter tree for the same config (``jax.eval_shape`` of the flax init,
  the fold axis in front), and its values equal ``flax_from_params`` of the
  run's final state, bit for bit; ``batch_stats`` is empty, as flax's is for
  this model.
- ``debug_nans`` raises on a NaN made in a forward operator and in a
  backward one, and neither when disabled nor outside its block.
- ``StepTimer``'s records and JSONL lines have the JAX package's keys;
  ``trace`` writes a Chrome trace.
- ``prefetch_to_device`` keeps the order and the values
  (``tests/test_models.py:113-120``) and raises a producer's exception.

JAX is imported inside the tests that compare with it, so that the
``cuda``-marked test runs where JAX is absent (the card's machine).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.utils import checkpoint as tck  # noqa: E402
from bbbp_tpu_torch.utils import profiling as tprof  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread, as the test workers share
    the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"enc0": {"kernel": torch.from_numpy(
                rng.standard_normal((3, 4, 5)).astype(np.float32)),
                "bias": torch.zeros(3, 5, dtype=torch.bfloat16)},
            "head": {"kernel": rng.standard_normal((3, 5, 1))}},
            "batch_stats": {},
            "step": torch.tensor(7, dtype=torch.int64),
            "counts": [torch.arange(4, dtype=torch.int32), np.float32(2.5)]}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_checkpoint_round_trips_bit_equal(tmp_path):
    state = _state()
    path = tck.save_checkpoint(str(tmp_path / "ck"), state, step=3)
    assert path.endswith(os.path.join("ck", "step_3"))
    back = tck.restore_checkpoint(path)
    want, got = dict(_leaves(state)), dict(_leaves(back))
    assert set(want) == set(got) and back["batch_stats"] == {}
    for name, w in want.items():
        w = torch.as_tensor(w)
        g = got[name]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", name
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.view(torch.uint8) if g.dim() else g,
                           w.view(torch.uint8) if w.dim() else w), name


def test_restore_onto_a_target(tmp_path):
    state = _state()
    path = tck.save_checkpoint(str(tmp_path / "ck"), state)
    target = _state(seed=1)
    target["params"]["head"]["kernel"] = np.zeros((3, 5, 1), np.float32)
    back = tck.restore_checkpoint(path, target)
    assert back["params"]["head"]["kernel"].dtype == np.float32
    np.testing.assert_array_equal(back["params"]["head"]["kernel"],
                                  state["params"]["head"]["kernel"].astype(np.float32))
    assert back["params"]["enc0"]["bias"].dtype == torch.bfloat16
    bad = _state()
    bad["params"]["enc0"]["kernel"] = torch.zeros(3, 4, 6)
    with pytest.raises(ValueError, match="shape"):
        tck.restore_checkpoint(path, bad)
    with pytest.raises(ValueError, match="keys"):
        tck.restore_checkpoint(path, {"params": {}})


def test_save_refuses_to_overwrite_when_asked(tmp_path):
    tck.save_checkpoint(str(tmp_path / "ck"), {"a": torch.ones(2)})
    with pytest.raises(FileExistsError):
        tck.save_checkpoint(str(tmp_path / "ck"), {"a": torch.ones(2)},
                            overwrite=False)
    tck.save_checkpoint(str(tmp_path / "ck"), {"a": torch.zeros(2)})
    assert torch.equal(tck.restore_checkpoint(str(tmp_path / "ck"))["a"],
                       torch.zeros(2))


@pytest.mark.parametrize("names", [[], ["step_1", "step_12", "step_3"],
                                   ["step_x", "step_5", "other", "step_"]])
def test_latest_step_equals_jax(tmp_path, names):
    pytest.importorskip("jax")
    from bbbp_tpu.utils.checkpoint import latest_step

    for n in names:
        os.makedirs(tmp_path / n)
    assert tck.latest_step(str(tmp_path)) == latest_step(str(tmp_path))
    assert tck.latest_step(str(tmp_path / "absent")) is None


def test_regression_nn_checkpoint_is_the_jax_packages_tree(tmp_path, monkeypatch):
    jax = pytest.importorskip("jax")
    from bbbp_tpu.models.transformer_cnn import MultiModalRegressor as Flax
    from bbbp_tpu_torch.models import MultiModalRegressor
    from bbbp_tpu_torch.models.convert import flatten_tree, flax_from_params
    from bbbp_tpu_torch.train import regression as R
    from tests.test_torch_regression import SMALL, _tiny_processed

    runs = []
    train_cv = R.train_cv

    def capture(*a, **kw):
        runs.append(train_cv(*a, **kw))
        return runs[-1]

    monkeypatch.setattr(R, "train_cv", capture)
    data = _tiny_processed()
    cfg = R.RegressionTrainConfig(**SMALL, out_dir=str(tmp_path))
    R.run_regression(cfg, data=data, verbose=False, device="cpu")
    ck = tck.restore_checkpoint(str(tmp_path / "nn_checkpoint"))
    assert set(ck) == {"params", "batch_stats"} and ck["batch_stats"] == {}

    nn_fp = data.nn_fp_features()
    img = data.img_norm.reshape(len(data.y), cfg.image_size, cfg.image_size, 3)
    flax = Flax(fp_dim=nn_fp.shape[1], n_layers=cfg.n_layers, fusion=cfg.fusion,
                fp_tokens=cfg.fp_tokens)
    shapes = jax.eval_shape(
        lambda k, fp, im: flax.init({"params": k, "dropout": k}, fp, im, train=True),
        jax.random.PRNGKey(0), nn_fp[:2], img[:2])["params"]
    want = {"/".join(str(p.key) for p in path): (cfg.n_folds,) + leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {path: tuple(t.shape) for path, t in flatten_tree(ck["params"]).items()}
    assert got == want

    model = MultiModalRegressor(fp_dim=nn_fp.shape[1], n_layers=cfg.n_layers,
                                fusion=cfg.fusion, fp_tokens=cfg.fp_tokens,
                                image_size=cfg.image_size)
    final = runs[0].params
    for i in range(cfg.n_folds):
        fold = flatten_tree(flax_from_params(model, i, final))
        for path, value in fold.items():
            assert np.array_equal(flatten_tree(ck["params"])[path][i], value), path


def test_debug_nans_forward_and_backward():
    with tprof.debug_nans():
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor([-1.0, 2.0]))
        x = torch.tensor([0.0, 4.0], requires_grad=True)
        y = (torch.sqrt(x) * 0.0).sum()          # forward finite, 0/0 backward
        assert torch.isfinite(y)
        with pytest.raises(FloatingPointError):
            y.backward()
        torch.empty(1000)                        # uninitialised, not a result
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    with tprof.debug_nans(False):
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
        x = torch.tensor([0.0], requires_grad=True)
        (torch.sqrt(x) * 0.0).sum().backward()
        assert torch.isnan(x.grad).all()


def test_step_timer_keys_equal_jax(tmp_path):
    pytest.importorskip("jax")
    from bbbp_tpu.utils.profiling import StepTimer as JaxTimer

    rows = {}
    for name, cls in (("port", tprof.StepTimer), ("jax", JaxTimer)):
        path = str(tmp_path / f"{name}.jsonl")
        timer = cls(jsonl_path=path)
        with timer.step("load", epoch=1):
            pass
        out = timer.timed("square", lambda a: a * a, np.float32(3), epoch=2)
        assert float(out) == 9.0
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        rows[name] = ([sorted(r) for r in timer.records], [sorted(r) for r in lines],
                      sorted(timer.summary()))
    assert rows["port"] == rows["jax"]


def test_timer_blocks_on_returned_tensors():
    timer = tprof.StepTimer()
    out = timer.timed("pair", lambda: (torch.ones(3), {"a": torch.zeros(2)}))
    assert timer.records[0]["name"] == "pair" and out[1]["a"].shape == (2,)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert prof.key_averages() is not None


def test_prefetch_keeps_order_and_values():
    from bbbp_tpu_torch.parallel import prefetch_to_device

    items = [(np.full((4,), i, np.float32), {"b": torch.full((2,), -i)})
             for i in range(10)]
    out = list(prefetch_to_device(iter(items), depth=2, device="cpu"))
    assert len(out) == 10
    for i, (a, d) in enumerate(out):
        assert isinstance(a, torch.Tensor) and float(a[0]) == i
        assert torch.equal(d["b"], torch.full((2,), -i))


def test_prefetch_raises_the_producers_error():
    from bbbp_tpu_torch.parallel import prefetch_to_device

    def items():
        yield np.zeros(2)
        raise KeyError("bad item")

    it = prefetch_to_device(items(), device="cpu")
    assert next(it).shape == (2,)
    with pytest.raises(KeyError, match="bad item"):
        next(it)


def test_prefetch_to_cuda_raises_without_cuda(monkeypatch):
    from bbbp_tpu_torch.parallel import prefetch_to_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([np.zeros(2)])))


@pytest.mark.cuda
def test_prefetch_onto_cuda_and_nan_check_in_backward():
    """On the card: items arrive in order through the side stream, and a
    NaN made in the backward pass (autograd's device thread) raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bbbp_tpu_torch.parallel import prefetch_to_device

    items = [np.full((1 << 16,), i, np.float32) for i in range(8)]
    for i, t in enumerate(prefetch_to_device(iter(items), depth=2)):
        assert t.is_cuda and float((t * 2).sum()) == 2 * i * (1 << 16)
    x = torch.tensor([0.0, 4.0], device="cuda", requires_grad=True)
    with tprof.debug_nans():
        y = (torch.sqrt(x) * 0.0).sum()
        with pytest.raises(FloatingPointError):
            y.backward()
