"""The port's ``io`` (datasets, samplers, ``default_collate_fn``,
``DataLoader``), ``metric`` and ``framework.io`` against the JAX package,
on the CPU.

Samplers that take their order from a seed are compared index for index:
``SequenceSampler``, ``BatchSampler``, ``DistributedBatchSampler`` (its
epoch-seeded numpy shuffle) and the samplers given an explicit numpy
generator.  A ``RandomSampler`` with no generator draws from each
package's own default generator, so there only the set of indices is
compared.  The metrics take the same numpy predictions and labels; their
results are compared exactly (counts) or within 1e-12 (``Auc``'s float
sums); ``accuracy`` within 1e-7.  ``framework.io`` files cross between
the packages for state dicts of plain arrays, and the port reads the
reference's tensor payloads.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.framework.io as jfio
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric

import paddle_tpu_torch.framework.io as tfio
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.metric as tmetric

torch.set_num_threads(1)


class _Range:
    """Item i: (an f32 row of i, the int label i % 3)."""

    def __init__(self, n=10):
        self.n = n

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), i % 3

    def __len__(self):
        return self.n


def _set(mod, n=10):
    return type("Range", (_Range, mod.Dataset), {})(n)


def _np(batch):
    if isinstance(batch, (list, tuple)):
        return [_np(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    return np.asarray(batch.numpy() if hasattr(batch, "numpy") else batch)


# ---------------------------------------------------------------------------
# samplers and datasets


@pytest.mark.parametrize("kw", [dict(batch_size=3), dict(batch_size=3, drop_last=True),
                                dict(batch_size=4, shuffle=True),
                                dict(batch_size=2, num_replicas=3, rank=1),
                                dict(batch_size=2, num_replicas=3, rank=2, shuffle=True,
                                     drop_last=True)])
def test_distributed_batch_sampler_same_index_stream(kw):
    j = jio.DistributedBatchSampler(_set(jio), **kw)
    t = tio.DistributedBatchSampler(_set(tio), **kw)
    for epoch in (0, 3):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        assert list(t) == list(j) and len(t) == len(j)


def test_batch_sampler_position_protocol():
    for mod in (jio, tio):
        bs = mod.BatchSampler(_set(mod), batch_size=3)
        it = iter(bs)
        next(it)
        next(it)
        assert bs.state_dict() == {"epoch": 0, "position": 2}
        fresh = mod.BatchSampler(_set(mod), batch_size=3)
        fresh.set_state_dict(bs.state_dict())
        assert list(fresh) == [[6, 7, 8], [9]]
        fresh.fast_forward(2)
        assert list(fresh) == [[6, 7, 8], [9]]
    assert list(tio.BatchSampler(_set(tio), batch_size=4, drop_last=True)) == \
        list(jio.BatchSampler(_set(jio), batch_size=4, drop_last=True))


def test_samplers_with_explicit_generators():
    """Given the same numpy generator state, the shuffles are the same."""
    for make in (lambda mod, g: mod.RandomSampler(_set(mod), generator=g),
                 lambda mod, g: mod.RandomSampler(_set(mod), replacement=True,
                                                  num_samples=7, generator=g)):
        got = list(make(tio, np.random.default_rng(5)))
        want = list(make(jio, np.random.default_rng(5)))
        assert got == want
    assert list(tio.SequenceSampler(_set(tio))) == list(jio.SequenceSampler(_set(jio)))
    parts = tio.random_split(_set(tio), [6, 4], generator=np.random.default_rng(2))
    jparts = jio.random_split(_set(jio), [6, 4], generator=np.random.default_rng(2))
    assert [p.indices for p in parts] == [p.indices for p in jparts]
    assert [len(p) for p in tio.random_split(_set(tio), [0.5, 0.5])] == [5, 5]


def test_default_generator_orders_are_permutations_and_seeded():
    ds = _set(tio)
    assert sorted(tio.RandomSampler(ds)) == list(range(10))
    torch.manual_seed(3)
    a = list(tio.RandomSampler(ds))
    b = list(tio.RandomSampler(ds))
    torch.manual_seed(3)
    assert list(tio.RandomSampler(ds)) == a and a != b      # seeded, advancing
    w = tio.WeightedRandomSampler([0.0, 1.0, 0.0], 5)
    assert list(w) == [1] * 5 and len(w) == 5
    with pytest.raises(ValueError, match="sum of lengths"):
        tio.random_split(ds, [3, 3])


def test_datasets_against_reference():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6)
    td, jd = tio.TensorDataset([x, y]), jio.TensorDataset([x, y])
    assert len(td) == len(jd) == 6
    for a, b in zip(_np(td[4]), _np(jd[4])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="first dimension"):
        tio.TensorDataset([x, y[:5]])
    cat = tio.ConcatDataset([_set(tio, 3), _set(tio, 4)])
    jcat = jio.ConcatDataset([_set(jio, 3), _set(jio, 4)])
    assert len(cat) == len(jcat) == 7
    for i in (0, 2, 3, 6, -1):
        np.testing.assert_array_equal(cat[i][0], jcat[i][0])
    comp = tio.ComposeDataset([_set(tio, 3), _set(tio, 5)])
    assert len(comp) == 3 and len(comp[1]) == 4
    assert tio.Subset(_set(tio), [4, 1])[1][1] == jio.Subset(_set(jio), [4, 1])[1][1]

    class Stream(tio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))

    assert list(iter(tio.ChainDataset([Stream(2), Stream(3)]))) == [0, 1, 0, 1, 2]
    with pytest.raises(RuntimeError):
        Stream(1)[0]


# ---------------------------------------------------------------------------
# collate and DataLoader


def test_default_collate_fn_structures():
    samples = [{"x": np.full((2,), i, np.float32), "pair": (i, float(i) / 2)}
               for i in range(3)]
    got, want = tio.default_collate_fn(samples), jio.default_collate_fn(samples)
    assert isinstance(got["x"], torch.Tensor) and tuple(got["x"].shape) == (3, 2)
    np.testing.assert_array_equal(_np(got["x"]), _np(want["x"]))
    for a, b in zip(_np(got["pair"]), _np(want["pair"])):
        np.testing.assert_array_equal(a, b)
    tensors = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(tio.default_collate_fn(tensors), torch.stack(tensors))


@pytest.mark.parametrize("workers", [0, 2, 3])
def test_dataloader_against_reference(workers):
    kw = dict(batch_size=3, shuffle=False, num_workers=workers, use_process_workers=False)
    got = [_np(b) for b in tio.DataLoader(_set(tio), **kw)]
    want = [_np(b) for b in jio.DataLoader(_set(jio), **kw)]
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_dataloader_position_and_refusals():
    loader = tio.DataLoader(_set(tio), batch_size=3, num_workers=2, use_process_workers=False)
    it = iter(loader)
    next(it)
    assert loader.state_dict()["position"] == 1
    assert len(loader) == 4
    with pytest.raises(NotImplementedError, match="A10"):
        iter(tio.DataLoader(_set(tio), batch_size=3, num_workers=2))

    class Boom(_Range, tio.Dataset):
        def __getitem__(self, i):
            if i == 4:
                raise KeyError("bad item")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="bad item"):
        list(tio.DataLoader(Boom(), batch_size=3, num_workers=2, use_process_workers=False))

    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(7, dtype=np.float32))

    sizes = [len(b) for b in tio.DataLoader(Stream(), batch_size=3)]
    assert sizes == [3, 3, 1]
    assert [len(b) for b in tio.DataLoader(Stream(), batch_size=3, drop_last=True)] == [3, 3]


# ---------------------------------------------------------------------------
# metrics


def _preds(seed=0, n=64, classes=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, classes)).astype(np.float32),
            rng.integers(0, classes, (n, 1)))


@pytest.mark.parametrize("topk", [1, (1, 3)])
def test_accuracy_metric_against_reference(topk):
    j, t = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for seed in range(3):
        pred, label = _preds(seed)
        jc = j.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
        tc = t.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(tc, jc)
        assert t.update(tc) == j.update(jc)
    assert t.accumulate() == j.accumulate() and t.name() == j.name()
    t.reset()
    assert t.accumulate() == (0.0 if topk == 1 else [0.0, 0.0])


def test_precision_recall_auc_against_reference():
    rng = np.random.default_rng(4)
    for cls in ("Precision", "Recall", "Auc"):
        j, t = getattr(jmetric, cls)(), getattr(tmetric, cls)()
        for _ in range(3):
            scores = rng.random(50).astype(np.float32)
            labels = (rng.random(50) < 0.4).astype(np.int64)
            if cls == "Auc":
                probs = np.stack([1 - scores, scores], 1)
                j.update(probs, labels)
                t.update(torch.from_numpy(probs), torch.from_numpy(labels))
            else:
                j.update(scores, labels)
                t.update(torch.from_numpy(scores), torch.from_numpy(labels))
        assert abs(t.accumulate() - j.accumulate()) <= 1e-12, cls
        assert t.name() == j.name()
    with pytest.raises(ValueError, match="mismatch"):
        tmetric.Precision().update(np.ones(3), np.ones(4))
    with pytest.raises(NotImplementedError):
        tmetric.Auc(curve="PR")


@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy_against_reference(k):
    pred, label = _preds(7, n=20)
    want = jmetric.accuracy(paddle.to_tensor(pred), paddle.to_tensor(label), k=k)
    correct, total = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    got = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k,
                           correct=correct, total=total)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-7)
    assert int(total) == 20 and abs(int(correct) / 20 - float(got)) < 1e-7


# ---------------------------------------------------------------------------
# framework.io


def test_save_load_cross_the_packages(tmp_path):
    plain = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": 7,
             "nested": [np.ones(2, np.int64), {"lr": 0.5}]}
    tfio.save(plain, str(tmp_path / "port.pdopt"))
    jfio.save(plain, str(tmp_path / "ref.pdopt"))
    for got in (jfio.load(str(tmp_path / "port.pdopt")), tfio.load(str(tmp_path / "ref.pdopt"))):
        np.testing.assert_array_equal(got["w"], plain["w"])
        assert got["step"] == 7 and got["nested"][1] == {"lr": 0.5}
    # the reference's tensor payloads load as host tensors in the port
    jfio.save({"t": paddle.to_tensor(plain["w"])}, str(tmp_path / "ref_t.pdparams"))
    loaded = tfio.load(str(tmp_path / "ref_t.pdparams"))
    assert isinstance(loaded["t"], torch.Tensor)
    np.testing.assert_array_equal(loaded["t"].numpy(), plain["w"])
    np.testing.assert_array_equal(tfio.load(str(tmp_path / "ref_t.pdparams"),
                                            return_numpy=True)["t"], plain["w"])


def test_save_load_round_trip_keeps_dtypes(tmp_path):
    state = {"bf16": torch.randn(3, 4).to(torch.bfloat16), "f32": torch.randn(5),
             "i64": torch.arange(4), "seq": (torch.ones(2), 3)}
    tfio.save(state, str(tmp_path / "sub" / "s.pdparams"))
    got = tfio.load(str(tmp_path / "sub" / "s.pdparams"))
    for k in ("bf16", "f32", "i64"):
        assert got[k].dtype == state[k].dtype and torch.equal(got[k], state[k]), k
    assert isinstance(got["seq"], tuple) and got["seq"][1] == 3


def test_save_group_sharded_model_writes_both_state_dicts(tmp_path):
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.optimizer import AdamW

    model = ptt.nn.Linear(3, 2, device="cpu")
    opt = AdamW(1e-2, parameters=model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    dist.save_group_sharded_model(model, str(tmp_path / "out"), opt)
    sd = tfio.load(str(tmp_path / "out.pdmodel"))
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    osd = tfio.load(str(tmp_path / "out.pdopt"))
    assert osd["@step"] == 1 and any(k.endswith("moment1") for k in osd)
    fresh = AdamW(1e-2, parameters=model.parameters())
    fresh.set_state_dict(osd)
    assert fresh.state_dict()["@step"] == 1
