"""The port's data pipeline against the JAX package's: synthetic batches
and the token-file reader byte for byte, the rescale-invariant global
stream (hypothesis), and the batch's move to the train step's device."""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as pipe
from repro_torch.training.trainer import to_device


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert np.ascontiguousarray(a[k]).tobytes() == np.ascontiguousarray(b[k]).tobytes()


@pytest.mark.parametrize("vocab,seq,gb,seed,zipf", [(512, 16, 8, 0, 1.2), (128256, 64, 4, 7, 1.2),
                                                   (122753, 33, 6, 3, 1.5)])
def test_global_batches_byte_equal(vocab, seq, gb, seed, zipf):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=gb, seed=seed, zipf_a=zipf)
    for step in (0, 1, 17, 1000):
        _same(pipe.global_batch(pipe.DataConfig(**kw), step),
              jpipe.global_batch(jpipe.DataConfig(**kw), step))


def test_batches_iterator_byte_equal():
    kw = dict(vocab=1000, seq_len=8, global_batch=8, seed=5)
    mine = pipe.batches(pipe.DataConfig(**kw), start_step=3, host=1, n_hosts=2)
    ref = jpipe.batches(jpipe.DataConfig(**kw), start_step=3, host=1, n_hosts=2)
    for _ in range(4):
        _same(next(mine), next(ref))


@settings(max_examples=25, deadline=None)
@given(n_hosts=st.sampled_from([1, 2, 4, 8]), step=st.integers(0, 1000))
def test_property_rescale_invariant_and_equal_to_reference(n_hosts, step):
    """Host slices concatenate to the global batch whatever the host count
    (the elastic-restart data order), and each slice is the reference's."""
    dc = pipe.DataConfig(vocab=512, seq_len=8, global_batch=16, seed=3)
    jdc = jpipe.DataConfig(vocab=512, seq_len=8, global_batch=16, seed=3)
    parts = [pipe.host_batch(dc, step, h, n_hosts) for h in range(n_hosts)]
    for h, p in enumerate(parts):
        _same(p, jpipe.host_batch(jdc, step, h, n_hosts))
    got = np.concatenate([p["inputs"] for p in parts], axis=0)
    np.testing.assert_array_equal(pipe.global_batch(dc, step)["inputs"], got)


def test_token_file_dataset_byte_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50000, size=10_001, dtype=np.int32).tofile(path)
    mine = pipe.TokenFileDataset(str(path), seq_len=32, batch=4, seed=9)
    ref = jpipe.TokenFileDataset(str(path), seq_len=32, batch=4, seed=9)
    assert mine.n_windows == ref.n_windows
    for step in (0, 5, 123):
        _same(mine.batch_at(step), ref.batch_at(step))


def test_to_device_keeps_dtypes_and_values():
    b = pipe.host_batch(pipe.DataConfig(vocab=512, seq_len=8, global_batch=4), 2, 0, 1)
    t = to_device(b, torch.device("cpu"))
    assert t["inputs"].dtype == torch.int32 and t["mask"].dtype == torch.float32
    for k in b:
        np.testing.assert_array_equal(t[k].numpy(), b[k])
