"""The port's CPC data path (port-local NumPy copies of the tokenizer, the
synthetic corpus, the window dataset and BachCPCDataloaderGenerator)
against the JAX package's: the same corpus and seeds give the same
vocabulary, windows and batches, element for element. Each side builds its
own cache under tmp_path."""
import numpy as np
import pytest

from vqcpcb_tpu.data import corpora as jax_corpora
from vqcpcb_tpu.data import dataloaders as jax_dataloaders
from vqcpcb_tpu.data import tokenizer as jax_tokenizer
from vqcpcb_tpu_torch.data import corpora, dataloaders, tokenizer

CORPUS = dict(num_chorales=8, min_beats=12, max_beats=20, seed=0)
GEOMETRY = dict(num_tokens_per_block=16, num_blocks_left=3, num_blocks_right=3,
                num_negative_samples=4)
BATCH = 4


def _generators(tmp_path, method, seed):
    jax_gen = jax_dataloaders.BachCPCDataloaderGenerator(
        negative_sampling_method=method,
        corpus=jax_corpora.SyntheticChoraleCorpus(**CORPUS),
        cache_root=str(tmp_path / "jax"), seed=seed, **GEOMETRY)
    gen = dataloaders.BachCPCDataloaderGenerator(
        negative_sampling_method=method,
        corpus=corpora.SyntheticChoraleCorpus(**CORPUS),
        cache_root=str(tmp_path / "port"), seed=seed, **GEOMETRY)
    return jax_gen, gen


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("method", ["random", "same_sequence"])
def test_cpc_batches_equal_jax(tmp_path, method, seed):
    """The first two train batches and the first val batch, then (from a
    second dataloaders() call, which goes on drawing from the generator's
    RandomState) one more train batch."""
    jax_gen, gen = _generators(tmp_path, method, seed)
    for _ in range(2):
        jtrain, jval, _ = jax_gen.dataloaders(batch_size=BATCH)
        train, val, _ = gen.dataloaders(batch_size=BATCH)
        for _ in range(2):
            _assert_batches_equal(next(train), next(jtrain))
        _assert_batches_equal(next(val), next(jval))
    first = next(gen.dataloaders(batch_size=BATCH)[0])
    b, neg, k, ticks, voices = first["negative_samples"].shape
    assert (b, k, ticks, voices) == (BATCH, 3, 4, 4)
    assert neg == (4 if method == "random" else 5)


def test_windows_vocabulary_and_events_equal_jax(tmp_path):
    """The window tensor and the vocabulary (built and cached by each
    side), and the inverse tokenization of a window."""
    jax_gen, gen = _generators(tmp_path, "random", 0)
    jds, ds = jax_gen.dataset_positive, gen.dataset_positive
    assert ds.vocabulary.note2index_dicts == jds.vocabulary.note2index_dicts
    assert ds.vocabulary.voice_ranges == jds.vocabulary.voice_ranges
    np.testing.assert_array_equal(ds.windows, jds.windows)
    assert ds.windows.dtype == np.int32 and len(ds.windows) > 100
    for got, want in zip(ds.splits(), jds.splits()):
        np.testing.assert_array_equal(got, want)
    assert (tokenizer.ticks_to_neutral_events(ds.windows[5], ds.vocabulary, 4)
            == jax_tokenizer.ticks_to_neutral_events(jds.windows[5],
                                                     jds.vocabulary, 4))
    reloaded = dataloaders.BachCPCDataloaderGenerator(
        negative_sampling_method="random",
        corpus=corpora.SyntheticChoraleCorpus(**CORPUS),
        cache_root=str(tmp_path / "port"), seed=0, **GEOMETRY)
    np.testing.assert_array_equal(reloaded.dataset_positive.windows, ds.windows)
