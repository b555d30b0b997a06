"""The port's small ops against their JAX counterparts on the CPU: masks,
flatten, the relative-bias maps, KV-cache formats and sampling filters."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vqcpcb_tpu import utils as jax_utils
from vqcpcb_tpu.data import vocab as jax_vocab
from vqcpcb_tpu.ops import kv_cache as jax_kv
from vqcpcb_tpu.ops import masks as jax_masks
from vqcpcb_tpu.ops import relative_attention as jax_rel
from vqcpcb_tpu.ops import sampling as jax_sampling
from vqcpcb_tpu_torch import utils
from vqcpcb_tpu_torch.data import vocab
from vqcpcb_tpu_torch.ops import kv_cache, masks, relative_attention, sampling


def test_masks_match_jax():
    np.testing.assert_array_equal(masks.causal_mask(6).numpy(),
                                  np.asarray(jax_masks.causal_mask(6)))
    np.testing.assert_array_equal(masks.anticausal_mask(6).numpy(),
                                  np.asarray(jax_masks.anticausal_mask(6)))
    np.testing.assert_array_equal(
        masks.anticausal_mask(4, sz_tgt=12).numpy(),
        np.asarray(jax_masks.anticausal_mask(4, sz_tgt=12)))


def test_flatten_unflatten_match_jax():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    flat = utils.flatten(torch.from_numpy(x))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jax_utils.flatten(jnp.asarray(x))))
    np.testing.assert_array_equal(utils.unflatten(flat, 4).numpy(), x)


def test_kv_cache_dtype_policy(monkeypatch):
    monkeypatch.delenv("VQCPCB_KV_DTYPE", raising=False)
    assert utils.kv_cache_dtype(torch.device("cpu")) is None
    assert utils.kv_cache_dtype(torch.device("cuda")) == torch.int8
    monkeypatch.setenv("VQCPCB_KV_DTYPE", "bf16")
    assert utils.kv_cache_dtype(torch.device("cuda")) == torch.bfloat16
    monkeypatch.setenv("VQCPCB_KV_DTYPE", "f32")
    assert utils.kv_cache_dtype(torch.device("cuda")) is None
    monkeypatch.setenv("VQCPCB_KV_DTYPE", "fp16")
    with pytest.raises(ValueError):
        utils.kv_cache_dtype(torch.device("cpu"))


def test_resolve_device(monkeypatch):
    assert utils.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        utils.resolve_device(None)
    with pytest.raises(RuntimeError):
        utils.resolve_device("cuda")


def test_vocab_copy_matches_jax():
    assert vocab.SPECIAL_SYMBOLS == jax_vocab.SPECIAL_SYMBOLS
    names = [{"p60", "p62", "C#4"}, {"p50", "E-3"}]
    mine = vocab.Vocabulary.from_note_sets(names, vocab.midi_of_name)
    theirs = jax_vocab.Vocabulary.from_note_sets(names, jax_vocab.midi_of_name)
    assert mine.note2index_dicts == theirs.note2index_dicts
    assert mine.voice_ranges == theirs.voice_ranges
    assert mine.symbol_indices(vocab.PAD_SYMBOL) == theirs.symbol_indices(jax_vocab.PAD_SYMBOL)


@pytest.mark.parametrize("src,tgt", [(8, 8), (6, 24)])
def test_relative_bias_matches_jax(src, tgt):
    """Full bias and every per-row bias to 1e-6 (f32 dots of length 8)."""
    rng = np.random.RandomState(0)
    q = rng.randn(2, 3, tgt, 8).astype(np.float32)
    e1 = rng.randn(3, src, 8).astype(np.float32)
    e2 = rng.randn(3, src, 8).astype(np.float32)
    for a, b in zip(relative_attention.relative_bias_index_maps(src, tgt),
                    jax_rel.relative_bias_index_maps(src, tgt)):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jax_rel.subsampled_relative_bias(*map(jnp.asarray, (q, e1, e2))))
    tq, te1, te2 = map(torch.from_numpy, (q, e1, e2))
    got = relative_attention.subsampled_relative_bias(tq, te1, te2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    for t in range(tgt):
        row = relative_attention.subsampled_relative_bias_row(tq[:, :, t], te1, te2, t, tgt)
        np.testing.assert_allclose(row.numpy(), want[:, :, t], rtol=1e-6, atol=1e-6)


def test_quantize_kv_and_update_match_jax():
    """int8 data, scales and in-place updates exactly equal (round half to
    even on both sides; halves are forced by construction)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    x[0, 0, 0] = [127.0, 0.5, 1.5, -2.5]             # scale 1: exact .5 ties
    data, scale = kv_cache.quantize_kv(torch.from_numpy(x))
    jdata, jscale = jax_kv.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    new = rng.randn(2, 3, 1, 4).astype(np.float32)
    for cache_dt in (torch.int8, None):
        jdt = jnp.int8 if cache_dt is not None else None
        cache = kv_cache.new_cache(torch.from_numpy(x), cache_dt)
        jcache = jax_kv.new_cache(jnp.asarray(x), jdt)
        cache = kv_cache.cache_update(cache, torch.from_numpy(new), 3)
        jcache = jax_kv.cache_update(jcache, jnp.asarray(new), 3)
        np.testing.assert_array_equal(kv_cache.dequantize_kv(cache).numpy(),
                                      np.asarray(jax_kv.dequantize_kv(jcache)))
        for n in (2, 7):
            np.testing.assert_array_equal(
                kv_cache.dequantize_kv(kv_cache.cache_resize(cache, n)).numpy(),
                np.asarray(jax_kv.dequantize_kv(jax_kv.cache_resize(jcache, n))))


@pytest.mark.parametrize("exact_ties", [False, True])
@pytest.mark.parametrize("top_k,top_p", [(0, 0.8), (5, 0.0), (5, 0.6), (0, 0.3)])
def test_top_k_top_p_filtering_matches_jax(exact_ties, top_k, top_p):
    """Filtered logits exactly equal under both tie rules, with exact ties
    planted at the nucleus boundary."""
    rng = np.random.RandomState(0)
    logits = rng.randn(16, 20).astype(np.float32)
    logits[:, 3] = logits[:, 7]                            # bit-equal ties
    logits[:4, :6] = 1.25
    want = np.asarray(jax_sampling.top_k_top_p_filtering(
        jnp.asarray(logits), top_k=top_k, top_p=top_p, exact_ties=exact_ties))
    got = sampling.top_k_top_p_filtering(torch.from_numpy(logits), top_k=top_k,
                                         top_p=top_p, exact_ties=exact_ties)
    np.testing.assert_array_equal(got.numpy(), want)


def _tied_logits():
    """test_top_k_top_p_filtering_matches_jax's logits: bit-equal ties at the
    nucleus boundary."""
    rng = np.random.RandomState(0)
    logits = rng.randn(16, 20).astype(np.float32)
    logits[:, 3] = logits[:, 7]
    logits[:4, :6] = 1.25
    return logits


@pytest.mark.parametrize("env", ["1", "0", None])
def test_top_k_top_p_filtering_reads_exact_ties_env_like_jax(env, monkeypatch):
    """With exact_ties left out, both read VQCPCB_EXACT_TOPP_TIES: filtered
    logits exactly equal, and the tie rule the variable names."""
    if env is None:
        monkeypatch.delenv("VQCPCB_EXACT_TOPP_TIES", raising=False)
    else:
        monkeypatch.setenv("VQCPCB_EXACT_TOPP_TIES", env)
    logits = _tied_logits()
    differs = False
    for top_k, top_p in [(0, 0.8), (5, 0.6), (0, 0.3)]:
        want = np.asarray(jax_sampling.top_k_top_p_filtering(
            jnp.asarray(logits), top_k=top_k, top_p=top_p))
        got = sampling.top_k_top_p_filtering(torch.from_numpy(logits),
                                             top_k=top_k, top_p=top_p)
        np.testing.assert_array_equal(got.numpy(), want)
        named = sampling.top_k_top_p_filtering(
            torch.from_numpy(logits), top_k=top_k, top_p=top_p,
            exact_ties=env == "1")
        np.testing.assert_array_equal(got.numpy(), named.numpy())
        other = sampling.top_k_top_p_filtering(
            torch.from_numpy(logits), top_k=top_k, top_p=top_p,
            exact_ties=env != "1")
        differs |= not torch.equal(got, other)
    assert differs, "the logits carry no tie that tells the two rules apart"


@pytest.mark.parametrize("env", [None, "", "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("scope", ["bfloat16", ""])
def test_compute_dtype_maps_the_env_like_jax(env, scope, monkeypatch):
    """utils.compute_dtype(default) against JAX's compute_dtype() inside
    default_compute_dtype(scope), the trainer's default (bf16 on the
    accelerator, '' = f32 elsewhere): an explicit variable, even '' or an
    unknown value, wins."""
    from vqcpcb_tpu.ops import compute_dtype as jax_compute_dtype
    from vqcpcb_tpu.ops import default_compute_dtype
    if env is None:
        monkeypatch.delenv("VQCPCB_COMPUTE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("VQCPCB_COMPUTE_DTYPE", env)
    with default_compute_dtype(scope):
        want = jax_compute_dtype()
    default = torch.bfloat16 if scope == "bfloat16" else torch.float32
    assert utils.compute_dtype(default) == (
        torch.bfloat16 if want == jnp.bfloat16 else torch.float32)


def test_sample_categorical_is_seeded_and_respects_filters():
    logits = torch.randn(64, 10, generator=torch.Generator().manual_seed(1))
    a = sampling.sample_categorical(torch.Generator().manual_seed(5), logits,
                                    top_k=3)
    b = sampling.sample_categorical(torch.Generator().manual_seed(5), logits,
                                    top_k=3)
    assert torch.equal(a, b)
    top3 = logits.topk(3, dim=-1).indices
    assert (top3 == a[:, None]).any(-1).all()
    greedy = sampling.sample_categorical(torch.Generator(), logits, top_k=1)
    assert torch.equal(greedy, logits.argmax(-1))
