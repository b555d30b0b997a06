"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version, which is held
against the JAX kernel run as the JAX tests run it (Pallas interpret mode).
The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
(and chip_smoke.py, at the slice's full shapes) hold them against the plain
versions there."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vqcpcb_tpu.ops.pallas_attention as pa
from vqcpcb_tpu.ops import pallas_vq
from vqcpcb_tpu.ops.masks import anticausal_mask as jax_anticausal
from vqcpcb_tpu.ops.masks import causal_mask as jax_causal
from vqcpcb_tpu_torch.ops import attention_kernels as ak
from vqcpcb_tpu_torch.ops import vq_kernels as vk


# ---- nearest-codebook search ------------------------------------------------

@pytest.mark.parametrize("n,k,d,s", [(50, 1, 3, 32), (300, 2, 8, 16),
                                     (7, 1, 130, 200)])
def test_nearest_codebook_plain_matches_jax(monkeypatch, n, k, d, s):
    """Exactly equal to the JAX XLA form and to the Pallas kernel in
    interpret mode: the indices are integers, and random inputs leave no
    near-ties at these sizes."""
    orig = pallas_vq.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_vq.pl, "pallas_call", interp)
    rng = np.random.RandomState(0)
    x = rng.randn(n, k, d).astype(np.float32)
    e = rng.randn(k, s, d).astype(np.float32)
    before = vk.launches
    got = vk.nearest_codebook_indices(torch.from_numpy(x), torch.from_numpy(e))
    assert got.dtype == torch.int32 and got.shape == (n, k)
    assert vk.launches == before          # a CPU tensor never reaches the kernel
    xla = pallas_vq._xla_indices(jnp.asarray(x), jnp.asarray(e))
    pallas = pallas_vq.nearest_codebook_indices(jnp.asarray(x), jnp.asarray(e),
                                                force_pallas=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_nearest_codebook_ties_go_to_lowest_index():
    e = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]]])   # codes 0 and 2 equal
    x = torch.tensor([[[1.0, 0.0]], [[0.5, 0.5]]])
    assert vk.nearest_codebook_indices(x, e)[:, 0].tolist() == [0, 0]


# ---- relative-bias attention forward ----------------------------------------

_RELBIAS_CASES = [(24, 24, "causal"), (32, 8, "anticausal_rect"),
                  (96, 96, "causal"), (16, 16, None)]


def _relbias_inputs(t, s, mask_kind, seed=0):
    rng = np.random.RandomState(seed)
    b, h, d = 2, 2, 8
    q = (rng.randn(b, h, t, d) * d ** -0.5).astype(np.float32)
    k = rng.randn(b, h, s, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    e1 = rng.randn(h, s, d).astype(np.float32)
    e2 = rng.randn(h, s, d).astype(np.float32)
    if mask_kind == "causal":
        mask = np.asarray(jax_causal(t))
    elif mask_kind == "anticausal_rect":
        mask = np.asarray(jax_anticausal(s, sz_tgt=t))
    else:
        mask = None
    return q, k, v, mask, e1, e2


def _jax_relbias(monkeypatch, q, k, v, mask, e1, e2):
    monkeypatch.setattr(pa, "use_pallas_relbias", lambda: True)
    out = pa.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if mask is None else jnp.asarray(mask),
                             jnp.asarray(e1), jnp.asarray(e2), interpret=True)
    return np.asarray(out)


def _torch_relbias(q, k, v, mask, e1, e2, dot_dtype):
    t = lambda a: None if a is None else torch.from_numpy(a.copy())  # noqa: E731
    return ak.relbias_attention_fwd(t(q), t(k), t(v), t(mask), t(e1), t(e2),
                                    dot_dtype=dot_dtype).numpy()


@pytest.mark.parametrize("t,s,mask_kind", _RELBIAS_CASES)
def test_relbias_plain_matches_jax_f32_dots(monkeypatch, t, s, mask_kind):
    """f32 dots on both sides (VQCPCB_PALLAS_BF16_DOTS=0): the same sums in
    another order, 2e-5."""
    monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", "0")
    inputs = _relbias_inputs(t, s, mask_kind)
    want = _jax_relbias(monkeypatch, *inputs)
    got = _torch_relbias(*inputs, dot_dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t,s,mask_kind", _RELBIAS_CASES)
def test_relbias_plain_matches_jax_bf16_dots(monkeypatch, t, s, mask_kind):
    """The shipping bf16 dot rule on both sides. The f32 sums before each
    bf16 rounding run in another order, so a softmax weight may round to the
    neighbouring bf16 value (one ulp, 2**-8 relative): the output then moves
    by at most 2**-8 * w * |v|, < 2e-3 with these inputs (|v| < 5)."""
    monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", "1")
    inputs = _relbias_inputs(t, s, mask_kind)
    want = _jax_relbias(monkeypatch, *inputs)
    got = _torch_relbias(*inputs, dot_dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_relbias_plain_matches_the_explicit_bias():
    """The combined-table bias equals relative_attention's index-map bias:
    the kernel's formulation and the module's plain path agree (f32, 1e-5)."""
    from vqcpcb_tpu_torch.ops.relative_attention import subsampled_relative_bias
    q, k, v, mask, e1, e2 = (torch.from_numpy(a.copy())
                             for a in _relbias_inputs(32, 8, "anticausal_rect"))
    scores = (torch.einsum("bhtd,bhsd->bhts", q, k) + mask
              + subsampled_relative_bias(q, e1, e2))
    want = torch.einsum("bhts,bhsd->bhtd", torch.softmax(scores, -1), v)
    got = ak.relbias_attention_fwd(q, k, v, mask, e1, e2, dot_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fully_masked_rows_give_no_nan():
    q, k, v, _, e1, e2 = (torch.from_numpy(a.copy()) if a is not None else None
                          for a in _relbias_inputs(16, 16, None))
    mask = torch.full((16, 16), float("-inf"))
    out = ak.relbias_attention_fwd(q, k, v, mask, e1, e2)
    assert torch.isfinite(out).all()
