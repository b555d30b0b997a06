"""The f32-dot relative-bias attention at the flagship's full length, on the
CPU: the port's plain forward and backward (what the streamed f32-dot CUDA
kernels compute) against JAX's packed kernels run in interpret mode under
VQCPCB_PALLAS_BF16_DOTS=0, at T = S = 384 (causal and anticausal) and at
T = 384, S = 24 (ratio 16, the AC/AC/C cross-attention), dropout 0 and 0.2.
The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py)."""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vqcpcb_tpu.ops.pallas_attention as pa
from vqcpcb_tpu.ops.masks import anticausal_mask as jax_anticausal
from vqcpcb_tpu.ops.masks import causal_mask as jax_causal
from vqcpcb_tpu_torch.ops import attention_kernels as ak

B, H, D = 1, 2, 16
GRADS = ("out", "dq", "dk", "dv", "dmask", "de1", "de2")


def _case(t, s, kind, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, t, H * D) * D ** -0.5).astype(np.float32)
    k, v = (rng.randn(B, s, H * D).astype(np.float32) for _ in range(2))
    e1, e2 = (rng.randn(H, s, D).astype(np.float32) for _ in range(2))
    g = rng.randn(B, t, H * D).astype(np.float32)
    mask = np.asarray(jax_causal(t) if kind == "causal"
                      else jax_anticausal(s, sz_tgt=None if t == s else t))
    return q, k, v, mask, e1, e2, g


def _jax(q, k, v, mask, e1, e2, g, rate, seed, causal):
    """Output and every input's VJP through the packed kernels in interpret
    mode (the mask clamped as the JAX module does); a causal case inside
    relbias_causal_scope, where JAX takes its narrow table."""
    mask_f = np.maximum(mask, pa.NEG_BIG).astype(np.float32)

    def f(*a):
        return pa.fused_attention_train_relbias_packed(
            rate, True, H, jnp.full((1,), seed, jnp.int32), *a)

    scope = pa.relbias_causal_scope() if causal else contextlib.nullcontext()
    with scope:
        out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v, mask_f, e1, e2)))
        grads = vjp(jnp.asarray(g))
    return [np.asarray(x) for x in (out, *grads)]


def _port(q, k, v, mask, e1, e2, g, rate, seed):
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    args = (t(q), t(k), t(v), t(mask), t(e1), t(e2))
    kw = dict(num_heads=H, dropout=rate, seed=seed)
    out = ak.relbias_attention_fwd(*args, torch.float32, **kw)
    grads = ak.relbias_attention_bwd(*args, t(g), torch.float32, **kw)
    return [x.numpy() for x in (out, *grads)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("t,s,kind", [(384, 384, "causal"),
                                      (384, 384, "anticausal"),
                                      (384, 24, "anticausal")])
def test_f32_dots_at_full_length_match_jax(monkeypatch, t, s, kind, rate):
    """f32 dots on both sides: the same sums in another order, each result
    within 1e-5 of max(1, its max |value|); under the causal mask e2's
    gradient is exactly 0 (JAX's narrow table gives it by construction)."""
    monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", "0")
    inputs = _case(t, s, kind, seed=t + s)
    want = _jax(*inputs, rate, 21, kind == "causal")
    got = _port(*inputs, rate, 21)
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape, name
        err = np.abs(a - w).max()
        assert err <= 1e-5 * max(1.0, np.abs(w).max()), (name, err)
    if kind == "causal":
        assert not got[GRADS.index("de2")].any()
