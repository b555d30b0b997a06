"""The port's relative-bias training attention against the JAX Pallas
kernels on the CPU: the dropout hash bit for bit, and the plain forward and
backward (what the CUDA kernels compute) against
fused_attention_train_relbias_packed run in interpret mode, as
tests/test_pallas_attention.py runs it."""
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

H, D = 2, 8
GRADS = ("out", "dq", "dk", "dv", "dmask", "de1", "de2")


@pytest.mark.parametrize("shape", [(16, 16), (32, 16), (7, 13)])
@pytest.mark.parametrize("rate", [0.1, 0.2])
def test_dropout_keep_matches_jax_bit_for_bit(shape, rate):
    """Seeds at both ends of int32, so the wrapping uint32 products are
    exercised; the masks must be equal, not close."""
    for seed in (0, 7, 123456789, 2 ** 31 - 2):
        want = np.asarray(pa._dropout_keep(shape, rate, jnp.int32(seed)))
        got = ak.dropout_keep_plain(shape, rate, seed).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.5 * rate < 1.0 - want.mean() < 2.0 * rate or want.size < 100


def test_dropout_keep_stream_per_batch_and_head():
    """The (b, h) plane uses stream seed + h*B + b (pallas_attention.py:883)."""
    seeds = ak._stream_seeds(11, 3, 2, "cpu")
    keep = ak.dropout_keep_plain((8, 8), 0.2, seeds)
    assert keep.shape == (3, 2, 8, 8)
    np.testing.assert_array_equal(
        keep[2, 1].numpy(), np.asarray(pa._dropout_keep((8, 8), 0.2, jnp.int32(11 + 1 * 3 + 2))))


def _case(t, s, kind, seed=0):
    rng = np.random.RandomState(seed)
    b = 2
    q = (rng.randn(b, t, H * D) * D ** -0.5).astype(np.float32)
    k = rng.randn(b, s, H * D).astype(np.float32)
    v = rng.randn(b, s, H * D).astype(np.float32)
    e1 = rng.randn(H, s, D).astype(np.float32)
    e2 = rng.randn(H, s, D).astype(np.float32)
    g = rng.randn(b, t, H * D).astype(np.float32)
    if kind == "causal":
        mask = np.asarray(jax_causal(t))
    else:
        mask = np.asarray(jax_anticausal(s, sz_tgt=None if t == s else t))
    return q, k, v, mask, e1, e2, g


def _jax_fwd_bwd(q, k, v, mask, e1, e2, g, rate, seed, causal):
    """Output and the VJP of every input (mask clamped as the JAX module
    does) through the packed kernels in interpret mode; a causal case runs
    inside relbias_causal_scope, where JAX takes its narrow table."""
    mask_f = np.maximum(mask, pa.NEG_BIG).astype(np.float32)

    def f(*a):
        return pa.fused_attention_train_relbias_packed(
            rate, True, H, jnp.full((1,), seed, jnp.int32), *a)

    scope = pa.relbias_causal_scope() if causal else contextlib.nullcontext()
    with scope:
        out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v, mask_f, e1, e2)))
        grads = vjp(jnp.asarray(g))
    return [np.asarray(x) for x in (out, *grads)]


def _port_fwd_bwd(q, k, v, mask, e1, e2, g, rate, seed, dot_dtype):
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    args = (t(q), t(k), t(v), t(mask), t(e1), t(e2))
    out = ak.relbias_attention_fwd(*args, dot_dtype, num_heads=H,
                                   dropout=rate, seed=seed)
    grads = ak.relbias_attention_bwd(*args, t(g), dot_dtype, num_heads=H,
                                     dropout=rate, seed=seed)
    return [x.numpy() for x in (out, *grads)]


_CASES = [(16, 16, "anticausal"), (16, 16, "causal"), (32, 16, "anticausal")]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("t,s,kind", _CASES)
def test_relbias_train_plain_matches_jax_f32_dots(monkeypatch, t, s, kind, rate):
    """f32 dots on both sides (VQCPCB_PALLAS_BF16_DOTS=0): the same sums in
    another order, each result within 1e-5 of max(1, its max |value|). The
    causal case also checks e2's gradient is exactly 0, which JAX's narrow
    table gives by construction."""
    monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", "0")
    inputs = _case(t, s, kind)
    want = _jax_fwd_bwd(*inputs, rate, 5, kind == "causal")
    got = _port_fwd_bwd(*inputs, rate, 5, torch.float32)
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape, name
        err = np.abs(a - w).max()
        assert err <= 1e-5 * max(1.0, np.abs(w).max()), (name, err)
    if kind == "causal":
        assert not got[GRADS.index("de2")].any()


@pytest.mark.parametrize("t,s,kind", _CASES)
def test_relbias_train_plain_matches_jax_bf16_dots(monkeypatch, t, s, kind):
    """The shipping bf16 rule at dropout 0.2. The f32 sums before each bf16
    rounding run in another order, so a weight or a score gradient may round
    to the neighbouring bf16 value (2**-8 relative), moving a result by at
    most 2**-8 of one term: 2e-3 of max(1, max |value|) bounds it here."""
    monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", "1")
    inputs = _case(t, s, kind, seed=1)
    want = _jax_fwd_bwd(*inputs, 0.2, 9, kind == "causal")
    got = _port_fwd_bwd(*inputs, 0.2, 9, torch.bfloat16)
    for name, a, w in zip(GRADS, got, want):
        err = np.abs(a - w).max()
        assert err <= 2e-3 * max(1.0, np.abs(w).max()), (name, err)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_backward_is_the_gradient_of_the_plain_forward(rate):
    """At f32 dots the hand-written backward equals torch autograd through
    the plain forward (same dropout mask), in the (B, H, L, d) layout:
    1e-5 relative to each gradient's scale."""
    q, k, v, mask, e1, e2, g = (torch.from_numpy(a.copy()) for a in _case(32, 16, "anticausal", 2))
    unpack = lambda x: x.unflatten(-1, (H, D)).transpose(1, 2).contiguous()  # noqa: E731
    leaves = [unpack(q), unpack(k), unpack(v), mask.clamp_min(-1e30), e1, e2]
    for x in leaves:
        x.requires_grad_(True)
    out = ak.relbias_attention_fwd_plain(*leaves, torch.float32, dropout=rate, seed=3)
    out.backward(unpack(g))
    got = ak.relbias_attention_bwd_plain(*[x.detach() for x in leaves], unpack(g),
                                         torch.float32, dropout=rate, seed=3)
    for name, a, x in zip(GRADS[1:], got, leaves):
        torch.testing.assert_close(a, x.grad, rtol=1e-5,
                                   atol=1e-5 * float(x.grad.abs().max()), msg=name)


def test_autograd_function_routes_and_skips_the_mask_gradient():
    """RelbiasAttention on CPU tensors: gradients equal the plain backward,
    and the mask gets none when it does not require one."""
    q, k, v, mask, e1, e2, g = (torch.from_numpy(a.copy()) for a in _case(16, 16, "causal", 3))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, e1, e2)]
    before = (ak.launches, ak.bwd_launches)
    out = ak.RelbiasAttention.apply(leaves[0], leaves[1], leaves[2], mask,
                                    leaves[3], leaves[4], H, 0.2, 4, torch.float32)
    out.backward(g)
    assert (ak.launches, ak.bwd_launches) == before   # CPU tensors: plain versions
    want = ak.relbias_attention_bwd_plain(q, k, v, mask, e1, e2, g, torch.float32,
                                          num_heads=H, dropout=0.2, seed=4)
    for x, w in zip(leaves, (want[0], want[1], want[2], want[4], want[5])):
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)
