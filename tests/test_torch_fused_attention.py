"""The port's fused attention (K4, and K6's forward and backward) against
the JAX Pallas kernels on the CPU: the plain versions (what the CUDA
kernels compute) against fused_attention and fused_attention_train run in
interpret mode, as tests/test_pallas_attention.py runs them; K6's dropout
stream bit for bit; and the attention module's training route without a
relative bias against the JAX module."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vqcpcb_tpu.ops.pallas_attention as pa
from vqcpcb_tpu.ops.attention import MultiheadAttention as JaxMHA
from vqcpcb_tpu.ops.masks import anticausal_mask as jax_anticausal
from vqcpcb_tpu.ops.masks import causal_mask as jax_causal
from vqcpcb_tpu.ops.relative_attention import \
    subsampled_relative_bias as jax_relative_bias
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.ops import attention_kernels as ak
from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
from vqcpcb_tpu_torch.ops.attention import MultiheadAttention

B, H, D = 2, 2, 8
GRADS = ("out", "dq", "dk", "dv", "dmask", "dbias")


def _t(a):
    return torch.from_numpy(np.array(a))


def _mask(kind, t, s):
    if kind == "causal":
        return np.asarray(jax_causal(t))
    if kind == "anticausal":
        return np.asarray(jax_anticausal(s, sz_tgt=None if t == s else t))
    return None


def _case(t, s, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, t, D) * D ** -0.5).astype(np.float32)
    k = rng.randn(B, H, s, D).astype(np.float32)
    v = rng.randn(B, H, s, D).astype(np.float32)
    g = rng.randn(B, H, t, D).astype(np.float32)
    e1 = rng.randn(H, s, D).astype(np.float32)
    e2 = rng.randn(H, s, D).astype(np.float32)
    return q, k, v, g, e1, e2


# ---- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("t,s,kind,relative", [
    (16, 16, "causal", False), (16, 8, None, False),
    (16, 16, "causal", True), (16, 8, "anticausal", True)])
def test_fused_attention_plain_matches_jax(t, s, kind, relative):
    """The plain K4 against pa.fused_attention in interpret mode, with the
    zero placeholder and with an e1 table (on the CPU the relbias gate is
    off, so JAX builds the skew bias and calls K4 with it): f32 throughout,
    sums in other orders, within 1e-5."""
    q, k, v, _, e1, e2 = _case(t, s)
    mask = _mask(kind, t, s)
    want = pa.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask),
                              jnp.asarray(e1) if relative else None,
                              jnp.asarray(e2) if relative else None,
                              interpret=True)
    bias = None
    if relative:
        bias = _t(jax_relative_bias(jnp.asarray(q), jnp.asarray(e1),
                                    jnp.asarray(e2))).reshape(B * H, t, s)
    got = fk.fused_attention(_t(q), _t(k), _t(v),
                             None if mask is None else _t(mask), bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 rounds: 10 mantissa bits, to
    nearest, ties away from zero (on the sign-magnitude bit pattern)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _product_3xtf32(a, b):
    """a (..., M, K) . b (..., K, N) as the kernel's tensor cores take it:
    each operand split into tf32 halves, hi = tf32(x) and lo = tf32(x - hi);
    per k-step of 8, the accumulator takes lo.hi, then hi.lo, then hi.hi,
    each an 8-term f32 sum of exact products."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = acc + x[..., ks] @ y[..., ks, :]
    return acc


def _k4_emulated(q, k, v, mask, bias=None):
    """The arithmetic of csrc/attention_fwd_f32.cuh in PyTorch: query tiles
    of 64 rows, key blocks of 64, both products in 3xTF32, an online softmax
    (running max and sum, the output rescaled, one division at the end), and
    the exact skip of key blocks whose mask entries over the tile are all
    the -1e30 clamp, taken only when every row of the tile has an entry
    above -1e29."""
    b, h, t, d = q.shape
    s = k.shape[2]
    mask = fk.finite_mask(mask, t, s, q.device)
    bias = None if bias is None else bias.expand(b * h, t, s).reshape(b, h, t, s)
    out = torch.empty_like(q)
    for t0 in range(0, t, 64):
        rows = slice(t0, min(t0 + 64, t))
        mt = mask[rows]
        skips = bool((mt > -1e29).any(-1).all())
        m = torch.full(q[:, :, rows, :1].shape, -float("inf"))
        l = torch.zeros_like(m)
        o = torch.zeros_like(q[:, :, rows])
        for s0 in range(0, s, 64):
            keys = slice(s0, min(s0 + 64, s))
            if skips and bool((mt[:, keys] == -1e30).all()):
                continue
            sc = _product_3xtf32(q[:, :, rows], k[:, :, keys].transpose(-1, -2))
            sc = sc + mt[:, keys]
            if bias is not None:
                sc = sc + bias[:, :, rows, keys]
            mx = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - mx)
            p = torch.exp(sc - mx)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + _product_3xtf32(p, v[:, :, keys])
            m = mx
        out[:, :, rows] = o / l
    return out


@pytest.mark.parametrize("t,s,kind,masked_row", [
    (384, 384, "causal", None), (384, 24, None, None),
    (24, 24, "anticausal", None), (100, 100, "causal", 70),
    (100, 100, "causal", None)])
def test_k4_kernel_arithmetic_holds_the_plain_bound(t, s, kind, masked_row):
    """The CUDA kernel's order of sums and its 3xTF32 split, emulated, stay
    within K4's 1e-5 of the plain version: the absolute decoder's three
    shapes, a fully masked row (its tile skips nothing: weights 1/S) and
    ragged tiles and key blocks; q ~ randn * d**-0.5, k, v ~ randn."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy((rng.randn(1, 2, t, 64) * 64 ** -0.5).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(1, 2, s, 64).astype(np.float32))
            for _ in range(2))
    mask = _mask(kind, t, s)
    mask = None if mask is None else _t(mask)
    if masked_row is not None:
        mask[masked_row] = -float("inf")
    got = _k4_emulated(q, k, v, mask)
    want = fk.fused_attention_plain(q, k, v, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if masked_row is not None:
        torch.testing.assert_close(got[0, :, masked_row],
                                   v[0].mean(1), rtol=0, atol=1e-5)


# ---- K6 ---------------------------------------------------------------------

def test_k6_dropout_stream_is_the_flat_grid_index():
    """Plane (b, h) of K6's mask is _dropout_keep on stream seed + b*H + h
    (program_id over the flat (B*H,) grid), bit for bit; the relbias
    kernels' stream seed + h*B + b gives a different mask."""
    seeds = fk.flat_stream_seeds(2 ** 31 - 7, 3, 2, "cpu")
    keep = ak.dropout_keep_plain((8, 8), 0.2, seeds)
    for b in range(3):
        for h in range(2):
            want = pa._dropout_keep((8, 8), 0.2, jnp.int32(2 ** 31 - 7 + b * 2 + h))
            np.testing.assert_array_equal(keep[b, h].numpy(), np.asarray(want))
    assert not torch.equal(keep, ak.dropout_keep_plain(
        (8, 8), 0.2, ak._stream_seeds(2 ** 31 - 7, 3, 2, "cpu")))


def _jax_k6(q, k, v, mask, bias, g, rate, seed):
    """Output and the VJP of q, k, v, mask and bias through
    fused_attention_train in interpret mode (mask clamped as the JAX module
    does)."""
    mask_f = np.maximum(mask, pa.NEG_BIG).astype(np.float32)

    def f(*a):
        return pa.fused_attention_train(rate, True, jnp.full((1,), seed, jnp.int32), *a)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v, mask_f, bias)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _port_k6(q, k, v, mask, bias, g, rate, seed, dot_dtype):
    args = (_t(q), _t(k), _t(v), _t(mask), _t(bias))
    out = fk.fused_attention_train_fwd(*args, dot_dtype, dropout=rate, seed=seed)
    dq, dk, dv, dmask, dbias = fk.fused_attention_train_bwd(
        *args, _t(g), dot_dtype, dropout=rate, seed=seed)
    if dbias is None:                       # the placeholder's zero cotangent
        dbias = torch.zeros_like(args[-1])
    return [x.numpy() for x in (out, dq, dk, dv, dmask, dbias)]


def _k6_inputs(t, s, kind, real_bias, seed):
    q, k, v, g, _, _ = _case(t, s, seed)
    rng = np.random.RandomState(seed + 100)
    bias = (rng.randn(B * H, t, s).astype(np.float32) if real_bias
            else np.zeros((B * H, 1, 1), np.float32))
    mask = _mask(kind, t, s)
    if mask is None:                        # the cross-attention's zero mask
        mask = np.zeros((t, s), np.float32)
    return q, k, v, mask, bias, g


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("real_bias", [False, True])
@pytest.mark.parametrize("t,s,kind", [(16, 16, "causal"), (16, 8, None)])
def test_k6_plain_matches_jax_f32_dots(monkeypatch, t, s, kind, real_bias, rate):
    """f32 dots on both sides (VQCPCB_PALLAS_BF16_DOTS=0): out, dq, dk, dv,
    dmask and dbias within 1e-5 of max(1, each result's max |value|); the
    placeholder's cotangent is exactly 0 and JAX's dmask is the in-kernel
    accumulation of K6-bwd-nobias."""
    monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", "0")
    inputs = _k6_inputs(t, s, kind, real_bias, 1)
    want = _jax_k6(*inputs, rate, 11)
    got = _port_k6(*inputs, rate, 11, torch.float32)
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape, name
        err = np.abs(a - w).max()
        assert err <= 1e-5 * max(1.0, np.abs(w).max()), (name, err)
    if not real_bias:
        assert not want[-1].any() and not got[-1].any()


@pytest.mark.parametrize("real_bias", [False, True])
def test_k6_plain_matches_jax_bf16_dots(monkeypatch, real_bias):
    """The shipping bf16 rule at dropout 0.2: the f32 sums before each bf16
    rounding run in another order, so a weight or a score gradient may
    round to the neighbouring bf16 value (2**-8 relative), moving a result
    by at most 2**-8 of one term: 2e-3 of max(1, max |value|)."""
    monkeypatch.setenv("VQCPCB_PALLAS_BF16_DOTS", "1")
    inputs = _k6_inputs(16, 16, "causal", real_bias, 2)
    want = _jax_k6(*inputs, 0.2, 3)
    got = _port_k6(*inputs, 0.2, 3, torch.bfloat16)
    for name, a, w in zip(GRADS, got, want):
        err = np.abs(a - w).max()
        assert err <= 2e-3 * max(1.0, np.abs(w).max()), (name, err)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k6_plain_backward_is_the_gradient_of_the_plain_forward(rate):
    """At f32 dots the hand-written backward equals torch autograd through
    the plain forward (same dropout mask), packed layout, real bias:
    1e-5 relative to each gradient's scale."""
    q, k, v, mask, bias, g = (_t(a) for a in _k6_inputs(16, 8, "anticausal", True, 4))
    pack = lambda x: x.transpose(1, 2).reshape(B, x.shape[2], H * D)  # noqa: E731
    leaves = [pack(q), pack(k), pack(v), mask.clamp_min(-1e30), bias]
    for x in leaves:
        x.requires_grad_(True)
    kw = dict(num_heads=H, dropout=rate, seed=6)
    out = fk.fused_attention_train_fwd_plain(*leaves, torch.float32, **kw)
    out.backward(pack(g))
    got = fk.fused_attention_train_bwd_plain(*[x.detach() for x in leaves],
                                             pack(g), torch.float32, **kw)
    for name, a, x in zip(GRADS[1:], got, leaves):
        torch.testing.assert_close(a, x.grad, rtol=1e-5,
                                   atol=1e-5 * float(x.grad.abs().max()), msg=name)


@pytest.mark.parametrize("kernel", ["relbias", "fused"])
def test_one_hot_v_reads_the_rounded_dropped_weights(kernel):
    """The premise of the forward kernels' weight check on the card: with v
    the one-hot columns of a block of keys, the bf16-dot plain forward
    returns bf16(w_drop) there exactly (one product of a bf16 weight and 1,
    and zeros, in f32). Causal mask, dropout 0.2, packed bf16 inputs."""
    t = s = 32
    q, k, _, g, e1, e2 = (_t(a) for a in _case(t, s, 5))
    mask = _t(_mask("causal", t, s)).clamp_min(-1e30)
    pack = lambda x: x.transpose(1, 2).reshape(B, x.shape[2], H * D)  # noqa: E731
    q, k, g = (pack(x).to(torch.bfloat16) for x in (q, k, g))
    extra = (e1, e2) if kernel == "relbias" else (None,)
    fwd, weights = ((ak.relbias_attention_fwd_plain, ak.relbias_attention_bwd_weights_plain)
                    if kernel == "relbias" else
                    (fk.fused_attention_train_fwd_plain,
                     fk.fused_attention_train_bwd_weights_plain))
    kw = dict(num_heads=H, dropout=0.2, seed=9)
    for c0 in range(0, s, D):
        v = torch.zeros((B, H, s, D))
        v[:, :, c0:c0 + D] = torch.eye(D)
        v = pack(v).to(torch.bfloat16)
        out = fwd(q, k, v, mask, *extra, **kw)
        w_drop, _ = weights(q, k, v, mask, *extra, g, **kw)
        got = out.unflatten(-1, (H, D)).transpose(1, 2)
        want = w_drop[..., c0:c0 + D].to(torch.bfloat16)
        assert (want == 0).any() and (want > 0).any()
        assert torch.equal(got, want)


def test_autograd_function_routes_and_gives_the_bias_its_cotangent():
    """FusedAttentionTrain on CPU tensors: no launch; q, k, v and a real
    bias get the plain backward's gradients, a placeholder zeros, and the
    mask none when it does not require one."""
    q, k, v, mask, bias, g = (_t(a) for a in _k6_inputs(16, 16, "causal", True, 5))
    before = (fk.train_fwd_launches, fk.train_bwd_launches,
              fk.train_bwd_nobias_launches)
    for b in (bias, torch.zeros((B * H, 1, 1))):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v, b)]
        out = fk.FusedAttentionTrain.apply(leaves[0], leaves[1], leaves[2], mask,
                                           leaves[3], None, 0.2, 4, torch.float32)
        out.backward(g)
        want = fk.fused_attention_train_bwd_plain(q, k, v, mask, b, g, torch.float32,
                                                  dropout=0.2, seed=4)
        for x, w in zip(leaves, want[:3] + (want[4],)):
            torch.testing.assert_close(x.grad, torch.zeros_like(x) if w is None else w,
                                       rtol=0, atol=0)
    assert (fk.train_fwd_launches, fk.train_bwd_launches,
            fk.train_bwd_nobias_launches) == before


# ---- the attention module -----------------------------------------------------

@pytest.mark.parametrize("t,s,self_attn", [(16, 16, True), (16, 8, False)])
def test_mha_training_route_without_bias_matches_jax(t, s, self_attn):
    """Train mode without a relative bias (K6 with the placeholder, f32 on
    the CPU) against the JAX module's training forward at dropout 0: output
    and the gradients of the inputs and of every parameter within 1e-5 of
    each result's scale."""
    jm = JaxMHA(embed_dim=16, num_heads=H, dropout=0.0)
    rng = np.random.RandomState(7)
    xq = rng.randn(2, t, 16).astype(np.float32)
    xk = xq if self_attn else rng.randn(2, s, 16).astype(np.float32)
    g = rng.randn(2, t, 16).astype(np.float32)
    mask = np.asarray(jax_causal(t)) if self_attn else None
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(xq), jnp.asarray(xk), jnp.asarray(xk))["params"])

    def jloss(p, q_in, k_in):
        k_in = q_in if self_attn else k_in
        out, _ = jm.apply({"params": p}, q_in, k_in, k_in,
                          attn_mask=None if mask is None else jnp.asarray(mask),
                          training=True)
        return (out * g).sum(), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(xq), jnp.asarray(xk))
    m = MultiheadAttention(16, H).train()
    m.load_state_dict(convert._attention(params, ""), strict=True)
    q_in = _t(xq).requires_grad_(True)
    k_in = q_in if self_attn else _t(xk).requires_grad_(True)
    out, weights = m(q_in, k_in, attn_mask=None if mask is None else _t(mask))
    assert weights is None
    out.backward(_t(g))
    scale = lambda w: max(1.0, float(np.abs(np.asarray(w)).max()))  # noqa: E731
    assert float((out.detach() - _t(want)).abs().max()) <= 1e-5 * scale(want)
    assert float((q_in.grad - _t(jgrads[1])).abs().max()) <= 1e-5 * scale(jgrads[1])
    if not self_attn:
        assert float((k_in.grad - _t(jgrads[2])).abs().max()) <= 1e-5 * scale(jgrads[2])
    want_grads = convert._attention(jax.tree.map(np.asarray, jgrads[0]), "")
    for name, p in m.named_parameters():
        w = want_grads[name]
        assert float((p.grad - w).abs().max()) <= 1e-5 * scale(w), name


def test_mha_training_route_without_bias_applies_k6_dropout():
    """Train mode with dropout and no relative bias drops attention weights
    with K6's hash on the seed drawn from `seed_generator` -- the route the
    port lacked before (an attention without a bias took `attend`, which
    applies no attention-weight dropout)."""
    m = MultiheadAttention(16, H, dropout=0.5).train()
    m.seed_generator = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(1))
    mask = _t(jax_causal(16))
    with torch.no_grad():
        out, _ = m(x, x, attn_mask=mask)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=torch.Generator().manual_seed(3)))
        qkv = torch.nn.functional.linear(x, m.in_proj_weight, m.in_proj_bias)
        att = fk.fused_attention_train_fwd_plain(
            qkv[..., :16] * (16 // H) ** -0.5, qkv[..., 16:32], qkv[..., 32:], mask,
            None, torch.float32, num_heads=H, dropout=0.5, seed=seed)
        plain, _ = m.eval()(x, x, attn_mask=mask)
    torch.testing.assert_close(out, m.out_proj(att), rtol=0, atol=0)
    assert float((out - plain).abs().max()) > 1e-2
