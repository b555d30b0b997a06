"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU (the kernels have no CPU
mode; their plain versions are tested against JAX in test_torch_kernels.py
and test_torch_relbias_train.py).
This file imports no JAX, so on a machine with a card and without JAX it
runs alone, past tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import pytest
import torch

from vqcpcb_tpu_torch.ops import attention_kernels as ak
from vqcpcb_tpu_torch.ops import vq_kernels as vk
from vqcpcb_tpu_torch.ops.masks import anticausal_mask, causal_mask


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,s", [(4096, 2, 8, 16), (7, 1, 130, 200)])
def test_nearest_codebook_kernel_on_card(gen, n, k, d, s):
    x = torch.randn((n, k, d), generator=gen, device="cuda")
    e = torch.randn((k, s, d), generator=gen, device="cuda")
    before = vk.launches
    got = vk.nearest_codebook_indices(x, e)
    assert vk.launches == before + 1
    assert torch.equal(got, vk.nearest_codebook_indices_plain(x, e))


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,dot_dtype", [(96, 24, torch.bfloat16),
                                           (64, 64, torch.bfloat16),
                                           (24, 24, torch.float32)])
def test_relbias_kernel_on_card(gen, t, s, dot_dtype):
    """bf16 dots: the same rounding points on both sides, f32 sums in two
    orders; a weight may land one bf16 ulp (2**-8 relative) apart, moving an
    output by < 2e-3 here. f32 dots: 1e-5."""
    b, h, d = 2, 2, 32
    q = torch.randn((b, h, t, d), generator=gen, device="cuda") * d ** -0.5
    k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
            for _ in range(2))
    e1, e2 = (torch.randn((h, s, d), generator=gen, device="cuda")
              for _ in range(2))
    mask = (causal_mask(t, device="cuda") if t == s
            else anticausal_mask(s, sz_tgt=t, device="cuda"))
    before = ak.launches
    got = ak.relbias_attention_fwd(q, k, v, mask, e1, e2, dot_dtype=dot_dtype)
    assert ak.launches == before + 1
    want = ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2, dot_dtype)
    atol = 2e-3 if dot_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.randn((8, 1, 3), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        vk.nearest_codebook_indices(x.double(), torch.randn((1, 4, 3), device="cuda").double())
    q = torch.randn((1, 1, 8, 12), generator=gen, device="cuda")    # head dim 12
    e = torch.randn((1, 8, 12), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ak.relbias_attention_fwd(q, q, q, None, e, e)


def _train_case(gen, b, h, t, s, d, packed, dtype):
    """Inputs of the training kernels: (B, H, L, d), or packed (B, L, H*d)."""
    q = torch.randn((b, h, t, d), generator=gen, device="cuda") * d ** -0.5
    k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda") for _ in range(2))
    g = torch.randn((b, h, t, d), generator=gen, device="cuda")
    e1, e2 = (torch.randn((h, s, d), generator=gen, device="cuda") for _ in range(2))
    mask = (causal_mask(t, device="cuda") if t == s
            else anticausal_mask(s, sz_tgt=t, device="cuda"))
    if packed:
        q, k, v, g = (x.transpose(1, 2).reshape(b, x.shape[2], h * d)
                      for x in (q, k, v, g))
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    return q, k, v, mask, e1, e2, g


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,packed,dropout,dtype", [
    (64, 64, True, 0.2, torch.bfloat16),
    (96, 24, False, 0.2, torch.float32),
    (24, 24, True, 0.0, torch.float32),
    (32, 32, False, 0.1, torch.bfloat16),
])
def test_relbias_train_kernels_on_card(gen, t, s, packed, dropout, dtype):
    """Forward and backward kernels against their plain versions, bf16 dots:
    the same rounding points and the same dropout mask on both sides; f32
    sums in other orders may round a weight or a score gradient to the
    neighbouring bf16 value (2**-8 of one term), so each result must lie
    within 4e-3 of max(1, its max |value|) (bf16 outputs add their own
    rounding of 2**-9 relative). e2's gradient under the causal mask is
    exactly 0."""
    b, h, d = 2, 2, 32
    nh = h if packed else None
    q, k, v, mask, e1, e2, g = _train_case(gen, b, h, t, s, d, packed, dtype)
    kw = dict(num_heads=nh, dropout=dropout, seed=77)
    before = (ak.launches, ak.bwd_launches)
    got = [ak.relbias_attention_fwd(q, k, v, mask, e1, e2, **kw),
           *ak.relbias_attention_bwd(q, k, v, mask, e1, e2, g, **kw)]
    assert (ak.launches, ak.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = [ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2, **kw),
            *ak.relbias_attention_bwd_plain(q, k, v, mask, e1, e2, g, **kw)]
    for name, a, w in zip(("out", "dq", "dk", "dv", "dmask", "de1", "de2"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        err = (a.float() - w.float()).abs().max().item()
        assert err <= 4e-3 * max(1.0, w.float().abs().max().item()), (name, err)
    if t == s:
        assert not got[-1].any()


@pytest.mark.cuda
def test_relbias_kernel_dropout_mask_is_the_hash(gen):
    """With v the one-hot columns the kernel's output is its dropped weight
    row: zero exactly where the hash drops (or the weight underflows)."""
    b, h, t, s, d = 2, 2, 32, 32, 32
    q, k, _, mask, e1, e2, _ = _train_case(gen, b, h, t, s, d, False, torch.float32)
    v = torch.eye(s, d, device="cuda").expand(b, h, s, d).contiguous()
    out = ak.relbias_attention_fwd(q, k, v, mask, e1, e2, dropout=0.2, seed=5)
    w = ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2, dropout=0.0)
    keep = ak.dropout_keep_plain((t, s), 0.2, ak._stream_seeds(5, b, h, "cuda"))
    live = w[..., :s] > 0
    assert torch.equal((out[..., :s] != 0) & live, keep & live)


@pytest.mark.cuda
def test_relbias_backward_raises_on_what_it_does_not_take(gen):
    q, k, v, mask, e1, e2, g = _train_case(gen, 1, 2, 16, 16, 32, True, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 inputs need bf16 dots"):
        ak.relbias_attention_bwd(q, k, v, mask, e1, e2, g, torch.float32, num_heads=2)
