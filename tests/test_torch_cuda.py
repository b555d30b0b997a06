"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU (the kernels have no CPU
mode; their plain versions are tested against JAX in test_torch_kernels.py).
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
