"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU (the kernels have no CPU
mode; their plain versions are tested against JAX in test_torch_kernels.py,
test_torch_relbias_train.py and test_torch_fused_attention.py).
This file imports no JAX, so on a machine with a card and without JAX it
runs alone, past tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import pytest
import torch

from vqcpcb_tpu_torch.ops import attention_kernels as ak
from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
from vqcpcb_tpu_torch.ops import vq_kernels as vk
from vqcpcb_tpu_torch.ops._kernel_io import bwd_scratch, heads, scratch_planes
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
@pytest.mark.parametrize("n", [1440, 96])
def test_nearest_codebook_kernel_at_encoder_training_shapes(gen, n):
    """The encoder-training step's K1 shapes (the negatives' 1,440 windows,
    the 96 left or right blocks), codebook 32 x 3: equal to the plain
    version on every row whose two smallest distances lie more than 1e-6
    relative apart (nearer rows may round either way between two summation
    orders)."""
    x = torch.randn((n, 1, 3), generator=gen, device="cuda") * 4
    e = torch.randn((1, 32, 3), generator=gen, device="cuda") * 4
    got = vk.nearest_codebook_indices(x, e)
    want = vk.nearest_codebook_indices_plain(x, e)
    dist = ((x * x).sum(-1, keepdim=True) - 2.0 * torch.einsum("nkd,ksd->nks", x, e)
            + (e * e).sum(-1)[None])
    two = dist.topk(2, dim=-1, largest=False).values
    margin = (two[..., 1] - two[..., 0]) > 1e-6 * two.abs().amax(-1).clamp_min(1.0)
    assert not ((got != want) & margin).any()


def _outside_margin(x, e):
    """Rows whose two smallest distances lie more than 1e-6 relative apart
    (nearer rows may round either way between two summation orders)."""
    dist = ((x * x).sum(-1, keepdim=True) - 2.0 * torch.einsum("nkd,ksd->nks", x, e)
            + (e * e).sum(-1)[None])
    two = dist.topk(2, dim=-1, largest=False).values
    return (two[..., 1] - two[..., 0]) > 1e-6 * two.abs().amax(-1).clamp_min(1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,s,kind", [(1, 3, 32, "d3_s32"), (2, 4, 16, "d4_s16")])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 96, 12288])
def test_nearest_codebook_instances_equal_the_runtime_kernel(gen, n, k, d, s, kind):
    """The compiled instances at the row-group and block edges: the shape
    picks the instance, whose indices equal the run-time kernel's bit for
    bit and the plain version's outside the margin; one launch, counted
    under the instance's kind."""
    x = torch.randn((n, k, d), generator=gen, device="cuda") * 4
    e = torch.randn((k, s, d), generator=gen, device="cuda") * 4
    assert vk.kernel_kind(d, s) == kind
    before, before_kind = vk.launches, vk.launches_by_kind[kind]
    got = vk.nearest_codebook_indices(x, e)
    assert vk.launches == before + 1
    assert vk.launches_by_kind[kind] == before_kind + 1
    runtime = vk.nearest_codebook_indices_cuda(x, e, kind="runtime")
    assert torch.equal(got, runtime)
    want = vk.nearest_codebook_indices_plain(x, e)
    assert not ((got != want) & _outside_margin(x, e)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("d,s", [(3, 32), (4, 16), (5, 40)])
def test_nearest_codebook_duplicated_codes_give_the_lowest_index(gen, d, s):
    """Codes duplicated within a lane's share, across lanes and everywhere:
    rows that sit on a duplicated code take its lowest index, in the
    instances and in the run-time kernel."""
    e = torch.randn((1, s, d), generator=gen, device="cuda")
    e[0, 2] = e[0, 3] = e[0, s - 1] = e[0, 1]
    x = e[0, torch.tensor([1, 2, 3, s - 1, 0], device="cuda")][:, None].contiguous()
    for kind in (vk.kernel_kind(d, s), "runtime"):
        got = vk.nearest_codebook_indices_cuda(x, e, kind=kind)
        assert got[:, 0].tolist() == [1, 1, 1, 1, 0], kind
        same = e[:, :1].expand(1, s, d).contiguous()
        assert (vk.nearest_codebook_indices_cuda(x, same, kind=kind) == 0).all(), kind


@pytest.mark.cuda
def test_nearest_codebook_instance_refuses_another_shape(gen):
    x = torch.randn((8, 1, 3), generator=gen, device="cuda")
    e = torch.randn((1, 16, 3), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="no K1 kernel"):
        vk.nearest_codebook_indices_cuda(x, e, kind="d3_s32")


@pytest.fixture
def f32_matmuls():
    """Matmuls and cuDNN (the GRUs) in f32, as on the CPU."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("ema", [False, True])
def test_encoder_train_step_on_card_matches_the_cpu(gen, f32_matmuls, ema):
    """One VQCPCEncoderTrainer step of a small VQ-CPC model (GRU 16, batch
    3, 2 + 2 blocks, 3 negatives, dropout 0) on the card and on the CPU
    from the same weights, batch and codebook-init permutation: the loss
    within 1e-4 relative, the codes' metrics equal, and three K1 launches
    on the card (negatives, left, right)."""
    import copy
    import numpy as np
    from vqcpcb_tpu_torch.models.cpc import CModule, FksModule, VQCPCModel
    from vqcpcb_tpu_torch.models.data_processor import BachCPCDataProcessor
    from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
    from vqcpcb_tpu_torch.models.encoder import Encoder
    from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
    from vqcpcb_tpu_torch.ops import quantizer
    from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
    torch.manual_seed(0)
    quant = (quantizer.EMAProductVectorQuantizer(8, 3, 0.25, 1) if ema
             else quantizer.ProductVectorQuantizer(8, 3, 0.25, 1))
    model = VQCPCModel(
        Encoder(BachCPCDataProcessor(8, 16, [7, 9, 6, 8], num_tokens_per_block=16),
                GruDownscaler(8, 3, [16], 16, 2, 0.0, bidirectional=True), quant,
                MlpUpscaler(3, 8, 16, 0.0)),
        CModule(8, 16, 8, 2, 0.0), FksModule(8, 8, 2))
    rng = np.random.RandomState(0)
    batch = {"x_left": rng.randint(0, 6, (3, 8, 4)), "x_right": rng.randint(0, 6, (3, 8, 4)),
             "negative_samples": rng.randint(0, 6, (3, 3, 2, 4, 4))}
    perms = [rng.permutation(18)]
    results = []
    for device in ("cuda", "cpu"):
        trainer = VQCPCEncoderTrainer(copy.deepcopy(model), device=device)
        trainer.init_state(batch, lr=1e-3, perms=perms)
        before = vk.launches
        metrics = trainer.train_step(batch)
        results.append({k: v.cpu() for k, v in metrics.items()})
        if device == "cuda":
            assert vk.launches == before + 3
    card, cpu = results
    assert abs(card["loss"].item() - cpu["loss"].item()) <= 1e-4 * abs(cpu["loss"].item())
    for name in ("num_codewords", "num_codewords_negative"):
        assert card[name].item() == cpu[name].item(), name


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


def _train_case(gen, b, h, t, s, d, packed, dtype, masked_row=None):
    """Inputs of the training kernels: (B, H, L, d), or packed (B, L, H*d);
    `masked_row` masks every key of that query row."""
    q = torch.randn((b, h, t, d), generator=gen, device="cuda") * d ** -0.5
    k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda") for _ in range(2))
    g = torch.randn((b, h, t, d), generator=gen, device="cuda")
    e1, e2 = (torch.randn((h, s, d), generator=gen, device="cuda") for _ in range(2))
    mask = (causal_mask(t, device="cuda") if t == s
            else anticausal_mask(s, sz_tgt=t, device="cuda"))
    if masked_row is not None:
        mask[masked_row] = float("-inf")
    if packed:
        q, k, v, g = (x.transpose(1, 2).reshape(b, x.shape[2], h * d)
                      for x in (q, k, v, g))
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    return q, k, v, mask, e1, e2, g


def _bf16_steps(a, w):
    """How many bf16 values apart a and w lie, entry by entry (0 equal, 1
    neighbours, counting across zero)."""
    def order(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(w)).abs()


def _grad_err(a, w, frac=4e-3):
    """How far kernel result `a` lies past its bound against the plain
    version's `w` (<= 0 within it): frac of max(1, max |w|). An entry of a
    result stored in bf16 that is w's neighbouring bf16 value is within it
    too: two f32 sums a hair apart, in other orders, may round to
    neighbouring bf16 values, one step of which can exceed the bound where
    the max |value| sits low in its binade."""
    err = (a.float() - w.float()).abs()
    if a.dtype == torch.bfloat16:
        err = torch.where(_bf16_steps(a, w) <= 1, 0.0, err)
    limit = frac * max(1.0, w.float().abs().max().item())
    return err.max().item() - limit


def _scratch_differs(scratch, weights_plain, inputs, kw):
    """The entries of the backward's bf16 w_drop and ds scratch that differ
    from the plain version's f32 values rounded to bf16 (both must be 0: a
    weight one bf16 step off moves dv as far as a skipped rounding point)."""
    w_drop, ds = weights_plain(*inputs, **kw)
    b, h, t, s = ds.shape
    return {name: (scratch_planes(x, b, h, t, s) != want.to(torch.bfloat16)).sum().item()
            for name, x, want in (("w_drop", scratch[1], w_drop), ("ds", scratch[0], ds))}


def _weights_differ(fwd, weights_plain, inputs, kw):
    """The entries of the forward's bf16 w_drop that differ from the plain
    version's f32 w_drop rounded to bf16 (must be 0, as for the backward's
    scratch). With v the one-hot columns of a block of d keys, the kernel's
    out is exactly its bf16 w_drop there (one product of a bf16 weight and
    1, and zeros, summed in f32)."""
    q, k, v, mask, *extra, g = inputs
    w_drop, _ = weights_plain(*inputs, **kw)
    b, h, t, s = w_drop.shape
    d = heads(q, kw["num_heads"]).shape[-1]
    differ = 0
    for c0 in range(0, s, d):
        n = min(d, s - c0)
        one_hot = torch.zeros((b, h, s, d), device="cuda")
        one_hot[:, :, c0:c0 + n, :n] = torch.eye(n, device="cuda")
        if kw["num_heads"]:
            one_hot = one_hot.transpose(1, 2).reshape(b, s, h * d)
        vv = torch.empty_strided(k.shape, k.stride(), dtype=v.dtype, device="cuda")
        vv.copy_(one_hot)                  # v shares k's strides, as the kernels ask
        out = heads(fwd(q, k, vv, mask, *extra, **kw), kw["num_heads"])
        want = w_drop[..., c0:c0 + n].to(torch.bfloat16).float()
        differ += (out[..., :n].float() != want).sum().item()
    return differ


# (B, H, T, S, d, packed, dropout, input dtype, fully masked query row):
# the layouts and dtypes, ragged T and S, a fully masked row, ratio 16 (the
# AC/AC/C cross-attention) and every head dim the dispatch takes
TRAIN_CASES = [
    (2, 2, 64, 64, 32, True, 0.2, torch.bfloat16, None),
    (2, 2, 96, 24, 32, False, 0.2, torch.float32, None),
    (2, 2, 24, 24, 32, True, 0.0, torch.float32, None),
    (2, 2, 32, 32, 32, False, 0.1, torch.bfloat16, None),
    (2, 2, 100, 100, 32, False, 0.2, torch.bfloat16, None),
    (2, 2, 17, 17, 32, True, 0.2, torch.bfloat16, 5),
    (1, 2, 384, 24, 64, True, 0.2, torch.bfloat16, None),
    (2, 2, 64, 64, 8, False, 0.2, torch.bfloat16, None),
    (2, 2, 64, 64, 16, True, 0.2, torch.bfloat16, None),
    (2, 2, 96, 96, 128, True, 0.2, torch.bfloat16, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,s,d,packed,dropout,dtype,masked_row", TRAIN_CASES)
def test_relbias_train_kernels_on_card(gen, b, h, t, s, d, packed, dropout, dtype,
                                       masked_row):
    """Forward and backward kernels against their plain versions, bf16 dots:
    the same rounding points and the same dropout mask on both sides; f32
    sums in other orders may round a weight or a score gradient to the
    neighbouring bf16 value (2**-8 of one term), so each result must lie
    within 4e-3 of max(1, its max |value|) (an entry of a bf16 output may
    instead be the plain version's neighbouring bf16 value). The bf16 w_drop
    and ds the kernels keep equal the plain version's. e2's gradient under
    the causal mask is exactly 0. A second backward on the same inputs gives
    the same dq, dk, dv, de1 and de2 bit for bit (dmask sums by atomics).
    The forward's bf16 w_drop equals the plain version's too."""
    nh = h if packed else None
    inputs = _train_case(gen, b, h, t, s, d, packed, dtype, masked_row)
    q, k, v, mask, e1, e2, g = inputs
    kw = dict(num_heads=nh, dropout=dropout, seed=77)
    before = (ak.launches, ak.bwd_launches)
    got = [ak.relbias_attention_fwd(q, k, v, mask, e1, e2, **kw),
           *ak.relbias_attention_bwd(q, k, v, mask, e1, e2, g, **kw)]
    assert (ak.launches, ak.bwd_launches) == (before[0] + 1, before[1] + 1)
    scratch = bwd_scratch(b, h, t, s, torch.bfloat16, "cuda")
    again = ak.relbias_attention_bwd_cuda(q, k, v, mask, e1, e2, g, scratch=scratch,
                                          **kw)
    for name, a, a2 in zip(("dq", "dk", "dv", "dmask", "de1", "de2"), got[1:], again):
        assert name == "dmask" or torch.equal(a, a2), name
    differs = _scratch_differs(scratch, ak.relbias_attention_bwd_weights_plain,
                               inputs, kw)
    assert differs == {"w_drop": 0, "ds": 0}, differs
    assert _weights_differ(ak.relbias_attention_fwd_cuda,
                           ak.relbias_attention_bwd_weights_plain, inputs, kw) == 0
    want = [ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2, **kw),
            *ak.relbias_attention_bwd_plain(q, k, v, mask, e1, e2, g, **kw)]
    for name, a, w in zip(("out", "dq", "dk", "dv", "dmask", "de1", "de2"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert _grad_err(a, w) <= 0, (name, _grad_err(a, w))
    if t == s and masked_row is None:
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


def _fused_case(gen, b, h, t, s, d, mask_kind, bias_kind, packed=False,
                dtype=torch.float32):
    """Inputs of the fused-attention kernels: a causal, anticausal or zero
    mask, and no bias, the (B*H, 1, 1) placeholder or a real (B*H, T, S)."""
    q = torch.randn((b, h, t, d), generator=gen, device="cuda") * d ** -0.5
    k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda") for _ in range(2))
    g = torch.randn((b, h, t, d), generator=gen, device="cuda")
    mask = {"causal": lambda: causal_mask(t, device="cuda"),
            "anticausal": lambda: anticausal_mask(s, sz_tgt=t, device="cuda"),
            "zero": lambda: torch.zeros((t, s), device="cuda")}[mask_kind]()
    bias = {"none": None,
            "placeholder": torch.zeros((b * h, 1, 1), device="cuda"),
            "real": torch.randn((b * h, t, s), generator=gen, device="cuda")}[bias_kind]
    if packed:
        q, k, v, g = (x.transpose(1, 2).reshape(b, x.shape[2], h * d)
                      for x in (q, k, v, g))
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    return q, k, v, mask, bias, g


# (T, S, mask, bias, head dim, input dtype, fully masked query row)
K4_CASES = [
    (64, 64, "causal", "none", 32, torch.float32, None),
    (96, 24, "zero", "placeholder", 32, torch.float32, None),
    (24, 24, "anticausal", "real", 32, torch.float32, None),
    # several key blocks of 64, dead ones skipped
    (384, 384, "causal", "none", 64, torch.float32, None),
    # ragged query tiles and a ragged last key block
    (100, 100, "causal", "placeholder", 32, torch.float32, None),
    # a fully masked row: its tile skips nothing (weights 1/S)
    (160, 160, "causal", "none", 64, torch.float32, 70),
    (64, 64, "causal", "real", 8, torch.float32, None),
    (64, 64, "zero", "none", 16, torch.float32, None),
    (96, 96, "causal", "placeholder", 128, torch.float32, None),
    # beyond the whole-plane staging of the first K4 kernel (S <= 219 at d = 128)
    (600, 600, "causal", "none", 128, torch.float32, None),
    # bf16 inputs, f32 dots
    (100, 100, "causal", "real", 64, torch.bfloat16, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,mask_kind,bias_kind,d,dtype,masked_row", K4_CASES)
def test_fused_attention_kernel_on_card(gen, t, s, mask_kind, bias_kind, d, dtype,
                                        masked_row):
    """K4 against its plain version: f32 throughout on both sides (TF32
    off), sums in other orders: 1e-5. Strided (B, H, L, d) views are read in
    place, and views whose rows do not start on 16 bytes too. bf16 inputs are
    widened to f32 in the kernel: the bf16 result equals the f32 kernel's on
    the widened inputs, rounded to bf16, bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask, bias, _ = _fused_case(gen, 2, 2, t, s, d, mask_kind, bias_kind)
    if masked_row is not None:
        mask[masked_row] = float("-inf")
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = fk.launches
    got = fk.fused_attention(q, k, v, mask, bias)
    assert fk.launches == before + 1
    if dtype == torch.bfloat16:
        q, k, v = (x.float() for x in (q, k, v))
        wide = fk.fused_attention(q, k, v, mask, bias)
        assert torch.equal(got, wide.to(torch.bfloat16))
        got = wide
    torch.testing.assert_close(got, fk.fused_attention_plain(q, k, v, mask, bias),
                               rtol=0, atol=1e-5)
    kv = torch.randn((2, s, 2, 2, d), generator=gen, device="cuda")
    k4, v4 = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    torch.testing.assert_close(fk.fused_attention(q, k4, v4, mask, bias),
                               fk.fused_attention_plain(q, k4, v4, mask, bias),
                               rtol=0, atol=1e-5)
    # rows one element off 16 bytes: the synchronous-load instance
    q1 = torch.randn((2, 2, t, d + 1), generator=gen, device="cuda")[..., 1:] * d ** -0.5
    torch.testing.assert_close(fk.fused_attention(q1, k4, v4, mask, bias),
                               fk.fused_attention_plain(q1, k4, v4, mask, bias),
                               rtol=0, atol=1e-5)


# (B, H, T, S, d, mask, bias, packed, dropout, input dtype, fully masked
# query row): as TRAIN_CASES, with no bias, the placeholder or a real bias
FUSED_TRAIN_CASES = [
    (2, 2, 64, 64, 32, "causal", "none", True, 0.2, torch.bfloat16, None),
    (2, 2, 96, 24, 32, "zero", "placeholder", False, 0.2, torch.float32, None),
    (2, 2, 32, 32, 32, "causal", "real", True, 0.1, torch.float32, None),
    (2, 2, 24, 24, 32, "anticausal", "real", False, 0.0, torch.bfloat16, None),
    (2, 2, 100, 100, 32, "causal", "placeholder", True, 0.2, torch.bfloat16, None),
    (2, 2, 17, 17, 32, "causal", "real", False, 0.2, torch.bfloat16, 5),
    (1, 2, 384, 24, 64, "zero", "placeholder", True, 0.2, torch.bfloat16, None),
    (2, 2, 64, 64, 8, "causal", "none", False, 0.2, torch.bfloat16, None),
    (2, 2, 64, 64, 16, "causal", "real", True, 0.2, torch.bfloat16, None),
    (2, 2, 96, 96, 128, "causal", "placeholder", True, 0.2, torch.bfloat16, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,t,s,d,mask_kind,bias_kind,packed,dropout,dtype,masked_row",
    FUSED_TRAIN_CASES)
def test_fused_attention_train_kernels_on_card(gen, b, h, t, s, d, mask_kind,
                                                bias_kind, packed, dropout, dtype,
                                                masked_row):
    """K6's forward and backward against their plain versions, bf16 dots:
    the same rounding points and dropout mask on both sides; f32 sums in
    other orders may round a weight or a score gradient to the neighbouring
    bf16 value, so each result lies within 4e-3 of max(1, its max |value|)
    or, in a bf16 output, one bf16 step of the plain version's entry, as for
    the relative-bias kernels. dmask and dbias are the f32 score
    gradient, taken before any bf16 rounding: within 1e-5. The
    placeholder's cotangent is none; a real bias's is the f32 score gradient
    (K6-bwd). A second backward gives the same dq, dk, dv and dbias bit for
    bit (dmask sums by atomics), and the bf16 w_drop and ds the kernels
    keep (the forward's w_drop too) equal the plain version's."""
    inputs = _fused_case(gen, b, h, t, s, d, mask_kind, bias_kind, packed, dtype)
    q, k, v, mask, bias, g = inputs
    if masked_row is not None:
        mask[masked_row] = float("-inf")
    kw = dict(num_heads=h if packed else None, dropout=dropout, seed=77)
    before = (fk.train_fwd_launches, fk.train_bwd_launches,
              fk.train_bwd_nobias_launches)
    got = [fk.fused_attention_train_fwd(q, k, v, mask, bias, **kw),
           *fk.fused_attention_train_bwd(q, k, v, mask, bias, g, **kw)]
    scratch = bwd_scratch(b, h, t, s, torch.bfloat16, "cuda")
    again = fk.fused_attention_train_bwd_cuda(q, k, v, mask, bias, g, scratch=scratch,
                                              **kw)
    for name, a, a2 in zip(("dq", "dk", "dv", "dmask", "dbias"), got[1:], again):
        assert name == "dmask" or a is None or torch.equal(a, a2), name
    differs = _scratch_differs(scratch, fk.fused_attention_train_bwd_weights_plain,
                               inputs, kw)
    assert differs == {"w_drop": 0, "ds": 0}, differs
    real = bias_kind == "real"
    assert (fk.train_fwd_launches, fk.train_bwd_launches,
            fk.train_bwd_nobias_launches) == (before[0] + 1, before[1] + 2 * real,
                                              before[2] + 2 * (not real))
    assert _weights_differ(fk.fused_attention_train_fwd_cuda,
                           fk.fused_attention_train_bwd_weights_plain, inputs, kw) == 0
    want = [fk.fused_attention_train_fwd_plain(q, k, v, mask, bias, **kw),
            *fk.fused_attention_train_bwd_plain(q, k, v, mask, bias, g, **kw)]
    for name, a, w in zip(("out", "dq", "dk", "dv", "dmask", "dbias"), got, want):
        assert (a is None) == (w is None), name
        if a is None:
            continue
        assert a.shape == w.shape and a.dtype == w.dtype, name
        frac = 1e-5 if name in ("dmask", "dbias") else 4e-3
        assert _grad_err(a, w, frac) <= 0, (name, _grad_err(a, w, frac))
    assert (got[-1] is not None) == real


@pytest.mark.cuda
def test_fused_attention_kernel_dropout_mask_is_the_flat_hash(gen):
    """With v the one-hot columns K6's output is its dropped weight row:
    zero exactly where the hash on stream seed + b*H + h drops."""
    b, h, t, s, d = 2, 3, 32, 32, 32
    q, k, _, mask, _, _ = _fused_case(gen, b, h, t, s, d, "causal", "none")
    v = torch.eye(s, d, device="cuda").expand(b, h, s, d).contiguous()
    out = fk.fused_attention_train_fwd(q, k, v, mask, None, torch.float32,
                                       dropout=0.2, seed=5)
    w = fk.fused_attention_plain(q, k, v, mask)
    keep = ak.dropout_keep_plain((t, s), 0.2, fk.flat_stream_seeds(5, b, h, "cuda"))
    live = w[..., :s] > 0
    assert torch.equal((out[..., :s] != 0) & live, keep & live)


@pytest.mark.cuda
def test_fused_attention_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q, k, v, mask, _, g = _fused_case(gen, 1, 2, 16, 16, 32, "causal", "none",
                                      True, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 inputs need bf16 dots"):
        fk.fused_attention_train_bwd(q, k, v, mask, None, g, torch.float32,
                                     num_heads=2)
    q4 = torch.randn((1, 2, 8, 12), generator=gen, device="cuda")    # head dim 12
    with pytest.raises(ValueError, match="head dim"):
        fk.fused_attention(q4, q4, q4, None)
    with pytest.raises(ValueError, match="bias must be"):
        fk.fused_attention(q4, q4, q4, None, torch.zeros((2, 3, 1), device="cuda"))


# ---- checkpoints on the card (twins of tests/test_torch_checkpoints.py) ----

def _checkpoint_helpers():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_checkpoints
    return test_torch_checkpoints


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["encoder", "decoder", "student", "prior"])
def test_resume_from_step_checkpoint_on_card(gen, tmp_path, kind):
    """A run killed at batch 3 of epoch 0 (step checkpoints every 2 batches)
    and resumed by train_model on the card ends where the uninterrupted run
    on the card does: parameters, buffers, optimizers, step and generators
    equal, bit for bit, and the same metrics rows. Dropout on (and label
    corruption with BatchNorm for the encoder)."""
    tc = _checkpoint_helpers()
    if kind == "encoder":
        build, config = tc.build_encoder_trainer, tc.encoder_config("commitment")
        kwargs = dict(batch_size=16, num_batches=5, num_epochs=2, lr=1e-3,
                      schedule_lr=True, corrupt_labels=True,
                      checkpoint_every_steps=2)
    elif kind == "student":
        build, config = tc.build_student_trainer, tc.student_config(dropout=0.1)
        kwargs = dict(batch_size=8, num_batches=5, num_epochs=2, lr=1e-3,
                      schedule_lr=True, checkpoint_every_steps=2)
    elif kind == "prior":
        build, config = tc.build_prior_trainer, tc.prior_config(dropout=0.1)
        kwargs = dict(batch_size=8, num_batches=5, num_epochs=2, lr=1e-3,
                      checkpoint_every_steps=2)
    else:
        build, config = tc.build_decoder_trainer, tc.decoder_config(dropout=0.1)
        kwargs = dict(batch_size=8, num_batches=5, num_epochs=2, lr=1e-3,
                      schedule_lr=True, checkpoint_every_steps=2)

    def on_card(tmp, name, cfg, **kw):
        return build(tmp, name, cfg, device="cuda", **kw)
    tc._resume_matches_uninterrupted(tmp_path, on_card, config, kwargs)


@pytest.mark.cuda
def test_student_train_step_on_card_matches_the_cpu(gen, tmp_path, f32_matmuls):
    """One StudentEncoderTrainer step of encoder_student_smoke.py (dropout
    0) on the card and on the CPU from the same weights, batch, masked event
    and codebook-init permutation: the four losses within 2e-2 relative
    (the card's attention kernels round their dot inputs to bf16), each of
    the four groups' updates (Adam's first step, about lr times the
    gradient's sign) within cosine 0.9 of the CPU's, and the step's
    launches on the card: K1 once, the relative-bias forward and backward
    once per relative layer (teacher 1, downscaler 2, auxiliary decoder 2)."""
    import numpy as np
    tc = _checkpoint_helpers()
    config = tc.student_config(dropout=0.0)
    results = []
    for device in ("cuda", "cpu"):
        trainer = tc.build_student_trainer(tmp_path, device, config, device=device)
        x = next(trainer.dataloader_generator.dataloaders(batch_size=8)[0])["x"]
        trainer.init_state(x, lr=1e-3, perms=[np.random.RandomState(0).permutation(32)])
        old = {k: v.cpu().clone() for k, v in trainer.model.state_dict().items()}
        before = (vk.launches, ak.launches, ak.bwd_launches)
        metrics = trainer.train_step(x, masked_event_index=7)
        if device == "cuda":
            assert (vk.launches - before[0], ak.launches - before[1],
                    ak.bwd_launches - before[2]) == (1, 5, 5)
        groups = {}
        for name, value in trainer.model.state_dict().items():
            group = ("teacher_data_processor" if name.startswith("teacher.data_processor.")
                     else name.split(".")[0])
            groups.setdefault(group, []).append((value.cpu() - old[name]).flatten())
        results.append(({k: v.item() for k, v in metrics.items()},
                        {k: torch.cat(v) for k, v in groups.items()}))
    (card, card_updates), (cpu, cpu_updates) = results
    for name, value in cpu.items():
        assert abs(card[name] - value) <= 2e-2 * abs(value), name
    assert len(cpu_updates) == 4
    for group, want in cpu_updates.items():
        got = card_updates[group]
        cos = float((got * want).sum() / (got.norm() * want.norm()))
        assert cos >= 0.9, (group, cos)


@pytest.mark.cuda
def test_prior_train_step_on_card_matches_the_cpu(gen, tmp_path, f32_matmuls):
    """The prior of prior_smoke.py (dropout 0) on the card and on the CPU
    from the same weights, on the card's codes of one batch: the loss
    within 2e-2 relative and every gradient within cosine 0.99 (the card's
    attention kernels round their dot inputs to bf16; the causal mask
    leaves e2 without a gradient on both); then one train step's launches
    on the card: K1 once, the relative-bias forward and backward once per
    layer."""
    import copy
    tc = _checkpoint_helpers()
    card = tc.build_prior_trainer(tmp_path, "p", tc.prior_config(dropout=0.0),
                                  device="cuda")
    x = next(card.dataloader_generator.dataloaders(batch_size=8)[0])["x"]
    codes = card.encode_codes(x)
    results = []
    for prior, c in ((card.prior, codes), (copy.deepcopy(card.prior).cpu(), codes.cpu())):
        prior.train()
        loss = prior(c)["loss"]
        loss.backward()
        results.append((loss.item(), {n: p.grad.float().cpu()
                                      for n, p in prior.named_parameters()}))
    (card_loss, card_grads), (cpu_loss, cpu_grads) = results
    assert abs(card_loss - cpu_loss) <= 2e-2 * abs(cpu_loss)
    for name, want in cpu_grads.items():
        got = card_grads[name]
        if name.endswith(".attn_bias.e2"):
            assert not got.any() and not want.any(), name
            continue
        assert float((got * want).sum() / (got.norm() * want.norm())) >= 0.99, name
    layers = len(card.prior.transformer.layers)
    card.init_state(lr=1e-3)
    before = (vk.launches, ak.launches, ak.bwd_launches)
    card.train_step(x)
    assert (vk.launches - before[0], ak.launches - before[1],
            ak.bwd_launches - before[2]) == (1, layers, layers)


@pytest.mark.cuda
def test_prior_greedy_sampler_on_card_matches_teacher_forcing(gen, monkeypatch):
    """A small prior (2 layers, d_model 32, 12 codes) on the card: greedy
    KV-cached codes with f32 caches, from position 0 (zero caches) and from
    6 after a fixed prefix (the relative-bias forward kernel's prefill and
    the plain decode steps), equal the argmax of the teacher-forced logits
    (the kernel's bf16 dots) at 99% or more of the sampled positions; one
    prefill launches the kernel once per layer."""
    from vqcpcb_tpu_torch.models.prior import PriorRelative
    monkeypatch.setenv("VQCPCB_KV_DTYPE", "float32")
    torch.manual_seed(0)
    prior = PriorRelative(11, 32, 2, 2, 48, 8, 1, 12, 0.0).cuda().eval()
    x0 = torch.zeros((64, 12), dtype=torch.long, device="cuda")
    before = ak.launches
    with torch.no_grad():
        prior.prefill(x0)
    assert ak.launches - before == 2
    greedy = prior.sample_window(x0, 0, 12, gen, top_k=1)
    prefix = greedy.clone()
    prefix[:, 6:] = 0
    tail = prior.sample_window(prefix, 6, 6, gen, top_k=1)
    assert torch.equal(tail[:, :6], prefix[:, :6])
    for codes, start in ((greedy, 0), (tail, 6)):
        with torch.no_grad():
            forced = prior.logits(codes).argmax(-1)
        agree = (forced == codes)[:, start:].float().mean().item()
        assert agree >= 0.99, (start, agree)


@pytest.mark.cuda
def test_decoder_reload_on_card_gives_the_trained_eval_loss(gen, tmp_path):
    """save, then a fresh trainer's init_state + load on the card: the whole
    state equal, and the eval loss of one batch equal to the trained
    model's in memory."""
    tc = _checkpoint_helpers()
    config = tc.decoder_config(dropout=0.1)
    a = tc.build_decoder_trainer(tmp_path, "d", config, device="cuda")
    a.train_model(batch_size=8, num_batches=3, num_epochs=1, lr=1e-3)
    x = next(a.dataloader_generator.dataloaders(batch_size=8)[1])["x"]
    trained = a.eval_step(x)["loss"].item()
    b = tc.build_decoder_trainer(tmp_path, "d", config, init_seed=1, seed=5,
                                 device="cuda")
    b.init_state(lr=1e-3)
    b.load(early_stopped=False)
    tc.assert_states_equal(b.state_dict(), a.state_dict())
    assert b.eval_step(x)["loss"].item() == trained


@pytest.mark.cuda
def test_dropout_on_card_draws_from_the_generator(gen):
    """utils.dropout on a CUDA tensor (torch's fused dropout kernel with the
    caller's generator): the same seed gives the same mask, another seed
    another; about 1 - rate of the elements kept, scaled by 1 / (1 - rate);
    the gradient is the mask over (1 - rate)."""
    from vqcpcb_tpu_torch.utils import dropout
    x = torch.randn((256, 512), generator=gen, device="cuda", requires_grad=True)

    def run(seed):
        return dropout(x, 0.2, True, torch.Generator(device="cuda").manual_seed(seed))

    a = run(1)
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(a[kept], x[kept] / 0.8)
    a.sum().backward()
    torch.testing.assert_close(x.grad, kept.float() / 0.8)
    assert dropout(x, 0.2, False) is x


# ---- the scale-up MIDI chain's shapes (configs/*_scaleup_midi.py) -------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [5760, 384, 768, 1536])
def test_nearest_codebook_at_the_scaleup_shapes(gen, n):
    """K1 at the chain's rows (its encoder's 64 x 15 x 6 negatives and 64 x
    6 blocks, its decoder's 32 x 24 and its prior's 64 x 24 codes) with its
    product codebook of 2 sub-codebooks of 16 codes of dimension 4
    (codebook_dim 8): the d4_s16 instance, equal to the run-time kernel bit
    for bit and to the plain version outside the margin."""
    x = torch.randn((n, 2, 4), generator=gen, device="cuda") * 4
    e = torch.randn((2, 16, 4), generator=gen, device="cuda") * 4
    assert vk.kernel_kind(4, 16) == "d4_s16"
    got = vk.nearest_codebook_indices(x, e)
    assert torch.equal(got, vk.nearest_codebook_indices_cuda(x, e, kind="runtime"))
    want = vk.nearest_codebook_indices_plain(x, e)
    assert not ((got != want) & _outside_margin(x, e)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(5760, 16), (5760, 4), (768, 16), (768, 4)])
def test_relbias_kernels_at_the_scaleup_batches(gen, b, t):
    """K2-fwd and K2-bwd (packed, f32 inputs, bf16 dots, dropout 0.1) and
    K3-fwd ((B, H, L, d)) with no mask at the chain's downscaler batches (8
    heads of 64, T = S = 16 and 4), within _grad_err's bound of their plain
    versions, and the forward's bf16 weights equal to the plain version's
    at every entry (its dots sliced by batch, _kernel_io.batch_einsum);
    K3-fwd's out within the bound too."""
    h, d = 8, 64
    q = torch.randn((b, t, h * d), generator=gen, device="cuda") * d ** -0.5
    k, v, g = (torch.randn((b, t, h * d), generator=gen, device="cuda")
               for _ in range(3))
    e1, e2 = (torch.randn((h, t, d), generator=gen, device="cuda") for _ in range(2))
    kw = dict(num_heads=h, dropout=0.1, seed=5)
    got = [ak.relbias_attention_fwd(q, k, v, None, e1, e2, **kw),
           *ak.relbias_attention_bwd(q, k, v, None, e1, e2, g, **kw)]
    want = [ak.relbias_attention_fwd_plain(q, k, v, None, e1, e2, **kw),
            *ak.relbias_attention_bwd_plain(q, k, v, None, e1, e2, g, **kw)]
    for name, a, w in zip(("out", "dq", "dk", "dv", "dmask", "de1", "de2"), got, want):
        if w is None:
            assert a is None, name
            continue
        assert _grad_err(a, w) <= 0, (name, _grad_err(a, w))
    assert _weights_differ(ak.relbias_attention_fwd_cuda,
                           ak.relbias_attention_bwd_weights_plain,
                           (q, k, v, None, e1, e2, g), kw) == 0
    q4, k4, v4 = (heads(x, h).contiguous() for x in (q, k, v))
    out = ak.relbias_attention_fwd(q4, k4, v4, None, e1, e2)
    assert _grad_err(out, ak.relbias_attention_fwd_plain(q4, k4, v4, None, e1, e2)) <= 0


@pytest.mark.cuda
def test_remat_gradients_on_card_equal_bit_for_bit(gen, monkeypatch):
    """VQCPCB_REMAT=1 on the card: a two-layer relative encoder stack in
    train mode at dropout 0.2 (the kernels' in-kernel dropout and the fused
    dropout draw from the wired generators) gives the loss and every
    gradient of the run without it bit for bit, and leaves the generators
    where that run leaves them."""
    from vqcpcb_tpu_torch.ops.transformer import TransformerEncoder, wire_generators
    torch.manual_seed(0)
    stack = TransformerEncoder(2, 512, 8, "relative_attention", 1, 16, 2048,
                               dropout=0.2).cuda().train()
    x = torch.randn((64, 16, 512), generator=gen, device="cuda")
    results = []
    for remat in ("0", "1"):
        monkeypatch.setenv("VQCPCB_REMAT", remat)
        gens = (torch.Generator(device="cuda").manual_seed(1),
                torch.Generator().manual_seed(2))
        wire_generators(stack, *gens)
        loss = stack(x).square().mean()
        grads = torch.autograd.grad(loss, list(stack.parameters()))
        results.append((loss, grads, [g.get_state() for g in gens]))
    (loss, grads, states), (rloss, rgrads, rstates) = results
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    assert all(torch.equal(a, b) for a, b in zip(states, rstates))
