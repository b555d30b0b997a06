"""Layout round trip of the weight bridge: a random port state_dict, through
the JAX package's reference importers to flax, then through
vqcpcb_tpu_torch.convert, comes back exactly. This pins every layout the
bridge handles (Dense transposes, the (E, 3, H, hd) in_proj, (H, S, hd)
relative tables, direction-stacked BiGRU weights, (K, S, d) codebooks, raw
params, the student modules' numbered stages and heads)."""
import pytest
import torch

from vqcpcb_tpu.training.import_reference import (
    import_auxiliary_decoder_state_dict, import_decoder_state_dict,
    import_encoder_state_dicts, import_teacher_state_dict,
    import_transformer_downscaler)
from vqcpcb_tpu_torch import convert
from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    BachDataProcessor)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.auxiliary_decoder import AuxiliaryDecoderRelative
from vqcpcb_tpu_torch.models.downscalers import (
    GruDownscaler, RelativeTransformerDownscaler,
    RelativeTransformerDownscalerLinear)
from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
from vqcpcb_tpu_torch.models.teacher import TeacherRelative
from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer

VOCABS = [5, 6, 7, 8]


def _randomized(module, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen)
            for k, v in module.state_dict().items()}


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_encoder_layout_round_trip():
    enc = Encoder(BachCPCDataProcessor(8, 16, VOCABS),
                  GruDownscaler(8, 4, [16], 12, num_layers=2, dropout=0.0,
                                bidirectional=True),
                  ProductVectorQuantizer(8, 4, 0.25, 2),
                  MlpUpscaler(4, 10, 12, 0.0))
    sd = _randomized(enc, 0)
    params = import_encoder_state_dicts(
        _sub(sd, "data_processor."), _sub(sd, "downscaler."),
        _sub(sd, "quantizer."), _sub(sd, "upscaler."), num_layers_gru=2,
        bidirectional=True)
    back = convert.encoder_state_dict(params)
    _assert_equal(back, sd)
    enc.load_state_dict(back, strict=True)


def test_decoder_layout_round_trip():
    dec = Decoder(BachDataProcessor(8, 8, VOCABS), "anticausal", d_model=16,
                  num_encoder_layers=2, num_decoder_layers=2, n_head=4,
                  dim_feedforward=24, positional_embedding_size=4,
                  num_channels_encoder=1, num_events_encoder=2,
                  num_channels_decoder=4, num_events_decoder=8,
                  total_upscaling=16, source_vocab_size=6)
    sd = _randomized(dec, 1)
    params = import_decoder_state_dict(sd, num_heads=4, num_encoder_layers=2,
                                       num_decoder_layers=2, aligned_cross=True)
    back = convert.decoder_state_dict(params)
    _assert_equal(back, sd)
    dec.load_state_dict(back, strict=True)


def test_absolute_decoder_layout_round_trip():
    """The absolute decoder with full cross-attention (configs/decoder_random.py):
    source and target positional embeddings, a source embedding d_model - p
    wide, and each layer's multihead_attn, through import_decoder_state_dict
    with aligned_cross=False, transformer_type='absolute'."""
    dec = Decoder(BachDataProcessor(8, 8, VOCABS), "anticausal", d_model=16,
                  num_encoder_layers=2, num_decoder_layers=2, n_head=4,
                  dim_feedforward=24, positional_embedding_size=4,
                  num_channels_encoder=1, num_events_encoder=2,
                  num_channels_decoder=4, num_events_decoder=8,
                  total_upscaling=16, source_vocab_size=6,
                  transformer_type="absolute", cross_attention_type="full")
    sd = _randomized(dec, 2)
    assert "transformer.decoder.layers.1.multihead_attn.in_proj_weight" in sd
    params = import_decoder_state_dict(sd, num_heads=4, num_encoder_layers=2,
                                       num_decoder_layers=2, aligned_cross=False,
                                       transformer_type="absolute")
    back = convert.decoder_state_dict(params)
    _assert_equal(back, sd)
    dec.load_state_dict(back, strict=True)


@pytest.mark.parametrize("cls", [RelativeTransformerDownscaler,
                                 RelativeTransformerDownscalerLinear])
def test_transformer_downscaler_layout_round_trip(cls):
    """Both relative-transformer downscalers through
    import_transformer_downscaler, inside the encoder's params."""
    ds = cls(8, 3, [4, 4], 4, 16, 4, [2, 1], 24, 0.0, positional_embedding_size=4)
    sd = _randomized(ds, 3)
    params = import_transformer_downscaler(
        sd, num_heads=4, list_of_num_layers=[2, 1],
        linear_aggregation=cls is RelativeTransformerDownscalerLinear)
    back = convert.encoder_state_dict({"data_processor": {}, "downscaler": params})
    _assert_equal(back, {f"downscaler.{k}": v for k, v in sd.items()})
    ds.load_state_dict(_sub(back, "downscaler."), strict=True)


def test_teacher_and_auxiliary_decoder_layout_round_trip():
    """The teacher (its data processor's tables included) through
    import_teacher_state_dict, the relative auxiliary decoder through
    import_auxiliary_decoder_state_dict."""
    teacher = TeacherRelative(BachDataProcessor(8, 8, VOCABS), 2, VOCABS, 4, 16,
                              24, 4, 32, 0.0)
    sd = _randomized(teacher, 4)
    params, dp = import_teacher_state_dict(sd, num_heads=4, num_layers=2)
    back = convert.teacher_state_dict(params, dp)
    _assert_equal(back, sd)
    teacher.load_state_dict(back, strict=True)
    aux = AuxiliaryDecoderRelative(VOCABS, 3, [4, 4], [1, 2], 4, 16, 24, 4, 0.0)
    sd = _randomized(aux, 5)
    back = convert.auxiliary_decoder_state_dict(
        import_auxiliary_decoder_state_dict(sd, num_heads=4, list_of_num_layers=[1, 2]))
    _assert_equal(back, sd)
    aux.load_state_dict(back, strict=True)
