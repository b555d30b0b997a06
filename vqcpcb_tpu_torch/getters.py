"""Config dict -> data loaders and modules (counterpart of
vqcpcb_tpu/getters.py), over the same config schema (configs/*.py) and with
the same derived dimensions, so one config builds the same model in either
package.

The port's modules take their input widths explicitly where flax infers
them (the downscalers', the upscaler's, the CPC context network's and an
unquantized decoder's source input); the getters fill them in from the
config. Every dataset of the JAX getters is here: 'synthetic', 'midi',
'musicxml' and 'bach' (music21's chorales, data/corpora.Music21BachCorpus,
which imports music21 when it reads the corpus).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from vqcpcb_tpu_torch.data.dataloaders import (BachCPCDataloaderGenerator,
                                               BachDataloaderGenerator)
from vqcpcb_tpu_torch.models.auxiliary_decoder import (AuxiliaryDecoder,
                                                       AuxiliaryDecoderRelative)
from vqcpcb_tpu_torch.models.cpc import CModule, FksModule, VQCPCModel
from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    BachDataProcessor)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.downscalers import (
    GruDownscaler, RelativeTransformerDownscaler,
    RelativeTransformerDownscalerLinear)
from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.models.prior import PriorRelative
from vqcpcb_tpu_torch.models.teacher import TeacherRelative
from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
from vqcpcb_tpu_torch.ops.quantizer import (EMAProductVectorQuantizer,
                                            NoQuantization,
                                            ProductVectorQuantizer)


def _corpus_from_config(config: Dict):
    """The corpus backend of config['dataset'] (getters.py:44)."""
    dataset = config.get("dataset", "bach").lower()
    if dataset == "synthetic":
        from vqcpcb_tpu_torch.data.corpora import SyntheticChoraleCorpus
        return SyntheticChoraleCorpus(**config.get("corpus_kwargs", {}))
    if dataset == "midi":
        # corpus_kwargs: midi_root, num_voices=4, max_files=None
        from vqcpcb_tpu_torch.data.midi import MidiCorpus
        return MidiCorpus(**config.get("corpus_kwargs", {}))
    if dataset == "musicxml":
        # corpus_kwargs: xml_root, num_voices=4, max_files=None
        from vqcpcb_tpu_torch.data.musicxml import MusicXmlCorpus
        return MusicXmlCorpus(**config.get("corpus_kwargs", {}))
    if dataset == "bach":
        # music21's chorales; the import happens when the corpus is read and
        # raises, naming music21, where it is not installed
        from vqcpcb_tpu_torch.data.corpora import Music21BachCorpus
        return Music21BachCorpus()
    raise NotImplementedError(
        "If you want to use your own datasets, you need to implement a "
        "corpus backend, data_processor and dataloader")


def get_dataloader_generator(dataset: str,
                             training_method: str,
                             dataloader_generator_kwargs: Dict,
                             config: Optional[Dict] = None,
                             cache_root: Optional[str] = None):
    """(getters.py:67) The explicit `dataset` wins over a config without the
    key."""
    config = dict(config) if config else {}
    config.setdefault("dataset", dataset)
    corpus = _corpus_from_config(config)
    kwargs = dataloader_generator_kwargs
    if training_method.lower() == "vqcpc":
        return BachCPCDataloaderGenerator(
            num_tokens_per_block=kwargs["num_tokens_per_block"],
            num_blocks_left=kwargs["num_blocks_left"],
            num_blocks_right=kwargs["num_blocks_right"],
            negative_sampling_method=kwargs["negative_sampling_method"],
            num_negative_samples=kwargs["num_negative_samples"],
            corpus=corpus, cache_root=cache_root)
    if training_method.lower() in ("student", "decoder", "prior"):
        return BachDataloaderGenerator(
            sequences_size=kwargs["sequences_size"], corpus=corpus,
            cache_root=cache_root)
    raise NotImplementedError(training_method)


def get_data_processor(dataloader_generator, data_processor_type: str,
                       data_processor_kwargs: Dict):
    """(getters.py:94)"""
    if data_processor_type == "bach":
        dataset = dataloader_generator.dataset
        return BachDataProcessor(
            embedding_size=data_processor_kwargs["embedding_size"],
            num_events=dataset.sequences_size * dataset.subdivision,
            num_tokens_per_channel=dataset.vocabulary.num_tokens_per_channel)
    if data_processor_type == "bach_cpc":
        dataset = dataloader_generator.dataset_positive
        return BachCPCDataProcessor(
            embedding_size=data_processor_kwargs["embedding_size"],
            num_events=dataset.sequences_size * dataset.subdivision,
            num_tokens_per_channel=dataset.vocabulary.num_tokens_per_channel,
            num_tokens_per_block=dataloader_generator.num_tokens_per_block)
    raise NotImplementedError(data_processor_type)


def get_downscaler(downscaler_type: str, downscaler_kwargs: Dict):
    """(getters.py:116) downscaler_kwargs carries `input_dim`, the data
    processor's embedding size, and `num_channels`, as get_encoder fills
    them in."""
    if downscaler_type == "lstm_downscaler":
        return GruDownscaler(
            input_dim=downscaler_kwargs["input_dim"],
            output_dim=downscaler_kwargs["output_dim"],
            downscale_factors=downscaler_kwargs["downscale_factors"],
            hidden_size=downscaler_kwargs["hidden_size"],
            num_layers=downscaler_kwargs["num_layers"],
            dropout=downscaler_kwargs["dropout"],
            bidirectional=downscaler_kwargs["bidirectional"])
    if downscaler_type in ("relative_transformer_downscaler",
                           "relative_transformer_downscaler_linear"):
        cls = (RelativeTransformerDownscaler
               if downscaler_type == "relative_transformer_downscaler"
               else RelativeTransformerDownscalerLinear)
        return cls(
            input_dim=downscaler_kwargs["input_dim"],
            output_dim=downscaler_kwargs["output_dim"],
            downscale_factors=downscaler_kwargs["downscale_factors"],
            num_channels=downscaler_kwargs["num_channels"],
            d_model=downscaler_kwargs["d_model"],
            n_head=downscaler_kwargs["n_head"],
            list_of_num_layers=downscaler_kwargs["list_of_num_layers"],
            dim_feedforward=downscaler_kwargs["dim_feedforward"],
            dropout=downscaler_kwargs["dropout"],
            positional_embedding_size=downscaler_kwargs.get(
                "positional_embedding_size", 8))
    raise NotImplementedError(downscaler_type)


def get_upscaler(upscaler_type: Optional[str], upscaler_kwargs: Dict):
    """(getters.py:147) upscaler_kwargs carries `input_dim`, the codebook
    dimension, as get_encoder fills it in."""
    if upscaler_type is None:
        return None
    if upscaler_type == "mlp_upscaler":
        return MlpUpscaler(
            input_dim=upscaler_kwargs["input_dim"],
            output_dim=upscaler_kwargs["output_dim"],
            hidden_size=upscaler_kwargs["hidden_size"],
            dropout=upscaler_kwargs["dropout"])
    raise NotImplementedError(upscaler_type)


def get_quantizer(config: Dict):
    """(getters.py:159) The codebook init is data-dependent and runs in the
    trainer's init_state; `quantizer_kwargs['initialize']` is provenance
    only."""
    kw = config["quantizer_kwargs"]
    if config["quantizer_type"] == "commitment":
        return ProductVectorQuantizer(
            codebook_size=kw["codebook_size"],
            codebook_dim=kw["codebook_dim"],
            commitment_cost=kw["commitment_cost"],
            num_codebooks=kw["num_codebooks"],
            squared_l2_norm=kw["squared_l2_norm"],
            use_batch_norm=kw["use_batch_norm"])
    if config["quantizer_type"] == "ema":
        return EMAProductVectorQuantizer(
            codebook_size=kw["codebook_size"],
            codebook_dim=kw["codebook_dim"],
            commitment_cost=kw["commitment_cost"],
            num_codebooks=kw["num_codebooks"],
            ema_decay=kw.get("ema_decay", 0.99))
    if config["quantizer_type"] is None:
        return NoQuantization(codebook_dim=kw["codebook_dim"])
    raise NotImplementedError(config["quantizer_type"])


def get_encoder(dataloader_generator, config: Dict) -> Encoder:
    """(getters.py:186) data processor -> downscaler -> quantizer ->
    optional upscaler, with the derived widths of the JAX getter."""
    data_processor = get_data_processor(
        dataloader_generator=dataloader_generator,
        data_processor_type=config["data_processor_type"],
        data_processor_kwargs=config["data_processor_kwargs"])
    codebook_dim = config["quantizer_kwargs"]["codebook_dim"]
    downscaler_kwargs = dict(config["downscaler_kwargs"])
    downscaler_kwargs["input_dim"] = data_processor.embedding_size
    downscaler_kwargs["output_dim"] = codebook_dim
    downscaler_kwargs["num_channels"] = data_processor.num_channels
    downscaler = get_downscaler(config["downscaler_type"], downscaler_kwargs)
    upscaler = None
    if config.get("upscaler_type") is not None:
        upscaler_kwargs = dict(config["upscaler_kwargs"], input_dim=codebook_dim)
        upscaler = get_upscaler(config["upscaler_type"], upscaler_kwargs)
    return Encoder(data_processor=data_processor, downscaler=downscaler,
                   quantizer=get_quantizer(config), upscaler=upscaler)


def z_width(encoder: Encoder, config: Dict) -> int:
    """The width of the encoder's z: the upscaler's output if it has one,
    else codebook_dim (flax infers it from z; torch's Linear is told)."""
    return (encoder.upscaler.mlp[3].out_features if encoder.upscaler is not None
            else config["quantizer_kwargs"]["codebook_dim"])


def get_vqcpc_model(dataloader_generator, config: Dict) -> VQCPCModel:
    """Encoder + CPC context and scorer networks (getters.py:211)."""
    encoder = get_encoder(dataloader_generator, config)
    aux = config["auxiliary_networks_kwargs"]
    c_net_kwargs = aux["c_net_kwargs"]
    z_dim = z_width(encoder, config)
    c_dim = c_net_kwargs["output_dim"]
    k_max = dataloader_generator.num_blocks_right

    def make_c():
        return CModule(input_dim=z_dim, hidden_size=c_net_kwargs["hidden_size"],
                       output_dim=c_dim, num_layers=c_net_kwargs["num_layers"],
                       dropout=c_net_kwargs["dropout"])

    def make_fks():
        return FksModule(z_dim=z_dim, c_dim=c_dim, k_max=k_max)

    bidirectional = c_net_kwargs.get("bidirectional", False)
    return VQCPCModel(
        encoder=encoder, c_module=make_c(), fks_module=make_fks(),
        c_module_back=make_c() if bidirectional else None,
        fks_module_back=make_fks() if bidirectional else None,
        quantization_weighting=aux["quantization_weighting"])


def get_teacher(teacher_kwargs: Dict, dataloader_generator) -> TeacherRelative:
    """(getters.py:243) The teacher with its own data processor (tables with
    the mask token's row); teacher_kwargs carries `num_tokens_per_channel`
    and `num_tokens`, as the encoder CLI fills them in."""
    dp_config = teacher_kwargs["data_processor_config"]
    data_processor = get_data_processor(
        dataloader_generator=dataloader_generator,
        data_processor_type=dp_config["data_processor_type"],
        data_processor_kwargs=dp_config["data_processor_kwargs"])
    return TeacherRelative(
        data_processor=data_processor,
        num_layers=teacher_kwargs["num_layers"],
        num_tokens_per_channel=teacher_kwargs["num_tokens_per_channel"],
        positional_embedding_size=teacher_kwargs["positional_embedding_size"],
        d_model=teacher_kwargs["d_model"],
        dim_feedforward=teacher_kwargs["dim_feedforward"],
        n_head=teacher_kwargs["n_head"],
        num_tokens=teacher_kwargs["num_tokens"],
        dropout=teacher_kwargs["dropout"])


def get_auxiliary_decoder(auxiliary_decoder_type: str,
                          auxiliary_decoder_kwargs: Dict) -> AuxiliaryDecoder:
    """(getters.py:262) 'absolute' or 'relative'; the kwargs carry the
    derived num_tokens_per_channel, codebook_dim, upscale_factors and
    num_tokens_bottleneck, as the encoder CLI fills them in."""
    cls = {"absolute": AuxiliaryDecoder,
           "relative": AuxiliaryDecoderRelative}[auxiliary_decoder_type]
    kw = auxiliary_decoder_kwargs
    return cls(
        num_tokens_per_channel=kw["num_tokens_per_channel"],
        codebook_dim=kw["codebook_dim"],
        upscale_factors=kw["upscale_factors"],
        list_of_num_layers=kw["list_of_num_layers"],
        n_head=kw["n_head"],
        d_model=kw["d_model"],
        dim_feedforward=kw["dim_feedforward"],
        num_tokens_bottleneck=kw["num_tokens_bottleneck"],
        dropout=kw["dropout"])


DECODER_TYPES = {
    # decoder_type -> (transformer_type, encoder_attention, cross_attention)
    # (getters.py:280-288)
    "transformer": ("absolute", "anticausal", "full"),
    "transformer_relative": ("relative", "anticausal", "anticausal"),
    "transformer_relative_fullCross": ("relative", "anticausal", "full"),
    "transformer_relative_diagonal": ("relative", "anticausal", "diagonal"),
    "transformer_relative_full": ("relative", "full", "full"),
}


def get_decoder(dataloader_generator, data_processor, encoder: Encoder,
                encoder_config: Dict, decoder_type: str,
                decoder_kwargs: Dict) -> Decoder:
    """(getters.py:291) The decoder over the codes of `encoder`: one code per
    prod(downscale_factors) target tokens, a source vocabulary of
    codebook_size ** num_codebooks merged codes; over an encoder without a
    quantizer, a source Linear from the width of its z (getters.py:307-318,
    where flax infers the width JAX's source_dim does not give). n_head_kv
    in decoder_kwargs makes it grouped-query."""
    transformer_type, enc_attn, cross_attn = DECODER_TYPES[decoder_type]
    num_channels_decoder = data_processor.num_channels
    num_events_decoder = data_processor.num_events
    num_channels_encoder = 1
    total_upscaling = int(np.prod(encoder.downscaler.downscale_factors))
    num_events_encoder = (num_events_decoder * num_channels_decoder) // (
        total_upscaling * num_channels_encoder)
    quantizer_kwargs = encoder_config["quantizer_kwargs"]
    if encoder_config["quantizer_type"] in ("commitment", "ema"):
        source_vocab_size = (quantizer_kwargs["codebook_size"]
                             ** quantizer_kwargs["num_codebooks"])
        source_dim = 0
    else:
        source_vocab_size, source_dim = 0, z_width(encoder, encoder_config)
    return Decoder(
        data_processor=data_processor,
        encoder_attention_type=enc_attn,
        d_model=decoder_kwargs["d_model"],
        num_encoder_layers=decoder_kwargs["num_encoder_layers"],
        num_decoder_layers=decoder_kwargs["num_decoder_layers"],
        n_head=decoder_kwargs["n_head"],
        dim_feedforward=decoder_kwargs["dim_feedforward"],
        positional_embedding_size=decoder_kwargs["positional_embedding_size"],
        num_channels_encoder=num_channels_encoder,
        num_events_encoder=num_events_encoder,
        num_channels_decoder=num_channels_decoder,
        num_events_decoder=num_events_decoder,
        total_upscaling=total_upscaling,
        source_vocab_size=source_vocab_size,
        source_dim=source_dim,
        dropout=decoder_kwargs["dropout"],
        transformer_type=transformer_type,
        cross_attention_type=cross_attn,
        n_head_kv=decoder_kwargs.get("n_head_kv"))


def get_prior(dataloader_generator, encoder: Encoder, encoder_config: Dict,
              prior_type: str, prior_kwargs: Dict) -> PriorRelative:
    """(getters.py:341) The prior over the codes of `encoder`, one code per
    prod(downscale_factors) tokens of the *prior* loader's sequences (not of
    the encoder's CPC window, getters.py:350-361), a vocabulary of
    codebook_size ** num_codebooks merged codes; n_head_kv in prior_kwargs
    makes it grouped-query."""
    if prior_type != "transformer_relative":
        raise NotImplementedError(prior_type)
    num_channels = 1
    dataset = dataloader_generator.dataset
    num_target_tokens = (dataset.sequences_size * dataset.subdivision
                         * len(dataset.vocabulary.num_tokens_per_channel))
    num_events = int(num_target_tokens
                     // (np.prod(encoder.downscaler.downscale_factors)
                         * num_channels))
    quantizer_kwargs = encoder_config["quantizer_kwargs"]
    return PriorRelative(
        code_vocab_size=(quantizer_kwargs["codebook_size"]
                         ** quantizer_kwargs["num_codebooks"]),
        d_model=prior_kwargs["d_model"],
        num_layers=prior_kwargs["num_layers"],
        n_head=prior_kwargs["n_head"],
        dim_feedforward=prior_kwargs["dim_feedforward"],
        embedding_size=prior_kwargs["embedding_size"],
        num_channels=num_channels,
        num_events=num_events,
        dropout=prior_kwargs["dropout"],
        n_head_kv=prior_kwargs.get("n_head_kv"))
