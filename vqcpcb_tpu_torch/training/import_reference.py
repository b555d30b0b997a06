"""Import a PyTorch-reference checkpoint into the port's state_dicts
(counterpart of vqcpcb_tpu/training/import_reference.py).

The reference saves per-module state_dicts: an encoder as
{model_dir}/{early_stopped,overfitted}/{data_processor,downscaler,quantizer,
upscaler} (reference VQCPCB/encoder.py:47-74), a decoder as one whole
`decoder` file (decoders/decoder.py:274-292, its frozen `encoder.*` entries
included), a prior as a `prior` file (priors/prior_relative.py:109-119). The
port keeps the reference's parameter names, so importing is a relayout:
each function reads exactly the keys that the JAX importer reads (a missing
one raises a KeyError naming it; the others, such as a decoder file's
`encoder.*` entries and BatchNorm's `num_batches_tracked`, are ignored) and
returns them under the names of the port's modules, the names that
vqcpcb_tpu_torch/convert.py gives, every tensor f32, contiguous and on the
CPU. The JAX importer followed by convert.py gives the same state_dict, bit
for bit. The BatchNorm running statistics become the quantizer's buffers
(`import_encoder_batch_stats`).

A grouped-query configuration (n_head_kv below n_head) keeps separate
q_proj / kv_proj projections, which the reference's fused in_proj_weight
does not fit: loading such an import raises (TrainLoopMixin.load_state_dict),
as the JAX load fails.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

StateDict = Dict[str, torch.Tensor]


def _take(sd: Mapping, key: str) -> torch.Tensor:
    """sd[key] as an f32 contiguous CPU tensor of its own; KeyError(key)
    when missing."""
    if key not in sd:
        raise KeyError(key)
    return torch.as_tensor(sd[key]).detach().to("cpu", torch.float32).contiguous().clone()


def _dense(sd: Mapping, prefix: str, out: str) -> StateDict:
    return {f"{out}weight": _take(sd, f"{prefix}weight"),
            f"{out}bias": _take(sd, f"{prefix}bias")}


def _numbered(sd: Mapping, key: str, out: str) -> StateDict:
    """key.format(c) for c = 0, 1, ... while present -> out.format(c)."""
    got, c = {}, 0
    while key.format(c) in sd:
        got[out.format(c)] = _take(sd, key.format(c))
        c += 1
    return got


def _embeddings(sd: Mapping, prefix: str, out: str) -> StateDict:
    """A data processor's per-channel embeddings."""
    return _numbered(sd, prefix + "embeddings.{}.weight", out + "embeddings.{}.weight")


def _gru(sd: Mapping, prefix: str, num_layers: int, out: str) -> StateDict:
    got = {}
    for layer in range(num_layers):
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            key = f"{name}_l{layer}"
            got[f"{out}{key}"] = _take(sd, f"{prefix}{key}")
    return got


def _attention(sd: Mapping, prefix: str, num_heads: int, out: str) -> StateDict:
    """MultiheadAttentionCustom (fused in_proj, out_proj, the relative
    tables e1 / e2 of (H*S, hd) when present)."""
    got = {f"{out}in_proj_weight": _take(sd, f"{prefix}in_proj_weight"),
           f"{out}in_proj_bias": _take(sd, f"{prefix}in_proj_bias")}
    e = got[f"{out}in_proj_weight"].shape[-1]
    if e % num_heads:
        raise ValueError(f"{prefix}in_proj_weight: width {e} is not a multiple of "
                         f"{num_heads} heads")
    got.update(_dense(sd, f"{prefix}out_proj.", f"{out}out_proj."))
    if f"{prefix}attn_bias.e1" in sd:
        for name in ("e1", "e2"):
            table = _take(sd, f"{prefix}attn_bias.{name}")
            if table.shape[0] % num_heads:
                raise ValueError(f"{prefix}attn_bias.{name}: {table.shape[0]} rows "
                                 f"are not a multiple of {num_heads} heads")
            got[f"{out}attn_bias.{name}"] = table
    return got


def _layer(sd: Mapping, prefix: str, num_heads: int, out: str,
           norms: Sequence[str] = ("norm1", "norm2")) -> StateDict:
    """One transformer layer: self-attention, the norms, the feed-forward."""
    got = _attention(sd, f"{prefix}self_attn.", num_heads, f"{out}self_attn.")
    for norm in norms:
        got.update(_dense(sd, f"{prefix}{norm}.", f"{out}{norm}."))
    for linear in ("linear1", "linear2"):
        got.update(_dense(sd, f"{prefix}{linear}.", f"{out}{linear}."))
    return got


def _stack(sd: Mapping, prefix: str, num_layers: int, num_heads: int) -> StateDict:
    got = {}
    for i in range(num_layers):
        got.update(_layer(sd, f"{prefix}layers.{i}.", num_heads, f"{prefix}layers.{i}."))
    return got


def _pre_softmaxes(sd: Mapping) -> StateDict:
    got, c = {}, 0
    while f"pre_softmaxes.{c}.weight" in sd:
        got.update(_dense(sd, f"pre_softmaxes.{c}.", f"pre_softmaxes.{c}."))
        c += 1
    return got


def import_transformer_downscaler(downscaler_sd: Mapping, num_heads: int,
                                  list_of_num_layers: Sequence[int],
                                  linear_aggregation: bool,
                                  out: str = "") -> StateDict:
    """Reference RelativeTransformerDownscaler(Linear) state_dict -> the
    port's downscaler entries under `out`."""
    sd = downscaler_sd
    got = _dense(sd, "input_linear.", f"{out}input_linear.")
    for name in ("target_channel_embeddings", "events_positioning_embeddings"):
        got[f"{out}{name}"] = _take(sd, name)
    got.update(_dense(sd, "output_linear.", f"{out}output_linear."))
    for i, num_layers in enumerate(list_of_num_layers):
        for j in range(num_layers):
            p = f"transformers.{i}.layers.{j}."
            got.update(_layer(sd, p, num_heads, f"{out}{p}"))
        if linear_aggregation:
            got.update(_dense(sd, f"linear_aggs.{i}.", f"{out}linear_aggs.{i}."))
    return got


def import_encoder_state_dicts(data_processor_sd: Mapping,
                               downscaler_sd: Mapping,
                               quantizer_sd: Mapping,
                               upscaler_sd: Optional[Mapping],
                               num_layers_gru: int = 2,
                               bidirectional: bool = True,
                               downscaler_type: str = "lstm_downscaler",
                               num_heads: int = 8,
                               list_of_num_layers: Optional[Sequence[int]] = None
                               ) -> StateDict:
    """The four reference state_dicts -> the parameters of the port's
    Encoder (convert.encoder_state_dict's names); the BatchNorm statistics
    come from import_encoder_batch_stats."""
    got = _embeddings(data_processor_sd, "", "data_processor.")
    if downscaler_type == "lstm_downscaler":
        got.update(_gru(downscaler_sd, "g_enc_fwd.", num_layers_gru,
                        "downscaler.g_enc_fwd."))
        if bidirectional:
            got.update(_gru(downscaler_sd, "g_enc_bwd.", num_layers_gru,
                            "downscaler.g_enc_bwd."))
        got.update(_dense(downscaler_sd, "output_linear.", "downscaler.output_linear."))
    else:
        got.update(import_transformer_downscaler(
            downscaler_sd, num_heads, list_of_num_layers,
            downscaler_type == "relative_transformer_downscaler_linear",
            "downscaler."))
    # the product quantizer's codebooks (reference vector_quantizer.py:44-48)
    codebooks = _numbered(quantizer_sd or {}, "embeddings.{}", "quantizer.embeddings.{}")
    if not codebooks:
        raise KeyError("embeddings.0")
    got.update(codebooks)
    if "batch_norm.weight" in quantizer_sd:
        got.update(_dense(quantizer_sd, "batch_norm.", "quantizer.batch_norm."))
    # the MLP upscaler (Sequential Linear / Dropout / SELU / Linear)
    if upscaler_sd is not None:
        got.update(_dense(upscaler_sd, "mlp.0.", "upscaler.mlp.0."))
        got.update(_dense(upscaler_sd, "mlp.3.", "upscaler.mlp.3."))
    return got


def import_encoder_batch_stats(quantizer_sd: Mapping) -> StateDict:
    """The quantizer BatchNorm's running statistics (reference
    vector_quantizer.py:54-55) as the port's quantizer buffers; empty when
    use_batch_norm was off."""
    if "batch_norm.running_mean" not in quantizer_sd:
        return {}
    return {f"quantizer.batch_norm.{name}": _take(quantizer_sd, f"batch_norm.{name}")
            for name in ("running_mean", "running_var")}


def import_decoder_state_dict(sd: Mapping, num_heads: int,
                              num_encoder_layers: int, num_decoder_layers: int,
                              aligned_cross: bool,
                              transformer_type: str = "relative") -> StateDict:
    """A reference Decoder file -> the port's Decoder state_dict; its frozen
    `encoder.*` entries are ignored (the encoder is imported on its own)."""
    got = {"sos": _take(sd, "sos")}
    got.update(_dense(sd, "linear_target.", "linear_target."))
    if "source_embeddings.weight" in sd and "source_embeddings.bias" not in sd:
        got["source_embeddings.weight"] = _take(sd, "source_embeddings.weight")
    else:           # NoQuantization: a Linear source (reference decoder.py:229)
        got.update(_dense(sd, "source_embeddings.", "source_embeddings."))
    names = (("target_channel_embeddings", "target_events_positioning_embeddings")
             if transformer_type == "relative" else
             ("source_positional_embeddings", "target_positional_embeddings"))
    for name in names:
        got[name] = _take(sd, name)
    got.update(_embeddings(sd, "data_processor.", "data_processor."))
    got.update(_stack(sd, "transformer.encoder.", num_encoder_layers, num_heads))
    for i in range(num_decoder_layers):
        p = f"transformer.decoder.layers.{i}."
        got.update(_layer(sd, p, num_heads, p, norms=("norm1", "norm2", "norm3")))
        if aligned_cross:
            for k in ("0", "2"):
                got.update(_dense(sd, f"{p}cross_attn.{k}.", f"{p}cross_attn.{k}."))
        else:
            got.update(_attention(sd, f"{p}multihead_attn.", num_heads,
                                  f"{p}multihead_attn."))
    got.update(_pre_softmaxes(sd))
    return got


def import_prior_state_dict(sd: Mapping, num_heads: int, num_layers: int) -> StateDict:
    """A reference PriorRelative file -> the port's PriorRelative
    state_dict (its one head pre_softmaxes.0 becomes pre_softmax)."""
    got = {"sos": _take(sd, "sos"), "embedding.weight": _take(sd, "embedding.weight")}
    got.update(_dense(sd, "linear.", "linear."))
    got.update(_dense(sd, "pre_softmaxes.0.", "pre_softmax."))
    got.update(_stack(sd, "transformer.", num_layers, num_heads))
    return got


def import_teacher_state_dict(sd: Mapping, num_heads: int, num_layers: int
                              ) -> Tuple[StateDict, StateDict]:
    """A reference TeacherRelative state_dict -> (the teacher's entries, its
    data processor's), both under the names of the port's TeacherRelative
    (the data processor is its submodule: data_processor.embeddings.{c})."""
    got = {"channel_embeddings": _take(sd, "channel_embeddings")}
    got.update(_dense(sd, "linear_to_input_transformer.",
                      "linear_to_input_transformer."))
    got.update(_stack(sd, "transformer.", num_layers, num_heads))
    got.update(_pre_softmaxes(sd))
    return got, _embeddings(sd, "data_processor.", "data_processor.")


def import_auxiliary_decoder_state_dict(sd: Mapping, num_heads: int,
                                        list_of_num_layers: Sequence[int]) -> StateDict:
    """A reference AuxiliaryDecoderRelative state_dict -> the port's."""
    got = _dense(sd, "linear.", "linear.")
    for i, num_layers in enumerate(list_of_num_layers):
        got[f"upscale_embeddings.{i}"] = _take(sd, f"upscale_embeddings.{i}")
        for j in range(num_layers):
            p = f"transformers.{i}.layers.{j}."
            got.update(_layer(sd, p, num_heads, p))
    got.update(_pre_softmaxes(sd))
    return got


def load_torch_file(path: str) -> Optional[Dict]:
    """A reference state_dict file, or None when it is missing."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_encoder_params(model_dir: str, early_stopped: bool,
                                  num_layers_gru: int = 2,
                                  bidirectional: bool = True) -> StateDict:
    """A reference GRU encoder's slot (the model directory itself in the
    pre-slot layout) -> the port's Encoder state_dict, the BatchNorm
    statistics included."""
    slot = os.path.join(model_dir, "early_stopped" if early_stopped else "overfitted")
    if not os.path.exists(slot):
        slot = model_dir
    quantizer = load_torch_file(os.path.join(slot, "quantizer"))
    got = import_encoder_state_dicts(
        load_torch_file(os.path.join(slot, "data_processor")),
        load_torch_file(os.path.join(slot, "downscaler")), quantizer,
        load_torch_file(os.path.join(slot, "upscaler")),
        num_layers_gru=num_layers_gru, bidirectional=bidirectional)
    got.update(import_encoder_batch_stats(quantizer))
    return got
