"""Weight bridge: JAX (flax) param trees -> the port's state_dicts.

The inverse of vqcpcb_tpu/training/import_reference.py: the port keeps the
reference's parameter names, so `import_encoder_state_dicts` /
`import_decoder_state_dict` followed by these functions gives back the
starting state_dict exactly. Inputs are nested dicts of arrays (numpy, as
jax.device_get returns them); the results load with strict=True.

Layouts handled: flax Dense kernels are (in, out), torch Linear weights
(out, in); the attention in_proj kernel is (E, 3, H, hd) and becomes the
(3E, E) in_proj_weight, or, grouped, q_proj (E, H, hd) and kv_proj (E, 2,
H_kv, hd) become the Linears q_proj and kv_proj; rel_e1 / rel_e2 are (H, S,
hd) and become (H*S, hd); a decoder's source_embeddings is an Embed, or the
Dense over an unquantized encoder's z; the fused BiGRU stacks its two
directions on axis 0 of (2, in, 3h) and becomes g_enc_fwd / g_enc_bwd;
codebooks are (K, S, d) and become embeddings.{k}; sos and the positional
embeddings (relative: target channel and event features; absolute: source
and target positions) are raw params; an attention decoder layer's
cross-attention is multihead_attn; a flax stack's layer_{i} is layers.{i},
and the student modules' numbered names (transformer_{i}, linear_agg_{i},
upscale_embeddings_{i}, pre_softmax_{c}) become the reference's lists
(transformers.{i}, linear_aggs.{i}, upscale_embeddings.{i},
pre_softmaxes.{c}).
The non-parameter collections (flax `batch_stats`: the quantizer
BatchNorm's mean / var; `ema`: the EMA quantizer's codebooks, cluster_size
and ema_sums) become buffers of the same state_dict.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True))


def _dense(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}weight": _tensor(np.asarray(params["kernel"]).T),
            f"{prefix}bias": _tensor(params["bias"])}


def _gru(layers: Mapping, prefix: str, direction=None) -> Dict[str, torch.Tensor]:
    """flax GRU / one direction of BiGRU params -> torch.nn.GRU names."""
    def pick(a):
        return np.asarray(a) if direction is None else np.asarray(a)[direction]

    out = {}
    layer = 0
    while f"layer_{layer}_w_i" in layers:
        out[f"{prefix}weight_ih_l{layer}"] = _tensor(pick(layers[f"layer_{layer}_w_i"]).T)
        out[f"{prefix}weight_hh_l{layer}"] = _tensor(pick(layers[f"layer_{layer}_w_h"]).T)
        out[f"{prefix}bias_ih_l{layer}"] = _tensor(pick(layers[f"layer_{layer}_b_i"]))
        out[f"{prefix}bias_hh_l{layer}"] = _tensor(pick(layers[f"layer_{layer}_b_h"]))
        layer += 1
    return out


def _embeddings(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    c = 0
    while f"embed_{c}" in params:
        out[f"{prefix}embeddings.{c}.weight"] = _tensor(params[f"embed_{c}"]["embedding"])
        c += 1
    return out


def _flat_dense(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A DenseGeneral whose kernel is (in, *features) -> a Linear."""
    kernel = np.asarray(params["kernel"])
    return _dense({"kernel": kernel.reshape(kernel.shape[0], -1),
                   "bias": np.asarray(params["bias"]).reshape(-1)}, prefix)


def _attention(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    if "in_proj" in params:
        kernel = np.asarray(params["in_proj"]["kernel"])     # (E, 3, H, hd)
        e = kernel.shape[0]
        out = {f"{prefix}in_proj_weight": _tensor(kernel.reshape(e, 3 * e).T),
               f"{prefix}in_proj_bias": _tensor(
                   np.asarray(params["in_proj"]["bias"]).reshape(3 * e))}
    else:                       # grouped: q (E, H, hd), kv (E, 2, H_kv, hd)
        out = _flat_dense(params["q_proj"], f"{prefix}q_proj.")
        out.update(_flat_dense(params["kv_proj"], f"{prefix}kv_proj."))
    out.update(_dense(params["out_proj"], f"{prefix}out_proj."))
    if "rel_e1" in params:
        for name in ("e1", "e2"):
            table = np.asarray(params[f"rel_{name}"])         # (H, S, hd)
            out[f"{prefix}attn_bias.{name}"] = _tensor(
                table.reshape(-1, table.shape[-1]))
    return out


def _layer_norm(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}weight": _tensor(params["scale"]),
            f"{prefix}bias": _tensor(params["bias"])}


def _transformer_layer(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    out = _attention(params["self_attn"], f"{prefix}self_attn.")
    out.update(_dense(params["ff"]["linear1"], f"{prefix}linear1."))
    out.update(_dense(params["ff"]["linear2"], f"{prefix}linear2."))
    for norm in ("norm1", "norm2", "norm3"):
        if norm in params:
            out.update(_layer_norm(params[norm], f"{prefix}{norm}."))
    if "cross_mlp_1" in params:
        out.update(_dense(params["cross_mlp_1"], f"{prefix}cross_attn.0."))
        out.update(_dense(params["cross_mlp_2"], f"{prefix}cross_attn.2."))
    if "multihead_attn" in params:
        out.update(_attention(params["multihead_attn"], f"{prefix}multihead_attn."))
    return out


def _transformer_stack(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax TransformerEncoder's layer_{i} -> {prefix}layers.{i}."""
    out = {}
    i = 0
    while f"layer_{i}" in params:
        out.update(_transformer_layer(params[f"layer_{i}"], f"{prefix}layers.{i}."))
        i += 1
    return out


def _stages(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """transformer_{i} (and linear_agg_{i}, upscale_embeddings_{i}) of the
    staged student modules -> transformers.{i} (linear_aggs.{i},
    upscale_embeddings.{i})."""
    out = {}
    i = 0
    while f"transformer_{i}" in params:
        out.update(_transformer_stack(params[f"transformer_{i}"],
                                      f"{prefix}transformers.{i}."))
        if f"linear_agg_{i}" in params:
            out.update(_dense(params[f"linear_agg_{i}"], f"{prefix}linear_aggs.{i}."))
        if f"upscale_embeddings_{i}" in params:
            out[f"{prefix}upscale_embeddings.{i}"] = _tensor(
                params[f"upscale_embeddings_{i}"])
        i += 1
    return out


def _pre_softmaxes(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    c = 0
    while f"pre_softmax_{c}" in params:
        out.update(_dense(params[f"pre_softmax_{c}"], f"{prefix}pre_softmaxes.{c}."))
        c += 1
    return out


def encoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax Encoder 'params' (GRU or relative-transformer downscaler, product
    quantizer, optional MLP upscaler) -> state_dict of
    vqcpcb_tpu_torch.models.encoder.Encoder."""
    sd = _embeddings(params["data_processor"], "data_processor.")
    ds = params["downscaler"]
    if "bigru" in ds:
        sd.update(_gru(ds["bigru"], "downscaler.g_enc_fwd.", direction=0))
        sd.update(_gru(ds["bigru"], "downscaler.g_enc_bwd.", direction=1))
    elif "g_enc_fwd" in ds:
        sd.update(_gru(ds["g_enc_fwd"], "downscaler.g_enc_fwd."))
    else:
        sd.update(_dense(ds["input_linear"], "downscaler.input_linear."))
        for name in ("target_channel_embeddings", "events_positioning_embeddings"):
            sd[f"downscaler.{name}"] = _tensor(ds[name])
        sd.update(_stages(ds, "downscaler."))
    sd.update(_dense(ds["output_linear"], "downscaler.output_linear."))
    quantizer = params.get("quantizer", {})       # none for EMA / pass-through
    if "codebooks" in quantizer:
        for k, table in enumerate(np.asarray(quantizer["codebooks"])):
            sd[f"quantizer.embeddings.{k}"] = _tensor(table)
    if "batch_norm" in quantizer:
        sd["quantizer.batch_norm.weight"] = _tensor(quantizer["batch_norm"]["scale"])
        sd["quantizer.batch_norm.bias"] = _tensor(quantizer["batch_norm"]["bias"])
    if "upscaler" in params:
        sd.update(_dense(params["upscaler"]["fc1"], "upscaler.mlp.0."))
        sd.update(_dense(params["upscaler"]["fc2"], "upscaler.mlp.3."))
    return sd


def decoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax Decoder 'params' (relative or absolute; aligned or attention
    cross branch) -> state_dict of vqcpcb_tpu_torch.models.decoder.Decoder."""
    sd = {"sos": _tensor(params["sos"])}
    source = params["source_embeddings"]
    if "embedding" in source:
        sd["source_embeddings.weight"] = _tensor(source["embedding"])
    else:                       # the Dense over an unquantized encoder's z
        sd.update(_dense(source, "source_embeddings."))
    for name in ("target_channel_embeddings",
                 "target_events_positioning_embeddings",       # relative
                 "source_positional_embeddings",
                 "target_positional_embeddings"):              # absolute
        if name in params:
            sd[name] = _tensor(params[name])
    sd.update(_dense(params["linear_target"], "linear_target."))
    sd.update(_embeddings(params["data_processor"], "data_processor."))
    for stack, name in (("encoder_transformer", "encoder"),
                        ("decoder_transformer", "decoder")):
        sd.update(_transformer_stack(params[stack], f"transformer.{name}."))
    sd.update(_pre_softmaxes(params))
    return sd


def teacher_state_dict(params: Mapping, data_processor_params: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """flax TeacherRelative 'params' and its data processor's (the student
    trainer's 'teacher' and 'teacher_data_processor' groups) -> state_dict
    of vqcpcb_tpu_torch.models.teacher.TeacherRelative."""
    sd = _embeddings(data_processor_params, "data_processor.")
    sd.update(_dense(params["linear_to_input_transformer"],
                     "linear_to_input_transformer."))
    sd["channel_embeddings"] = _tensor(params["channel_embeddings"])
    sd.update(_transformer_stack(params["transformer"], "transformer."))
    sd.update(_pre_softmaxes(params))
    return sd


def auxiliary_decoder_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax AuxiliaryDecoder[Relative] 'params' -> state_dict of
    vqcpcb_tpu_torch.models.auxiliary_decoder.AuxiliaryDecoder[Relative]."""
    sd = _dense(params["linear"], "linear.")
    if "positional_embeddings" in params:
        sd["positional_embeddings"] = _tensor(params["positional_embeddings"])
    sd.update(_stages(params, ""))
    sd.update(_pre_softmaxes(params))
    return sd


def prior_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax PriorRelative 'params' (or a gradient of the same tree) ->
    state_dict of vqcpcb_tpu_torch.models.prior.PriorRelative."""
    sd = {"sos": _tensor(params["sos"]),
          "embedding.weight": _tensor(params["embedding"]["embedding"])}
    sd.update(_dense(params["linear"], "linear."))
    sd.update(_transformer_stack(params["transformer"], "transformer."))
    sd.update(_dense(params["pre_softmax"], "pre_softmax."))
    return sd


def _encoder_buffers(collections: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """An encoder's variable collections ({'batch_stats': {'quantizer':
    ...}, 'ema': {'quantizer': ...}}) -> its quantizer's buffers."""
    sd = {}
    quantizer = collections.get("batch_stats", {}).get("quantizer", {})
    if "batch_norm" in quantizer:
        sd[f"{prefix}quantizer.batch_norm.running_mean"] = _tensor(quantizer["batch_norm"]["mean"])
        sd[f"{prefix}quantizer.batch_norm.running_var"] = _tensor(quantizer["batch_norm"]["var"])
    ema = collections.get("ema", {}).get("quantizer", {})
    for name in ("codebooks", "cluster_size", "ema_sums"):
        if name in ema:
            sd[f"{prefix}quantizer.{name}"] = _tensor(ema[name])
    return sd


def student_state_dict(params: Mapping, collections: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """The JAX student trainer's params (groups 'encoder', 'teacher',
    'auxiliary_decoder', 'teacher_data_processor') and its encoder's
    variable collections (state.batch_stats) -> the state_dict of the
    StudentEncoderTrainer's `model` (encoder.*, teacher.*,
    auxiliary_decoder.*)."""
    sd = {f"encoder.{k}": v for k, v in encoder_state_dict(params["encoder"]).items()}
    sd.update({f"teacher.{k}": v for k, v in teacher_state_dict(
        params["teacher"], params["teacher_data_processor"]).items()})
    sd.update({f"auxiliary_decoder.{k}": v for k, v in
               auxiliary_decoder_state_dict(params["auxiliary_decoder"]).items()})
    sd.update(_encoder_buffers(collections or {}, "encoder."))
    return sd


def vqcpc_state_dict(params: Mapping, collections: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """flax VQCPCModel 'params' and its other variable collections (the JAX
    trainer's state.batch_stats: {'batch_stats': ..., 'ema': ...}) -> the
    state_dict, parameters and buffers, of
    vqcpcb_tpu_torch.models.cpc.VQCPCModel."""
    sd = {f"encoder.{k}": v for k, v in encoder_state_dict(params["encoder"]).items()}
    for name in ("c_module", "c_module_back"):
        if name in params:
            sd.update(_gru(params[name]["g_ar_fwd"], f"{name}.g_ar_fwd."))
            sd.update(_dense(params[name]["output_linear"], f"{name}.output_linear."))
    for name in ("fks_module", "fks_module_back"):
        if name in params:
            sd[f"{name}.W"] = _tensor(params[name]["W"])
    collections = collections or {}
    sd.update(_encoder_buffers({k: v.get("encoder", {}) for k, v in collections.items()},
                               "encoder."))
    return sd
